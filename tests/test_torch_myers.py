"""The port's Myers flank scan (plain PyTorch versions, which the CUDA
wrappers run for CPU tensors) against the Pallas kernel in interpret
mode, in both its modes: top-8 valley keys and exact counts, and the
valley-cost map, must be equal integers."""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu.ops import pallas_myers  # noqa: E402
from barbell_tpu.ops.pallas_myers import (  # noqa: E402
    myers_topk_from_words,
    myers_valleys,
    pattern_words as jax_pattern_words,
)
from barbell_tpu_torch import _build  # noqa: E402
from barbell_tpu_torch.ops.myers import (  # noqa: E402
    TOPK,
    myers_topk,
    myers_valleys as port_myers_valleys,
    pattern_words,
)

BASES = np.array([1, 2, 4, 8], dtype=np.uint8)
UNIT = 2560


@pytest.fixture(autouse=True)
def _myers_unroll_1(monkeypatch):
    """The Pallas kernel unrolls its position loop 16-fold for the TPU's
    scheduler (``BARBELL_MYERS_UNROLL``); the arithmetic is the same at
    any factor, and at 1 its interpret-mode trace compiles about 16
    times faster on the CPU."""
    monkeypatch.setattr(pallas_myers, "UNROLL", 1)


def _rows(rng, pattern, R, L):
    """Random rows with planted noisy flank copies, IUPAC N bytes, zero
    padding tails, and one row packed with more than 8 valleys."""
    m = len(pattern)
    rows = BASES[rng.integers(0, 4, (R, L))]
    for r in range(R):
        for pos in rng.integers(0, L - 4, 3):
            seg = pattern[: min(m, L - pos)].copy()
            if len(seg) > 4:
                seg[rng.integers(0, len(seg))] = BASES[rng.integers(0, 4)]
            rows[r, pos : pos + len(seg)] = seg
        rows[r, rng.integers(0, L, 4)] = 15  # IUPAC N
        rows[r, L - int(rng.integers(0, L // 4)) :] = 0  # zero padding
    step = m + 3
    for pos in range(1, L - m, step):  # > 8 exact copies
        rows[1, pos : pos + m] = pattern
    return rows


@pytest.mark.parametrize("m", [9, 45, 90])
def test_myers_topk_plain_matches_pallas(m):
    rng = np.random.default_rng(100 + m)
    R, L = 24, 256
    pattern = BASES[rng.integers(0, 4, m)]
    pattern[rng.integers(0, m, 2)] = 15  # IUPAC inside the flank
    rows = _rows(rng, pattern, R, L)
    k_units = max(2, m // 5)
    emit_lo = rng.integers(0, 40, R).astype(np.int32)
    emit_hi = (L - 1 - rng.integers(0, 40, R)).astype(np.int32)
    emit_lo[2], emit_hi[2] = 50, 10  # empty emission range
    klmul = UNIT * (L + 2)

    words, W, top_bit = pattern_words(pattern)
    jw, jW, jtop = jax_pattern_words(pattern)
    assert np.array_equal(words, jw) and (W, top_bit) == (jW, jtop)
    want_k, want_c = myers_topk_from_words(
        jnp.asarray(words), W, top_bit, m, jnp.asarray(rows),
        jnp.asarray(emit_lo), jnp.asarray(emit_hi), jnp.int32(k_units),
        klmul, CL=L, interpret=True,
    )
    got_k, got_c = myers_topk(
        torch.from_numpy(words.view(np.int32)), m, torch.from_numpy(rows),
        torch.from_numpy(emit_lo), torch.from_numpy(emit_hi), k_units, klmul,
    )
    assert got_k.dtype == torch.int32 and got_k.shape == (R, TOPK)
    assert np.array_equal(got_k.numpy(), np.asarray(want_k))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c[2] == 0
    if m == 9:
        assert got_c[1] > TOPK  # the overflow row really overflowed


@pytest.mark.parametrize("m", [9, 90])
def test_myers_valleys_plain_matches_pallas(m):
    """Map mode: the u8 valley-cost map (255 = no valley), IUPAC N in the
    flank and in the rows, and an empty emission range."""
    rng = np.random.default_rng(200 + m)
    R, L = 16, 256
    pattern = BASES[rng.integers(0, 4, m)]
    pattern[rng.integers(0, m, 2)] = 15
    rows = _rows(rng, pattern, R, L)
    k_units = max(2, m // 5)
    emit_lo = rng.integers(0, 40, R).astype(np.int32)
    emit_hi = (L - 1 - rng.integers(0, 40, R)).astype(np.int32)
    emit_lo[3], emit_hi[3] = 60, 20  # empty emission range
    want = myers_valleys(
        pattern, jnp.asarray(rows), jnp.asarray(emit_lo), jnp.asarray(emit_hi),
        jnp.int32(k_units), CL=L, interpret=True,
    )
    words, _, _ = pattern_words(pattern)
    got = port_myers_valleys(
        torch.from_numpy(words.view(np.int32)), m, torch.from_numpy(rows),
        torch.from_numpy(emit_lo), torch.from_numpy(emit_hi), k_units,
    )
    assert got.dtype == torch.uint8 and got.shape == (R, L)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got[3] == 255).all()
    assert int((got < 255).sum()) >= R  # valleys were found


def test_launch_counter_loses_no_update_across_threads():
    """The engine's worker threads launch kernels concurrently, so the
    counters' read-modify-write must lose no update."""

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, n_each = 16, 2000

    def work():
        for _ in range(n_each):
            _build.count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * n_each


def test_wrapper_takes_plain_path_only_for_cpu():
    words, W, _ = pattern_words(BASES[:5])
    rows = torch.zeros((2, 32), dtype=torch.uint8)
    lo = torch.zeros(2, dtype=torch.int32)
    before = myers_topk.launches
    myers_topk(torch.from_numpy(words.view(np.int32)), 5, rows, lo, lo + 31, 1, 34)
    assert myers_topk.launches == before  # no kernel launch on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        myers_topk(
            torch.from_numpy(words.view(np.int32)), 5, rows.to("meta"),
            lo.to("meta"), lo.to("meta"), 1, 34,
        )
