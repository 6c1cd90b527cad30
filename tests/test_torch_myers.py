"""The port's Myers flank scan (plain PyTorch versions, which the CUDA
wrappers run for CPU tensors) against the Pallas kernel in interpret
mode, in both its modes: top-8 valley keys and exact counts, and the
valley-cost map, must be equal integers.  A pure-torch emulation of the
CUDA kernel's segment-and-merge (each row split by the wrapper's plan,
each segment started a warm-up early) is held to the same results."""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs
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
    BIG,
    TOPK,
    _valleys_plain,
    myers_topk,
    myers_topk_plain,
    myers_valleys as port_myers_valleys,
    myers_valleys_plain,
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


# ------------------------------------------------ the kernel's segmentation


def _segmented(patw, m, rows, emit_lo, emit_hi, k, klmul, plan, warm=None):
    """Pure-torch emulation of ``csrc/myers.cu``'s segment-and-merge:
    (keys [R, 8], counts [R], valley map [R, L]).  Segment s of the plan
    (SEG, S) decides positions [s*SEG, min(L, (s+1)*SEG)) inside the
    row's emission range, starting the scan fresh ``warm`` columns before
    the first of them; like the kernel it reads from the 16-byte word
    holding that column with the bytes before it zeroed, and stops after
    the column right of its last position.  Each segment keeps its 8
    lowest keys; the row's keys are the 8 lowest of those lists."""
    R, L = rows.shape
    seg, S = plan
    warm = _build.myers_warmup(m, k) if warm is None else warm
    lo, hi = emit_lo.long(), emit_hi.long()
    lists = []
    counts = torch.zeros(R, dtype=torch.int64)
    vmap = torch.full((R, L), 255, dtype=torch.uint8)
    for s in range(S):
        a = min(L, s * seg)
        b = min(L, a + seg)
        dlo = torch.clamp(lo, min=a)
        dhi = torch.clamp(hi, max=b - 1)
        work = dlo <= dhi
        if not bool(work.any()):
            continue
        s0 = torch.clamp(dlo - warm, min=0)
        start = s0 // 16 * 16
        width = int(torch.where(work, dhi + 1 - start, 0).max())
        idx = start[:, None] + torch.arange(width)[None, :]
        text = rows.gather(1, idx.clamp(max=L - 1))
        text = torch.where((idx >= s0[:, None]) & (idx < L), text, 0)
        valleys, costs = _valleys_plain(
            patw, m, text, torch.where(work, dlo - start, 1),
            torch.where(work, dhi - start, 0), k)
        keys = torch.where(valleys, costs * klmul + idx, BIG)
        lists.append(keys.sort(dim=1).values[:, :TOPK])
        counts += valleys.sum(dim=1)
        rr, cc = valleys.nonzero(as_tuple=True)
        vmap[rr, idx[rr, cc]] = costs[rr, cc].to(torch.uint8)
    keys = torch.cat(lists + [torch.full((R, TOPK), BIG)], dim=1)
    return keys.sort(dim=1).values[:, :TOPK].to(torch.int32), counts.to(torch.int32), vmap


def _crafted(rng, pattern, L, k):
    """(rows, emit_lo, emit_hi): rows built around every column a that is
    a multiple of 16 (each plan's segment boundaries are among them): a
    cost-k alignment of k insertions (spanning exactly m + k columns)
    ending at every offset a-2 .. a+2, and a run of N wider than the
    pattern (a plateau at cost 0) across a; then a row of back-to-back
    copies (more than 8 valleys, over several segments) and rows with
    noisy copies, IUPAC N bytes and zero padding past ``emit_hi``, among
    them an empty range, a range that ends in the first segment and one
    that starts mid-segment.  The other ranges end at ``L - 1``."""
    m = len(pattern)
    span = m + k
    rows, lo, hi = [], [], []

    def add(row, a=0, b=L - 1):
        rows.append(row)
        lo.append(a)
        hi.append(b)

    def noise():
        return BASES[rng.integers(0, 4, L)]

    for a in range(16, L, 16):
        for d in range(-2, 3):
            end = a + d
            if end - span < 0 or end > L - 1:
                continue
            text = list(pattern)
            for p in sorted(rng.integers(1, max(2, m), k), reverse=True):
                text.insert(int(p), BASES[rng.integers(0, 4)])
            row = noise()
            row[end - span : end] = text
            add(row)
        row = noise()
        row[max(0, a - m - 1) : a + 2] = 15
        add(row)
    row = noise()
    for pos in range(1, L - m + 1, m + 3):
        row[pos : pos + m] = pattern
    add(row)
    for i in range(12):
        row = noise()
        for pos in rng.integers(0, max(1, L - m), 2):
            copy = pattern[: L - pos].copy()
            copy[rng.integers(0, len(copy))] = BASES[rng.integers(0, 4)]
            row[pos : pos + len(copy)] = copy
        row[rng.integers(0, L, 3)] = 15
        tec = int(rng.integers(L // 2, L + 1))
        row[tec:] = 0
        if i == 0:
            add(row, 7, 3)  # empty range
        elif i == 1:
            add(row, 0, 9)  # ends in the first segment
        elif i == 2:
            add(row, min(L - 1, int(rng.integers(L // 4, L)) | 5), L - 1)  # mid-word
        else:
            add(row, int(rng.integers(0, 3)), tec - 2)  # padding past hi
    return (np.stack(rows), np.array(lo, dtype=np.int32),
            np.array(hi, dtype=np.int32))


def _crafted_case(m, L, S, seed):
    """(pattern, k, plan, rows, emit_lo, emit_hi, patw): crafted rows for
    a flank of length m (an IUPAC N inside when m > 4) and the plan the
    wrapper would use, or S segments when S is given."""
    rng = np.random.default_rng(seed)
    pattern = BASES[rng.integers(0, 4, m)]
    if m > 4:
        pattern[rng.integers(1, m - 1)] = 15
    k = 0 if m == 1 else max(2, m // 5)
    rows, lo, hi = _crafted(rng, pattern, L, k)
    if S is None:
        plan = _build.segment_plan(m, k, L, rows.shape[0])
    else:
        plan = (_build.segment_size(L, S), S)
    words, _, _ = pattern_words(pattern)
    return pattern, k, plan, rows, lo, hi, torch.from_numpy(words.view(np.int32))


SEGMENT_CASES = {  # (m, L, S, or None for the wrapper's plan)
    "m1_W1": (1, 64, None),
    "m9_L16": (9, 16, None),
    "m9_many_valleys": (9, 256, None),
    "m32_top_bit31_L208_S4": (32, 208, 4),
    "m33_W2": (33, 256, None),
    "m45_S2": (45, 256, 2),
    "m128_W4_S4": (128, 512, 4),
}


@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segmented_scan_matches_plain_and_pallas(case):
    """The kernel's segment-and-merge (emulated) equals one pass over the
    row: the plain versions' keys, counts and valley map and, for
    m <= 45, the Pallas kernel's keys and counts, on rows crafted around
    the segment boundaries."""
    m, L, S = SEGMENT_CASES[case]
    pattern, k, plan, rows, lo, hi, patw = _crafted_case(m, L, S, 300 + m + L)
    seg, S = plan
    assert S & (S - 1) == 0 and S <= 32 and seg % 16 == 0 and seg * S >= L
    klmul = UNIT * (L + 2)
    args = (patw, m, torch.from_numpy(rows), torch.from_numpy(lo),
            torch.from_numpy(hi), k)
    got_k, got_c, got_map = _segmented(*args, klmul, plan)
    want_k, want_c = myers_topk_plain(*args, klmul)
    assert np.array_equal(got_k.numpy(), want_k.numpy())
    assert np.array_equal(got_c.numpy(), want_c.numpy())
    assert np.array_equal(got_map.numpy(), myers_valleys_plain(*args).numpy())
    assert int((want_c > 0).sum()) >= rows.shape[0] // 4
    if m * 9 < L:
        assert int(want_c.max()) > TOPK
    if m <= 45:
        words, W, top_bit = jax_pattern_words(pattern)
        pk, pc = myers_topk_from_words(
            jnp.asarray(words), W, top_bit, m, jnp.asarray(rows),
            jnp.asarray(lo), jnp.asarray(hi), jnp.int32(k), klmul, CL=L,
            interpret=True,
        )
        assert np.array_equal(got_k.numpy(), np.asarray(pk))
        assert np.array_equal(got_c.numpy(), np.asarray(pc))


@pytest.mark.parametrize("case", ["m33_W2", "m128_W4_S4"])
def test_myers_warmup_one_column_shorter_differs(case):
    """A warm-up one column shorter than the kernel's misses valleys on
    the crafted rows (a cost-k alignment spanning m + k columns that ends
    at a segment's first position): the segmentation tests can see a
    warm-up that is too short."""
    m, L, S = SEGMENT_CASES[case]
    _pattern, k, plan, rows, lo, hi, patw = _crafted_case(m, L, S, 300 + m + L)
    klmul = UNIT * (L + 2)
    args = (patw, m, torch.from_numpy(rows), torch.from_numpy(lo),
            torch.from_numpy(hi), k)
    want_k, want_c = myers_topk_plain(*args, klmul)
    warm = _build.myers_warmup(m, k)
    got_k, got_c, _ = _segmented(*args, klmul, plan, warm=warm)
    assert torch.equal(got_k, want_k) and torch.equal(got_c, want_c)
    short_k, short_c, _ = _segmented(*args, klmul, plan, warm=warm - 1)
    differ = (short_k != want_k).any(dim=1) | (short_c != want_c)
    assert int(differ.sum()) > 0
