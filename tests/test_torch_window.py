"""The port's window DP (plain PyTorch version, which the CUDA wrapper
runs for CPU tensors) against the Pallas kernel in interpret mode, in
all three modes: valley keys/counts, trace summaries and interval
mappings must be equal integers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu.ops import oracle  # noqa: E402
from barbell_tpu.ops import pallas_window as pw  # noqa: E402
from barbell_tpu_torch.ops import window as tw  # noqa: E402

BASES = np.array([1, 2, 4, 8], dtype=np.uint8)
ALPHA = oracle.scale_alpha(0.4)
UNIT = oracle.COST_SCALE


def _cases(rng, H, m, W, shared_pattern):
    """Windows with noisy planted pattern copies, IUPAC N bytes and a
    zero tail past each lane's w_len."""
    pats = BASES[rng.integers(0, 4, (1 if shared_pattern else H, m))]
    pats[:, rng.integers(0, m)] = 15
    pats = np.broadcast_to(pats, (H, m)).copy()
    w_len = rng.integers(max(1, m // 2), W + 1, H).astype(np.int32)
    wins = np.zeros((H, W), dtype=np.uint8)
    for h in range(H):
        n = int(w_len[h])
        content = BASES[rng.integers(0, 4, n)]
        for pos in rng.integers(0, max(1, n - m), 2):
            src = pats[h].copy()
            src[rng.integers(0, m)] = BASES[rng.integers(0, 4)]
            seg = src[: min(m, n - pos)]
            content[pos : pos + len(seg)] = seg
        content[rng.integers(0, n)] = 15
        wins[h, :n] = content
    return pats, wins, w_len


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_window_valleys_matches_pallas():
    rng = np.random.default_rng(5)
    H, m, W = 40, 20, 47
    pats, wins, w_len = _cases(rng, H, m, W, shared_pattern=True)
    # one lane of back-to-back short-period copies: > 8 valleys
    wins[0] = np.tile(np.concatenate([pats[0][:5], BASES[[0, 1, 2]]]), 6)[:W]
    w_len[0] = W
    ledge = rng.integers(0, 2, H).astype(bool)
    rpos = np.where(rng.integers(0, 2, H) != 0, w_len, -1).astype(np.int32)
    emit_lo = rng.integers(0, 6, H).astype(np.int32)
    emit_hi = (w_len - rng.integers(0, 6, H)).astype(np.int32)
    emit_lo[3], emit_hi[3] = 9, 2  # empty range
    k_scaled = 16 * UNIT
    klmul = W + 2
    want_k, want_c = pw.window_valleys(
        jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(w_len),
        jnp.asarray(ledge), jnp.asarray(rpos), jnp.asarray(emit_lo),
        jnp.asarray(emit_hi), jnp.int32(ALPHA), jnp.int32(k_scaled), klmul,
        interpret=True,
    )
    got_k, got_c = tw.window_valleys(
        _t(pats[0]), _t(wins), _t(w_len), _t(ledge), _t(rpos), _t(emit_lo),
        _t(emit_hi), ALPHA, k_scaled, klmul,
    )
    assert np.array_equal(got_k.numpy(), np.asarray(want_k))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c[3] == 0 and got_c.max() > tw.VTOPK


def test_window_trace_matches_pallas():
    rng = np.random.default_rng(21)
    H, m, W = 24, 11, 26
    pats, wins, w_len = _cases(rng, H, m, W, shared_pattern=True)
    ledge = rng.integers(0, 2, H).astype(bool)
    rpos = np.where(rng.integers(0, 2, H) != 0, w_len, -1).astype(np.int32)
    end_j = w_len.copy()
    end_j[0] = 0  # captured from column 0
    end_j[1] = W + 5  # never captured
    ra, rb = 2, m - 3
    want = pw.window_trace(
        jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(end_j),
        jnp.asarray(ledge), jnp.asarray(rpos), jnp.int32(ALPHA),
        jnp.int32(ra), jnp.int32(rb), interpret=True,
    )
    got = tw.window_trace(
        _t(pats[0]), _t(wins), _t(end_j), _t(ledge), _t(rpos), ALPHA, ra, rb
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("iv", [(2, 7), (0, 14), (5, 5)])
def test_window_interval_matches_pallas(iv):
    rng = np.random.default_rng(7 + iv[0])
    H, m, W = 24, 14, 30
    pats, wins, w_len = _cases(rng, H, m, W, shared_pattern=False)
    end_j = np.minimum(w_len, rng.integers(m - 2, W + 1, H)).astype(np.int32)
    end_j[0] = 0
    want = pw.window_interval(
        jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(end_j),
        jnp.int32(iv[0]), jnp.int32(iv[1]), interpret=True,
    )
    got = tw.window_interval(_t(pats), _t(wins), _t(end_j), iv[0], iv[1])
    assert got.shape == (H, 6)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "mode,m,W",
    [
        (tw.MODE_VALLEY, 9, 20),
        (tw.MODE_VALLEY, 12, 9),  # window shorter than the pattern
        (tw.MODE_TRACE, 9, 20),
        (tw.MODE_TRACE, 12, 9),
        (tw.MODE_INTERVAL, 12, 9),
    ],
    ids=["valley", "valley_w_lt_m", "trace", "trace_w_lt_m", "interval_w_lt_m"],
)
def test_window_edge_cases_match_pallas(mode, m, W):
    """Edge cases of the CUDA kernel's wavefront, held on the plain
    version: ``end_j`` 0, 1, W and past W (the kernel stops at the end
    column), ``right_pos`` at 1 and at W (the column-dependent vertical
    cost), left-edge lanes (the column-0 boundary), ``w_len`` 0 and
    past W."""
    rng = np.random.default_rng(300 + 10 * mode + W)
    H = 20
    pats, wins, w_len = _cases(rng, H, m, W, shared_pattern=mode != tw.MODE_INTERVAL)
    ledge = rng.integers(0, 2, H).astype(bool)
    ledge[:2] = True
    rpos = rng.choice([1, W], H).astype(np.int32)
    end_j = rng.integers(0, W + 1, H).astype(np.int32)
    end_j[:4] = 0, 1, W, W + 2
    if mode == tw.MODE_VALLEY:
        w_len[:2] = 0, W + 3
        emit_lo = rng.integers(-1, 3, H).astype(np.int32)
        emit_hi = (W - rng.integers(-2, 4, H)).astype(np.int32)
        k_scaled = m * UNIT
        want = pw.window_valleys(
            jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(w_len),
            jnp.asarray(ledge), jnp.asarray(rpos), jnp.asarray(emit_lo),
            jnp.asarray(emit_hi), jnp.int32(ALPHA), jnp.int32(k_scaled), W + 2,
            interpret=True,
        )
        got = tw.window_valleys(
            _t(pats[0]), _t(wins), _t(w_len), _t(ledge), _t(rpos),
            _t(emit_lo), _t(emit_hi), ALPHA, k_scaled, W + 2,
        )
        assert int(got[1].sum()) > 0
    elif mode == tw.MODE_TRACE:
        ra, rb = 2, m - 3
        want = pw.window_trace(
            jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(end_j),
            jnp.asarray(ledge), jnp.asarray(rpos), jnp.int32(ALPHA),
            jnp.int32(ra), jnp.int32(rb), interpret=True,
        )
        got = tw.window_trace(
            _t(pats[0]), _t(wins), _t(end_j), _t(ledge), _t(rpos), ALPHA, ra, rb
        )
    else:
        want = (pw.window_interval(
            jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(end_j),
            jnp.int32(3), jnp.int32(m - 2), interpret=True,
        ),)
        got = (tw.window_interval(_t(pats), _t(wins), _t(end_j), 3, m - 2),)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m", [1, 11, 44, 90, 128])
def test_window_plan_covers_pattern(m):
    """The kernel's (rows, group) choice: at most 4 rows a thread, a
    power-of-two group within a warp, enough rows for the pattern."""
    for W in (1, 26, 111, 400):
        R, G = tw.plan(m, W)
        assert R in tw.ROWS and G in (1, 2, 4, 8, 16, 32) and G * R >= m
    with pytest.raises(ValueError):
        tw.plan(129, 10)
