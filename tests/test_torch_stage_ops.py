"""The port's plain stage functions (``ops/device.py``) and staged
composites (``flank_scan``, ``flank_trace``, ``barcode_rank`` and their
``*_reference`` variants) against the JAX package's on the same inputs
(the JAX composites on their jnp path): integers equal, Lodhi scores bit
for bit.  Inputs are made from numpy seeds at small sizes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.ops import composite as jcomp  # noqa: E402
from barbell_tpu.ops import device as jdev  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.ops.lodhi import perfect_score  # noqa: E402
from barbell_tpu.ops.oracle import scale_alpha, scale_k  # noqa: E402
from barbell_tpu.ops.pallas_myers import pattern_words  # noqa: E402
from barbell_tpu_torch.ops import composite as comp  # noqa: E402
from barbell_tpu_torch.ops import device as dev  # noqa: E402

BASES = np.array([1, 2, 4, 8], dtype=np.uint8)
COMPLEMENT = np.zeros(16, dtype=np.uint8)
COMPLEMENT[[1, 2, 4, 8, 15]] = [8, 4, 2, 1, 15]
ALPHA = scale_alpha(0.4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape, w.shape, g.dtype, w.dtype)
    if g.dtype == np.float32:  # bit for bit
        assert np.array_equal(g.view(np.int32), w.view(np.int32)), what
    else:
        assert np.array_equal(g, w), what


def _noisy(rng, pat, n_edits):
    out = list(pat)
    for _ in range(n_edits):
        kind, p = rng.integers(0, 3), int(rng.integers(0, len(out)))
        if kind == 0:
            out[p] = BASES[rng.integers(0, 4)]
        elif kind == 1 and len(out) > 1:
            del out[p]
        else:
            out.insert(p, BASES[rng.integers(0, 4)])
    return np.array(out, dtype=np.uint8)


def _group(n=16):
    g = BarcodeGroup.from_kit("SQK-RBK114-96")[0]
    g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return g, np.asarray(g.patterns_fwd, dtype=np.uint8)[:n]


def _windows(rng, patterns, H, L, W):
    """Rows [H, L] whose window [start, start + w_len) holds random bases
    and a noisy copy of one pattern; lane 3 an N byte, lane 5 empty."""
    P, m = patterns.shape
    rows = np.zeros((H, L), dtype=np.uint8)
    start = rng.integers(0, L - W, H).astype(np.int32)
    w_len = rng.integers(m - 4, W + 1, H).astype(np.int32)
    w_len[5] = 0
    for h in range(H):
        n = int(w_len[h])
        content = BASES[rng.integers(0, 4, n)]
        seg = _noisy(rng, patterns[rng.integers(0, P)], int(rng.integers(0, 4)))
        pos = int(rng.integers(0, max(1, n - len(seg))))
        seg = seg[: max(0, n - pos)]
        content[pos : pos + len(seg)] = seg
        if h == 3 and n:
            content[n // 2] = 15
        rows[h, start[h] : start[h] + n] = content
    return rows, start, w_len


# --------------------------------------------------------------- ops/device.py


@pytest.mark.parametrize("seed", [0, 1])
def test_flank_ends_and_find_hits_match_jax(seed):
    rng = np.random.default_rng(seed)
    g, _ = _group()
    flank = np.asarray(g.flank_masks, dtype=np.uint8)
    B, L = 10, 200
    rows = BASES[rng.integers(0, 4, (B, L))]
    for b in range(B):
        seg = _noisy(rng, flank, int(rng.integers(0, 12)))[: L - 20]
        p = int(rng.integers(0, L - len(seg)))
        rows[b, p : p + len(seg)] = seg
        rows[b, int(rng.integers(120, L + 1)):] = 0
    rows[2, 7] = 15
    start = rng.choice([-1, 0, 3], B).astype(np.int32)
    end = rng.integers(100, L + 3, B).astype(np.int32)
    want = jdev.flank_ends(jnp.asarray(flank), jnp.asarray(rows), jnp.asarray(start),
                           jnp.asarray(end), jnp.int32(ALPHA))
    got = dev.flank_ends(_t(flank), _t(rows), _t(start), _t(end), ALPHA)
    _eq(got, want, "ends")
    lo = rng.integers(0, 30, B).astype(np.int32)
    hi = rng.integers(100, L + 1, B).astype(np.int32)
    k_scaled = scale_k(g.k_cutoff)
    for K in (4, 16):
        w = jdev.find_hits(want, jnp.asarray(lo), jnp.asarray(hi), jnp.int32(k_scaled), K)
        h = dev.find_hits(got, _t(lo), _t(hi), k_scaled, K)
        for name in dev.Hits._fields:
            _eq(getattr(h, name), getattr(w, name), name)
    assert int(h.count.sum()) > 0


def _dp_case(seed, H=9, P=5, m=14, W=30):
    rng = np.random.default_rng(seed)
    pats = BASES[rng.integers(0, 4, (P, m))]
    pats[1, 3] = 15
    rows, _start, w_len = _windows(rng, pats, H, W + 1, W)
    wins = rows[:, :W]
    ledge = rng.integers(0, 2, H).astype(bool)
    rpos = np.where(rng.integers(0, 2, H) != 0, w_len, -1).astype(np.int32)
    return rng, pats, wins, ledge, rpos, w_len


@pytest.mark.parametrize("seed", [0, 1])
def test_window_dp_and_traceback_reduce_match_jax(seed):
    rng, pats, wins, ledge, rpos, w_len = _dp_case(seed)
    H, W = wins.shape
    P, m = pats.shape
    want = jdev.window_dp(jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(ledge),
                          jnp.asarray(rpos), jnp.int32(ALPHA))
    got = dev.window_dp(_t(pats), _t(wins), _t(ledge), _t(rpos), ALPHA)
    _eq(got.ends, want.ends, "ends")
    _eq(got.moves, want.moves, "moves")
    end_j = rng.integers(0, W + 1, (H, P)).astype(np.int32)
    valid = rng.integers(0, 4, (H, P)) != 0
    for ra, rb, ia, ib in ((2, m - 3, 3, m - 2), (0, -1, 0, m)):
        w = jdev.traceback_reduce(want.moves, jnp.asarray(end_j), jnp.asarray(valid),
                                  jnp.int32(ra), jnp.int32(rb), jnp.int32(ia),
                                  jnp.int32(ib), m=m, W=W)
        g = dev.traceback_reduce(got.moves, _t(end_j), _t(valid), ra, rb, ia, ib,
                                 m=m, W=W)
        for name in dev.TraceResult._fields:
            _eq(getattr(g, name), getattr(w, name), name)


@pytest.mark.parametrize("per_lane", [False, True])
def test_window_dp_summary_matches_jax(per_lane):
    rng, pats, wins, ledge, rpos, w_len = _dp_case(2 + per_lane)
    H = wins.shape[0]
    P, m = pats.shape
    hp = np.stack([pats[rng.permutation(P)] for _ in range(H)]) if per_lane else pats[None]
    flags = dict(with_lodhi=True, with_region=True, with_interval=True, with_start=True)
    want = jdev.window_dp_summary(jnp.asarray(hp), jnp.asarray(wins), jnp.asarray(ledge),
                                  jnp.asarray(rpos), jnp.int32(ALPHA), jnp.int32(2),
                                  jnp.int32(m - 3), jnp.int32(3), jnp.int32(m - 2), **flags)
    got = dev.window_dp_summary(_t(hp), _t(wins), _t(ledge), _t(rpos), ALPHA, 2, m - 3,
                                3, m - 2, **flags)
    for name in dev.SummaryDP._fields:
        _eq(getattr(got, name), getattr(want, name), name)
    best_w = jdev.best_valley_per_pattern(want.ends, jnp.asarray(w_len))
    best_g = dev.best_valley_per_pattern(got.ends, _t(w_len))
    for name in dev.BestPerPattern._fields:
        _eq(getattr(best_g, name), getattr(best_w, name), name)


# ---------------------------------------------------------- staged composites


def _flank_rows(seed, S=6, L=256):
    """Nibble rows of S simple reads (a noisy flank + barcode construct
    in each, one rc), their metadata as demux_call derives it for the
    reads and their rc twins, and the group."""
    rng = np.random.default_rng(seed)
    g, _ = _group()
    flank = np.asarray(g.flank_masks, dtype=np.uint8)
    m, k = len(flank), int(g.k_cutoff)
    n = rng.integers(150, L + 1, S).astype(np.int32)
    rows = np.zeros((S, L), dtype=np.uint8)
    for s in range(S):
        body = BASES[rng.integers(0, 4, int(n[s]))]
        seg = _noisy(rng, flank, int(rng.integers(0, 6)))[: n[s] - 10]
        p = int(rng.integers(0, n[s] - len(seg)))
        body[p : p + len(seg)] = seg
        if s == 1:  # a reverse-complemented read
            body = COMPLEMENT[body[::-1]]
        rows[s, : n[s]] = body
    rows[2, 11] = 15
    tsc = np.concatenate([np.zeros(S, np.int32), L - n]).astype(np.int32)
    tec = np.concatenate([n, np.full(S, L, np.int32)]).astype(np.int32)
    emit_lo = tsc + m + k + 2
    emit_hi = tec - 2
    return g, flank, rows, tsc, tec, emit_lo, emit_hi


def _keys(packed_row, K):
    cols, costs = packed_row[:K], packed_row[K : 2 * K]
    return {(int(c), int(v)) for c, v in zip(cols, costs) if v < comp.BIG}


def _flank_scan_vs_jax(got, want, tec, K):
    """The port's ``FlankScanOut`` against the JAX jnp path's: rows
    equal, each row's keys equal but for the read-end key at ``tec - 1``
    (see :func:`test_flank_scan_matches_jax`), on under half the rows."""
    _eq(got.rows, want.rows, "rows")
    g_np, w_np = got.packed.numpy(), np.asarray(want.packed)
    edge_rows = 0
    for r in range(g_np.shape[0]):
        if np.array_equal(g_np[r], w_np[r]):
            continue
        extra = _keys(g_np[r], K) - _keys(w_np[r], K)
        assert _keys(w_np[r], K) <= _keys(g_np[r], K), r
        assert [c for c, _v in extra] == [tec[r] - 1], (r, extra, tec[r])
        assert g_np[r, 2 * K] == w_np[r, 2 * K] + 1, r
        edge_rows += 1
    assert edge_rows < g_np.shape[0] // 2


@pytest.mark.parametrize("seed", [0, 1])
def test_flank_scan_matches_jax(seed):
    """The port's flank scan runs the kernels' semantics (the JAX
    package's Pallas path): the right boundary window emits from column
    tec - 1 with its left neighbour outside the emission range, so a
    cost rising into a read's true end makes a valley at tec - 1 that
    the jnp path's full-neighbour test does not.  Every row equals the
    jnp path's, except that such rows carry exactly that one key more
    (and a count one higher)."""
    g, flank, rows, tsc, tec, emit_lo, emit_hi = _flank_rows(seed)
    S, L = rows.shape
    m, k, K = len(flank), int(g.k_cutoff), 16
    packed = jcomp.pack_rows_np(rows)
    sidx = np.arange(S, dtype=np.int32)
    words, W_words, top_bit = pattern_words(flank)
    want = jcomp.flank_scan(
        jnp.asarray(flank), jnp.asarray(words), jnp.asarray(packed), jnp.asarray(sidx),
        jnp.asarray(tsc), jnp.asarray(tec), jnp.asarray(tsc), jnp.asarray(tec),
        jnp.asarray(emit_lo), jnp.asarray(emit_hi), jnp.int32(ALPHA), K=K,
        use_pallas=False, interpret=False, m=m, k_units=k, W_words=W_words,
        top_bit=top_bit,
    )
    got = comp.flank_scan(
        _t(flank), _t(words.view(np.int32)), _t(packed), _t(sidx), _t(tsc), _t(tec),
        _t(tsc), _t(tec), _t(emit_lo), _t(emit_hi), ALPHA, K=K, m=m, k_units=k,
    )
    _flank_scan_vs_jax(got, want, tec, K)
    _pos, _cost, valid, _count = comp.unpack_flank_scan(got.packed, K)
    assert int(valid.sum()) >= 2 * S - 2  # the constructs were found


def _trace_case(seed, H=12):
    rng = np.random.default_rng(seed)
    g, _ = _group()
    flank = np.asarray(g.flank_masks, dtype=np.uint8)
    fm = len(flank)
    Wf = fm + 30
    rows, start, fend = _windows(rng, flank[None], H, 512, Wf)
    ledge = rng.integers(0, 2, H).astype(bool)
    rpos = np.where(rng.integers(0, 2, H) != 0, fend, -1).astype(np.int32)
    hvalid = np.ones(H, dtype=bool)
    hvalid[-1] = False
    args = (flank, rows, np.arange(H, dtype=np.int32), start, ledge, rpos, fend,
            hvalid, g.bar_region[0], g.bar_region[1])
    return args, fm, Wf, hvalid


@pytest.mark.parametrize("seed", [0, 1])
def test_flank_trace_matches_jax(seed):
    args, fm, Wf, hvalid = _trace_case(seed)
    jargs = [jnp.asarray(a) for a in args[:8]] + [jnp.int32(args[8]), jnp.int32(args[9]),
                                                  jnp.int32(ALPHA)]
    pargs = [_t(a) for a in args[:8]] + [args[8], args[9], ALPHA]
    want = np.asarray(jcomp.flank_trace(*jargs, m=fm, W=Wf))
    got = comp.flank_trace(*pargs, m=fm, W=Wf)
    _eq(got, want, "flank_trace")
    want_ref = np.asarray(jcomp.flank_trace_reference(*jargs, m=fm, W=Wf))
    got_ref = comp.flank_trace_reference(*pargs, m=fm, W=Wf)
    _eq(got_ref, want_ref, "flank_trace_reference")
    # the fused form against the move-table anchor, where the lane is valid
    _eq(got[_t(hvalid)], got_ref[_t(hvalid)], "port trace vs its reference")


def _rank_case(seed, H=12, n_pat=16, extra=24):
    rng = np.random.default_rng(seed)
    g, pats = _group(n_pat)
    P, m = pats.shape
    W = m + extra
    rows, start, w_len = _windows(rng, pats, H, 256 if W < 250 else 2 * W, W)
    hvalid = np.ones(H, dtype=bool)
    hvalid[-1] = False
    pad0 = g.pad_region[0]
    scal = (scale_k(int(m * 0.4)), g.bar_region[0] - pad0, g.bar_region[1] - pad0,
            float(np.float32(perfect_score(g.pad_region[1] - pad0))), 0.2, 0.1)
    arrays = (pats, rows, np.arange(H, dtype=np.int32), start, w_len, hvalid)
    jargs = [jnp.asarray(a) for a in arrays] + [
        jnp.int32(scal[0]), jnp.int32(scal[1]), jnp.int32(scal[2]),
        jnp.float32(scal[3]), jnp.float32(scal[4]), jnp.float32(scal[5])]
    pargs = [_t(a) for a in arrays] + list(scal)
    return jargs, pargs, m, W, hvalid


@pytest.mark.parametrize("seed", [0, 1])
def test_barcode_rank_matches_jax(seed):
    jargs, pargs, m, W, hvalid = _rank_case(seed)
    want = np.asarray(jcomp.barcode_rank(*jargs, m=m, W=W))
    got = comp.barcode_rank(*pargs, m=m, W=W)
    _eq(got[_t(hvalid)], want[hvalid], "barcode_rank")
    assert int(got[:, 1].sum()) >= 4  # accepted lanes
    want_ref = np.asarray(jcomp.barcode_rank_reference(*jargs, m=m, W=W))
    got_ref = comp.barcode_rank_reference(*pargs, m=m, W=W)
    _eq(got_ref, want_ref, "barcode_rank_reference")
    # the port's kernel route against its own move-table anchor
    _eq(got[_t(hvalid)], got_ref[_t(hvalid)], "port rank vs its reference")


def test_barcode_rank_wide_window_takes_the_summary_dp():
    """W > 255 (past the rank key's 8-bit position) ranks by the summary
    DP, as the reference does, and still equals its outputs."""
    jargs, pargs, m, W, hvalid = _rank_case(5, H=6, n_pat=3, extra=260 - 44)
    assert W > 255
    want = np.asarray(jcomp.barcode_rank(*jargs, m=m, W=W))
    got = comp.barcode_rank(*pargs, m=m, W=W)
    _eq(got[_t(hvalid)], want[hvalid], "barcode_rank W > 255")
