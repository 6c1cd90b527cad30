"""Approximate search of the plain reference: semiglobal edit DP, plateau
valleys, tracebacks and the Lodhi score of an alignment.

A frozen copy of barbell's scalar search semantics (the oracle the
port's kernels are held to): unit edit costs scaled by ``COST_SCALE``
(2560) so every comparison is an integer one; the flank search charges
``alpha`` per pattern base hanging over a read end; one match per cost
valley (the rightmost point of each plateau minimum); tracebacks prefer
diagonal, then vertical, then horizontal steps.  The barcode search runs
the same DP for all of a group's patterns at once (one NumPy step per
pattern row instead of one per pattern and row); its results are the
scalar search's.

Lodhi scores (gap-weighted 3-subsequences, lambda 0.5, reference
`src/annotate/searcher.rs:209-239`) are accumulated in float32 along the
path in column order, one rounding per operation, as the configuration
states.  The controls of the benchmark's comparison lower one stated
precision: ``precision="bfloat16"`` rounds every Lodhi operation to
bfloat16, ``precision="int16"`` stores the scaled edit costs of every
DP table in 16-bit integers (wrapping, as a narrower store would).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

COST_SCALE = 2560
BIG = 2**30
OP_M, OP_X, OP_U, OP_L = 0, 1, 2, 3

# IUPAC 4-bit membership masks: two bases match iff their masks intersect
_MASKS = {
    "A": 1, "C": 2, "G": 4, "T": 8, "U": 8, "R": 5, "Y": 10, "S": 6, "W": 9,
    "K": 12, "M": 3, "B": 14, "D": 13, "H": 11, "V": 7, "N": 15, "X": 0,
}
ENCODE = np.full(256, 255, dtype=np.uint8)
for _c, _m in _MASKS.items():
    ENCODE[ord(_c)] = ENCODE[ord(_c.lower())] = _m
_MASK_RC = np.array([((m & 1) << 3) | ((m & 2) << 1) | ((m & 4) >> 1) | ((m & 8) >> 3)
                     for m in range(16)], dtype=np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip("ACGTUNRYSWKMBDHVX", "TGCAANYRSWMKVHDBX"):
    _COMP[ord(_a)], _COMP[ord(_a.lower())] = ord(_b), ord(_b.lower())


def encode(seq: bytes) -> np.ndarray:
    return ENCODE[np.frombuffer(seq, dtype=np.uint8)]


def rc_masks(masks: np.ndarray) -> np.ndarray:
    return _MASK_RC[masks[::-1] & 0xF]


def revcomp(seq: bytes) -> bytes:
    return _COMP[np.frombuffer(seq, dtype=np.uint8)[::-1]].tobytes()


def scale(units: float) -> int:
    return int(round(float(units) * COST_SCALE))


def cost_int(scaled: int) -> int:
    """Reported integer cost: round half up."""
    return int((int(scaled) + COST_SCALE // 2) // COST_SCALE)


def flank_span(m: int, k: int) -> int:
    """Text width any flank match of cost <= k spans, plus one."""
    return m + k + 1


# --------------------------------------------------------------------------
# flank search (one pattern, a whole strand, overhang alpha at read ends)


def _store(x, precision: str):
    """Costs as the table stores them: int32 (exact), or wrapped to int16."""
    if precision == "int16":
        return ((np.asarray(x, dtype=np.int64) + 2**15) & 0xFFFF) - 2**15
    return x


def _dp(pat: np.ndarray, text: np.ndarray, left_step: int, vert: np.ndarray,
        precision: str = "float32") -> np.ndarray:
    m, n = len(pat), len(text)
    unit = COST_SCALE
    sub = np.where((pat[:, None] & text[None, :]) != 0, 0, unit).astype(np.int64)
    C = np.zeros((m + 1, n + 1), dtype=np.int64)
    C[1:, 0] = _store(left_step * np.arange(1, m + 1, dtype=np.int64), precision)
    jj = np.arange(n, dtype=np.int64)
    for i in range(1, m + 1):
        prev = C[i - 1]
        v = np.minimum(prev[:-1] + sub[i - 1], prev[1:] + vert)
        u = np.minimum(v, C[i, 0] + unit * (jj + 1)) - unit * jj
        np.minimum.accumulate(u, out=u)
        C[i, 1:] = _store(u + unit * jj, precision)
    return C


def valleys(ends: np.ndarray, k_scaled: int) -> List[int]:
    n = len(ends) - 1
    nxt = np.append(ends[1:], BIG)
    prv = np.insert(ends[:-1], 0, BIG)
    ok = (ends <= k_scaled) & (ends < nxt) & (ends <= prv)
    return [int(j) for j in np.nonzero(ok)[0] if j <= n]


def _traceback(C, pat, text, j_end, left_step, right_pos, alpha_s):
    """(start, path [cols, 2], ops) from cell (m, j_end)."""
    unit = COST_SCALE
    i, j = len(pat), j_end
    cols, ops = [], []
    while i > 0:
        here = int(C[i, j])
        if j > 0:
            eq = (pat[i - 1] & text[j - 1]) != 0
            if here == int(C[i - 1, j - 1]) + (0 if eq else unit):
                i, j = i - 1, j - 1
                cols.append((i, j))
                ops.append(OP_M if eq else OP_X)
                continue
        if j == 0:
            vcost = left_step
        elif alpha_s is not None and j == right_pos:
            vcost = alpha_s
        else:
            vcost = unit
        if here == int(C[i - 1, j]) + vcost:
            i -= 1
            cols.append((i, j))
            ops.append(OP_U)
            continue
        if j == 0:
            raise RuntimeError("traceback stuck")
        j -= 1
        cols.append((i, j))
        ops.append(OP_L)
    cols.reverse()
    ops.reverse()
    return j, np.array(cols, dtype=np.int64).reshape(-1, 2), np.array(ops, dtype=np.int8)


def flank_search(flank: np.ndarray, text: np.ndarray, k: int, alpha: float,
                 precision: str = "float32"):
    """Every valley match of the flank on one strand: (start, end, scaled
    cost, path, ops), the traceback taken on the (m + k + 1)-wide window
    ending at the match (the canonical convention)."""
    n = len(text)
    if n == 0:
        return []
    a = scale(alpha)
    vert = np.full(n, COST_SCALE, dtype=np.int64)
    vert[n - 1] = a  # a vertical step into column n hangs over the read end
    ends = _dp(flank, text, a, vert, precision)[-1]
    span = flank_span(len(flank), k)
    out = []
    for j in valleys(ends, scale(k)):
        s = max(0, j - span)
        window = text[s:j]
        left_step = a if s == 0 else COST_SCALE
        right_pos = (j - s) if j == n else -1
        wvert = np.full(j - s + 1, COST_SCALE, dtype=np.int64)
        if 0 <= right_pos <= j - s:
            wvert[right_pos] = a
        C = _dp(flank, window, left_step, wvert[1:], precision)
        try:
            start, path, ops = _traceback(C, flank, window, j - s, left_step, right_pos, a)
        except RuntimeError:
            if precision != "int16":
                raise
            continue  # a wrapped table need not hold a path
        if len(path):
            path[:, 1] += s
        out.append((s + start, j, int(ends[j]), path, ops))
    return out


# --------------------------------------------------------------------------
# barcode search (all patterns of a group at once, no overhang)


def _bf16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _round(x, precision: str):
    x = np.asarray(x, dtype=np.float32)
    return _bf16(x) if precision == "bfloat16" else x


def barcode_search(pats: np.ndarray, text: np.ndarray, k_frac: float = 0.4,
                   precision: str = "float32"):
    """For each pattern of ``pats`` [P, m]: its best valley match in
    ``text`` (lowest cost, then lowest end) at ``k = int(m * k_frac)``,
    or at ``k = m`` for every pattern when at most one matched.

    Returns (cand [P] bool, cost [P], end [P], start [P], lodhi [P] in
    ``precision``, paths: list of per-pattern (path, ops) or None)."""
    P, m = pats.shape
    n = len(text)
    unit = COST_SCALE
    eq = (pats[:, :, None] & text[None, None, :]) != 0  # [P, m, n]
    C = np.zeros((P, m + 1, n + 1), dtype=np.int64)
    C[:, 1:, 0] = _store(unit * np.arange(1, m + 1, dtype=np.int64), precision)
    jj = np.arange(n, dtype=np.int64)
    for i in range(1, m + 1):
        prev = C[:, i - 1]
        v = np.minimum(prev[:, :-1] + np.where(eq[:, i - 1], 0, unit), prev[:, 1:] + unit)
        u = np.minimum(v, C[:, i, :1] + unit * (jj + 1)) - unit * jj
        np.minimum.accumulate(u, axis=1, out=u)
        C[:, i, 1:] = _store(u + unit * jj, precision)
    ends = C[:, m]  # [P, n + 1]
    nxt = np.concatenate([ends[:, 1:], np.full((P, 1), BIG)], axis=1)
    prv = np.concatenate([np.full((P, 1), BIG), ends[:, :-1]], axis=1)
    is_valley = (ends < nxt) & (ends <= prv)
    vcost = np.where(is_valley, ends, BIG)
    best_end = np.argmin(vcost, axis=1)  # lowest cost, then lowest end
    best_cost = vcost[np.arange(P), best_end]
    k1 = int(m * k_frac)
    in_k1 = best_cost <= scale(k1)
    cand = in_k1 if (in_k1.sum() > 1 or k1 >= m) else best_cost <= scale(m)

    # traceback of every candidate at once
    idx = np.nonzero(cand)[0]
    i = np.full(len(idx), m, dtype=np.int64)
    j = best_end[idx].astype(np.int64)
    steps = m + n
    ops = np.full((len(idx), steps), -1, dtype=np.int8)
    pi = np.full((len(idx), steps), -1, dtype=np.int64)
    pj = np.full((len(idx), steps), -1, dtype=np.int64)
    Cc = C[idx]
    pc = pats[idx]
    r = np.arange(len(idx))
    lost = np.zeros(len(idx), dtype=bool)
    for s in range(steps):
        act = i > 0
        if not act.any():
            break
        here = Cc[r, i, j]
        jm = np.maximum(j - 1, 0)
        im = np.maximum(i - 1, 0)
        e = (pc[r, im] & text[jm]) != 0
        diag_ok = act & (j > 0) & (here == Cc[r, im, jm] + np.where(e, 0, unit))
        up_ok = act & ~diag_ok & (here == Cc[r, im, j] + unit)
        left = act & ~diag_ok & ~up_ok
        stuck = left & (j == 0)  # only a wrapped (int16) table strands a path
        if stuck.any():
            if precision != "int16":
                raise RuntimeError("traceback stuck")
            lost[stuck] = True
            left &= ~stuck
            i = np.where(stuck, 0, i)
        ops[:, s] = np.where(diag_ok, np.where(e, OP_M, OP_X),
                             np.where(up_ok, OP_U, np.where(left, OP_L, -1)))
        i = np.where(diag_ok | up_ok, i - 1, i)
        j = np.where(diag_ok | left, j - 1, j)
        pi[:, s] = np.where(act, i, -1)
        pj[:, s] = np.where(act, j, -1)
    start = j

    # Lodhi score along each path in column order (the traceback's
    # reverse): state (t1, t2, s) <- a * (t1 + mf), a * (t2 + mf * t1),
    # s + (mf * a) * t2 from the predecessor's state
    lens = (ops >= 0).sum(axis=1)
    L = int(lens.max()) if len(idx) else 0
    t1 = np.zeros(len(idx), dtype=np.float32)
    t2 = np.zeros(len(idx), dtype=np.float32)
    sc = np.zeros(len(idx), dtype=np.float32)
    for c in range(L):
        col = lens - 1 - c  # column c in path order sits at traceback step lens-1-c
        live = col >= 0
        op = np.where(live, ops[r, np.maximum(col, 0)], -1)
        mf = np.where(op == OP_M, 1.0, 0.0).astype(np.float32)
        a = np.where(op <= OP_X, 0.25, 0.5).astype(np.float32)
        n1 = _round(a * _round(t1 + mf, precision), precision)
        n2 = _round(a * _round(t2 + _round(mf * t1, precision), precision), precision)
        ns = _round(sc + _round(_round(mf * a, precision) * t2, precision), precision)
        t1 = np.where(live, n1, t1)
        t2 = np.where(live, n2, t2)
        sc = np.where(live, ns, sc)

    lodhi = np.zeros(P, dtype=np.float32)
    lodhi[idx] = sc
    cand = cand.copy()
    cand[idx[lost]] = False
    paths = [None] * P
    for q, p in enumerate(idx):
        ln = lens[q]
        path = np.stack([pi[q, :ln][::-1], pj[q, :ln][::-1]], axis=1)
        paths[p] = (path, ops[q, :ln][::-1].copy())
    st = np.zeros(P, dtype=np.int64)
    st[idx] = start
    return cand, best_cost, best_end, st, lodhi, paths


def perfect_score(length: int, lam: float = 0.5, k: int = 3) -> float:
    """Lodhi score of an all-match alignment of ``length`` columns (float64)."""
    a = lam ** 2
    T = [0.0] * (k - 1)
    score = 0.0
    for _ in range(length):
        score += a * T[k - 2]
        for d in range(k - 2, 0, -1):
            T[d] = a * (T[d] + T[d - 1])
        T[0] = a * (T[0] + 1.0)
    return score


def select(cand, lodhi, perfect: float, min_score: float, min_score_diff: float,
           precision: str = "float32") -> Tuple[Optional[int], bool]:
    """(top pattern, accepted): the best normalised score (ties to the
    first pattern), accepted at ``min_score`` or more and, with a runner-up,
    ``min_score_diff`` or more ahead of it; compared in ``precision``."""
    if not cand.any():
        return None, False
    norm = _round(lodhi / np.float32(perfect), precision)
    scores = np.where(cand, norm, -np.inf).astype(np.float32)
    top = int(np.argmax(scores))
    rest = scores.copy()
    rest[top] = -np.inf
    thr = _round(np.float32(min_score), precision)
    dthr = _round(np.float32(min_score_diff), precision)
    ok = scores[top] >= thr
    if cand.sum() > 1:
        ok = ok and _round(scores[top] - rest.max(), precision) >= dthr
    return top, bool(ok)


def pattern_interval(path, ops, p_start: int, p_end: int):
    """((pattern span), (text span), edits) of pattern positions
    [p_start, p_end) (`src/annotate/cigar_parse.rs:6-45`)."""
    sel = np.nonzero((path[:, 0] >= p_start) & (path[:, 0] < p_end))[0]
    if len(sel) == 0:
        return None
    f, l = int(sel[0]), int(sel[-1])
    cost = int(np.count_nonzero(ops[f:l + 1] != OP_M))
    return (int(path[f, 0]), int(path[l, 0]) + 1), (int(path[f, 1]), int(path[l, 1]) + 1), cost


def matching_region(path, strand_rc: bool, mask_start: int, mask_end: int, n: int):
    """Text span of pattern positions [mask_start, mask_end] inclusive,
    in forward coordinates (`src/annotate/cigar_parse.rs:71-82`)."""
    sel = np.nonzero((path[:, 0] >= mask_start) & (path[:, 0] <= mask_end))[0]
    if len(sel) == 0:
        return None
    a, b = int(path[sel[0], 1]), int(path[sel[-1], 1])
    lo, hi = min(a, b), max(a, b)
    return (n - hi, n - lo) if strand_rc else (lo, hi)
