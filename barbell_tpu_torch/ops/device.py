"""Plain PyTorch stage functions of the demux pipeline.

Counterpart of :mod:`barbell_tpu.ops.device`, in the scaled-integer
cost domain of :mod:`barbell_tpu_torch.ops.oracle`:

1. :func:`flank_ends` — semiglobal end-cost curve of one flank over a
   batch of rows (a loop over pattern rows; each row's left-gap closure
   is a cumulative minimum);
2. :func:`find_hits` — plateau-valley extraction and top-K compaction;
3. :func:`window_dp` — every pattern against every window, with each
   cell's traceback move (2-bit move + match bit);
4. :func:`traceback_reduce` — a fixed-length backward walk over the
   move tables giving the alignment start, the text span of a pattern
   sub-range, the mapped barcode interval and its sub-cost, and the
   Lodhi gap-weighted score;
5. :func:`window_dp_summary` — stages 3-4 as one forward DP that
   carries the path summaries cell to cell (no move table);
6. :func:`best_valley_per_pattern` — the lowest-cost valley of each
   (window, pattern).

There is no kernel here: these are an independent formulation (a move
table and its traceback, or a forward summary DP), the port's own
conformance anchors, run on any device.  Every ordering is a composite
key (cost, then column), so ties go to the smallest column whatever the
sort's own tie order.  Each is :func:`~barbell_tpu_torch.models.graphs.compiled`
with the reference's static arguments: on the card a call replays one
CUDA graph per key, so no function reads a device value on the host
(scalar arguments may be 0-d tensors).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.graphs import compiled
from .oracle import COST_SCALE

UNIT = COST_SCALE
BIG = 2**30

LAM = 0.5  # Lodhi decay
A_DIAG = LAM * LAM  # width-2 column factor
A_GAP = LAM  # width-1 column factor

_I32 = torch.int32
_F32 = torch.float32


def _shift_right(a, fill):
    """``a`` moved one column right along its last axis, ``fill`` in."""
    pad = torch.full(a.shape[:-1] + (1,), fill, dtype=a.dtype, device=a.device)
    return torch.cat([pad, a[..., :-1]], dim=-1)


def _shift_left(a, fill):
    pad = torch.full(a.shape[:-1] + (1,), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a[..., 1:], pad], dim=-1)


# ---------------------------------------------------------------------------
# Stage 1: flank end-cost curve
# ---------------------------------------------------------------------------


@compiled()
def flank_ends(pattern, text, start_col, end_col, alpha_scaled):
    """End-cost curve of ``pattern`` over each text row.

    pattern [m] uint8 IUPAC masks; text [B, L] uint8 (0 outside each
    row's text); start_col [B] the column of the read's true start (its
    vertical steps cost alpha) or -1; end_col [B] the column of the
    read's true end, or out of range.  Returns ends [B, L + 1] int32,
    garbage outside each row's valid end range (masked downstream)."""
    B, L = text.shape
    dev = text.device
    jpos = torch.arange(L + 1, dtype=_I32, device=dev)
    boundary_col = (jpos[None, :] == start_col[:, None]) | (
        jpos[None, :] == end_col[:, None]
    )
    vert = torch.where(boundary_col, alpha_scaled, UNIT).to(_I32)  # [B, L+1]
    unit_j = UNIT * jpos
    boundary_step = torch.where(start_col == 0, alpha_scaled, UNIT).to(_I32)  # [B]
    txt = text.to(_I32)
    C = torch.zeros((B, L + 1), dtype=_I32, device=dev)
    for i, pat_i in enumerate(pattern.to(_I32), start=1):  # m from the shape
        sub = torch.where((txt & pat_i) != 0, 0, UNIT).to(_I32)
        v = torch.minimum(C[:, :-1] + sub, C[:, 1:] + vert[:, 1:])
        w = torch.cat([(boundary_step * i)[:, None], v], dim=1)
        C = torch.cummin(w - unit_j, dim=1).values + unit_j
    return C


# ---------------------------------------------------------------------------
# Stage 2: valley extraction
# ---------------------------------------------------------------------------


class Hits(NamedTuple):
    pos: torch.Tensor  # [B, K] int32 end positions (within row)
    cost: torch.Tensor  # [B, K] int32 scaled costs (BIG where invalid)
    valid: torch.Tensor  # [B, K] bool
    count: torch.Tensor  # [B] int32 total valleys (for overflow detection)


@compiled(static_argnames=("K",))
def find_hits(ends, lo, hi, k_scaled, K: int) -> Hits:
    """Plateau-valley minima with cost <= k, compacted to K per row.

    Valid end positions are ``lo[b] <= j <= hi[b]``; a valley is
    ``e[j] <= k and e[j] < e[j+1] and e[j] <= e[j-1]`` with +inf outside
    the valid range.  Returns the K lowest-cost valleys, ties to the
    smallest j; the slots past the valleys hold the smallest other
    columns with cost BIG, as the reference's ``top_k`` leaves them."""
    B, N = ends.shape
    jpos = torch.arange(N, dtype=_I32, device=ends.device)
    valid = (jpos[None, :] >= lo[:, None]) & (jpos[None, :] <= hi[:, None])
    e = torch.where(valid, ends, BIG)
    prv = _shift_right(e, BIG)
    nxt = _shift_left(e, BIG)
    isv = (e <= k_scaled) & (e < nxt) & (e <= prv)
    count = isv.sum(dim=1, dtype=_I32)
    key = torch.where(isv, e, BIG).to(torch.int64) * N + jpos  # unique per row
    top = key.sort(dim=1).values[:, :K]
    cost = (top // N).to(_I32)
    return Hits(pos=(top % N).to(_I32), cost=cost, valid=cost < BIG, count=count)


# ---------------------------------------------------------------------------
# Stage 3: windowed multi-pattern DP with move recording
# ---------------------------------------------------------------------------


class WindowDP(NamedTuple):
    ends: torch.Tensor  # [H, P, W+1] int32
    moves: torch.Tensor  # [m, H, P, W+1] uint8 (bits 0-1 move, bit 2 match)


@compiled()
def window_dp(patterns, windows, left_edge, right_pos, alpha_scaled) -> WindowDP:
    """Semiglobal DP of every pattern [P, m] against every window [H, W]
    (content left-aligned, zero tail).  ``left_edge`` [H]: column 0 is
    the read's true start (alpha boundary); ``right_pos`` [H]: the window
    column of the read's true end (alpha verticals) or -1.  Move of cell
    (i, j): 0 diagonal, 1 up, 2 left (ties in that order); bit 2 set when
    the diagonal characters match."""
    P, m = patterns.shape
    H, W = windows.shape
    dev = windows.device
    jpos = torch.arange(W + 1, dtype=_I32, device=dev)
    unit_j = UNIT * jpos
    vert = torch.where(jpos[None, :] == right_pos[:, None], alpha_scaled, UNIT).to(_I32)
    vert3 = vert[:, None, :]
    win = windows.to(_I32)[:, None, :]
    edge = left_edge.to(torch.bool)
    C = torch.zeros((H, P, W + 1), dtype=_I32, device=dev)
    first_col = torch.ones((H, P, 1), dtype=_I32, device=dev)
    no_eq = torch.zeros((H, P, 1), dtype=_I32, device=dev)
    moves = []
    for i, pat_row in enumerate(patterns.to(_I32).t(), start=1):  # [P] each
        eq = (win & pat_row[None, :, None]) != 0  # [H, P, W]
        sub = torch.where(eq, 0, UNIT).to(_I32)
        diag_val = C[:, :, :-1] + sub
        v = torch.minimum(diag_val, C[:, :, 1:] + vert3[:, :, 1:])
        boundary = torch.where(edge, alpha_scaled * i, UNIT * i).to(_I32)
        w = torch.cat([boundary[:, None, None].expand(H, P, 1), v], dim=2)
        Cn = torch.cummin(w - unit_j, dim=2).values + unit_j
        diag_ok = Cn[:, :, 1:] == diag_val
        up_ok = Cn == C + vert3
        tail = torch.where(diag_ok, 0, torch.where(up_ok[:, :, 1:], 1, 2)).to(_I32)
        move = torch.cat([first_col, tail], dim=2)
        eq_bits = torch.cat([no_eq, eq.to(_I32)], dim=2)
        moves.append((move | (eq_bits << 2)).to(torch.uint8))
        C = Cn
    if not moves:
        return WindowDP(C, torch.zeros((0, H, P, W + 1), dtype=torch.uint8, device=dev))
    return WindowDP(ends=C, moves=torch.stack(moves))


# ---------------------------------------------------------------------------
# Stage 4: traceback with fused reductions
# ---------------------------------------------------------------------------


class TraceResult(NamedTuple):
    text_start: torch.Tensor  # [H, P] int32 window col where the match starts
    region_lo: torch.Tensor  # [H, P] int32 min col over region columns
    region_hi: torch.Tensor  # [H, P] int32 max col over region columns
    has_region: torch.Tensor  # [H, P] bool
    iv_pi: torch.Tensor  # [H, P] first in-interval column (pattern pos)
    iv_pj: torch.Tensor  # [H, P] first in-interval column (text pos)
    iv_ei: torch.Tensor  # [H, P] last in-interval column (pattern pos)
    iv_ej: torch.Tensor  # [H, P] last in-interval column (text pos)
    iv_cost: torch.Tensor  # [H, P] int32 sub-cost in edit units
    has_interval: torch.Tensor  # [H, P] bool
    lodhi: torch.Tensor  # [H, P] float32 gap-weighted score


@compiled(static_argnames=("m", "W"))
def traceback_reduce(moves, end_j, valid, region_a, region_b, iv_a, iv_b,
                     m: int, W: int) -> TraceResult:
    """Backward walk over the move tables ([m, H, P, W + 1]) from
    ``(m, end_j)`` for ``m + W`` steps, lanes where ``valid``.  Region
    rows are ``[region_a, region_b]``, interval rows ``[iv_a, iv_b)``;
    every reduction is order-independent or tracks the reversal (the
    interval's start is overwritten on every step, its end set once)."""
    H, P = end_j.shape
    dev = end_j.device
    hh = torch.arange(H, device=dev)[:, None].expand(H, P)
    pp = torch.arange(P, device=dev)[None, :].expand(H, P)

    def full(v, dtype=_I32):
        return torch.full((H, P), v, dtype=dtype, device=dev)

    i = full(m)
    j = end_j.to(_I32)
    done = ~valid.to(torch.bool)
    text_start = full(0)
    region_lo, region_hi = full(BIG), full(-1)
    iv_pi, iv_pj, iv_ei, iv_ej, iv_cost = full(0), full(0), full(-1), full(-1), full(0)
    has_interval = full(False, torch.bool)
    T1, T2, S = full(0.0, _F32), full(0.0, _F32), full(0.0, _F32)
    for _ in range(m + W):
        active = ~done
        # the move of cell (i, j) is moves[i - 1, h, p, j]
        mv = moves[(i.clamp(min=1) - 1).long(), hh, pp, j.clamp(0, W).long()].to(_I32)
        move = mv & 3
        eqb = (mv >> 2) & 1
        ni = torch.where(move == 2, i, i - 1)
        nj = torch.where(move == 1, j, j - 1)

        is_match = active & (move == 0) & (eqb == 1)
        a_c = torch.where(move == 0, A_DIAG, A_GAP).to(_F32)
        a_c = torch.where(active, a_c, torch.ones_like(a_c))
        mf = is_match.to(_F32)
        S = S + mf * a_c * T2
        T2 = torch.where(active, a_c * (T2 + mf * T1), T2)
        T1 = torch.where(active, a_c * (T1 + mf), T1)

        # column coordinates: the state after the step
        in_region = active & (ni >= region_a) & (ni <= region_b)
        region_lo = torch.where(in_region, torch.minimum(region_lo, nj), region_lo)
        region_hi = torch.where(in_region, torch.maximum(region_hi, nj), region_hi)
        in_iv = active & (ni >= iv_a) & (ni < iv_b)
        iv_pi = torch.where(in_iv, ni, iv_pi)
        iv_pj = torch.where(in_iv, nj, iv_pj)
        first_iv = in_iv & ~has_interval
        iv_ei = torch.where(first_iv, ni, iv_ei)
        iv_ej = torch.where(first_iv, nj, iv_ej)
        iv_cost = iv_cost + (in_iv & ~is_match).to(_I32)
        has_interval = has_interval | in_iv

        newly_done = active & (ni == 0)
        text_start = torch.where(newly_done, nj, text_start)
        done = done | newly_done
        i = torch.where(active, ni, i)
        j = torch.where(active, nj, j)
    return TraceResult(
        text_start=text_start, region_lo=region_lo, region_hi=region_hi,
        has_region=region_hi >= 0, iv_pi=iv_pi, iv_pj=iv_pj, iv_ei=iv_ei,
        iv_ej=iv_ej, iv_cost=iv_cost, has_interval=has_interval, lodhi=S,
    )


# ---------------------------------------------------------------------------
# Stages 3-4 fused: forward path-summary DP (no move table, no traceback)
# ---------------------------------------------------------------------------


class SummaryDP(NamedTuple):
    """Per-cell path summaries at the last pattern row, each
    [H, P, W + 1]: the value for the optimal path ending at text column
    j (what :func:`traceback_reduce` gives from (m, j) over
    :func:`window_dp`'s moves).  Fields not requested are None."""

    ends: torch.Tensor  # int32 end costs (== window_dp().ends)
    lodhi: torch.Tensor  # float32 gap-weighted score
    text_start: torch.Tensor  # int32 window col where the path starts
    region_lo: torch.Tensor  # int32 min text col over region pattern rows
    region_hi: torch.Tensor  # int32 max text col (has_region = hi >= 0)
    iv_pi: torch.Tensor  # int32 first in-interval pattern pos
    iv_pj: torch.Tensor  # int32 first in-interval text pos
    iv_ei: torch.Tensor  # int32 last in-interval pattern pos
    iv_ej: torch.Tensor  # int32 last in-interval text pos
    iv_cost: torch.Tensor  # int32 non-match steps inside the interval
    has_interval: torch.Tensor  # bool


@compiled(static_argnames=("with_lodhi", "with_region", "with_interval", "with_start"))
def window_dp_summary(patterns_hp, windows, left_edge, right_pos, alpha_scaled,
                      region_a, region_b, iv_a, iv_b, with_lodhi: bool = False,
                      with_region: bool = False, with_interval: bool = False,
                      with_start: bool = False) -> SummaryDP:
    """Forward DP carrying path summaries per cell: ``patterns_hp``
    [Hp, P, m] with Hp 1 (shared) or H (one stack a window), windows
    [H, W].  Move ties (diag > up > left) and every update mirror
    :func:`traceback_reduce`; a run of left moves only scales the Lodhi
    state by lambda**d and extends the trackers, so each cell takes its
    state from the nearest non-left cell g(j) <= j of its row (a
    cumulative maximum of the base columns and one gather per array)."""
    Hp, P, m = patterns_hp.shape
    H, W = windows.shape
    dev = windows.device
    ra, rb, ia, ib = region_a, region_b, iv_a, iv_b
    jpos = torch.arange(W + 1, dtype=_I32, device=dev)
    jpos3 = jpos[None, None, :]
    unit_j = UNIT * jpos
    vert = torch.where(jpos[None, :] == right_pos[:, None], alpha_scaled, UNIT).to(_I32)
    vert3 = vert[:, None, :]
    win = windows.to(_I32)[:, None, :]
    edge = left_edge.to(torch.bool)
    # lambda**d for a run of d left moves, exact powers of two (products
    # of halves are exact in f64), made on the device
    halves = torch.full((W,), 0.5, dtype=torch.float64, device=dev).cumprod(0)
    pow2 = torch.cat([torch.ones(1, dtype=torch.float64, device=dev), halves]).to(_F32)

    def zi(fill):
        return torch.full((H, P, W + 1), fill, dtype=_I32, device=dev)

    st = {"C": zi(0)}
    if with_lodhi:
        for name in ("T1", "T2", "S"):
            st[name] = torch.zeros((H, P, W + 1), dtype=_F32, device=dev)
    if with_region:
        st["region_lo"] = zi(BIG)
        st["region_hi"] = zi(-1)
    if with_interval:
        st["iv_pi"] = zi(0)
        st["iv_pj"] = zi(0)
        st["iv_ei"] = zi(-1)
        st["iv_ej"] = zi(-1)
        st["iv_cost"] = zi(0)
        st["has_iv"] = torch.zeros((H, P, W + 1), dtype=torch.bool, device=dev)
    if with_start:
        st["ts"] = zi(0)

    pat_cols = patterns_hp.to(_I32).permute(2, 0, 1)  # [m, Hp, P]
    false_col = torch.zeros((H, P, 1), dtype=torch.bool, device=dev)
    for i in range(1, m + 1):
        C_prev = st["C"]
        eq = (win & pat_cols[i - 1][:, :, None]) != 0  # [H, P, W]
        sub = torch.where(eq, 0, UNIT).to(_I32)
        diag_val = C_prev[:, :, :-1] + sub
        v = torch.minimum(diag_val, C_prev[:, :, 1:] + vert3[:, :, 1:])
        boundary = torch.where(edge, alpha_scaled * i, UNIT * i).to(_I32)
        w = torch.cat([boundary[:, None, None].expand(H, P, 1), v], dim=2)
        C = torch.cummin(w - unit_j, dim=2).values + unit_j

        diag_ok = torch.cat([false_col, C[:, :, 1:] == diag_val], dim=2)
        up_ok = C == C_prev + vert3
        # column 0 is always an up move (window_dp's move there)
        up_ok[:, :, 0] = True
        isleft = ~diag_ok & ~up_ok

        # the edge INTO cell (i, j): diag consumes (pattern i, text j)
        # from (i-1, j-1), up consumes pattern i from (i-1, j)
        eq_full = torch.cat([false_col, eq], dim=2)
        mf = (diag_ok & eq_full).to(_F32)
        u_i = torch.where(diag_ok | up_ok, i - 1, i).to(_I32)
        base = {}
        for name, arr in st.items():
            if name != "C":
                base[name] = torch.where(diag_ok, _shift_right(arr, 0), arr)
        if with_lodhi:
            a_c = torch.where(diag_ok, A_DIAG, A_GAP).to(_F32)
            T1p, T2p, Sp = base["T1"], base["T2"], base["S"]
            base["S"] = Sp + mf * a_c * T2p
            base["T2"] = a_c * (T2p + mf * T1p)
            base["T1"] = a_c * (T1p + mf)
        u_j = torch.where(diag_ok, jpos3 - 1, jpos3).to(_I32)
        if with_region:
            in_r = (u_i >= ra) & (u_i <= rb)
            base["region_lo"] = torch.minimum(base["region_lo"], torch.where(in_r, u_j, BIG))
            base["region_hi"] = torch.maximum(base["region_hi"], torch.where(in_r, u_j, -1))
        if with_interval:
            in_iv = (u_i >= ia) & (u_i < ib)
            first_iv = in_iv & ~base["has_iv"]
            base["iv_pi"] = torch.where(first_iv, u_i, base["iv_pi"])
            base["iv_pj"] = torch.where(first_iv, u_j, base["iv_pj"])
            base["iv_ei"] = torch.where(in_iv, u_i, base["iv_ei"])
            base["iv_ej"] = torch.where(in_iv, u_j, base["iv_ej"])
            base["iv_cost"] = base["iv_cost"] + (in_iv & (mf == 0.0)).to(_I32)
            base["has_iv"] = base["has_iv"] | in_iv
        if with_start:
            base["ts"] = torch.where(u_i == 0, u_j, base["ts"])

        # left runs: cell j enters row i at g(j), the nearest non-left
        # cell <= j (column 0 never is left), then takes d = j - g left
        # edges, each from (i, j'), j' = g..j-1, with a = lambda, mf = 0
        g = torch.cummax(torch.where(isleft, -1, jpos3.expand(H, P, W + 1)), dim=2).values
        gl = g.long()
        new = {name: torch.gather(arr, 2, gl) for name, arr in base.items()}
        d = jpos3 - g
        chain = d > 0
        if with_lodhi:
            factor = pow2[d.long()]
            new["T1"] = new["T1"] * factor
            new["T2"] = new["T2"] * factor
        # the row tests below are masks, not branches: region and
        # interval bounds may be device values
        if with_region:
            chain_r = chain & ((ra <= i) & (i <= rb))
            new["region_lo"] = torch.where(chain_r, torch.minimum(new["region_lo"], g),
                                           new["region_lo"])
            new["region_hi"] = torch.where(chain_r, torch.maximum(new["region_hi"], jpos3 - 1),
                                           new["region_hi"])
        if with_interval:
            chain_iv = chain & ((ia <= i) & (i < ib))
            first_iv = chain_iv & ~new["has_iv"]
            new["iv_pi"] = torch.where(first_iv, i, new["iv_pi"]).to(_I32)
            new["iv_pj"] = torch.where(first_iv, g, new["iv_pj"])
            new["iv_ei"] = torch.where(chain_iv, i, new["iv_ei"]).to(_I32)
            new["iv_ej"] = torch.where(chain_iv, jpos3 - 1, new["iv_ej"]).to(_I32)
            new["iv_cost"] = new["iv_cost"] + torch.where(chain_iv, d, 0).to(_I32)
            new["has_iv"] = new["has_iv"] | chain_iv
        new["C"] = C
        st = new
    return SummaryDP(
        ends=st["C"], lodhi=st.get("S"), text_start=st.get("ts"),
        region_lo=st.get("region_lo"), region_hi=st.get("region_hi"),
        iv_pi=st.get("iv_pi"), iv_pj=st.get("iv_pj"), iv_ei=st.get("iv_ei"),
        iv_ej=st.get("iv_ej"), iv_cost=st.get("iv_cost"),
        has_interval=st.get("has_iv"),
    )


# ---------------------------------------------------------------------------
# Best valley per pattern
# ---------------------------------------------------------------------------


class BestPerPattern(NamedTuple):
    cost: torch.Tensor  # [H, P] int32
    pos: torch.Tensor  # [H, P] int32
    has: torch.Tensor  # [H, P] bool


@compiled()
def best_valley_per_pattern(ends, w_len) -> BestPerPattern:
    """Lowest-cost valley per (window, pattern), ties to the smallest j;
    without a valley, column 0 (cost BIG).  ends [H, P, W + 1]; w_len
    [H] valid window lengths."""
    H, P, N = ends.shape
    jpos = torch.arange(N, dtype=_I32, device=ends.device)
    valid = jpos[None, None, :] <= w_len[:, None, None]
    e = torch.where(valid, ends, BIG)
    prv = _shift_right(e, BIG)
    nxt = _shift_left(e, BIG)
    isv = (e < nxt) & (e <= prv)
    # unique key: low cost, then low j; non-valleys after every valley
    key = torch.where(isv, e, BIG).to(torch.int64) * N + jpos
    best = key.argmin(dim=2)
    best_cost = torch.gather(e, 2, best[:, :, None])[:, :, 0]
    return BestPerPattern(cost=best_cost, pos=best.to(_I32), has=best_cost < BIG)
