"""NumPy reference engine for approximate flank/barcode search.

This module *defines* the framework's alignment semantics.  The TPU
kernels in :mod:`barbell_tpu.ops.device` are validated cell-for-cell
against it, and it doubles as the CPU fallback path.

Semantics (modelled on the reference's search engine usage,
`src/annotate/searcher.rs`; the engine itself is a non-vendored
dependency, so the precise conventions below are *ours* and are used
consistently across oracle and kernels):

* **Semiglobal search**: the pattern must be fully aligned, the text
  match may start/end anywhere.  Unit costs (sub/ins/del = 1), IUPAC
  masks intersect => match (cost 0).
* **Integer cost domain**: all DP runs in int32 with costs scaled by
  ``COST_SCALE`` (2560).  A unit edit costs 2560; the fractional
  overhang cost ``alpha`` quantizes to ``round(alpha * 2560)`` (exact
  for the default 0.4 -> 1024).  This makes every valley/traceback
  comparison exact on both CPU and TPU — no float-tie hazards.
* **Overhang** (flank search only): pattern bases that extend past the
  *text* ends cost ``alpha`` each instead of 1 (CLI ``--alpha``).
  Implemented as: column-0 vertical steps cost alpha, column-n vertical
  steps cost alpha.  A match is accepted iff ``cost <= k`` (scaled);
  the reported integer cost rounds half-up.
* **Match enumeration**: one match per cost valley over end positions:
  report end ``j`` iff ``ends[j] <= k`` and ``ends[j] < ends[j+1]``
  and ``ends[j] <= ends[j-1]`` (out-of-range neighbours = +inf), i.e.
  the rightmost point of each plateau-valley.
* **Traceback tie-breaking** (canonical): diagonal (match/sub) first,
  then vertical (pattern-consuming gap), then horizontal (text gap).
* **Reverse complement**: an Rc search runs the forward pattern
  against ``revcomp(text)``; coordinates are mapped back to forward
  text coordinates (span ``[s,e)`` in rc space -> ``[n-e, n-s)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..models.records import Strand

# Alignment column op codes.
OP_M = 0  # match      (consumes pattern + text, cost 0)
OP_X = 1  # substitute (consumes pattern + text, cost 1)
OP_U = 2  # pattern-consuming gap / overhang (cost 1, or alpha at text ends)
OP_L = 3  # text-consuming gap (cost 1)

# Scaled integer cost domain: one unit edit = COST_SCALE.
COST_SCALE = 2560
BIG = np.int32(2**30)


def scale_alpha(alpha: Optional[float]) -> Optional[int]:
    """Quantize the overhang cost to the integer domain."""
    if alpha is None:
        return None
    return int(round(float(alpha) * COST_SCALE))


def effective_alpha(alpha: float) -> float:
    """The alpha actually used after quantization."""
    return scale_alpha(alpha) / COST_SCALE


def scale_k(k: float) -> int:
    """Scale an edit threshold into the integer domain."""
    return int(round(float(k) * COST_SCALE))


def cost_to_int(scaled: int) -> int:
    """Reported integer cost: round half up."""
    return int((int(scaled) + COST_SCALE // 2) // COST_SCALE)


@dataclass
class Alignment:
    """One search hit.

    ``text_start``/``text_end`` are in the *searched* text's coordinates
    (for Rc searches, the caller maps them with :func:`rc_span_to_fwd`).
    ``path`` holds one (pattern_pos, text_pos) pair per alignment column
    — the column's start coordinates.  ``ops`` holds one op code per
    column.  Both run in pattern order.  ``cost`` is in the scaled
    integer domain.
    """

    text_start: int
    text_end: int
    cost: int  # scaled by COST_SCALE
    strand: Strand
    path: np.ndarray  # [n_cols, 2] int32
    ops: np.ndarray  # [n_cols] int8
    pattern_idx: int = 0

    @property
    def cost_units(self) -> float:
        return self.cost / COST_SCALE

    @property
    def cost_int(self) -> int:
        return cost_to_int(self.cost)


def dp_table(
    pattern_masks: np.ndarray,
    text_masks: np.ndarray,
    alpha: Optional[float] = None,
) -> np.ndarray:
    """Full semiglobal DP cost table C[(m+1), (n+1)] (int32, scaled).

    C[i][j] = min scaled cost of aligning pattern[:i] against some text
    window ending at j, with free start anywhere in the text.
    """
    m = len(pattern_masks)
    n = len(text_masks)
    a = scale_alpha(alpha)
    gap_edge = COST_SCALE if a is None else a
    unit = COST_SCALE

    eq = (pattern_masks[:, None] & text_masks[None, :]) != 0  # [m, n]
    sub = np.where(eq, 0, unit).astype(np.int64)  # [m, n]

    C = np.zeros((m + 1, n + 1), dtype=np.int64)
    C[1:, 0] = gap_edge * np.arange(1, m + 1, dtype=np.int64)

    jj = np.arange(n, dtype=np.int64)
    vert = np.full(n, unit, dtype=np.int64)
    if a is not None and n > 0:
        vert[n - 1] = a  # vertical step in the last column = right overhang
    for i in range(1, m + 1):
        prev = C[i - 1]
        # candidates without the horizontal (text-gap) transition
        v = np.minimum(prev[:-1] + sub[i - 1], prev[1:] + vert)
        # horizontal closure: C[i][j] = min_{j'<=j} (w[j'] + unit*(j-j')),
        # seeded from the j=0 boundary cell.
        u = np.minimum(v, C[i, 0] + unit * (jj + 1))
        u = u - unit * jj
        np.minimum.accumulate(u, out=u)
        C[i, 1:] = u + unit * jj
    return C.astype(np.int32)


def end_costs(C: np.ndarray) -> np.ndarray:
    """Best scaled cost for a match ending at each text position j."""
    return C[-1]


def find_valleys(ends: np.ndarray, k_scaled: int) -> List[int]:
    """End positions that are plateau-valley minima with cost <= k."""
    n = len(ends) - 1
    out = []
    for j in range(n + 1):
        if ends[j] > k_scaled:
            continue
        nxt = ends[j + 1] if j < n else BIG
        prv = ends[j - 1] if j > 0 else BIG
        if ends[j] < nxt and ends[j] <= prv:
            out.append(j)
    return out


def traceback(
    C: np.ndarray,
    pattern_masks: np.ndarray,
    text_masks: np.ndarray,
    j_end: int,
    alpha: Optional[float] = None,
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Walk back from cell (m, j_end); returns (text_start, path, ops)."""
    m = len(pattern_masks)
    n = len(text_masks)
    a = scale_alpha(alpha)
    unit = COST_SCALE
    i, j = m, j_end
    cols: List[Tuple[int, int]] = []
    ops: List[int] = []
    while i > 0:
        here = int(C[i, j])
        if j > 0:
            is_eq = (pattern_masks[i - 1] & text_masks[j - 1]) != 0
            diag = int(C[i - 1, j - 1]) + (0 if is_eq else unit)
            if here == diag:
                i, j = i - 1, j - 1
                cols.append((i, j))
                ops.append(OP_M if is_eq else OP_X)
                continue
        vcost = unit
        if a is not None and (j == 0 or j == n):
            vcost = a
        if here == int(C[i - 1, j]) + vcost:
            i = i - 1
            cols.append((i, j))
            ops.append(OP_U)
            continue
        # horizontal
        assert j > 0, "traceback stuck"
        j = j - 1
        cols.append((i, j))
        ops.append(OP_L)
    cols.reverse()
    ops.reverse()
    text_start = j
    return (
        text_start,
        np.array(cols, dtype=np.int32).reshape(-1, 2),
        np.array(ops, dtype=np.int8),
    )


def window_table(
    pattern_masks: np.ndarray,
    window_masks: np.ndarray,
    left_edge: bool,
    right_pos: int,
    alpha: Optional[float] = None,
) -> np.ndarray:
    """Semiglobal DP table over a bounded text window.

    This is the *canonical* table used for flank-match tracebacks (the
    device pipeline computes the identical table): column 0 is the
    read's true start only when ``left_edge`` (overhang boundary
    ``alpha*i``; otherwise a plain ``unit*i`` boundary, unreachable by
    any within-threshold match because the window is sized to
    ``m + k + 1``), and vertical steps into column ``right_pos`` (the
    read's true end, or -1) cost alpha.
    """
    m = len(pattern_masks)
    n = len(window_masks)
    a = scale_alpha(alpha)
    unit = COST_SCALE

    eq = (pattern_masks[:, None] & window_masks[None, :]) != 0
    sub = np.where(eq, 0, unit).astype(np.int64)

    boundary_step = a if (a is not None and left_edge) else unit
    C = np.zeros((m + 1, n + 1), dtype=np.int64)
    C[1:, 0] = boundary_step * np.arange(1, m + 1, dtype=np.int64)

    jj = np.arange(n, dtype=np.int64)
    vert = np.full(n + 1, unit, dtype=np.int64)
    if a is not None and 0 <= right_pos <= n:
        vert[right_pos] = a
    for i in range(1, m + 1):
        prev = C[i - 1]
        v = np.minimum(prev[:-1] + sub[i - 1], prev[1:] + vert[1:])
        u = np.minimum(v, C[i, 0] + unit * (jj + 1))
        u = u - unit * jj
        np.minimum.accumulate(u, out=u)
        C[i, 1:] = u + unit * jj
    return C.astype(np.int32)


def window_traceback(
    C: np.ndarray,
    pattern_masks: np.ndarray,
    window_masks: np.ndarray,
    j_end: int,
    left_edge: bool,
    right_pos: int,
    alpha: Optional[float] = None,
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Traceback within a :func:`window_table` (same conventions)."""
    m = len(pattern_masks)
    a = scale_alpha(alpha)
    unit = COST_SCALE
    boundary_step = a if (a is not None and left_edge) else unit
    i, j = m, j_end
    cols: List[Tuple[int, int]] = []
    ops: List[int] = []
    while i > 0:
        here = int(C[i, j])
        if j > 0:
            is_eq = (pattern_masks[i - 1] & window_masks[j - 1]) != 0
            diag = int(C[i - 1, j - 1]) + (0 if is_eq else unit)
            if here == diag:
                i, j = i - 1, j - 1
                cols.append((i, j))
                ops.append(OP_M if is_eq else OP_X)
                continue
        if j == 0:
            vcost = boundary_step
        elif a is not None and j == right_pos:
            vcost = a
        else:
            vcost = unit
        if here == int(C[i - 1, j]) + vcost:
            i = i - 1
            cols.append((i, j))
            ops.append(OP_U)
            continue
        assert j > 0, "traceback stuck"
        j = j - 1
        cols.append((i, j))
        ops.append(OP_L)
    cols.reverse()
    ops.reverse()
    return (
        j,
        np.array(cols, dtype=np.int32).reshape(-1, 2),
        np.array(ops, dtype=np.int8),
    )


def flank_window_span(m: int, k_units: int) -> int:
    """Window width for flank tracebacks: any match with cost <= k spans
    at most m + k text positions (every extra text char is a unit gap)."""
    return m + k_units + 1


def op_cost(op: int, j: int, n: int, alpha: Optional[float]) -> int:
    """Scaled cost of one alignment column."""
    if op == OP_M:
        return 0
    a = scale_alpha(alpha)
    if op == OP_U and a is not None and (j == 0 or j == n):
        return a
    return COST_SCALE


def search(
    pattern_masks: np.ndarray,
    text_masks: np.ndarray,
    k: float,
    alpha: Optional[float] = None,
    strand: Strand = Strand.Fwd,
) -> List[Alignment]:
    """All valley matches of pattern in text with cost <= k, by end asc.

    ``k`` is in edit units (scaled internally).
    """
    n = len(text_masks)
    if n == 0:
        return []
    C = dp_table(pattern_masks, text_masks, alpha)
    ends = end_costs(C)
    out = []
    for j in find_valleys(ends, scale_k(k)):
        text_start, path, ops = traceback(C, pattern_masks, text_masks, j, alpha)
        out.append(
            Alignment(
                text_start=text_start,
                text_end=j,
                cost=int(ends[j]),
                strand=strand,
                path=path,
                ops=ops,
            )
        )
    return out


def best_match_per_pattern(
    pattern_mask_list: np.ndarray,
    text_masks: np.ndarray,
    k: float,
) -> List[Optional[Alignment]]:
    """For each pattern (all equal length), the best valley match or None.

    Best = lowest cost; ties broken by smallest end position (the first
    streamed match at the minimal cost).  Forward search, no overhang.
    """
    out: List[Optional[Alignment]] = []
    for idx in range(pattern_mask_list.shape[0]):
        pat = pattern_mask_list[idx]
        matches = search(pat, text_masks, k)
        if not matches:
            out.append(None)
            continue
        best = min(matches, key=lambda aln: (aln.cost, aln.text_end))
        best.pattern_idx = idx
        out.append(best)
    return out


def rc_span_to_fwd(text_start_rc: int, text_end_rc: int, n: int) -> Tuple[int, int]:
    """Map a span [s, e) in rc-text coordinates to forward coordinates."""
    return n - text_end_rc, n - text_start_rc


def matching_region(
    aln: Alignment, mask_start: int, mask_end: int, n: Optional[int] = None
) -> Optional[Tuple[int, int]]:
    """Text window covered by pattern positions [mask_start, mask_end].

    Mirrors the reference's path filtering (`src/annotate/cigar_parse.rs:71-82`):
    take the first and last path column whose pattern position lies in
    the *inclusive* range, return their text positions as (min, max).
    For Rc alignments pass ``n`` (the forward text length) to get the
    window in forward coordinates.
    """
    in_range = (aln.path[:, 0] >= mask_start) & (aln.path[:, 0] <= mask_end)
    idx = np.nonzero(in_range)[0]
    if len(idx) == 0:
        return None
    j_first = int(aln.path[idx[0], 1])
    j_last = int(aln.path[idx[-1], 1])
    if aln.strand is Strand.Rc:
        assert n is not None
        lo, hi = min(j_first, j_last), max(j_first, j_last)
        return n - hi, n - lo
    return min(j_first, j_last), max(j_first, j_last)


def map_pattern_interval(
    aln: Alignment, p_start: int, p_end: int
) -> Optional[Tuple[Tuple[int, int], Tuple[int, int], int]]:
    """((pat_start, pat_end), (text_start, text_end), sub_cost) for the
    pattern interval [p_start, p_end) — exclusive end, matching the
    reference's `map_pat_to_text_with_cost` (`src/annotate/cigar_parse.rs:6-45`).
    Sub-cost counts every non-match column as 1 (unscaled edit units).
    """
    in_range = (aln.path[:, 0] >= p_start) & (aln.path[:, 0] < p_end)
    idx = np.nonzero(in_range)[0]
    if len(idx) == 0:
        return None
    first, last = int(idx[0]), int(idx[-1])
    pi, pj = (int(x) for x in aln.path[first])
    ei, ej = (int(x) for x in aln.path[last])
    cost = int(np.count_nonzero(aln.ops[first : last + 1] != OP_M))
    return (pi, ei + 1), (pj, ej + 1), cost
