"""Gap-weighted subsequence (Lodhi) scoring of alignment columns.

Re-scores barcode candidate alignments by how *contiguously* they match:
the score is the sum over all increasing k-tuples (k=3 in production,
reference `src/annotate/searcher.rs:209`) of match columns, each tuple
weighted by ``lambda ** (pattern_span + text_span)`` of the enclosing
column range — i.e. ``lambda ** sum(width(col) for col in [c1..ck])``
where a column's width is 2 if it consumes both pattern and text
(match/sub) and 1 if it consumes only one (gap).  Long exact runs score
high; scattered matches decay geometrically.  Scores are normalized by
the all-match "perfect" score of the group's padded barcode length
(reference `src/annotate/searcher.rs:229-239`).

The sum factorizes into a linear left-to-right recurrence (O(k) state
per column), which is what the device pipeline evaluates inside its
traceback scan — the formula is reversal-invariant, so it can be
accumulated in either column order.
"""

from __future__ import annotations

import numpy as np

from .oracle import OP_M

DEFAULT_K = 3
DEFAULT_LAMBDA = 0.5


def lodhi_from_columns(
    is_match: np.ndarray,
    widths: np.ndarray,
    k: int = DEFAULT_K,
    lam: float = DEFAULT_LAMBDA,
) -> float:
    """Score a column sequence given per-column match flags and widths."""
    a = np.power(lam, widths.astype(np.float64))
    m = is_match.astype(np.float64)
    # T[d] = sum over (d+1)-subsets of match columns c_0<..<c_d <= current
    # of prod(a[c_0..current]);  score accumulates completed k-subsets.
    T = np.zeros(k - 1, dtype=np.float64)
    score = 0.0
    for ac, mc in zip(a, m):
        if mc:
            score += ac * T[k - 2]
        # update highest order first so each T_d sees the previous T_{d-1}
        for d in range(k - 2, 0, -1):
            T[d] = ac * (T[d] + mc * T[d - 1])
        T[0] = ac * (T[0] + mc)
    return float(score)


def lodhi_from_ops(ops: np.ndarray, k: int = DEFAULT_K, lam: float = DEFAULT_LAMBDA) -> float:
    """Score an alignment's op sequence (op codes from the oracle)."""
    is_match = ops == OP_M
    widths = np.where(ops <= 1, 2, 1)  # M/X consume both; gaps consume one
    return lodhi_from_columns(is_match, widths, k=k, lam=lam)


def perfect_score(length: int, k: int = DEFAULT_K, lam: float = DEFAULT_LAMBDA) -> float:
    """Score of an all-match alignment of the given column length."""
    ops = np.zeros(length, dtype=np.int8)
    return lodhi_from_ops(ops, k=k, lam=lam)
