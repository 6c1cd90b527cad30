"""Overlap collapse of flank/barcode matches within one read.

Matches whose flank intervals overlap by >= threshold (0.8 in
production) are grouped (transitively against any group member) and
only the best survives.  Priority: barcode matches (Ftag/Rtag) beat
flank-only (Fflank/Rflank); among barcode matches lower barcode_cost
then lower flank_cost wins; among flank-only the longer flank wins.
Mirrors reference `src/annotate/interval.rs:4-79` (stable sorts keep
insertion order for full ties).
"""

from __future__ import annotations

from typing import List

from .records import BarbellMatch, BarcodeType


def _is_overlap(a: BarbellMatch, b: BarbellMatch, threshold: float) -> bool:
    start = max(a.read_start_flank, b.read_start_flank)
    end = min(a.read_end_flank, b.read_end_flank)
    if end <= start:
        return False
    overlap = end - start
    min_len = min(
        a.read_end_flank - a.read_start_flank,
        b.read_end_flank - b.read_start_flank,
    )
    return overlap / min_len >= threshold


def _priority(m: BarbellMatch) -> int:
    return 1 if m.match_type in (BarcodeType.Ftag, BarcodeType.Rtag) else 2


def _select_best(group: List[BarbellMatch]) -> BarbellMatch:
    def key(m: BarbellMatch):
        p = _priority(m)
        if p == 1:
            return (p, m.barcode_cost, m.flank_cost, 0)
        # flank-only: longer flank first
        return (p, 0, 0, -(m.read_end_flank - m.read_start_flank))

    # Python's sort is stable, like the reference's sort_by.
    return sorted(group, key=key)[0]


def collapse_overlapping_matches(
    matches: List[BarbellMatch], filter_overlap: float
) -> List[BarbellMatch]:
    if len(matches) <= 1:
        # nothing can overlap; skipping the sorts halves the batched
        # engine's per-read host cost for the typical 1-construct read
        return list(matches)
    ordered = sorted(matches, key=lambda m: m.read_start_flank)

    groups: List[List[BarbellMatch]] = []
    group = [ordered[0]]
    for m in ordered[1:]:
        if any(_is_overlap(g, m, filter_overlap) for g in group):
            group.append(m)
        else:
            groups.append(group)
            group = [m]
    groups.append(group)
    return [_select_best(g) for g in groups]
