"""Annotation rows and their TSV form, as the kit run writes them.

Plain copy of the row type of barbell (`src/annotate/searcher.rs:31-142`):
column order, ``Fwd`` / ``Rc`` strands, cuts as ``After(id):idx``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

FTAG, RTAG, FFLANK, RFLANK = "Ftag", "Rtag", "Fflank", "Rflank"
FWD, RC = "Fwd", "Rc"
BEFORE, AFTER = "Before", "After"

TSV_COLUMNS = [
    "read_id", "read_len", "rel_dist_to_end", "read_start_bar",
    "read_end_bar", "read_start_flank", "read_end_flank", "bar_start",
    "bar_end", "match_type", "flank_cost", "barcode_cost", "label",
    "strand", "cuts",
]
TSV_HEADER = "\t".join(TSV_COLUMNS)


def as_flank(match_type: str) -> str:
    return {FTAG: FFLANK, RTAG: RFLANK}[match_type]


@dataclass(frozen=True)
class Cut:
    group_id: int
    direction: str  # BEFORE | AFTER

    def __str__(self) -> str:
        return f"{self.direction}({self.group_id})"

    @staticmethod
    def from_pattern_string(s: str) -> Optional["Cut"]:
        if len(s) < 2 or s[:2] not in (">>", "<<"):
            return None
        direction = AFTER if s[:2] == ">>" else BEFORE
        try:
            return Cut(int(s[2:]) if s[2:] else 0, direction)
        except ValueError:
            return None


@dataclass
class Row:
    read_id: str
    read_len: int
    rel_dist_to_end: int
    read_start_bar: int
    read_end_bar: int
    read_start_flank: int
    read_end_flank: int
    bar_start: int
    bar_end: int
    match_type: str
    flank_cost: int
    barcode_cost: int
    label: str
    strand: str
    cuts: Optional[List[Tuple[Cut, int]]] = None

    def tsv(self) -> str:
        cuts = ",".join(f"{c}:{p}" for c, p in self.cuts) if self.cuts else ""
        return "\t".join(str(v) for v in (
            self.read_id, self.read_len, self.rel_dist_to_end,
            self.read_start_bar, self.read_end_bar, self.read_start_flank,
            self.read_end_flank, self.bar_start, self.bar_end,
            self.match_type, self.flank_cost, self.barcode_cost, self.label,
            self.strand, cuts))


def rel_dist_to_end(pos: int, read_len: int) -> int:
    """Signed distance to the nearer end (`src/annotate/searcher.rs:183-199`)."""
    if pos < 0:
        return 1
    if pos <= read_len // 2:
        return 1 if pos == 0 else pos
    if pos == read_len:
        return -1
    return -(read_len - pos)
