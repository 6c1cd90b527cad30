"""Annotation records and their TSV wire format.

``BarbellMatch`` is the one row type that flows through the whole
pipeline (annotate writes it, filter/inspect/trim read it back).  The
TSV layout is byte-compatible with the reference implementation:

* column order = reference struct field order
  (`src/annotate/searcher.rs:31-64`)
* strand serialized as ``Fwd`` / ``Rc``
  (`src/annotate/searcher.rs:67-88`)
* cuts serialized as ``After(id):idx,Before(id):idx`` or empty
  (`src/annotate/searcher.rs:90-142`)
* tab delimiter, ``\\n`` line terminator, no quoting (fields never
  contain tabs), header row of field names.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Tuple


class BarcodeType(str, Enum):
    """Reference `src/annotate/barcodes.rs:8-33`."""

    Ftag = "Ftag"
    Rtag = "Rtag"
    Fflank = "Fflank"  # flank found but barcode not confidently resolved
    Rflank = "Rflank"

    def as_flank(self) -> "BarcodeType":
        if self is BarcodeType.Ftag:
            return BarcodeType.Fflank
        if self is BarcodeType.Rtag:
            return BarcodeType.Rflank
        raise ValueError(f"Cannot convert {self.value} to flank")

    def as_str(self) -> str:
        return self.value


class Strand(str, Enum):
    Fwd = "Fwd"
    Rc = "Rc"


class CutDirection(str, Enum):
    Before = "Before"  # cut at match flank start
    After = "After"  # cut at match flank end


_CUT_CACHE: dict = {}


@dataclass(frozen=True)
class Cut:
    """A cut marker: which slice group it belongs to and on which side.

    String forms (reference `src/filter/pattern.rs:46-94`):
    ``After(n)`` / ``Before(n)`` in the TSV, ``>>n`` / ``<<n`` in the
    pattern grammar (bare ``>>`` / ``<<`` default to group id 0).
    """

    group_id: int
    direction: CutDirection

    def __str__(self) -> str:
        return f"{self.direction.value}({self.group_id})"

    @staticmethod
    def from_string(s: str) -> Optional["Cut"]:
        # Memoized: Cut is frozen and the string vocabulary is tiny
        # (After(0)/Before(1)/...), while trim parses one per TSV cut.
        try:
            return _CUT_CACHE[s]
        except KeyError:
            pass
        cut = Cut._parse(s)
        if len(_CUT_CACHE) < 4096:
            _CUT_CACHE[s] = cut
        return cut

    @staticmethod
    def _parse(s: str) -> Optional["Cut"]:
        s = s.strip()
        for name, direction in (("Before", CutDirection.Before), ("After", CutDirection.After)):
            prefix = name + "("
            if s.startswith(prefix) and s.endswith(")"):
                inner = s[len(prefix):-1]
                try:
                    return Cut(int(inner), direction)
                except ValueError:
                    return None
        return None

    @staticmethod
    def from_pattern_string(s: str) -> Optional["Cut"]:
        if len(s) < 2:
            return None
        head, tail = s[:2], s[2:]
        if head == ">>":
            direction = CutDirection.After
        elif head == "<<":
            direction = CutDirection.Before
        else:
            return None
        if tail == "":
            return Cut(0, direction)
        try:
            return Cut(int(tail), direction)
        except ValueError:
            return None


# TSV column order — must not change (wire compatibility).
TSV_COLUMNS = [
    "read_id",
    "read_len",
    "rel_dist_to_end",
    "read_start_bar",
    "read_end_bar",
    "read_start_flank",
    "read_end_flank",
    "bar_start",
    "bar_end",
    "match_type",
    "flank_cost",
    "barcode_cost",
    "label",
    "strand",
    "cuts",
]

TSV_HEADER = "\t".join(TSV_COLUMNS)

# Enum __call__ lookups cost ~1us each; the TSV parser runs two per row.
_BARCODE_BY_VALUE = {m.value: m for m in BarcodeType}
_STRAND_BY_VALUE = {m.value: m for m in Strand}


@dataclass(slots=True)
class BarbellMatch:
    """One annotation row; see module docstring for wire format."""

    read_id: str
    read_len: int
    rel_dist_to_end: int
    read_start_bar: int
    read_end_bar: int
    read_start_flank: int
    read_end_flank: int
    bar_start: int
    bar_end: int
    match_type: BarcodeType
    flank_cost: int
    barcode_cost: int
    label: str
    strand: Strand
    cuts: Optional[List[Tuple[Cut, int]]] = field(default=None)

    def to_tsv_row(self) -> str:
        cuts_str = (
            ",".join(f"{cut}:{pos}" for cut, pos in self.cuts) if self.cuts else ""
        )
        return "\t".join(
            (
                self.read_id,
                str(self.read_len),
                str(self.rel_dist_to_end),
                str(self.read_start_bar),
                str(self.read_end_bar),
                str(self.read_start_flank),
                str(self.read_end_flank),
                str(self.bar_start),
                str(self.bar_end),
                self.match_type.value,
                str(self.flank_cost),
                str(self.barcode_cost),
                self.label,
                self.strand.value,
                cuts_str,
            )
        )

    @staticmethod
    def from_tsv_fields(fields: List[str]) -> "BarbellMatch":
        if len(fields) != len(TSV_COLUMNS):
            raise ValueError(
                f"Expected {len(TSV_COLUMNS)} TSV fields, got {len(fields)}: {fields!r}"
            )
        cuts_field = fields[14]
        cuts: Optional[List[Tuple[Cut, int]]] = None
        if cuts_field:
            cuts = []
            for part in cuts_field.split(","):
                cut_str, _, pos_str = part.partition(":")
                cut = Cut.from_string(cut_str)
                if cut is None or not pos_str:
                    raise ValueError(f"Invalid cut field: {cuts_field!r}")
                cuts.append((cut, int(pos_str)))
        return BarbellMatch(
            read_id=fields[0],
            read_len=int(fields[1]),
            rel_dist_to_end=int(fields[2]),
            read_start_bar=int(fields[3]),
            read_end_bar=int(fields[4]),
            read_start_flank=int(fields[5]),
            read_end_flank=int(fields[6]),
            bar_start=int(fields[7]),
            bar_end=int(fields[8]),
            match_type=_BARCODE_BY_VALUE.get(fields[9]) or BarcodeType(fields[9]),
            flank_cost=int(fields[10]),
            barcode_cost=int(fields[11]),
            label=fields[12],
            strand=_STRAND_BY_VALUE.get(fields[13]) or Strand(fields[13]),
            cuts=cuts,
        )

    @staticmethod
    def from_tsv_line(line: str) -> "BarbellMatch":
        return BarbellMatch.from_tsv_fields(line.rstrip("\n").split("\t"))


def rel_dist_to_end(pos: int, read_len: int) -> int:
    """Signed distance-to-nearest-end convention.

    Positive = distance from the left end (0 -> 1), negative = distance
    from the right end (read_len -> -1); positions before the read start
    -> 1.  Reference `src/annotate/searcher.rs:183-199`.
    """
    if pos < 0:
        return 1
    if pos <= read_len // 2:
        return 1 if pos == 0 else pos
    if pos == read_len:
        return -1
    return -(read_len - pos)


class AnnotationWriter:
    """Streaming TSV writer; writes the header lazily on first row."""

    def __init__(self, fh):
        self._fh = fh
        self._wrote_header = False

    def write_rows(self, rows) -> None:
        if not rows:
            # keep zero-row outputs EMPTY (not header-only): the
            # reference's csv::Writer emits the header with the first
            # serialized row, and callers pass empty batches routinely
            return
        if not self._wrote_header:
            self._fh.write(TSV_HEADER + "\n")
            self._wrote_header = True
        self._fh.write("".join(row.to_tsv_row() + "\n" for row in rows))

    def write_lines(self, lines) -> None:
        """Pre-serialized TSV rows (no trailing newline) — the columnar
        hit-table path; byte-identical to write_rows on the same rows."""
        if not lines:
            return
        if not self._wrote_header:
            self._fh.write(TSV_HEADER + "\n")
            self._wrote_header = True
        self._fh.write("\n".join(lines) + "\n")

    def finish(self) -> None:
        # Match the reference (csv::Writer + serialize): the header is
        # only emitted with the first row, so an empty output stays empty.
        pass


def read_annotations(path: str):
    """Iterate BarbellMatch rows from an annotation TSV file."""
    with open(path, "r") as fh:
        header = fh.readline()
        if not header:
            return  # empty annotation file (no matches at all)
        if header.rstrip("\n").split("\t") != TSV_COLUMNS:
            raise ValueError(f"Unexpected annotation header in {path}: {header!r}")
        for line in fh:
            if line.strip():
                yield BarbellMatch.from_tsv_line(line)


def read_annotation_groups(path: str):
    """Yield (read_id, [rows]) grouped by *consecutive* read_id.

    The annotate stage guarantees each read's rows are contiguous in the
    file; filter/inspect rely on that (reference `src/filter/filter.rs:51-85`).
    """
    current_id = None
    group: List[BarbellMatch] = []
    for row in read_annotations(path):
        if current_id is not None and row.read_id != current_id:
            yield current_id, group
            group = []
        current_id = row.read_id
        group.append(row)
    if group:
        yield current_id, group
