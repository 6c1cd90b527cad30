"""Filter patterns of the plain reference: the grammar, the greedy match,
the filter's pass rule, the inspect label and the trim of a read.

Frozen copy of barbell's semantics: `src/filter/pattern.rs:205-343`,
`src/filter/filter.rs:10-214`, `src/inspect/inspect.rs:9-131`,
`src/trim/trim.rs:31-268`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .records import BEFORE, FTAG, FWD, RC, RTAG, Cut, Row

_TYPES = ("Ftag", "Rtag", "Fflank", "Rflank")


@dataclass
class Element:
    match_type: str
    orientation: Optional[str] = None
    label: Optional[str] = None
    placeholder: Optional[int] = None
    range: Tuple[int, int] = (0, 0)
    relative_to: Optional[str] = None  # left | right | prev_left
    cuts: List[Cut] = field(default_factory=list)


def parse(pattern: str) -> List[Element]:
    out = []
    for chunk in pattern.split("__"):
        head, _, params = chunk.strip().partition("[")
        if head.strip() not in _TYPES:
            raise ValueError(f"bad pattern element {chunk!r}")
        el = Element(head.strip())
        for p in (q.strip() for q in params.rstrip().rstrip("]").split(",")):
            if p == "fw":
                el.orientation = FWD
            elif p == "rc":
                el.orientation = RC
            elif p.startswith("@"):
                name, _, rng = p[1:].partition("(")
                lo, _, hi = rng.rstrip(")").partition("..")
                el.relative_to, el.range = name, (int(lo), int(hi))
            elif p.startswith("?"):
                el.placeholder = int(p[1:])
            elif p.startswith((">", "<")):
                el.cuts.append(Cut.from_pattern_string(p))
            elif p and p != "*":
                el.label = p.strip('"')
        out.append(el)
    return out


def _element_ok(m: Row, el: Element, labels: Dict[int, str], prev_end) -> bool:
    if m.match_type != el.match_type:
        return False
    if el.match_type in (FTAG, RTAG) and el.label is not None:
        if el.label.startswith("~"):
            if el.label[1:] not in m.label:
                return False
        elif el.label != m.label:
            return False
    if el.placeholder is not None:
        stored = labels.get(el.placeholder)
        if stored is not None and m.label != stored:
            return False
        labels.setdefault(el.placeholder, m.label)
    if el.orientation is not None and el.orientation != m.strand:
        return False
    lo, hi = el.range
    if el.relative_to == "left":
        return lo <= m.read_start_bar <= hi
    if el.relative_to == "right":
        return m.read_len - hi <= m.read_end_bar <= m.read_len - lo
    if el.relative_to == "prev_left" and prev_end is not None:
        return prev_end + lo <= m.read_start_bar <= prev_end + hi
    return True


def match(rows: List[Row], pattern: List[Element]):
    """(matched, [(row index, cut)]): element i against row i, in order."""
    if len(rows) < len(pattern):
        return False, []
    labels: Dict[int, str] = {}
    cuts = []
    prev_end = None
    for i, el in enumerate(pattern):
        if not _element_ok(rows[i], el, labels, prev_end):
            return False, []
        cuts.extend((i, c) for c in el.cuts)
        prev_end = rows[i].read_end_bar
    return True, cuts


def filter_pass(rows: List[Row], patterns: List[List[Element]]) -> bool:
    """Writes the longest matching pattern's cuts into ``rows``; passes
    iff that pattern covers every row."""
    best, best_cuts = 0, None
    for pat in patterns:
        ok, cuts = match(rows, pat)
        if ok and len(pat) > best:
            best, best_cuts = len(pat), cuts
    if best > 0 and best_cuts is not None:
        for i, cut in best_cuts:
            rows[i].cuts = (rows[i].cuts or []) + [(cut, i)]
    return best == len(rows)


def _bucket(pos: int, size: int) -> int:
    return (max(0, pos - 1) // size) * size


def structure(rows: List[Row], size: int = 250) -> str:
    """The inspect label of a read's rows."""
    parts = []
    prev_end = None
    for r in rows:
        s, e = r.read_start_bar, r.read_end_bar
        if prev_end is not None and max(0, s - prev_end) <= max(0, r.read_len - e):
            g = _bucket(max(0, s - prev_end), size)
            tag = f"@prev_left({g}..{g + size})"
        elif prev_end is None and r.rel_dist_to_end > 0:
            b = _bucket(s, size)
            tag = f"@left({b}..{b + size})"
        else:
            lo = _bucket(max(0, r.read_len - e), size)
            hi = _bucket(max(0, r.read_len - s), size) + size
            tag = f"@right({lo}..{hi})"
        cut = ("" if not r.cuts else (", <<" if r.strand == FWD else ", >>"))
        ori = "fw" if r.strand == FWD else "rc"
        parts.append(f"{r.match_type}[{ori}, *{cut}, {tag}]")
        prev_end = e
    return "__".join(parts)


def _slices(rows: List[Row], n: int):
    groups: Dict[int, list] = {}
    for r in rows:
        for cut, _pos in r.cuts or ():
            groups.setdefault(cut.group_id, []).append(
                (r.read_start_flank, r.read_end_flank, cut, r))
    ordered = sorted(groups.items(), key=lambda kv: kv[1][0][0])
    out = []
    for i, (_gid, g) in enumerate(ordered):
        if len(g) == 2:
            (s1, e1, c1, r1), (s2, e2, c2, r2) = g
            out.append((s1 if c1.direction == BEFORE else e1,
                        s2 if c2.direction == BEFORE else e2, [r1, r2]))
        elif len(g) == 1:
            fs, fe, cut, r = g[0]
            if cut.direction == BEFORE:
                if i > 0:
                    best = max(ordered[i - 1][1], key=lambda t: t[1])
                    out.append((best[1], fs, [best[3], r]))
                else:
                    out.append((0, fs, [r]))
            else:
                if i < len(ordered) - 1:
                    best = min(ordered[i + 1][1], key=lambda t: t[0])
                    out.append((fe, best[0], [r, best[3]]))
                else:
                    out.append((fe, n, [r]))
    return out


def trim(seq: bytes, qual: bytes, rows: List[Row]):
    """[(seq, qual, file label, id suffix)]: the kit's trim (label of the
    slice's leftmost barcode, flanks left out, no flip)."""
    out = []
    for count, (s, e, annos) in enumerate(_slices(rows, len(seq))):
        if s >= e:
            continue
        labels = [a.label for a in annos if "flank" not in a.label]
        out.append((seq[s:e], qual[s:e], labels[0] if labels else "none",
                    "" if count == 0 else f"_{count}"))
    return out
