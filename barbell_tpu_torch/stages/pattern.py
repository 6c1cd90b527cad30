"""The filter pattern grammar: parsing and matching.

Grammar (reference `src/filter/pattern.rs`, README "Filtering"):
elements joined by ``__``, each element::

    Type[param, param, ...]

* Type: ``Ftag`` | ``Rtag`` | ``Fflank`` | ``Rflank``
* params (any order):
    - orientation: ``fw`` | ``rc``
    - position: ``@left(a..b)`` | ``@right(a..b)`` | ``@prev_left(a..b)``
    - placeholder: ``?N`` (labels with the same N must be equal)
    - cuts: ``>>[id]`` | ``<<[id]`` (``After``/``Before``, default id 0)
    - label: ``*`` (any) | ``~substr`` (substring) | literal label
* ``@right`` windows measure from the read's right end against the
  match's ``read_end_bar``; ``@prev_left`` measures from the previous
  element's ``read_end_bar`` against this match's ``read_start_bar``.

Matching is greedy left-to-right: element ``i`` must match the read's
``i``-th annotation; a read group matches iff every element matches in
order (reference `src/filter/pattern.rs:205-240`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..models.records import BarbellMatch, BarcodeType, Cut, Strand


@dataclass
class PatternElement:
    match_type: BarcodeType
    orientation: Optional[Strand] = None
    label: Optional[str] = None
    placeholder: Optional[int] = None
    range: Tuple[int, int] = (0, 0)
    relative_to: Optional[str] = None  # 'left' | 'right' | 'prev_left'
    cuts: Optional[List[Cut]] = None


@dataclass
class Pattern:
    elements: List[PatternElement]
    source: str = ""

    def __len__(self) -> int:
        return len(self.elements)


class PatternParseError(ValueError):
    pass


def _parse_range(range_str: str) -> Optional[Tuple[int, int]]:
    inner = range_str.strip().strip("()")
    parts = inner.split("..")
    if len(parts) != 2:
        return None
    try:
        return int(parts[0].strip()), int(parts[1].strip())
    except ValueError:
        return None


def _parse_position(pos_str: str) -> Optional[Tuple[str, Tuple[int, int]]]:
    head, sep, _ = pos_str.partition("(")
    if not sep:
        return None
    name = head.lstrip("@")
    if name not in ("left", "right", "prev_left"):
        return None
    rng = _parse_range(pos_str[len(head):].strip())
    if rng is None:
        return None
    return name, rng


def _warn_dropped_param(param: str, kind: str) -> None:
    """Malformed position/placeholder/cut params are *dropped*, exactly
    like the reference parser's ``if let Some(..)`` arms
    (`src/filter/pattern.rs:324-343`) — but dropping a constraint
    silently weakens the filter, so we at least say so on stderr."""
    import sys

    print(
        f"warning: ignoring malformed {kind} parameter {param!r} in filter pattern",
        file=sys.stderr,
    )


def _parse_element(element_str: str) -> Optional[PatternElement]:
    parts = element_str.split("[", 1)
    if len(parts) != 2:
        return None
    type_str = parts[0].strip()
    if type_str in ("Flank", "flank"):
        raise PatternParseError("Flank is not valid, use Fflank or Rflank")
    try:
        match_type = BarcodeType(type_str)
    except ValueError:
        return None

    el = PatternElement(match_type=match_type)
    cuts: List[Cut] = []
    params = parts[1].rstrip().rstrip("]")
    for param in (p.strip() for p in params.split(",")):
        if param == "fw":
            el.orientation = Strand.Fwd
        elif param == "rc":
            el.orientation = Strand.Rc
        elif param.startswith("@"):
            pos = _parse_position(param)
            if pos is not None:
                el.relative_to, el.range = pos
            else:
                _warn_dropped_param(param, "position")
        elif param.startswith("?"):
            try:
                el.placeholder = int(param[1:])
            except ValueError:
                _warn_dropped_param(param, "placeholder")
        elif param.startswith(">") or param.startswith("<"):
            cut = Cut.from_pattern_string(param)
            if cut is not None:
                cuts.append(cut)
            else:
                _warn_dropped_param(param, "cut")
        elif param == "*":
            pass  # any label
        elif param:
            el.label = param.strip('"')
    el.cuts = cuts or None
    return el


def pattern_from_str(pattern_str: str) -> Pattern:
    elements = []
    for chunk in pattern_str.split("__"):
        el = _parse_element(chunk.strip())
        if el is not None:
            elements.append(el)
    # Basic verification: every user chunk must have parsed.
    user_elems = pattern_str.count("__") + 1
    if user_elems != len(elements):
        raise PatternParseError(f"Pattern parse error for: {pattern_str!r}")
    return Pattern(elements=elements, source=pattern_str)


def patterns_from_file(path: str) -> List[Pattern]:
    with open(path) as fh:
        lines = [ln.strip() for ln in fh]
    return [pattern_from_str(ln) for ln in lines if ln]


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------


def _check_type_and_label(m: BarbellMatch, el: PatternElement) -> bool:
    if m.match_type != el.match_type:
        return False
    if el.match_type in (BarcodeType.Ftag, BarcodeType.Rtag) and el.label is not None:
        if el.label.startswith("~"):
            if el.label[1:] not in m.label:
                return False
        elif el.label != m.label:
            return False
    return True


def _check_placeholder(
    m: BarbellMatch, el: PatternElement, matched_labels: Dict[int, str]
) -> bool:
    if el.placeholder is None:
        return True
    stored = matched_labels.get(el.placeholder)
    if stored is not None:
        return m.label == stored
    matched_labels[el.placeholder] = m.label
    return True


def _check_orientation(m: BarbellMatch, el: PatternElement) -> bool:
    return el.orientation is None or el.orientation == m.strand


def _check_relative_position(
    m: BarbellMatch, el: PatternElement, prev_end: Optional[int], seq_len: int
) -> bool:
    if el.relative_to is None:
        return True
    m_start = m.read_start_bar
    m_end = m.read_end_bar
    lo, hi = el.range
    if el.relative_to == "left":
        return lo <= m_start <= hi
    if el.relative_to == "right":
        left_bound = seq_len - hi
        right_bound = seq_len - lo
        return left_bound <= m_end <= right_bound
    if el.relative_to == "prev_left":
        if prev_end is None:
            return True
        return prev_end + lo <= m_start <= prev_end + hi
    raise NotImplementedError(f"relative position {el.relative_to!r}")


def match_pattern(
    matches: List[BarbellMatch], pattern: Pattern
) -> Tuple[bool, List[Tuple[int, Cut]]]:
    """Greedy sequential match; returns (matched, [(match_idx, cut)])."""
    if len(matches) < len(pattern.elements):
        return False, []

    prev_end: Optional[int] = None
    matched_labels: Dict[int, str] = {}
    cut_positions: List[Tuple[int, Cut]] = []

    for idx, el in enumerate(pattern.elements):
        m = matches[idx]
        ok = (
            _check_type_and_label(m, el)
            and _check_placeholder(m, el, matched_labels)
            and _check_orientation(m, el)
            and _check_relative_position(m, el, prev_end, m.read_len)
        )
        if not ok:
            return False, []
        if el.cuts:
            for cut in el.cuts:
                cut_positions.append((idx, cut))
        prev_end = m.read_end_bar

    return True, cut_positions
