"""Built-in filter pattern presets per kit class.

'safe' presets only accept unambiguous constructs; 'maximize' adds
riskier patterns to rescue more reads.  Reference
`src/kits/kits.rs:175-236`.  Patterns are grammar strings parsed by
:mod:`barbell_tpu.stages.pattern`.
"""

from __future__ import annotations

from typing import List

SINGLE_SAFE: List[str] = [
    # Single barcode on the left.
    "Ftag[fw, *, @left(0..250), >>]",
    # Double barcode on the left with identical labels (within-sample ligation).
    "Ftag[fw, ?1, @left(0..250)]__Ftag[fw, ?1, @prev_left(0..250), >>]",
]

SINGLE_MAXIMIZE: List[str] = SINGLE_SAFE + [
    # Ignores that both left labels should be identical; uses the left one.
    "Ftag[fw, *, @left(0..250)]__Ftag[fw, *, @prev_left(0..250), >>]",
    # Unexpected barcode on the right; still trust the left assignment.
    "Ftag[fw, *, @left(0..250), >>]__Ftag[<<, fw, *, @right(0..250)]",
    # Same plus a double-left.
    "Ftag[fw, *, @left(0..250)]__Ftag[fw, *, @prev_left(0..250), >>]__Ftag[<<, fw, *, @right(0..250)]",
]

DOUBLE_SAFE: List[str] = [
    # Single barcode on the left.
    "Ftag[fw, *, @left(0..250), >>]",
    # Single barcode on the right.
    "Ftag[<<, rc, *, @right(0..250)]",
    # Both ends, identical labels.
    "Ftag[fw, ?1, @left(0..250), >>]__Ftag[<<, rc, ?1, @right(0..250)]",
]

DOUBLE_MAXIMIZE: List[str] = DOUBLE_SAFE + [
    # Extra barcode on the left; the two inner barcodes must agree.
    "Ftag[fw, *, @left(0..250)]__Ftag[fw, ?1, @prev_left(0..250), >>]__Ftag[<<, rc, ?1, @right(0..250)]",
    # Barcode left + bare flank right (can't disprove agreement).
    "Ftag[fw, *, @left(0..250), >>]__Fflank[<<, rc, *, @right(0..250)]",
    # Flipped version of the above.
    "Fflank[fw, *, @left(0..250), >>]__Ftag[<<, rc, *, @right(0..250)]",
    # Two barcodes on the left.
    "Ftag[fw, *, @left(0..250)]__Ftag[fw, *, @prev_left(0..250), >>]",
    # Chimeric: double Ftag on the right.
    "Ftag[fw, ?1, @left(0..250), >>]__Ftag[<<, fw, ?1, @right(0..250)]__Ftag[rc, *, @right(0..250)]",
    # Triple barcode on the left; inner pair must agree.
    "Ftag[fw, *, @left(0..250)]__Ftag[rc, *, @prev_left(0..250)]__Ftag[fw, ?1, @prev_left(0..250), >>]__Ftag[<<, rc, ?1, @right(0..250)]",
]


def preset_patterns(pattern_class: str, maximize: bool) -> List[str]:
    if pattern_class == "single":
        return SINGLE_MAXIMIZE if maximize else SINGLE_SAFE
    if pattern_class == "double":
        return DOUBLE_MAXIMIZE if maximize else DOUBLE_SAFE
    raise ValueError(f"Unknown pattern class: {pattern_class!r}")
