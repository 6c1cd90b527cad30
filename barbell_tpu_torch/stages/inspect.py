"""Inspect stage: summarize per-read annotation structures.

Renders each read's annotation list into a canonical bucketized pattern
string (bucket 250bp default) and counts frequencies.  Position tags:
``@left`` for a first annotation on the left half; otherwise
``@prev_left`` vs ``@right`` by whichever anchor is nearer.  Reference
`src/inspect/inspect.rs:9-208`.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional

from ..models.records import BarbellMatch, Strand, read_annotation_groups


def bucket_position(pos: int, bucket_size: int) -> int:
    """Inclusive-upper-bound bucketing: 0..=250 -> 0, 251..=500 -> 250, ..."""
    return (max(0, pos - 1) // bucket_size) * bucket_size


def get_group_structure(group: List[BarbellMatch], bucket_size: int) -> str:
    if not group:
        return ""

    elements: List[str] = []
    prev_end: Optional[int] = None

    for annotation in group:
        start = annotation.read_start_bar
        end = annotation.read_end_bar

        if prev_end is not None:
            distance_to_prev = max(0, start - prev_end)
            distance_to_right = max(0, annotation.read_len - end)
            if distance_to_prev <= distance_to_right:
                gap_start = bucket_position(distance_to_prev, bucket_size)
                position_tag = f"@prev_left({gap_start}..{gap_start + bucket_size})"
            else:
                right_start = bucket_position(
                    max(0, annotation.read_len - end), bucket_size
                )
                right_end = (
                    bucket_position(max(0, annotation.read_len - start), bucket_size)
                    + bucket_size
                )
                position_tag = f"@right({right_start}..{right_end})"
        elif annotation.rel_dist_to_end > 0:
            start_bucket = bucket_position(start, bucket_size)
            position_tag = f"@left({start_bucket}..{start_bucket + bucket_size})"
        else:
            right_start = bucket_position(max(0, annotation.read_len - end), bucket_size)
            right_end = (
                bucket_position(max(0, annotation.read_len - start), bucket_size)
                + bucket_size
            )
            position_tag = f"@right({right_start}..{right_end})"

        if annotation.cuts:
            cut = ", <<" if annotation.strand == Strand.Fwd else ", >>"
        else:
            cut = ""

        ori = "fw" if annotation.strand == Strand.Fwd else "rc"
        elements.append(
            f"{annotation.match_type.as_str()}[{ori}, *{cut}, {position_tag}]"
        )
        prev_end = end

    return "__".join(elements)


# Reference `src/inspect/inspect.rs:120-131`: the printed top-N patterns
# color element types (Fflank light pink, Ftag dark pink, Rflank light
# blue, Rtag dark blue) while the underlying strings stay clean.  Color
# only on a tty, like the reference's `colored` crate.
_TYPE_COLORS = (
    ("Fflank", (255, 182, 193)),
    ("Ftag", (231, 84, 128)),
    ("Rflank", (173, 216, 230)),
    ("Rtag", (0, 0, 139)),
)


def colorize_pattern(pattern: str, force: bool = False) -> str:
    import sys as _sys

    if not force and not _sys.stdout.isatty():
        return pattern
    for name, (r, g, b) in _TYPE_COLORS:
        pattern = pattern.replace(
            name, f"\x1b[38;2;{r};{g};{b}m{name}\x1b[0m"
        )
    return pattern


def print_pattern_summary(pattern_count: Counter, top_n: int = 10) -> None:
    """Console top-N rendering shared by ``inspect`` and the fused kit
    runner (reference `src/inspect/inspect.rs:133-208`)."""
    print(f"Found {len(pattern_count)} unique patterns")
    ranked = sorted(pattern_count.items(), key=lambda kv: -kv[1])
    for i, (pattern, count) in enumerate(ranked[:top_n]):
        print(f"\tPattern {i + 1}: {count} occurrences")
        print(f"\t\t{colorize_pattern(pattern)}")
    print(f"Showed {min(top_n, len(ranked))} / {len(ranked)} patterns")


def inspect(
    annotated_file: str,
    top_n: int = 10,
    read_pattern_out: Optional[str] = None,
    bucket_size: int = 250,
) -> Counter:
    pattern_count: Counter = Counter()
    out_fh = open(read_pattern_out, "w") if read_pattern_out else None
    try:
        for read_id, group in read_annotation_groups(annotated_file):
            label = get_group_structure(group, bucket_size)
            if out_fh is not None:
                out_fh.write(f"{read_id}\t{label}\n")
            pattern_count[label] += 1
    finally:
        if out_fh is not None:
            out_fh.close()

    print_pattern_summary(pattern_count, top_n)
    return pattern_count
