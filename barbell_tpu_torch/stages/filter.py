"""Filter stage: keep reads whose annotations fully match a pattern.

Streams the annotation TSV grouped by consecutive ``read_id``.  A read
passes iff some pattern matches AND the longest matching pattern covers
*all* of the read's annotations; the winning pattern's cuts are written
into the matched rows' ``cuts`` column.  Reference
`src/filter/filter.rs:10-214`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from ..models.records import (
    AnnotationWriter,
    BarbellMatch,
    read_annotation_groups,
)
from ..utils.progress import FILTER_METRICS, ProgressTracker
from .pattern import Pattern, match_pattern, pattern_from_str, patterns_from_file


def check_filter_pass(annotations: List[BarbellMatch], patterns: Sequence[Pattern]) -> bool:
    """Mutates ``annotations`` in place (adds cuts); returns pass/fail.

    Cuts are written *before* the pass decision, so rows routed to the
    ``--dropped`` file can carry cut markers — this matches the
    reference exactly (`src/filter/filter.rs:201-213` mutates the
    group, then returns ``max_matches == annotations.len()``)."""
    max_matches = 0
    best_cut_positions = None
    for pattern in patterns:
        is_match, cut_positions = match_pattern(annotations, pattern)
        if is_match and len(pattern) > max_matches:
            max_matches = len(pattern)
            best_cut_positions = cut_positions

    if max_matches > 0 and best_cut_positions is not None:
        for cut_match_idx, cut in best_cut_positions:
            row = annotations[cut_match_idx]
            if row.cuts is not None:
                row.cuts.append((cut, cut_match_idx))
            else:
                row.cuts = [(cut, cut_match_idx)]

    return max_matches == len(annotations)


def filter_annotations(
    annotated_file: str,
    output_file: str,
    patterns: Sequence[Pattern],
    dropped_out_file: Optional[str] = None,
    verbose: bool = False,
) -> None:
    log_dir = os.path.dirname(output_file) or "."
    progress = ProgressTracker(
        FILTER_METRICS, step="filter" if verbose else None, log_dir=log_dir if verbose else None
    )

    with open(output_file, "w") as out_fh:
        writer = AnnotationWriter(out_fh)
        dropped_fh = open(dropped_out_file, "w") if dropped_out_file else None
        dropped_writer = AnnotationWriter(dropped_fh) if dropped_fh else None
        try:
            for _read_id, group in read_annotation_groups(annotated_file):
                progress.inc(0)
                if check_filter_pass(group, patterns):
                    progress.inc(1)
                    writer.write_rows(group)
                else:
                    progress.inc(2)
                    if dropped_writer is not None:
                        dropped_writer.write_rows(group)
                progress.refresh()
            writer.finish()
            if dropped_writer is not None:
                dropped_writer.finish()
        finally:
            if dropped_fh is not None:
                dropped_fh.close()
    progress.finish("reads")


def filter_from_pattern_str(
    annotated_file: str,
    pattern_str: str,
    output_file: str,
    dropped_out_file: Optional[str] = None,
    verbose: bool = False,
) -> None:
    filter_annotations(
        annotated_file,
        output_file,
        [pattern_from_str(pattern_str)],
        dropped_out_file,
        verbose,
    )


def filter_from_text_files(
    annotated_file: str,
    text_files: Sequence[str],
    output_file: str,
    dropped_out_file: Optional[str] = None,
    verbose: bool = False,
) -> None:
    if not text_files:
        raise ValueError("No filter pattern files provided")
    patterns: List[Pattern] = []
    for path in text_files:
        patterns.extend(patterns_from_file(path))
    if not patterns:
        raise ValueError("No filter patterns found")
    filter_annotations(annotated_file, output_file, patterns, dropped_out_file, verbose)
