"""Trim stage: slice reads at filter-assigned cut positions and write
per-sample FASTQ files.

Cut pairing semantics (reference `src/trim/trim.rs:127-248`):
cuts are grouped by their group id; a 2-cut group yields an explicit
slice (Before -> flank start, After -> flank end); a 1-cut group extends
to the neighbouring group's boundary or the read end.  ``--flip``
reverse-complements a slice when any Ftag matched on the Rc strand.
Multi-slice reads get ``_N`` read-id suffixes.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..models.records import (
    BarbellMatch,
    BarcodeType,
    CutDirection,
    Strand,
    read_annotations,
)
from ..utils import dna
from ..utils.fastx import validate_fastq_paths
from ..utils.fastx_native import iter_fastq_batches_auto
from ..utils.progress import TRIM_METRICS, ProgressTracker

TOTAL_IDX, TRIMMED_IDX, TRIMMED_SPLIT_IDX, FAILED_IDX = 0, 1, 2, 3


class LabelConfig:
    """Builds the output-file label from a slice's annotations.

    Reference `src/trim/trim.rs:31-105`.
    """

    def __init__(
        self,
        include_label: bool = True,
        include_orientation: bool = True,
        include_flank: bool = True,
        sort_labels: bool = False,
        only_side: Optional[str] = None,  # 'left' | 'right'
    ):
        self.include_label = include_label
        self.include_orientation = include_orientation
        self.include_flank = include_flank
        self.sort_labels = sort_labels
        self.only_side = only_side

    def create_label(self, annotations: Sequence[BarbellMatch]) -> str:
        if not self.include_label:
            return "none"
        if self.sort_labels and self.only_side is not None:
            raise ValueError(
                "Cannot enable only keeping left label and sorting as this makes it ambiguous"
            )

        parts: List[str] = []
        for m in annotations:
            label = m.label
            # Skip flank pseudo-labels when flanks are excluded.
            if not self.include_flank and "flank" in label:
                continue
            if self.include_orientation:
                ori = "fw" if m.strand == Strand.Fwd else "rc"
                label = f"{label}_{ori}"
            parts.append(label)

        if not parts:
            return "none"
        if self.sort_labels:
            return "__".join(sorted(parts))
        if self.only_side is not None:
            return parts[0] if self.only_side == "left" else parts[-1]
        return "__".join(parts)


def preprocess_cuts(
    annotations: Sequence[BarbellMatch], seq_len: int
) -> List[Tuple[int, int, List[BarbellMatch]]]:
    """Resolve cut markers into (start, end, slice_annotations) slices."""
    # Group cuts by group id: id -> [(flank_start, flank_end, cut, anno)]
    cut_groups: Dict[int, List[Tuple[int, int, object, BarbellMatch]]] = {}
    for anno in annotations:
        if anno.cuts:
            for cut, _pos in anno.cuts:
                cut_groups.setdefault(cut.group_id, []).append(
                    (anno.read_start_flank, anno.read_end_flank, cut, anno)
                )

    # Sort groups by their first member's flank start (stable).
    sorted_groups = sorted(
        cut_groups.items(),
        key=lambda kv: kv[1][0][0] if kv[1] else 2**63,
    )

    slices: List[Tuple[int, int, List[BarbellMatch]]] = []
    for i, (_gid, group) in enumerate(sorted_groups):
        if len(group) == 2:
            g1, g2 = group
            start = g1[0] if g1[2].direction == CutDirection.Before else g1[1]
            end = g2[0] if g2[2].direction == CutDirection.Before else g2[1]
            slices.append((start, end, [g1[3], g2[3]]))
        elif len(group) == 1:
            fstart, fend, cut, anno = group[0]
            if cut.direction == CutDirection.Before:
                # Extend left to the previous group's furthest flank end.
                if i > 0:
                    prev_group = sorted_groups[i - 1][1]
                    best = max(prev_group, key=lambda t: t[1])
                    slice_start, left_anno = best[1], best[3]
                else:
                    slice_start, left_anno = 0, None
                annos = ([left_anno] if left_anno is not None else []) + [anno]
                slices.append((slice_start, fstart, annos))
            else:  # After
                if i < len(sorted_groups) - 1:
                    next_group = sorted_groups[i + 1][1]
                    best = min(next_group, key=lambda t: t[0])
                    slice_end, right_anno = best[0], best[3]
                else:
                    slice_end, right_anno = seq_len, None
                annos = [anno] + ([right_anno] if right_anno is not None else [])
                slices.append((fend, slice_end, annos))
        # groups with >2 cuts are ignored (reference behaviour)
    return slices


def should_flip(annotations: Sequence[BarbellMatch]) -> bool:
    return any(
        a.match_type == BarcodeType.Ftag and a.strand == Strand.Rc
        for a in annotations
    )


def process_read_and_anno(
    seq: bytes,
    qual: bytes,
    annotations: Sequence[BarbellMatch],
    label_config: LabelConfig,
    skip_trim: bool = False,
    flip: bool = False,
) -> List[Tuple[bytes, bytes, str, str]]:
    """Returns [(trimmed_seq, trimmed_qual, group_label, read_suffix)]."""
    results = []
    slices = preprocess_cuts(annotations, len(seq))
    # slice_count enumerates ALL slices including skipped empty ones —
    # reference parity (`trim.rs:265-268` enumerates before the
    # start>=end continue), so a read whose FIRST slice is empty emits
    # only `_N`-suffixed records, exactly like the reference.
    for slice_count, (start, end, slice_annos) in enumerate(slices):
        if start >= end:
            continue
        if skip_trim:
            trimmed_seq, trimmed_qual = seq, qual
        else:
            trimmed_seq, trimmed_qual = seq[start:end], qual[start:end]
        if flip and should_flip(slice_annos):
            trimmed_seq = dna.reverse_complement_bytes(trimmed_seq)
            trimmed_qual = trimmed_qual[::-1]
        group_label = label_config.create_label(slice_annos)
        read_suffix = "" if slice_count == 0 else f"_{slice_count}"
        results.append((trimmed_seq, trimmed_qual, group_label, read_suffix))
    return results


class _PyWriter:
    def __init__(self, path: str, use_gzip: bool):
        try:
            self._fh = (
                gzip.open(path, "wb", compresslevel=6) if use_gzip else open(path, "wb")
            )
        except OSError as err:
            raise _file_error(path, err)

    def write_record(self, header: bytes, seq: bytes, qual: bytes) -> None:
        self._fh.write(b"@" + header + b"\n" + seq + b"\n+\n" + qual + b"\n")

    def write_block(self, block: bytes) -> None:
        self._fh.write(block)

    def close(self) -> None:
        self._fh.close()


class _WriterPool:
    """Lazy per-label FASTQ writers; native (C++/zlib) when available."""

    def __init__(self, output_folder: str, use_gzip: bool):
        self.output_folder = output_folder
        self.use_gzip = use_gzip
        self._writers: Dict[str, object] = {}
        from ..utils import fastx_native

        self._native = fastx_native.native_available()
        self._native_cls = fastx_native.NativeFastqWriter if self._native else None

    def get(self, group: str):
        w = self._writers.get(group)
        if w is None:
            suffix = ".trimmed.fastq.gz" if self.use_gzip else ".trimmed.fastq"
            path = os.path.join(self.output_folder, f"{group}{suffix}")
            if self._native:
                try:
                    w = self._native_cls(path, gzip_level=6 if self.use_gzip else 0)
                except OSError as err:
                    raise _file_error(path, err)
            else:
                w = _PyWriter(path, self.use_gzip)
            self._writers[group] = w
        return w

    def close_all(self):
        for w in self._writers.values():
            w.close()


def _file_error(path: str, err: OSError) -> OSError:
    msg = f"Failed to create output file '{path}': {err}"
    if err.errno == 24:  # EMFILE
        msg += '\nTry setting ulimit higher: "ulimit -n 65000"'
    return OSError(msg)


class _ThreadedWriterPool:
    """Fan per-label writes out to worker threads (gzip compression is
    the trim bottleneck on 96-plex runs; zlib releases the GIL).

    Labels shard to workers by stable hash, so every file is written by
    exactly one worker in arrival order — output bytes are identical to
    the single-threaded pool.  Worker errors re-raise on close."""

    def __init__(self, output_folder: str, use_gzip: bool, n_threads: int):
        import queue
        import threading

        self._pools = [
            _WriterPool(output_folder, use_gzip) for _ in range(n_threads)
        ]
        self._queues = [queue.Queue(maxsize=4096) for _ in range(n_threads)]
        self._errors: list = []
        self._threads = []
        for i in range(n_threads):
            t = threading.Thread(
                target=self._worker, args=(i,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _shard(self, group: str) -> int:
        # stable across processes (hash() is salted)
        return sum(group.encode()) % len(self._queues)

    def _worker(self, i: int) -> None:
        pool = self._pools[i]
        q = self._queues[i]
        while True:
            item = q.get()
            if item is None:
                return
            try:
                if len(item) == 2:
                    pool.get(item[0]).write_block(item[1])
                else:
                    pool.get(item[0]).write_record(item[1], item[2], item[3])
            except BaseException as exc:  # propagate on close
                self._errors.append(exc)
                # Keep draining (discarding) so a producer blocked on a
                # full queue — and close_all's sentinel put — never
                # deadlock against a dead worker.
                while q.get() is not None:
                    pass
                return

    def get(self, group: str):
        return _ThreadedHandle(self, group)

    def write(self, group, header, seq, qual):
        if self._errors:
            raise self._errors[0]
        self._queues[self._shard(group)].put((group, header, seq, qual))

    def write_block(self, group, block):
        if self._errors:
            raise self._errors[0]
        self._queues[self._shard(group)].put((group, block))

    def close_all(self):
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join()
        for pool in self._pools:
            pool.close_all()
        if self._errors:
            raise self._errors[0]


class _ThreadedHandle:
    """Adapter matching the plain pool's ``get(group).write_record`` and
    ``write_block``."""

    def __init__(self, pool: "_ThreadedWriterPool", group: str):
        self._pool = pool
        self._group = group

    def write_record(self, header: bytes, seq: bytes, qual: bytes) -> None:
        self._pool.write(self._group, header, seq, qual)

    def write_block(self, block: bytes) -> None:
        self._pool.write_block(self._group, block)


def trim_matches(
    filtered_match_file: str,
    read_fastq_files: Sequence[str],
    output_folder: str,
    label_config: Optional[LabelConfig] = None,
    failed_out: Optional[str] = None,
    write_full_header: bool = True,
    skip_trim: bool = False,
    flip: bool = False,
    verbose: bool = False,
    use_gzip: bool = False,
    threads: int = 1,
) -> None:
    os.makedirs(output_folder, exist_ok=True)
    label_config = label_config or LabelConfig()
    if label_config.sort_labels and label_config.only_side is not None:
        raise ValueError(
            "Cannot enable only keeping left/right label and sorting; this is ambiguous"
        )

    progress = ProgressTracker(
        TRIM_METRICS,
        step="trim" if verbose else None,
        log_dir=output_folder if verbose else None,
    )

    annotations_by_read: Dict[str, List[BarbellMatch]] = {}
    for anno in read_annotations(filtered_match_file):
        annotations_by_read.setdefault(anno.read_id, []).append(anno)

    failed_fh = open(failed_out, "w") if failed_out else None
    if threads > 1:
        writers = _ThreadedWriterPool(output_folder, use_gzip, threads)
    else:
        writers = _WriterPool(output_folder, use_gzip)
    try:
        validate_fastq_paths(read_fastq_files)
        # batched native reader (GIL-free parse + gzip) when available
        records = (
            rec
            for b in iter_fastq_batches_auto(read_fastq_files, 2048)
            for rec in zip(b.ids, b.descs, b.seqs, b.quals)
        )
        for read_id, desc, seq, qual in records:
            progress.inc(TOTAL_IDX)
            annos = annotations_by_read.get(read_id)
            if annos is not None:
                results = process_read_and_anno(
                    seq, qual, annos, label_config, skip_trim, flip
                )
                if results:
                    progress.inc(TRIMMED_IDX)
                else:
                    progress.inc(FAILED_IDX)
                    if failed_fh is not None:
                        failed_fh.write(read_id + "\n")
                if len(results) > 1:
                    progress.inc(TRIMMED_SPLIT_IDX)

                for trimmed_seq, trimmed_qual, group, read_suffix in results:
                    w = writers.get(group)
                    if write_full_header and desc:
                        header = f"{read_id}{read_suffix} {desc}"
                    else:
                        header = f"{read_id}{read_suffix}"
                    w.write_record(
                        header.encode("ascii"), bytes(trimmed_seq), bytes(trimmed_qual)
                    )
            progress.refresh()
    finally:
        writers.close_all()
        if failed_fh is not None:
            failed_fh.close()
    progress.finish("reads")
