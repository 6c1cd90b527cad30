"""Annotate stage: stream FASTQ reads through a demux engine to TSV.

Counterpart of :mod:`barbell_tpu.stages.annotate` with the backends
``torch`` (the batched device pipeline on ``device``; :func:`make_engine`
also takes the reads mesh ``devices``), ``auto`` (the same) and
``oracle`` (the scalar NumPy engine).  There is no fallback from one to the other: an engine that
cannot be built fails the run.  The default scan is the whole read
(``ends_window`` None, the reference-parity default); each read's rows
stay contiguous in the output — filter/inspect group by consecutive
``read_id`` (reference `src/annotate/annotator.rs:103-119`).

``config.shard = (rank, world)`` processes the records with
``stream_index % world == rank`` and writes a ``<out>.idx`` sidecar for
:func:`~barbell_tpu_torch.parallel.distributed.merge_annotation_shards`.
``BARBELL_PROFILE_DIR=<dir>`` records a ``torch.profiler`` trace of the
whole stream into ``dir``: the card's kernels, copies and runtime calls
(CPU ops on the CPU) and the program's spans on one timeline
(:func:`profile_trace`).
"""

from __future__ import annotations

import contextlib
import os
import sys
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence

from .. import timing
from ..models.barcodes import BarcodeGroup
from ..models.demux import Demuxer
from ..models.hittable import emit_tsv_lines
from ..models.pipeline import TorchDemuxEngine, engine_map_batches
from ..models.records import AnnotationWriter, BarcodeType
from ..models.twotier import EndsPlan, make_ends_engine
from ..ops.edit_model import get_edit_cut_off
from ..utils.fastx_native import iter_fastq_batches_auto
from ..utils.progress import ANNOTATE_METRICS, ProgressTracker

BACKENDS = ("auto", "torch", "oracle")


@dataclass
class AnnotateConfig:
    max_flank_errors: Optional[int] = None
    alpha: float = 0.4
    n_threads: int = 10  # batch-parallel on device; kept for CLI parity
    verbose: bool = False
    min_score: float = 0.2
    min_score_diff: float = 0.1
    use_extended: bool = False
    backend: str = "auto"  # 'auto' (= 'torch') | 'torch' | 'oracle'
    batch_size: int = 2048
    # Multi-host record striping: (rank, world) — this process handles
    # records with stream_index %% world == rank.
    shard: Optional[tuple] = None
    # Ends-only fast path (SURVEY §5.7): long reads ship only their
    # first/last W bases (full coverage up to W_l+W_r-halo-PADDING-1;
    # the middle of longer reads is not scanned).  Accepts an int
    # (symmetric W), a (W_left, W_right) pair, or a two-tier
    # models.twotier.EndsPlan.  None = whole-read scan (the
    # reference-parity default for annotate); the kit runner derives
    # the plan from its preset patterns.
    ends_window: object = None


def _apply_flank_threshold(groups: Sequence[BarcodeGroup], config: AnnotateConfig):
    for group in groups:
        if config.max_flank_errors is not None:
            group.set_flank_threshold(config.max_flank_errors)
        else:
            k = get_edit_cut_off(group.get_effective_len())
            print(f"Auto edit flank cut off: {k}")
            group.set_flank_threshold(k)
    return groups


def _torch_engine(groups: Sequence[BarcodeGroup], config: AnnotateConfig,
                  device, devices=None):
    """Device engine for the config: plain whole-read or ends scan, or
    the two-tier shallow+rescue engine when ``ends_window`` is an
    :class:`~barbell_tpu_torch.models.twotier.EndsPlan`."""
    kw = dict(
        alpha=config.alpha,
        min_score=config.min_score,
        min_score_diff=config.min_score_diff,
        device=device,
        devices=devices,
    )
    ew = config.ends_window
    if isinstance(ew, EndsPlan):
        return make_ends_engine(list(groups), ew, **kw)
    return TorchDemuxEngine(list(groups), ends_window=ew, **kw)


def make_engine(groups: Sequence[BarcodeGroup], config: AnnotateConfig,
                device="cuda", devices=None):
    if config.backend in ("auto", "torch"):
        return _torch_engine(groups, config, device, devices)
    if config.backend == "oracle":
        return _OracleEngine(groups, config)
    raise ValueError(
        f"Unknown backend {config.backend!r}; choose one of {', '.join(BACKENDS)}"
    )


class _OracleEngine:
    """Batch adapter over the scalar Demuxer."""

    def __init__(self, groups: Sequence[BarcodeGroup], config: AnnotateConfig):
        self._demuxer = Demuxer(
            alpha=config.alpha,
            verbose=config.verbose,
            min_score=config.min_score,
            min_score_diff=config.min_score_diff,
        )
        for group in groups:
            self._demuxer.add_query_group(group)

    def demux_batch(self, read_ids: List[str], seqs: List[bytes]):
        return [
            self._demuxer.demux(read_id, seq) for read_id, seq in zip(read_ids, seqs)
        ]


@contextlib.contextmanager
def profile_trace(engine, name: str):
    """``BARBELL_PROFILE_DIR=<dir>``: a torch.profiler trace of the block
    with the program's spans (:mod:`~barbell_tpu_torch.timing`: the
    runner's stages, the engine's phases and calls in flight, graph
    captures) on the profiler's clock, written as
    ``<dir>/<name>.<pid>.trace.json`` (Chrome trace format) when the
    block ends.  On a card the profiler records CUDA activity alone
    (kernels, copies and the runtime calls that issue them), which keeps
    the trace of a long run small; on the CPU, CPU ops.  A profiler that
    cannot start, or a trace that cannot be written, costs one line on
    stderr, not the run."""
    profile_dir = os.environ.get("BARBELL_PROFILE_DIR")
    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        on_card = any(d.type == "cuda" for d in getattr(engine, "devices", ()))
        acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
        try:
            os.makedirs(profile_dir, exist_ok=True)
            prof = profile(activities=acts)
            prof.start()
        except Exception as exc:  # noqa: BLE001 - the trace is optional, the run is not
            print(f"BARBELL_PROFILE_DIR: profiler did not start ({exc}); "
                  f"running without a trace", file=sys.stderr)
            prof = None
    if prof is not None:
        was_on, timing.ENABLED = timing.ENABLED, True
        anchor = timing.keep_intervals()
    try:
        yield
    finally:
        if prof is not None:
            kept = timing.stop_keeping()
            timing.ENABLED = was_on
            try:
                prof.stop()
                path = os.path.join(profile_dir, f"{name}.{os.getpid()}.trace.json")
                prof.export_chrome_trace(path)
                timing.add_to_chrome_trace(path, kept, anchor)
            except Exception as exc:  # noqa: BLE001 - as above
                print(f"BARBELL_PROFILE_DIR: trace not written ({exc})",
                      file=sys.stderr)


def annotate(
    read_files: Sequence[str],
    out_file: str,
    query_groups: Sequence[BarcodeGroup],
    config: AnnotateConfig,
    device="cuda",
) -> None:
    for i, group in enumerate(query_groups):
        print(f"{group.barcode_type.as_str()}: {i}")
        group.display(5)

    engine = make_engine(query_groups, config, device)

    log_dir = os.path.dirname(out_file) or "."
    progress = ProgressTracker(
        ANNOTATE_METRICS,
        step="annotate" if config.verbose else None,
        log_dir=log_dir if config.verbose else None,
    )

    shard = config.shard
    # Sharded runs also write a ``<out>.idx`` sidecar of
    # ``stream_index<TAB>n_rows`` per processed read, so the merge can
    # interleave shards back into the exact single-host read order
    # (reads with zero annotation rows would otherwise desynchronize a
    # row-count-based merge).
    idx_queue: deque = deque()

    def batches():
        if shard is None:
            for batch in iter_fastq_batches_auto(read_files, config.batch_size):
                yield batch.ids, batch.seqs
            return
        rank, world = shard
        idx = 0
        read_ids: list = []
        seqs: list = []
        idxs: list = []
        for batch in iter_fastq_batches_auto(read_files, config.batch_size):
            for rid, s in zip(batch.ids, batch.seqs):
                if idx % world == rank:
                    read_ids.append(rid)
                    seqs.append(s)
                    idxs.append(idx)
                    if len(read_ids) >= config.batch_size:
                        idx_queue.append(idxs)
                        yield read_ids, seqs
                        read_ids, seqs, idxs = [], [], []
                idx += 1
        if read_ids:
            idx_queue.append(idxs)
            yield read_ids, seqs

    # The device engine yields columnar HitTables (no per-hit Python
    # objects on the hot path); the oracle engine yields BarbellMatch
    # lists.  Both serialize to byte-identical TSV.
    table_mode = hasattr(engine, "demux_batch_table")
    method = "demux_batch_table" if table_mode else "demux_batch"

    sidecar = open(out_file + ".idx", "w") if shard is not None else None
    try:
        # the trace covers the whole annotate stream
        with profile_trace(engine, "annotate"), open(out_file, "w") as fh:
            writer = AnnotationWriter(fh)
            for read_ids, _seqs, out in engine_map_batches(
                engine, batches(), method=method
            ):
                if table_mode:
                    writer.write_lines(emit_tsv_lines(out))
                    counts = out.rows_per_read().tolist()
                else:
                    rows = []
                    counts = []
                    for matches in out:
                        counts.append(len(matches))
                        rows.extend(matches)
                    writer.write_rows(rows)
                found = sum(c > 0 for c in counts)
                if sidecar is not None:
                    # one block write per batch (per-read writes are GIL
                    # time on the pipelined host path)
                    sidecar.write("".join(
                        f"{si}\t{c}\n"
                        for si, c in zip(idx_queue.popleft(), counts)
                    ))
                progress.add(0, len(read_ids))
                progress.add(1, found)
                progress.add(2, len(read_ids) - found)
                progress.refresh()
            writer.finish()
    finally:
        if sidecar is not None:
            sidecar.close()
    progress.finish("records")


def annotate_with_kit(
    read_files: Sequence[str], out_file: str, kit: str, config: AnnotateConfig,
    device="cuda",
) -> None:
    groups = BarcodeGroup.from_kit(kit, config.use_extended)
    annotate(read_files, out_file, _apply_flank_threshold(groups, config), config,
             device)


def annotate_with_files(
    read_files: Sequence[str],
    query_files: Sequence[str],
    query_types: Sequence[BarcodeType],
    out_file: str,
    config: AnnotateConfig,
    device="cuda",
) -> None:
    if len(query_files) != len(query_types):
        raise ValueError(
            f"Expected the same number of query files and barcode types, got "
            f"{len(query_files)} query file(s) and {len(query_types)} barcode type(s)"
        )
    groups = [
        BarcodeGroup.from_fasta(path, qtype)
        for path, qtype in zip(query_files, query_types)
    ]
    annotate(read_files, out_file, _apply_flank_threshold(groups, config), config,
             device)


def annotate_with_groups(
    read_files: Sequence[str],
    out_file: str,
    query_groups: Sequence[BarcodeGroup],
    config: AnnotateConfig,
    device="cuda",
) -> None:
    annotate(read_files, out_file, _apply_flank_threshold(query_groups, config),
             config, device)
