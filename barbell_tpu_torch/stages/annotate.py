"""Annotate stage: stream FASTQ reads through a demux engine to TSV.

Counterpart of :mod:`barbell_tpu.stages.annotate` with the backends
``torch`` (the batched device pipeline; ``device`` says where it runs)
and ``oracle`` (the scalar NumPy engine).  There is no automatic
fallback from one to the other.  The default scan is the whole read
(``ends_window`` None, the reference-parity default); each read's rows
stay contiguous in the output — filter/inspect group by consecutive
``read_id`` (reference `src/annotate/annotator.rs:103-119`).

Not ported (raises): multi-host record striping (``shard``) and the
profiler trace of ``BARBELL_PROFILE_DIR``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..models.barcodes import BarcodeGroup
from ..models.demux import Demuxer
from ..models.hittable import emit_tsv_lines
from ..models.pipeline import _NOT_PORTED, TorchDemuxEngine, engine_map_batches
from ..models.records import AnnotationWriter, BarcodeType
from ..models.twotier import EndsPlan, make_ends_engine
from ..ops.edit_model import get_edit_cut_off
from ..utils.fastx import split_fastq_header
from ..utils.fastx_native import iter_fastq_batches_auto
from ..utils.progress import ANNOTATE_METRICS, ProgressTracker

BACKENDS = ("torch", "oracle")


@dataclass
class AnnotateConfig:
    max_flank_errors: Optional[int] = None
    alpha: float = 0.4
    n_threads: int = 10  # batch-parallel on device; kept for CLI parity
    verbose: bool = False
    min_score: float = 0.2
    min_score_diff: float = 0.1
    use_extended: bool = False
    backend: str = "torch"  # 'torch' | 'oracle'
    batch_size: int = 2048
    # Multi-host record striping: (rank, world) — not ported.
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


def _torch_engine(groups: Sequence[BarcodeGroup], config: AnnotateConfig, device):
    """Device engine for the config: plain whole-read or ends scan, or
    the two-tier shallow+rescue engine when ``ends_window`` is an
    :class:`~barbell_tpu_torch.models.twotier.EndsPlan`."""
    kw = dict(
        alpha=config.alpha,
        min_score=config.min_score,
        min_score_diff=config.min_score_diff,
        device=device,
    )
    ew = config.ends_window
    if isinstance(ew, EndsPlan):
        return make_ends_engine(list(groups), ew, **kw)
    return TorchDemuxEngine(list(groups), ends_window=ew, **kw)


def make_engine(groups: Sequence[BarcodeGroup], config: AnnotateConfig,
                device="cuda"):
    if config.backend == "torch":
        return _torch_engine(groups, config, device)
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


def annotate(
    read_files: Sequence[str],
    out_file: str,
    query_groups: Sequence[BarcodeGroup],
    config: AnnotateConfig,
    device="cuda",
) -> None:
    if config.shard is not None:
        raise NotImplementedError(
            f"multi-host record striping (--shard-rank/--shard-world) is "
            f"{_NOT_PORTED}"
        )
    if os.environ.get("BARBELL_PROFILE_DIR"):
        raise NotImplementedError(f"BARBELL_PROFILE_DIR tracing is {_NOT_PORTED}")
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

    def batches():
        for batch in iter_fastq_batches_auto(read_files, config.batch_size):
            read_ids = [split_fastq_header(h)[0] for h, _s, _q in batch]
            seqs = [s for _h, s, _q in batch]
            yield read_ids, seqs

    # The device engine yields columnar HitTables (no per-hit Python
    # objects on the hot path); the oracle engine yields BarbellMatch
    # lists.  Both serialize to byte-identical TSV.
    table_mode = hasattr(engine, "demux_batch_table")
    method = "demux_batch_table" if table_mode else "demux_batch"

    with open(out_file, "w") as fh:
        writer = AnnotationWriter(fh)
        for read_ids, _seqs, out in engine_map_batches(
            engine, batches(), method=method
        ):
            if table_mode:
                writer.write_lines(emit_tsv_lines(out))
                found = int((out.rows_per_read() > 0).sum())
            else:
                rows = []
                found = 0
                for matches in out:
                    if matches:
                        found += 1
                        rows.extend(matches)
                writer.write_rows(rows)
            progress.add(0, len(read_ids))
            progress.add(1, found)
            progress.add(2, len(read_ids) - found)
            progress.refresh()
        writer.finish()
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
