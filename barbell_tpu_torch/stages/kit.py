"""One-shot kit pipeline on the port: annotate -> inspect -> filter ->
trim, fused per batch.

Counterpart of :func:`barbell_tpu.stages.kit.demux_using_kit` and its
streaming runner, with the port's engines: writes ``annotation.tsv``,
``pattern_per_read.tsv``, ``filtered.tsv`` and per-label trimmed
FASTQs, byte-identical to the JAX package's runner on the same input
(enforced by tests).  The kit's preset patterns fix a two-tier ends
plan (:func:`barbell_tpu.stages.kit.ends_plan_for_patterns`).

Not ported (raises): ``--full-scan`` / ``--use-extended`` (whole-read
scans) and the staged four-pass runner (``stream=False`` or
``verbose``, which writes per-stage logs).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from barbell_tpu.kits.database import get_kit_info
from barbell_tpu.kits.presets import preset_patterns
from barbell_tpu.models.barcodes import BarcodeGroup
from barbell_tpu.ops.edit_model import get_edit_cut_off
from barbell_tpu.stages.annotate import AnnotateConfig
from barbell_tpu.stages.kit import KitRunConfig, ends_plan_for_patterns
from barbell_tpu.stages.pattern import pattern_from_str
from barbell_tpu.stages.trim import LabelConfig

from ..models.pipeline import _NOT_PORTED

__all__ = ["KitRunConfig", "demux_using_kit", "kit_groups"]


def kit_groups(kit_name: str, max_flank_errors: Optional[int] = None):
    """The kit's barcode groups with their flank thresholds set (the
    edit cut-off of the flank's length unless ``max_flank_errors``)."""
    groups = BarcodeGroup.from_kit(kit_name, False)
    for g in groups:
        g.set_flank_threshold(
            max_flank_errors
            if max_flank_errors is not None
            else get_edit_cut_off(g.get_effective_len())
        )
    return groups


def demux_using_kit(fastq_files: Sequence[str], config: KitRunConfig,
                    device="cuda") -> None:
    if config.full_scan or config.use_extended:
        raise NotImplementedError(
            f"kit --full-scan / --use-extended (whole-read scan) is {_NOT_PORTED}"
        )
    if not config.stream or config.verbose:
        raise NotImplementedError(
            f"the staged kit runner (--no-stream / --verbose) is {_NOT_PORTED}"
        )
    os.makedirs(config.output_folder, exist_ok=True)

    kit_info = get_kit_info(config.kit_name)

    print("\nKit info")
    print(f"Kit name: {kit_info.name}")
    print(f"Kit type: {'Maximize' if config.maximize else 'Safe'}")
    for tmpl in kit_info.templates:
        print(f"Barcodes: {tmpl.barcodes.from_label} - {tmpl.barcodes.to_label}")

    annotate_config = AnnotateConfig(
        max_flank_errors=config.max_flank_errors,
        alpha=config.alpha,
        n_threads=config.threads,
        verbose=config.verbose,
        min_score=config.min_score,
        min_score_diff=config.min_score_diff,
        use_extended=config.use_extended,
        backend=config.backend,
        batch_size=config.batch_size,
    )

    wgroups = kit_groups(config.kit_name, config.max_flank_errors)
    wpats = [
        pattern_from_str(s)
        for s in preset_patterns(kit_info.pattern_class, config.maximize)
    ]
    plan = ends_plan_for_patterns(wpats, wgroups)
    if plan is None:
        raise NotImplementedError(
            f"this preset is not positionally bounded; its whole-read scan "
            f"is {_NOT_PORTED}"
        )
    annotate_config.ends_window = plan
    msg = (
        f"Ends-only scan: long reads ship their first/last "
        f"{plan.shallow[0]} bases"
    )
    if plan.deep:
        msg += (
            f" (+ deep {plan.deep[0]}-base left rescan for "
            f"chain-boundary reads)"
        )
    print(msg + " (preset windows are positional)")
    _demux_using_kit_streaming(
        fastq_files, config, kit_info, annotate_config, device
    )


def _demux_using_kit_streaming(
    fastq_files: Sequence[str],
    config: KitRunConfig,
    kit_info,
    annotate_config: AnnotateConfig,
    device,
) -> None:
    """Fused one-pass kit pipeline (the JAX package's streaming runner
    on the port's engine): every stage runs per batch while later
    batches' device calls are in flight, and the outputs are byte-
    identical to the staged four-pass runner.

    Grouping: a "run" merges annotation rows of same-id reads delimited
    only by a DIFFERENT-id read that itself has rows — exactly the
    consecutive-read_id row grouping the staged inspect/filter see in
    annotation.tsv.  Single-member runs (unique read ids) flush
    columnar; multi-member runs merge rows and take the object path."""
    from collections import Counter, deque

    from barbell_tpu.models.hittable import emit_tsv_lines
    from barbell_tpu.models.records import AnnotationWriter
    from barbell_tpu.stages.annotate import _apply_flank_threshold
    from barbell_tpu.stages.filter import check_filter_pass
    from barbell_tpu.stages.inspect import get_group_structure, print_pattern_summary
    from barbell_tpu.stages.kit_columnar import (
        CompiledPatterns,
        StructureLabeler,
        TableAdapter,
        batch_trim_plan,
        cut_strings,
        kit_slice_label,
        matches_for_rows,
        segment_table,
        trim_slices,
    )
    from barbell_tpu.stages.trim import (
        _ThreadedWriterPool,
        _WriterPool,
        process_read_and_anno,
    )
    from barbell_tpu.utils.fastx import split_fastq_header, validate_fastq_paths
    from barbell_tpu.utils.fastx_native import iter_fastq_batches_auto
    from barbell_tpu.utils.progress import TRIM_METRICS, ProgressTracker

    from ..models.pipeline import engine_map_batches
    from .annotate import make_engine

    out = config.output_folder
    groups = BarcodeGroup.from_kit(config.kit_name, config.use_extended)
    for i, group in enumerate(groups):
        print(f"{group.barcode_type.as_str()}: {i}")
        group.display(5)
    groups = _apply_flank_threshold(groups, annotate_config)
    engine = make_engine(groups, annotate_config, device)
    if not hasattr(engine, "demux_batch_table"):
        engine = TableAdapter(engine, groups)
    if hasattr(engine, "warm_deep"):
        # the deep tier runs once before the stream: a broken deep path
        # fails here, not at the first mid-stream rescue
        engine.warm_deep()

    pattern_strs = preset_patterns(kit_info.pattern_class, config.maximize)
    patterns = [pattern_from_str(p) for p in pattern_strs]
    label_config = LabelConfig(
        include_label=True,
        include_orientation=False,
        include_flank=False,
        sort_labels=False,
        only_side="left",
    )

    print("\nProcessing reads (fused annotate+inspect+filter+trim)...")
    validate_fastq_paths(fastq_files)

    meta_queue: deque = deque()  # per-batch (descs, quals)

    def batches():
        for batch in iter_fastq_batches_auto(fastq_files, config.batch_size):
            ids, descs, seqs, quals = [], [], [], []
            for h, s, q in batch:
                rid, desc = split_fastq_header(h)
                ids.append(rid)
                descs.append(desc)
                seqs.append(s)
                quals.append(q)
            meta_queue.append((descs, quals))
            yield ids, seqs

    progress = ProgressTracker(TRIM_METRICS)
    TOTAL, KEPT, SPLIT, FAILED = 0, 1, 2, 3
    pattern_count: Counter = Counter()
    bucket_size = 250
    labeler = StructureLabeler(bucket_size)
    cpats = CompiledPatterns(patterns, engine.labels)

    anno_fh = open(os.path.join(out, "annotation.tsv"), "w")
    anno_writer = AnnotationWriter(anno_fh)
    ppr_fh = open(os.path.join(out, "pattern_per_read.tsv"), "w")
    filt_fh = open(os.path.join(out, "filtered.tsv"), "w")
    filt_writer = AnnotationWriter(filt_fh)
    failed_fh = open(config.failed_out, "w") if config.failed_out else None
    n_threads = config.threads if config.gzip else 1
    if n_threads > 1:
        writers = _ThreadedWriterPool(out, config.gzip, n_threads)
    else:
        writers = _WriterPool(out, config.gzip)

    # One run in flight: members hold per member read-with-rows a
    # (table, seg_start, seg_len, label, win, passed, lines, rsf, ref,
    # row_labels, trim_plan) context; recs the run's FASTQ records.
    pend_id: Optional[str] = None
    pend_members: list = []
    pend_recs: list = []
    ppr_buf: list = []
    filt_buf: list = []
    # winning-pattern cut strings depend only on (pattern, row count)
    cut_str_cache: dict = {}

    def drain_bufs() -> None:
        if ppr_buf:
            ppr_fh.write("".join(ppr_buf))
            ppr_buf.clear()
        if filt_buf:
            filt_writer.write_lines(filt_buf)
            filt_buf.clear()

    # bound a run's buffered records (a malformed file of millions of
    # same-id records must not exhaust memory)
    _RUN_CAP = 100_000

    def write_trimmed(results, desc) -> None:
        if results:
            progress.inc(KEPT)
        else:
            progress.inc(FAILED)
            if failed_fh is not None:
                failed_fh.write(pend_id + "\n")
        if len(results) > 1:
            progress.inc(SPLIT)
        for tseq, tqual, grp, suffix in results:
            w = writers.get(grp)
            header = f"{pend_id}{suffix} {desc}" if desc else f"{pend_id}{suffix}"
            w.write_record(header.encode("ascii"), bytes(tseq), bytes(tqual))

    def flush_run() -> None:
        if pend_id is None or not pend_members:
            return
        if len(pend_members) > 1:
            # duplicate-id run: merge rows, object path (parity)
            drain_bufs()  # keep file order ahead of direct writes
            rows = []
            for member in pend_members:
                table, s, l = member[0], member[1], member[2]
                rows.extend(matches_for_rows(table, s, l))
            label = get_group_structure(rows, bucket_size)
            ppr_fh.write(f"{pend_id}\t{label}\n")
            pattern_count[label] += 1
            if not check_filter_pass(rows, patterns):
                return
            filt_writer.write_rows(rows)
            for desc, seq, qual in pend_recs:
                write_trimmed(
                    process_read_and_anno(
                        seq, qual, rows, label_config,
                        skip_trim=False, flip=False,
                    ),
                    desc,
                )
            return
        (table, s, l, label, win, passed, lines, rsf, ref_,
         row_labels, trim) = pend_members[0]
        ppr_buf.append(f"{pend_id}\t{label}\n")
        pattern_count[label] += 1
        if not passed:
            return
        cuts = cpats.cuts[win]
        cstrs = cut_str_cache.get((win, l))
        if cstrs is None:
            cstrs = cut_str_cache[(win, l)] = cut_strings(cuts, l)
        filt_buf.extend(line + cs for line, cs in zip(lines, cstrs))
        if trim is not None:
            # preset cut shape: bounds/label precomputed for the whole
            # batch (batch_trim_plan); en -1 = to record end
            st, en, lab = trim
            for desc, seq, qual in pend_recs:
                e = len(seq) if en < 0 else en
                if st >= e:
                    write_trimmed([], desc)
                else:
                    write_trimmed([(seq[st:e], qual[st:e], lab, "")], desc)
            return
        for desc, seq, qual in pend_recs:
            results = []
            for slice_count, (st, en, rows_idx) in enumerate(
                trim_slices(cuts, rsf, ref_, len(seq))
            ):
                if st >= en:
                    continue
                suffix = "" if slice_count == 0 else f"_{slice_count}"
                results.append(
                    (
                        seq[st:en],
                        qual[st:en],
                        kit_slice_label(rows_idx, row_labels),
                        suffix,
                    )
                )
            write_trimmed(results, desc)

    try:
        for ids, seqs, table in engine_map_batches(engine, batches()):
            descs, quals = meta_queue.popleft()
            lines = emit_tsv_lines(table)
            anno_writer.write_lines(lines)
            seg_start, seg_len = segment_table(table)
            slabels = labeler.labels(table, seg_start, seg_len)
            win, passed = cpats.match(table, seg_start, seg_len)
            seg_start_l = seg_start.tolist()
            seg_len_l = seg_len.tolist()
            win_l = win.tolist()
            passed_l = passed.tolist()
            tcols = table.cols
            rsf_l = tcols["rsf"].tolist()
            ref_l = tcols["ref"].tolist()
            tlabels = table.labels
            rowlab_l = [tlabels[k] for k in tcols["label"].tolist()]
            tplan = batch_trim_plan(cpats, table, seg_start, win, passed)
            progress.add(TOTAL, len(ids))
            for i, rid in enumerate(ids):
                l = seg_len_l[i]
                if l:
                    s = seg_start_l[i]
                    e = s + l
                    trim = (
                        (tplan[1][i], tplan[2][i], tplan[3][i])
                        if tplan is not None and tplan[0][i]
                        else None
                    )
                    member = (
                        table, s, l, slabels[i], win_l[i], passed_l[i],
                        lines[s:e], rsf_l[s:e], ref_l[s:e], rowlab_l[s:e],
                        trim,
                    )
                    if rid != pend_id:
                        flush_run()
                        pend_id = rid
                        pend_members = [member]
                        pend_recs = [(descs[i], seqs[i], quals[i])]
                    else:
                        pend_members.append(member)
                        pend_recs.append((descs[i], seqs[i], quals[i]))
                elif rid == pend_id:
                    # row-less record of the live run's id: trimmed with
                    # the run's annotations (the staged trim map does)
                    pend_recs.append((descs[i], seqs[i], quals[i]))
                # else: zero-match read — no annotation rows, so it
                # neither splits the run nor gets trimmed
                if len(pend_recs) >= _RUN_CAP:
                    progress.print_error(
                        f"warning: read id {pend_id!r} repeats over "
                        f"{_RUN_CAP} consecutive records; flushing early"
                    )
                    flush_run()
                    pend_id, pend_members, pend_recs = None, [], []
            drain_bufs()
            progress.refresh()
        flush_run()
        drain_bufs()
        anno_writer.finish()
        filt_writer.finish()
    finally:
        writers.close_all()
        for fh in (anno_fh, ppr_fh, filt_fh):
            fh.close()
        if failed_fh is not None:
            failed_fh.close()
    progress.finish("reads")

    print()
    print_pattern_summary(pattern_count, top_n=10)
    anno_path = os.path.join(out, "annotation.tsv")
    print(
        f"Want to see more patterns? Run: "
        f"`python -m barbell_tpu_torch inspect -i {anno_path} -n 100`"
    )

    print("\nDone!")
