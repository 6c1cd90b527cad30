"""Accuracy evaluation harness over simulated read classes.

The counterpart of the reference's tool-comparison crate: runs the kit
pipeline over each simulated group, normalizes the per-read assignment
(read_id -> label), verifies it against ground truth, and — like the
reference's independent re-checker — re-validates assigned reads with a
direct oracle flank+barcode search that is independent of the pipeline
under test.

Expected outcomes per class (reference benchmarks/data/README.md):
GroupII fully recovered; GroupI/IV/V/VI rejected; GroupIII best-effort.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..kits.database import RBK4_FRONT, RBK4_REAR, lookup_barcode_seq
from ..ops import oracle
from ..ops.edit_model import get_edit_cut_off
from ..utils import dna
from ..utils.fastx import iter_fastq, split_fastq_header


@dataclass
class GroupReport:
    group: str
    total_reads: int = 0
    assigned: int = 0
    correct: int = 0
    verified: int = 0
    checked: int = 0  # how many assignments the --verify re-check sampled
    wall_s: Optional[float] = None  # kit-pipeline wall clock (--time)

    @property
    def assign_rate(self) -> float:
        return self.assigned / self.total_reads if self.total_reads else 0.0

    @property
    def accuracy(self) -> float:
        return self.correct / self.assigned if self.assigned else 0.0

    @property
    def reads_per_sec(self) -> Optional[float]:
        if self.wall_s is None or self.wall_s <= 0:
            return None
        return self.total_reads / self.wall_s


def read_truth(path: str) -> Dict[str, str]:
    truth = {}
    if os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line:
                    rid, _, label = line.partition("\t")
                    truth[rid] = label
    return truth


def assignments_from_trimmed(out_dir: str) -> Dict[str, str]:
    """read_id -> label from the per-label trimmed FASTQ outputs."""
    assigned: Dict[str, str] = {}
    for fname in sorted(os.listdir(out_dir)):
        for suffix in (".trimmed.fastq", ".trimmed.fastq.gz"):
            if fname.endswith(suffix):
                label = fname[: -len(suffix)]
                for header, _seq, _q in iter_fastq([os.path.join(out_dir, fname)]):
                    assigned[split_fastq_header(header)[0]] = label
    return assigned


def verify_context(kit: Optional[str] = None) -> List[Tuple]:
    """[(flank_masks, flank_k)] per query group of ``kit`` (RBK4 rapid
    flanks when no kit is given) for :func:`independent_check` — built
    once per evaluation, not per read."""
    if kit is None:
        flank = (RBK4_FRONT + "N" * 24 + RBK4_REAR).encode()
        k = get_edit_cut_off(len(RBK4_FRONT) + len(RBK4_REAR))
        return [(dna.encode(flank), k)]
    from ..models.barcodes import BarcodeGroup

    ctx = []
    for g in BarcodeGroup.from_kit(kit):
        ctx.append((dna.encode(g.flank), get_edit_cut_off(g.get_effective_len())))
    return ctx


def independent_check(
    seq: bytes, label: str, ctx: Optional[List[Tuple]] = None
) -> bool:
    """Re-verify an assignment with a direct search, independent of the
    pipeline: some query group's flank must hit (either strand) and the
    assigned barcode must sit in the flank neighbourhood within its own
    edit budget.  ``ctx`` carries the kit's flanks (``verify_context``);
    default is the RBK4 rapid flank."""
    if ctx is None:
        ctx = verify_context(None)
    try:
        bar_seq = lookup_barcode_seq(label)
    except ValueError:
        # labels with no numeric part (e.g. flank-only "none" outputs)
        bar_seq = None
    if bar_seq is None:
        return False
    bar_masks = dna.encode(bar_seq.encode())
    bar_k = max(1, int(len(bar_seq) * 0.25))

    text = dna.encode(seq)
    for masks in (text, dna.reverse_complement_masks(text)):
        for flank_masks, flank_k in ctx:
            flank_hits = oracle.search(flank_masks, masks, flank_k, alpha=0.4)
            for fm in flank_hits:
                lo = max(0, fm.text_start)
                hi = min(len(masks), fm.text_end)
                window = masks[lo:hi]
                if len(window) == 0:
                    continue
                if oracle.search(bar_masks, window, bar_k):
                    return True
    return False


def score_assignments(
    report: GroupReport,
    assigned: Dict[str, str],
    truth: Dict[str, str],
    ids: set,
    seqs: Optional[Dict[str, bytes]] = None,
    verify: bool = False,
    verify_limit: int = 50,
    ctx: Optional[List[Tuple]] = None,
) -> GroupReport:
    """Score a read_id -> label assignment table against ground truth;
    shared by the pipeline evaluation and tool-output imports."""
    # Collapse multi-slice outputs (``_N`` read-id suffixes) onto their
    # base read: each input read counts at most once toward assigned /
    # correct, and the PRIMARY (unsuffixed) slice's label wins over any
    # ``_N`` slice regardless of which label file sorts first.
    by_read: Dict[str, str] = {}
    deferred: List[Tuple[str, int, str]] = []
    for rid, label in assigned.items():
        if rid in ids:
            by_read[rid] = label
        else:
            base, _, tail = rid.rpartition("_")
            if tail.isdigit() and base in ids:
                deferred.append((base, int(tail), label))
    for base, _n, label in sorted(deferred, key=lambda t: (t[0], t[1])):
        by_read.setdefault(base, label)

    for rid, label in by_read.items():
        report.assigned += 1
        if truth.get(rid) == label:
            report.correct += 1
        if verify and report.checked < verify_limit:
            if independent_check(seqs[rid], label, ctx):
                report.verified += 1
            report.checked += 1
    return report


def evaluate_group(
    group: str,
    fastq_path: str,
    truth_path: str,
    out_dir: str,
    verify: bool = False,
    verify_limit: int = 50,
    kit: Optional[str] = None,
) -> GroupReport:
    truth = read_truth(truth_path)
    assigned = assignments_from_trimmed(out_dir)
    report = GroupReport(group=group)

    # sequences are only needed for --verify re-searching; otherwise a
    # set of ids suffices (don't hold the whole FASTQ in memory)
    ids: set = set()
    seqs: Dict[str, bytes] = {}
    for header, seq, _q in iter_fastq([fastq_path]):
        rid = split_fastq_header(header)[0]
        report.total_reads += 1
        ids.add(rid)
        if verify:
            seqs[rid] = seq

    ctx = verify_context(kit) if verify else None
    return score_assignments(
        report, assigned, truth, ids, seqs, verify, verify_limit, ctx
    )


def run_import_compare(
    tool: str,
    import_path: str,
    truth_path: str,
    reads_path: Optional[str] = None,
    bar_file: Optional[str] = None,
    normalized_out: Optional[str] = None,
    trimmed_out: Optional[str] = None,
    verify: bool = False,
    verify_limit: int = 50,
    kit: Optional[str] = None,
) -> GroupReport:
    """Score another tool's demux output against ground truth — the
    importer half of the reference's comparison harness
    (`benchmarks/src/compare/compare.rs:51-73,97-421`): normalize the
    tool's layout to ``read_id\\tbarcode\\tlen\\tn_flank_matches``
    (independent construct re-count included when sequences are
    available) and evaluate assigned/correct/verified rates."""
    import tempfile

    from . import ingest

    if verify and not reads_path:
        raise ValueError(
            "--verify on an import needs --reads (the original FASTQ) "
            "to re-search sequences"
        )
    truth = read_truth(truth_path)
    report = GroupReport(group=f"import:{tool}")

    # The input read universe: the original FASTQ when given (defines
    # total_reads exactly), else the truth table's ids.
    ids: set = set()
    seqs: Dict[str, bytes] = {}
    if reads_path:
        for header, seq, _q in iter_fastq([reads_path]):
            rid = split_fastq_header(header)[0]
            report.total_reads += 1
            ids.add(rid)
            seqs[rid] = seq
    else:
        ids = set(truth)
        report.total_reads = len(ids)

    records = ingest.iter_tool_output(
        tool, import_path, bar_file=bar_file, reads=seqs if seqs else None
    )
    counter = ingest.ConstructCounter(ingest.default_bars())
    if normalized_out is None:
        # the normalized table is a side artifact unless requested
        tmp = tempfile.NamedTemporaryFile(
            mode="w", suffix=".tsv", delete=False
        )
        tmp.close()
        normalized_out = tmp.name
        keep = False
    else:
        keep = True
    try:
        assigned = ingest.write_normalized(
            records, normalized_out, trimmed_out, counter
        )
    finally:
        if not keep:
            os.unlink(normalized_out)

    ctx = verify_context(kit) if verify else None
    return score_assignments(
        report, assigned, truth, ids, seqs, verify, verify_limit, ctx
    )


def run_compare(
    sim_dir: str,
    work_dir: str,
    kit: str = "SQK-RBK110-96",
    groups: Optional[List[str]] = None,
    maximize: bool = False,
    backend: str = "auto",
    verify: bool = False,
    time_runs: bool = False,
    device="cuda",
) -> List[GroupReport]:
    """Run the kit pipeline on each simulated group and score it.

    ``backend`` is ``torch`` (the port's engine on ``device``; ``auto``
    is the same) or ``oracle``.  ``time_runs`` adds per-group wall
    clock + reads/s to the reports — the wall-clock side of the
    reference's tool-comparison harness
    (`benchmarks/src/compare/compare.rs:467-523`, scaffolding there),
    after one untimed warm-up run of the first group, which takes the
    first-call costs (the kernels' and native library's loads)."""
    import time

    from ..stages.kit import KitRunConfig, demux_using_kit
    from .simulate import GROUPS

    groups = groups or [
        g for g in GROUPS if os.path.exists(os.path.join(sim_dir, f"{g}.fastq"))
    ]
    reports = []
    if time_runs and groups:
        warm = os.path.join(work_dir, "_warmup")
        demux_using_kit(
            [os.path.join(sim_dir, f"{groups[0]}.fastq")],
            KitRunConfig(
                kit_name=kit, output_folder=warm, maximize=maximize, backend=backend
            ),
            device=device,
        )
    for group in groups:
        fastq = os.path.join(sim_dir, f"{group}.fastq")
        out = os.path.join(work_dir, group)
        config = KitRunConfig(
            kit_name=kit,
            output_folder=out,
            maximize=maximize,
            backend=backend,
        )
        t0 = time.perf_counter()
        demux_using_kit([fastq], config, device=device)
        wall = time.perf_counter() - t0
        report = evaluate_group(
            group,
            fastq,
            os.path.join(sim_dir, f"{group}_truth.txt"),
            out,
            verify=verify,
            kit=kit,
        )
        if time_runs:
            report.wall_s = wall
        reports.append(report)
    return reports


def print_reports(reports: List[GroupReport]) -> None:
    timed = any(r.wall_s is not None for r in reports)
    checked = any(r.checked for r in reports)
    head = (f"{'group':<10} {'reads':>6} {'assigned':>9} {'correct':>8} "
            f"{'assign%':>8} {'acc%':>6}")
    if checked:
        head += f" {'verified':>9}"
    if timed:
        head += f" {'wall_s':>8} {'reads/s':>9}"
    print(head)
    for r in reports:
        line = (
            f"{r.group:<10} {r.total_reads:>6} {r.assigned:>9} {r.correct:>8} "
            f"{100 * r.assign_rate:>7.1f}% {100 * r.accuracy:>5.1f}%"
        )
        if checked:
            line += f" {r.verified:>4}/{r.checked:<4}" if r.checked else f" {'-':>9}"
        if timed:
            if r.wall_s is not None:
                line += f" {r.wall_s:>8.2f} {r.reads_per_sec:>9.1f}"
            else:
                line += f" {'-':>8} {'-':>9}"
        print(line)
