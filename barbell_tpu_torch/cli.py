"""Command line of the port: ``python -m barbell_tpu_torch <command>``.

``annotate``, ``kit`` and ``compare`` run on the port's engine
(``--backend torch`` on the CUDA device, or the scalar ``oracle``;
``compare`` also takes ``auto``, which is ``torch``); ``filter``,
``trim``, ``inspect``, ``kits`` and ``sim`` are host-only, as in
barbell_tpu.  Flag names and defaults follow barbell_tpu's CLI.  What
is not ported yet (``annotate``'s multi-host sharding and
``BARBELL_PROFILE_DIR`` tracing) exits with status 2.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .models.records import BarcodeType
from .sim.ingest import IMPORT_TOOLS
from .stages.annotate import (
    BACKENDS,
    AnnotateConfig,
    annotate_with_files,
    annotate_with_kit,
)
from .stages.filter import filter_from_text_files
from .stages.inspect import inspect
from .stages.kit import KitRunConfig, demux_using_kit
from .stages.trim import LabelConfig, trim_matches

DEVICE = "cuda"  # --backend torch


def _add_backend_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--backend", choices=list(BACKENDS), default="torch",
        help="torch: the batched pipeline on the CUDA device; oracle: the "
        "scalar NumPy engine",
    )
    p.add_argument("--batch-size", type=int, default=2048,
                   help="Reads per device batch")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="barbell-tpu-torch",
        description="Pattern-aware Nanopore barcode demultiplexing on one "
        "NVIDIA GPU (PyTorch + CUDA port of barbell-tpu).",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("annotate", help="Annotate FASTQ files with barcode information")
    p.add_argument("-i", "--input", nargs="+", required=True, help="Read FASTQ file(s)")
    p.add_argument("-o", "--output", default="output.tsv")
    p.add_argument("-q", "--queries", nargs="+", help="Query FASTA file(s)")
    p.add_argument(
        "-b", "--barcode-types", nargs="+", default=["Ftag"],
        help="Barcode types matching --queries order (Ftag or Rtag)",
    )
    p.add_argument("--kit", help="Kit name (e.g. SQK-RBK114-24)")
    p.add_argument("--flank-max-errors", type=int, default=None)
    p.add_argument("--min-score", type=float, default=0.2)
    p.add_argument("--min-score-diff", type=float, default=0.1)
    p.add_argument("--alpha", type=float, default=0.4)
    p.add_argument(
        "--ends-window", type=int, default=None,
        help="Scan only each read's first/last N bases (device backend;"
        " mid-read hits are skipped). Default: whole-read scan.",
    )
    _add_backend_args(p)

    p = sub.add_parser("filter", help="Filter annotation files based on pattern")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-f", "--file", nargs="+", required=True, help="Pattern file(s)")
    p.add_argument("--dropped", help="Write dropped read annotations to this file")
    p.add_argument("--verbose", action="store_true")

    p = sub.add_parser("trim", help="Trim and sort reads based on filtered annotations")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-r", "--reads", nargs="+", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="Writer threads (parallel gzip compression)")
    p.add_argument("--no-label", action="store_true")
    p.add_argument("--no-orientation", action="store_true")
    p.add_argument("--no-flanks", action="store_true")
    p.add_argument("--sort-labels", action="store_true")
    p.add_argument("--only-side", choices=["left", "right"])
    p.add_argument("--failed-out")
    p.add_argument("--skip-trim", action="store_true")
    p.add_argument("--flip", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--gzip", action="store_true")

    p = sub.add_parser("inspect", help="View most common patterns in annotation")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-n", "--top-n", type=int, default=10)
    p.add_argument("-o", "--read-pattern-out")
    p.add_argument("-s", "--bucket-size", type=int, default=250)

    p = sub.add_parser("kit", help="Run a kit preset pipeline")
    p.add_argument("-k", "--kit", required=True)
    p.add_argument("-i", "--input", nargs="+", required=True)
    p.add_argument("-t", "--threads", type=int, default=10)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--maximize", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--min-score", type=float, default=0.2)
    p.add_argument("--min-score-diff", type=float, default=0.1)
    p.add_argument("--flank-max-errors", type=int, default=None)
    p.add_argument("--failed-out")
    p.add_argument("--use-extended", action="store_true")
    p.add_argument("--alpha", type=float, default=0.4)
    p.add_argument("--gzip", action="store_true")
    p.add_argument(
        "--full-scan", action="store_true",
        help="Scan whole reads instead of the preset-window ends-only "
        "fast path (the presets positionally reject mid-read hits; "
        "--use-extended implies full scan).",
    )
    p.add_argument(
        "--no-stream", action="store_true",
        help="Run the four stages as separate file passes instead of the "
        "fused one-pass pipeline. Outputs are byte-identical unless the "
        "input reuses a read id non-adjacently; --verbose implies this "
        "mode (per-stage log files).",
    )
    _add_backend_args(p)

    sub.add_parser("kits", help="List supported kit names")

    p = sub.add_parser("sim", help="Generate simulated reads with ground truth")
    p.add_argument("-n", "--num-reads", type=int, default=1000)
    p.add_argument("-o", "--output", required=True, help="Output directory")
    p.add_argument("-r", "--rc-frac", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--groups", nargs="+", default=None, help="Subset of GroupI..GroupVI")
    p.add_argument("--num-barcodes", type=int, default=96)

    p = sub.add_parser(
        "compare",
        help="Run the kit pipeline over simulated groups and score it, or "
        "score another tool's demux output (--import-tool)",
    )
    p.add_argument("--sim-dir", help="Simulated data directory (pipeline mode)")
    p.add_argument("-o", "--output", help="Working directory (pipeline mode)")
    p.add_argument("-k", "--kit", default="SQK-RBK110-96")
    p.add_argument("--maximize", action="store_true")
    p.add_argument("--verify", action="store_true",
                   help="Independently re-verify assignments with a direct search")
    p.add_argument("--time", action="store_true", dest="time_runs",
                   help="Report per-group wall clock and reads/s")
    p.add_argument("--backend", choices=["auto", *BACKENDS], default="auto",
                   help="auto and torch: the batched pipeline on the CUDA "
                   "device; oracle: the scalar NumPy engine")
    p.add_argument("--import-tool", choices=list(IMPORT_TOOLS),
                   help="Score another tool's output instead of running "
                   "the pipeline")
    p.add_argument("--import-path",
                   help="The tool's output folder (dorado/barbell), "
                   "classified_reads.fastq (flexiplex), or a "
                   "read_id<TAB>label table (tsv)")
    p.add_argument("--truth", help="Ground-truth read_id<TAB>label TSV")
    p.add_argument("--reads", help="Original input FASTQ (read universe; "
                   "needed for --verify and construct re-counts)")
    p.add_argument("--bar-file",
                   help="flexiplex: seq<TAB>label barcode map file")
    p.add_argument("--normalized-out",
                   help="Write the normalized read_id/barcode/len/"
                   "n_flank_matches table here")
    p.add_argument("--trimmed-out",
                   help="Write the normalized trimmed FASTA here")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    try:
        return _dispatch(args)
    except NotImplementedError as exc:
        print(f"Error: {exc}")
        return 2
    except (KeyError, ValueError, OSError) as exc:
        print(f"Error: {exc.args[0] if exc.args else exc}")
        return 1


def _dispatch(args) -> int:
    if args.command == "annotate":
        print("Starting annotation...")
        config = AnnotateConfig(
            max_flank_errors=args.flank_max_errors,
            alpha=args.alpha,
            min_score=args.min_score,
            min_score_diff=args.min_score_diff,
            backend=args.backend,
            batch_size=args.batch_size,
            ends_window=args.ends_window,
        )
        if args.kit:
            annotate_with_kit(args.input, args.output, args.kit, config, DEVICE)
        else:
            if not args.queries:
                print("Error: --queries is required unless --kit is provided")
                return 1
            try:
                types = [BarcodeType(t) for t in args.barcode_types]
            except ValueError as e:
                print(f"Error during processing: {e}; use one of: Ftag, Rtag")
                return 1
            annotate_with_files(args.input, args.queries, types, args.output,
                                config, DEVICE)
        print("Annotation complete!")

    elif args.command == "filter":
        print("Starting filtering...")
        filter_from_text_files(
            args.input, args.file, args.output, args.dropped, args.verbose
        )
        print("Filtering successful!")

    elif args.command == "trim":
        print("Starting trimming...")
        label_config = LabelConfig(
            include_label=not args.no_label,
            include_orientation=not args.no_orientation,
            include_flank=not args.no_flanks,
            sort_labels=args.sort_labels,
            only_side=args.only_side,
        )
        trim_matches(
            args.input,
            args.reads,
            args.output,
            label_config=label_config,
            failed_out=args.failed_out,
            write_full_header=True,
            skip_trim=args.skip_trim,
            flip=args.flip,
            verbose=args.verbose,
            use_gzip=args.gzip,
            threads=args.threads,
        )
        print("Trimming complete!")

    elif args.command == "inspect":
        print("Inspecting...")
        inspect(args.input, args.top_n, args.read_pattern_out, args.bucket_size)
        print("Inspection complete!")

    elif args.command == "kit":
        config = KitRunConfig(
            kit_name=args.kit,
            output_folder=args.output,
            threads=args.threads,
            maximize=args.maximize,
            min_score=args.min_score,
            min_score_diff=args.min_score_diff,
            max_flank_errors=args.flank_max_errors,
            failed_out=args.failed_out,
            use_extended=args.use_extended,
            alpha=args.alpha,
            gzip=args.gzip,
            backend=args.backend,
            batch_size=args.batch_size,
            verbose=args.verbose,
            stream=not args.no_stream,
            full_scan=args.full_scan,
        )
        demux_using_kit(args.input, config, device=DEVICE)

    elif args.command == "kits":
        from .kits.database import get_kit_info, supported_kits

        for alias in supported_kits():
            print(f"{alias}\t{get_kit_info(alias).name}")

    elif args.command == "sim":
        from .sim.simulate import GROUPS, create_testdata, default_barcodes

        create_testdata(
            args.num_reads,
            args.output,
            barcodes=default_barcodes(args.num_barcodes),
            rc_frac=args.rc_frac,
            seed=args.seed,
            groups=tuple(args.groups) if args.groups else GROUPS,
        )
        print(f"Simulated data written to {args.output}")

    elif args.command == "compare":
        from .sim.compare import print_reports, run_compare, run_import_compare

        if args.import_tool:
            if not args.import_path or not args.truth:
                raise ValueError("--import-tool needs --import-path and --truth")
            report = run_import_compare(
                args.import_tool,
                args.import_path,
                args.truth,
                reads_path=args.reads,
                bar_file=args.bar_file,
                normalized_out=args.normalized_out,
                trimmed_out=args.trimmed_out,
                verify=args.verify,
                kit=args.kit if args.verify else None,
            )
            print_reports([report])
        else:
            if not args.sim_dir or not args.output:
                raise ValueError(
                    "compare needs --sim-dir and -o/--output (or "
                    "--import-tool to score an external tool's output)"
                )
            reports = run_compare(
                args.sim_dir,
                args.output,
                kit=args.kit,
                maximize=args.maximize,
                backend=args.backend,
                verify=args.verify,
                time_runs=args.time_runs,
                device=DEVICE,
            )
            print_reports(reports)

    return 0
