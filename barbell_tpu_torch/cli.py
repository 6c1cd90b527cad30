"""Command line of the port: ``python -m barbell_tpu_torch kit ...``.

``kit`` runs the flagship pipeline on the port's engine (``--backend
torch`` on the CUDA device, or the scalar ``oracle``).  The host-only
subcommands ``filter``, ``trim``, ``inspect``, ``kits`` and ``sim``
delegate to barbell_tpu's handlers (they never touch a device);
``annotate``, ``compare``, ``kit --full-scan`` and ``kit
--use-extended`` are not ported yet and exit with status 2.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from barbell_tpu import cli as reference_cli
from barbell_tpu.stages.kit import KitRunConfig

from .stages.annotate import BACKENDS

DELEGATED = ("filter", "trim", "inspect", "kits", "sim")
NOT_PORTED = ("annotate", "compare")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="barbell-tpu-torch",
        description="Pattern-aware Nanopore barcode demultiplexing on one "
        "NVIDIA GPU (PyTorch + CUDA port of barbell-tpu). Also: "
        + ", ".join(DELEGATED) + " (as in barbell_tpu).",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("kit", help="Run a kit preset pipeline")
    p.add_argument("-k", "--kit", required=True)
    p.add_argument("-i", "--input", nargs="+", required=True)
    p.add_argument("-t", "--threads", type=int, default=10)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--maximize", action="store_true")
    p.add_argument("--min-score", type=float, default=0.2)
    p.add_argument("--min-score-diff", type=float, default=0.1)
    p.add_argument("--flank-max-errors", type=int, default=None)
    p.add_argument("--failed-out")
    p.add_argument("--use-extended", action="store_true",
                   help="not ported yet")
    p.add_argument("--alpha", type=float, default=0.4)
    p.add_argument("--gzip", action="store_true")
    p.add_argument("--full-scan", action="store_true", help="not ported yet")
    p.add_argument(
        "--backend", choices=list(BACKENDS), default="torch",
        help="torch: the batched pipeline on the CUDA device; oracle: the "
        "scalar NumPy engine",
    )
    p.add_argument("--batch-size", type=int, default=2048,
                   help="Reads per device batch")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in DELEGATED:
        args = reference_cli.build_parser().parse_args(argv)
        return reference_cli._dispatch(args)
    if argv and argv[0] in NOT_PORTED:
        print(f"Error: '{argv[0]}' is not ported yet (see ROADMAP.md)")
        return 2
    args = build_parser().parse_args(argv)
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
        full_scan=args.full_scan,
    )
    from .stages.kit import demux_using_kit

    try:
        demux_using_kit(args.input, config, device="cuda")
    except NotImplementedError as exc:
        print(f"Error: {exc}")
        return 2
    except (KeyError, ValueError, OSError) as exc:
        print(f"Error: {exc.args[0] if exc.args else exc}")
        return 1
    return 0
