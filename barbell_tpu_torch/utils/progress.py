"""Per-stage progress counters with optional TSV log output.

Counter layout mirrors the reference (`src/progress/progress.rs:15-72`):
annotate/filter track Total/Kept/Dropped; trim adds Kept-split/Failed.
With ``verbose`` a ``{step}.{unix_ms}.log`` TSV (``step\\tmetric\\tcount``)
is written next to the stage output.  Rendering is plain stderr lines
(refreshed in place when attached to a TTY) rather than spinners.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Sequence

ANNOTATE_METRICS = ("Total:", "Kept:", "Dropped:")
FILTER_METRICS = ("Total:", "Kept:", "Dropped:")
TRIM_METRICS = ("Total:", "Kept:", "Kept split:", "Failed:")


class ProgressTracker:
    def __init__(
        self,
        metrics: Sequence[str],
        step: Optional[str] = None,
        log_dir: Optional[str] = None,
        stream=None,
    ):
        self.metrics = list(metrics)
        self.counts: List[int] = [0] * len(metrics)
        self.step = step
        self.log_path = None
        if step is not None and log_dir is not None:
            ts = int(time.time() * 1000)
            self.log_path = os.path.join(log_dir, f"{step}.{ts}.log")
        self.stream = stream if stream is not None else sys.stderr
        self._last_render = 0.0
        self._is_tty = hasattr(self.stream, "isatty") and self.stream.isatty()

    def add(self, idx: int, count: int) -> None:
        self.counts[idx] += count

    def inc(self, idx: int) -> None:
        self.counts[idx] += 1

    def refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_render < 0.5:
            return
        self._last_render = now
        line = "  ".join(
            f"{name} {count}" for name, count in zip(self.metrics, self.counts)
        )
        if self._is_tty:
            self.stream.write("\r" + line)
            self.stream.flush()

    def print_error(self, msg: str) -> None:
        self.stream.write("\n" + msg + "\n")

    def finish(self, unit: str) -> None:
        line = "  ".join(
            f"{name} {count} {unit}" for name, count in zip(self.metrics, self.counts)
        )
        end = "\n"
        prefix = "\r" if self._is_tty else ""
        self.stream.write(prefix + line + end)
        if self.log_path is not None:
            with open(self.log_path, "w") as fh:
                fh.write("step\tmetric\tcount\n")
                for name, count in zip(self.metrics, self.counts):
                    fh.write(f"{self.step}\t{name}\t{count}\n")
