"""Cells by name: ``BENCHMARK.json``'s entry of a workload, with its
configuration (``benchmark/configs/<config>.json``) and traffic mix
(``benchmark/traffic/<traffic>.json``), and the per-layer metrics that
apply to it (``benchmark/metrics/<name>.py``).  A new cell, mix,
configuration or metric is a new file and a new entry; nothing here
names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Metric:
    name: str
    unit: str
    read: Optional[Callable]  # per-layer metrics: read(ctx) -> value or None


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def run_options(self) -> dict:
        """The kit options of the run: the configuration's, then the mix's."""
        return {**self.config["kit_options"], **self.traffic.get("kit_options", {})}


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_reader(name: str, root: Path = ROOT) -> Callable:
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the checkout at ``root``."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = json.loads((root / "benchmark" / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = [Metric(m["name"], m["unit"], None) for m in bench["end_to_end"] if _applies(m, name)]
    layers = [Metric(m["name"], m["unit"], load_reader(m["name"], root))
              for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, config, traffic, int(entry["chips"]), e2e, layers)
