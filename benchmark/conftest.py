"""Test settings of the benchmark's own tests (``pytest benchmark/``)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, at run
    time, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run `pytest benchmark/ -m card` on the card")


TINY = {"pool_reads": 24, "reference_sample": 6, "kit_options": {"batch_size": 8}}


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout holding the benchmark plus a cell added as files alone:
    ``dummy.tiny`` (a configuration file, a traffic file, a metric reader
    and BENCHMARK.json entries), small enough for the port's plain
    versions on the CPU."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/nbd114_96.json").read_text())
    cfg["name"] = "dummy"
    (root / "benchmark/configs/dummy.json").write_text(json.dumps(cfg))
    tr = json.loads((ROOT / "benchmark/traffic/ends_ref_sim.json").read_text())
    tr.update(TINY, name="tiny")
    (root / "benchmark/traffic/tiny.json").write_text(json.dumps(tr))
    (root / "benchmark/metrics/dummy.reads.py").write_text(
        "def read(ctx):\n    return float(ctx['reads'])\n")
    bench["configs"].append({"name": "dummy", "source": "test", "file": "benchmark/configs/dummy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.tiny", "config": "dummy", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy.reads", "unit": "reads", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "reads_per_s", "workloads": ["dummy.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
