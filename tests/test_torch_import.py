"""The port never imports jax: every barbell_tpu_torch module imports,
and one CPU engine batch runs, in a process where importing jax fails;
and the port's command line runs its kit path and delegates the rest."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import barbell_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    barbell_tpu_torch.__path__, "barbell_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # the chip script imports no jax either

from barbell_tpu.models.barcodes import BarcodeGroup
from barbell_tpu.ops.edit_model import get_edit_cut_off
from barbell_tpu.sim.simulate import default_barcodes, rapid_adapter
from barbell_tpu_torch.models.pipeline import TorchDemuxEngine

groups = BarcodeGroup.from_kit("SQK-RBK114-96", False)
for g in groups:
    g.barcodes = g.barcodes[:4]
    g.patterns_fwd = g.patterns_fwd[:4]
    g.patterns_rc = g.patterns_rc[:4]
    g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
engine = TorchDemuxEngine(groups, ends_window=(512, 512), device="cpu")
label, bseq = default_barcodes(4)[2]
table = engine.demux_batch_table(["r0"], [rapid_adapter(bseq) + b"ACGT" * 60])
assert table.n_rows >= 1, table.n_rows
print("MODULES", len(names), "ROWS", table.n_rows)
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 12


def test_chip_smoke_imports_only_the_port():
    """The chip script reaches the JAX package's jax-free modules only
    through the port: it imports no ``jax`` and no ``barbell_tpu``."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "barbell_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "barbell_tpu"}, sorted(names)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the chip script exits non-zero and prints no result
    line, from the repo and from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would run for real")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, alone)):
        res = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True,
            text=True, timeout=120,
        )
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_cli_kit_oracle_delegation_and_not_ported(tmp_path, capsys):
    from barbell_tpu import cli as reference_cli
    from barbell_tpu.sim.simulate import default_barcodes, rapid_adapter
    from barbell_tpu_torch.cli import main

    fq = tmp_path / "r.fastq"
    with open(fq, "w") as fh:
        for i, (_label, bseq) in enumerate(default_barcodes(3)):
            s = (rapid_adapter(bseq) + b"ACGTTG" * 50).decode()
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    outs = {}
    for name, fn in (("port", main), ("ref", reference_cli.main)):
        out = tmp_path / name
        assert fn(["kit", "-k", "SQK-RBK114-96", "-i", str(fq), "-o", str(out),
                   "--backend", "oracle"]) == 0
        outs[name] = {f.name: f.read_bytes() for f in sorted(out.iterdir())}
    assert outs["port"] == outs["ref"] and "annotation.tsv" in outs["port"]
    assert main(["inspect", "-i", str(tmp_path / "port" / "annotation.tsv")]) == 0
    assert main(["annotate", "-i", str(fq)]) == 2
    assert main(["kit", "-k", "SQK-RBK114-96", "-i", str(fq), "-o",
                 str(tmp_path / "x"), "--full-scan", "--backend", "oracle"]) == 2
    assert "not ported yet" in capsys.readouterr().out
