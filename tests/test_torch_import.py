"""The port imports neither jax nor the JAX package: every
barbell_tpu_torch module imports (``sim.compare`` and ``sim.ingest``
among them), one CPU engine batch runs in each scan mode, and the
command line runs ``annotate`` and ``filter``, in a process where
importing ``jax`` or ``barbell_tpu`` fails; the chip script imports
neither; and the port's command line runs its kit path."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["barbell_tpu"] = None  # and so does the JAX package
import barbell_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    barbell_tpu_torch.__path__, "barbell_tpu_torch.")]
assert {"barbell_tpu_torch.sim.compare", "barbell_tpu_torch.sim.ingest"} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke  # the chip script imports neither

from barbell_tpu_torch import cli
from barbell_tpu_torch.models.barcodes import BarcodeGroup
from barbell_tpu_torch.models.pipeline import TorchDemuxEngine
from barbell_tpu_torch.ops.edit_model import get_edit_cut_off
from barbell_tpu_torch.sim.simulate import default_barcodes, rapid_adapter

groups = BarcodeGroup.from_kit("SQK-RBK114-96", False)
for g in groups:
    g.barcodes = g.barcodes[:4]
    g.patterns_fwd = g.patterns_fwd[:4]
    g.patterns_rc = g.patterns_rc[:4]
    g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
label, bseq = default_barcodes(4)[2]
read = rapid_adapter(bseq) + b"ACGTTG" * 100
rows = []
for ends in ((256, 256), None):  # ends scan, whole-read scan (chunk rows)
    engine = TorchDemuxEngine(groups, ends_window=ends, max_row_len=256,
                              device="cpu")
    rows.append(engine.demux_batch_table(["r0"], [read]).n_rows)
assert min(rows) >= 1, rows

d = tempfile.mkdtemp()
fq, tsv, pat, qf = (os.path.join(d, f)
                    for f in ("r.fastq", "a.tsv", "p.txt", "q.fasta"))
with open(qf, "w") as fh:
    for lab, bs in default_barcodes(3)[1:]:
        fh.write(f">{lab}\n{rapid_adapter(bs).decode()}\n")
with open(fq, "w") as fh:
    fh.write(f"@r0\n{read.decode()}\n+\n{'I' * len(read)}\n")
with open(pat, "w") as fh:
    fh.write("Ftag[fw, *, @left(0..250), >>]\n")
cli.DEVICE = "cpu"
assert cli.main(["annotate", "-i", fq, "-o", tsv, "-q", qf, "-b", "Ftag",
                 "--batch-size", "4"]) == 0
assert cli.main(["filter", "-i", tsv, "-o", tsv + ".f", "-f", pat]) == 0
assert open(tsv + ".f").read().count("\n") == 2  # header + the read's row
assert not any(m == "jax" or m.startswith(("jax.", "barbell_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("MODULES", len(names), "ROWS", rows)
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 37


def test_chip_smoke_imports_only_the_port():
    """The chip script imports no ``jax`` and no ``barbell_tpu``, only
    the port."""
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


def test_nvcc_flags_keep_exact_lodhi_and_hopper_target():
    """The kernels build for sm_90a, and with FMA contraction off: the
    rank kernel's Lodhi scores are held bit for bit."""
    from barbell_tpu_torch import _build

    flags = _build.NVCC_FLAGS
    assert "--fmad=false" in flags
    assert flags[flags.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert ("-Xptxas", "-v") in zip(flags, flags[1:])


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


def test_cli_kit_oracle_delegation_and_not_ported(tmp_path, capsys,
                                                 monkeypatch):
    """The port's ``kit`` on the oracle backend writes the JAX CLI's
    stage files; its host commands run; a command missing its inputs
    exits 1; what is not ported (``BARBELL_PROFILE_DIR`` tracing) exits
    2."""
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
    assert main(["kits"]) == 0
    assert main(["annotate", "-i", str(fq)]) == 1  # needs --kit or -q
    assert main(["compare", "--sim-dir", "x"]) == 1  # needs -o
    capsys.readouterr()
    monkeypatch.setenv("BARBELL_PROFILE_DIR", str(tmp_path / "trace"))
    assert main(["annotate", "-i", str(fq), "--kit", "SQK-RBK114-96",
                 "--backend", "oracle"]) == 2
    assert "not ported yet" in capsys.readouterr().out
