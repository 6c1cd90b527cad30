"""The port's ``annotate`` command line takes every flag of the JAX
package's: ``annotate --kit SQK-RBK114-96 --use-extended -t 4
--verbose`` writes the ``annotation.tsv`` of ``python -m barbell_tpu``
with the same flags, on the oracle backend and on the torch engine on
the CPU; ``--backend auto`` (the default) builds the torch engine and
fails where it cannot be built; ``BARBELL_DEBUG`` re-raises what
otherwise exits 1."""

import os
import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs

from barbell_tpu import cli as reference_cli  # noqa: E402
from barbell_tpu.kits import database as db  # noqa: E402
from barbell_tpu.sim.simulate import create_testdata, default_barcodes  # noqa: E402
from barbell_tpu_torch import cli  # noqa: E402

FLAGS = ["--kit", "SQK-RBK114-96", "--use-extended", "-t", "4", "--verbose",
         "--batch-size", "4"]


def _inputs(tmp_path):
    """Three simulated GroupII reads and one read with a mid-read fusion
    construct (front fusion flank + barcode + rear flank)."""
    create_testdata(3, str(tmp_path / "sim"), barcodes=default_barcodes(4),
                    rc_frac=0.0, seed=9, groups=("GroupII",))
    rng = random.Random(1)
    body = lambda n: "".join(rng.choice("ACGT") for _ in range(n))  # noqa: E731
    seq = body(200) + db.RBK4_FRONT_FUSION + db.BC_SEQS[0] + db.RBK4_REAR + body(200)
    fq = tmp_path / "reads.fastq"
    with open(tmp_path / "sim" / "GroupII.fastq") as src, open(fq, "w") as fh:
        fh.write(src.read())
        fh.write(f"@fus_0\n{seq}\n+\n{'I' * len(seq)}\n")
    return str(fq)


@pytest.mark.parametrize("backend", ["oracle", "torch"])
def test_annotate_extended_flags_match_reference(tmp_path, monkeypatch, backend):
    fq = _inputs(tmp_path)
    for name in ("ref", "port"):
        (tmp_path / name).mkdir()
    want = str(tmp_path / "ref" / "annotation.tsv")
    assert reference_cli.main(["annotate", "-i", fq, "-o", want, *FLAGS,
                               "--backend", "oracle"]) == 0
    monkeypatch.setattr(cli, "DEVICE", "cpu")
    got = str(tmp_path / "port" / "annotation.tsv")
    assert cli.main(["annotate", "-i", fq, "-o", got, *FLAGS,
                     "--backend", backend]) == 0
    with open(want) as a, open(got) as b:
        text = a.read()
        assert b.read() == text
    # the fusion read's construct is found (through the extended group)
    assert any(ln.startswith("fus_0\t") and "\tBC01\t" in ln
               for ln in text.splitlines())
    # --verbose: the progress log beside the output
    assert any(f.startswith("annotate") for f in os.listdir(tmp_path / "port"))


def test_auto_backend_has_no_fallback(tmp_path, monkeypatch):
    """``--backend auto``, the default of ``annotate`` and ``kit``, on a
    host where the CUDA engine cannot be built fails the run instead of
    falling back to the oracle engine."""
    parser = cli.build_parser()
    for cmd in (["annotate", "-i", "x"], ["kit", "-k", "K", "-i", "x", "-o", "y"]):
        assert parser.parse_args(cmd).backend == "auto"
        assert parser.parse_args(cmd + ["--backend", "auto"]).backend == "auto"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the engine would build")
    fq = _inputs(tmp_path)
    out = tmp_path / "a.tsv"
    monkeypatch.setattr(cli, "DEVICE", "cuda")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cli.main(["annotate", "-i", fq, "-o", str(out), "--kit", "SQK-RBK114-96",
                  "--backend", "auto"])
    assert not out.exists()


def test_debug_reraises(tmp_path, monkeypatch):
    """An unknown kit exits 1 with a message; under BARBELL_DEBUG the
    error propagates."""
    fq = _inputs(tmp_path)
    args = ["annotate", "-i", fq, "-o", str(tmp_path / "a.tsv"), "--kit",
            "NO-SUCH-KIT", "--backend", "oracle"]
    monkeypatch.delenv("BARBELL_DEBUG", raising=False)
    assert cli.main(args) == 1
    monkeypatch.setenv("BARBELL_DEBUG", "1")
    with pytest.raises(KeyError):
        cli.main(args)
