"""The port's own copies of the host-only stages, driven through its
command line, against the JAX package's: ``filter``, ``trim`` and
``inspect`` on one small annotation file must write byte-identical
outputs."""

import random

import pytest

pytest.importorskip("torch")

from barbell_tpu import cli as reference_cli  # noqa: E402
from barbell_tpu.sim.simulate import (  # noqa: E402
    default_barcodes,
    mutate_sequence,
    rapid_adapter,
    random_sequence,
)
from barbell_tpu.utils import dna  # noqa: E402
from barbell_tpu_torch import cli as port_cli  # noqa: E402

PATTERNS = (
    "Ftag[fw, *, @left(0..250), >>]\n"
    "Ftag[<<, rc, *, @right(0..250)]\n"
)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(reads FASTQ, annotation TSV, pattern file): ten reads with one or
    two constructs, forward or rc, annotated by the JAX package's scalar
    oracle with three custom queries."""
    d = tmp_path_factory.mktemp("host_stages")
    rng = random.Random(5)
    bcs = default_barcodes(3)
    fq, qf = d / "reads.fastq", d / "queries.fasta"
    with open(qf, "w") as fh:
        for label, bseq in bcs:
            fh.write(f">{label}\n{rapid_adapter(bseq).decode()}\n")
    with open(fq, "w") as fh:
        for i in range(10):
            seq = rapid_adapter(bcs[i % 3][1]) + bytes(
                random_sequence(rng, rng.randrange(80, 400))
            )
            if i % 4 == 3:  # a second construct: a split read
                seq += rapid_adapter(bcs[(i + 1) % 3][1]) + bytes(
                    random_sequence(rng, 150)
                )
            if i % 2:
                seq = dna.reverse_complement_bytes(seq)
            s = mutate_sequence(rng, seq, 0, 3).decode()
            fh.write(f"@h{i} run=1\n{s}\n+\n{'I' * len(s)}\n")
    anno = d / "annotation.tsv"
    assert reference_cli.main(["annotate", "-i", str(fq), "-o", str(anno),
                               "-q", str(qf), "-b", "Ftag",
                               "--backend", "oracle"]) == 0
    pat = d / "patterns.txt"
    pat.write_text(PATTERNS)
    return fq, anno, pat


def _stage_args(stage, fq, anno, pat, out):
    if stage == "filter":
        return ["filter", "-i", str(anno), "-o", str(out / "filtered.tsv"),
                "-f", str(pat), "--dropped", str(out / "dropped.tsv")]
    if stage == "trim":
        return ["trim", "-i", str(anno), "-r", str(fq), "-o", str(out),
                "--failed-out", str(out / "failed.txt")]
    return ["inspect", "-i", str(anno), "-n", "5",
            "-o", str(out / "read_patterns.tsv")]


@pytest.mark.parametrize("stage", ["filter", "trim", "inspect"])
def test_host_stage_matches_jax(inputs, tmp_path, stage):
    fq, anno, pat = inputs
    outs = {}
    for name, main in (("port", port_cli.main), ("ref", reference_cli.main)):
        out = tmp_path / name
        out.mkdir()
        assert main(_stage_args(stage, fq, anno, pat, out)) == 0
        outs[name] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert outs["port"] == outs["ref"]
    assert outs["port"] and all(outs["port"].values())
