"""The port's own copies of the host-only stages, driven through its
command line, against the JAX package's: ``filter``, ``trim`` and
``inspect`` on one small annotation file must write byte-identical
outputs, and so must ``compare``; the kit runner's other forms
(``--use-extended``, ``--no-stream``, ``--verbose``) against the port's
own oracle backend and streaming runner."""

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs

from barbell_tpu import cli as reference_cli  # noqa: E402
from barbell_tpu.sim.simulate import (  # noqa: E402
    default_barcodes,
    mutate_sequence,
    rapid_adapter,
    random_sequence,
)
from barbell_tpu.utils import dna  # noqa: E402
from barbell_tpu_torch import cli as port_cli  # noqa: E402
from barbell_tpu_torch.models.barcodes import BarcodeGroup as PortGroup  # noqa: E402

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


def _kit_files(out):
    """A kit run's output files (the verbose runner's per-stage logs are
    named by the time, so they are listed by stage)."""
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())
            if not p.name.endswith(".log")}


N_KIT = 8  # barcodes the kit keeps in the kit and compare tests


def _cut_kit(monkeypatch, group_cls, n):
    """Kits built by ``group_cls.from_kit`` keep their first ``n``
    barcodes (the simulated reads use no others)."""
    from_kit = group_cls.from_kit

    def cut(kit, use_extended=False):
        groups = from_kit(kit, use_extended)
        for g in groups:
            g.barcodes = g.barcodes[:n]
            g.patterns_fwd = g.patterns_fwd[:n]
            g.patterns_rc = g.patterns_rc[:n]
        return groups

    monkeypatch.setattr(group_cls, "from_kit", staticmethod(cut))


def _kit_reads(path, fusion_every=0):
    """Eight SQK-RBK114-96 reads with the kit's first N_KIT barcodes,
    forward or rc; with ``fusion_every``, every such read also carries
    the kit's fusion/artefact construct mid-read."""
    from barbell_tpu.kits import database as db

    rng = random.Random(12)
    with open(path, "w") as fh:
        for i in range(8):
            bc = rng.randrange(N_KIT)
            seq = (db.RBK4_KIT14_FRONT + db.BC_SEQS[bc] + db.RBK4_KIT14_REAR).encode()
            seq += bytes(random_sequence(rng, rng.randrange(200, 400)))
            if fusion_every and i % fusion_every == 0:
                seq += (db.RBK4_FRONT_FUSION + db.BC_SEQS[(bc + 3) % N_KIT]
                        + db.RBK4_REAR).encode()
                seq += bytes(random_sequence(rng, 200))
            if i % 3 == 2:
                seq = dna.reverse_complement_bytes(seq)
            s = mutate_sequence(rng, seq, 0, 3).decode()
            fh.write(f"@k{i} run=1\n{s}\n+\n{'I' * len(s)}\n")


def test_kit_use_extended_matches_oracle(tmp_path, monkeypatch):
    """``kit --use-extended`` (two barcode groups, whole-read scan) on
    the port's engine writes the same files as the port's scalar oracle
    backend; the fusion template's rows reach the annotation.  The kit
    keeps the N_KIT barcodes the reads carry."""
    _cut_kit(monkeypatch, PortGroup, N_KIT)
    monkeypatch.setattr(port_cli, "DEVICE", "cpu")
    fq = tmp_path / "reads.fastq"
    _kit_reads(fq, fusion_every=2)
    outs = {}
    for backend in ("torch", "oracle"):
        out = tmp_path / backend
        assert port_cli.main(["kit", "-k", "SQK-RBK114-96", "-i", str(fq),
                              "-o", str(out), "--use-extended",
                              "--backend", backend]) == 0
        outs[backend] = _kit_files(out)
    assert outs["torch"] == outs["oracle"]
    assert sum(n.endswith(".trimmed.fastq") for n in outs["torch"]) >= 2
    anno = outs["torch"]["annotation.tsv"].decode().splitlines()[1:]
    assert len({line.split("\t")[0] for line in anno}) == 8
    assert len(anno) >= 12  # the fusion constructs too


@pytest.mark.parametrize("mode, backend", [("--no-stream", "torch"),
                                           ("--verbose", "oracle")])
def test_kit_staged_matches_streaming(tmp_path, monkeypatch, mode, backend):
    """The staged runner (``--no-stream``, or ``--verbose`` with its
    per-stage logs) writes the streaming runner's files, byte for byte:
    annotation, patterns per read, filtered rows, trimmed FASTQs and the
    failed list, on the port's engine (whole-read scan: the ends plan's
    deep tier would double the CPU time) and on the scalar oracle.  The
    kit keeps the N_KIT barcodes the reads carry."""
    _cut_kit(monkeypatch, PortGroup, N_KIT)
    monkeypatch.setattr(port_cli, "DEVICE", "cpu")
    fq = tmp_path / "reads.fastq"
    _kit_reads(fq)
    outs = {}
    flags = ["--backend", backend] + (["--full-scan"] if backend == "torch" else [])
    for name, extra in (("stream", flags), ("staged", [mode, *flags])):
        out = tmp_path / name
        assert port_cli.main(["kit", "-k", "SQK-RBK114-96", "-i", str(fq),
                              "-o", str(out), "--failed-out",
                              str(out / "failed.txt"), *extra]) == 0
        outs[name] = _kit_files(out)
    assert outs["staged"] == outs["stream"]
    assert sum(n.endswith(".trimmed.fastq") for n in outs["stream"]) >= 3
    assert {"annotation.tsv", "pattern_per_read.tsv", "filtered.tsv",
            "failed.txt"} <= set(outs["stream"])
    logs = sorted(p.name.split(".")[0] for p in (tmp_path / "staged").iterdir()
                  if p.name.endswith(".log"))
    assert logs == (["annotate", "filter", "trim"] if mode == "--verbose" else [])


def test_compare_matches_jax(tmp_path, capsys, monkeypatch):
    """``compare --verify`` on the oracle backend over a ``sim -n 8`` set
    (rc fraction 0, as the class contract uses) prints the JAX package's
    per-group report, the group outcomes included.  Both kits keep the
    N_KIT barcodes the simulated reads carry."""
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.sim.compare import print_reports, run_compare

    for cls in (BarcodeGroup, PortGroup):
        _cut_kit(monkeypatch, cls, N_KIT)
    sim = tmp_path / "sim"
    assert port_cli.main(["sim", "-n", "8", "-o", str(sim), "-r", "0",
                          "--num-barcodes", str(N_KIT)]) == 0
    capsys.readouterr()
    assert port_cli.main(["compare", "--sim-dir", str(sim), "-o",
                          str(tmp_path / "port"), "--backend", "oracle",
                          "--verify"]) == 0
    got = capsys.readouterr().out.splitlines()[-7:]
    reports = run_compare(str(sim), str(tmp_path / "jax"), backend="oracle",
                          verify=True)
    capsys.readouterr()
    print_reports(reports)
    assert got == capsys.readouterr().out.splitlines()
    by_group = {r.group: r for r in reports}
    assert by_group["GroupII"].assigned == by_group["GroupII"].correct == 8
    assert all(by_group[g].assigned == 0
               for g in ("GroupI", "GroupIV", "GroupV", "GroupVI"))


def test_compare_engine_matches_jax(tmp_path, capsys, monkeypatch):
    """``compare --verify`` on the port's engine (on the CPU) gives JAX
    ``run_compare``'s report on its own engine for GroupV (a construct
    mid-read): the kit's two-tier ends scan does not see that construct
    and assigns each read by its end constructs, in both packages (the
    ends-scan deviation, docs/SEMANTICS.md), so all 8 reads are assigned
    and none correctly.  The kit keeps the N_KIT barcodes the simulated
    reads carry."""
    pytest.importorskip("jax")
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.sim.compare import print_reports, run_compare

    for cls in (BarcodeGroup, PortGroup):
        _cut_kit(monkeypatch, cls, N_KIT)
    monkeypatch.setattr(port_cli, "DEVICE", "cpu")
    sim = tmp_path / "sim"
    assert port_cli.main(["sim", "-n", "8", "-o", str(sim), "-r", "0",
                          "--num-barcodes", str(N_KIT)]) == 0
    for p in sim.iterdir():
        if not p.name.startswith(("GroupV.", "GroupV_")):
            p.unlink()
    capsys.readouterr()
    assert port_cli.main(["compare", "--sim-dir", str(sim), "-o",
                          str(tmp_path / "port"), "--backend", "torch",
                          "--verify"]) == 0
    got = capsys.readouterr().out.splitlines()[-2:]
    (report,) = run_compare(str(sim), str(tmp_path / "jax"), backend="jax",
                            verify=True)
    capsys.readouterr()
    print_reports([report])
    assert got == capsys.readouterr().out.splitlines()
    assert report.group == "GroupV"
    assert (report.total_reads, report.assigned, report.correct) == (8, 8, 0)


@pytest.mark.parametrize("pattern", [
    "Ftag[fw, *, @left(0..250), >>]",
    "Ftag[fw, ?1, @left(0..250)]__Ftag[fw, ?1, @prev_left(0..250), >>]",
    "Ftag[<<, rc, *, @right(0..250)]",
    "Ftag[fw, *]",
    "Ftag[fw, *, @prev_left(0..250)]",
])
def test_ends_window_for_patterns_matches_jax(pattern):
    """The one-window ends plan of a pattern (``tests/test_ends.py``'s
    cases on SQK-RBK114-96: 512, 896, 512, and None for an unbounded
    element or a bare ``@prev_left``) equals the JAX package's."""
    from barbell_tpu.stages.kit import ends_window_for_patterns as jax_window
    from barbell_tpu.stages.pattern import pattern_from_str as jax_pattern
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.ops.edit_model import get_edit_cut_off
    from barbell_tpu_torch.stages.kit import ends_window_for_patterns, kit_groups
    from barbell_tpu_torch.stages.pattern import pattern_from_str

    groups = BarcodeGroup.from_kit("SQK-RBK114-96", False)
    for g in groups:
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    want = jax_window([jax_pattern(pattern)], groups)
    got = ends_window_for_patterns([pattern_from_str(pattern)],
                                   kit_groups("SQK-RBK114-96"))
    assert got == want
    assert want in (512, 896, None)
