"""The port's engines, annotate stage and kit runner on the CPU against
the JAX package: equal HitTable columns batch for batch, in the ends
scan and the whole-read scan, byte-identical annotation TSVs, and
byte-identical stage files from the kit runner."""

import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from barbell_tpu.models import hittable  # noqa: E402
from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.models.pipeline import JaxDemuxEngine  # noqa: E402
from barbell_tpu.models.records import BarcodeType  # noqa: E402
from barbell_tpu.models.twotier import EndsPlan  # noqa: E402
from barbell_tpu.models.twotier import make_ends_engine as jax_ends_engine  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.sim.simulate import (  # noqa: E402
    default_barcodes,
    mutate_sequence,
    rapid_adapter,
    random_sequence,
)
from barbell_tpu.stages import annotate as jax_annotate  # noqa: E402
from barbell_tpu.stages.kit import KitRunConfig  # noqa: E402
from barbell_tpu.stages.kit import demux_using_kit as jax_demux_using_kit  # noqa: E402
from barbell_tpu.utils import dna  # noqa: E402
from barbell_tpu_torch.models import barcodes as port_barcodes  # noqa: E402
from barbell_tpu_torch.models import records as port_records  # noqa: E402
from barbell_tpu_torch.models import twotier as port_twotier  # noqa: E402
from barbell_tpu_torch.models.pipeline import TorchDemuxEngine  # noqa: E402
from barbell_tpu_torch.models.twotier import (  # noqa: E402
    TwoTierDemuxEngine,
    make_ends_engine,
)
from barbell_tpu_torch.stages import annotate as port_annotate  # noqa: E402
from barbell_tpu_torch.stages.kit import KitRunConfig as PortKitRunConfig  # noqa: E402
from barbell_tpu_torch.stages.kit import demux_using_kit  # noqa: E402

PLAN = dict(shallow=(512, 512), deep=(896, 512), trigger_margin=374)


def _cpu1():
    return jax.devices()[:1]


def _assert_tables_equal(a, b):
    assert a.read_ids == b.read_ids
    assert np.array_equal(a.read_lens, b.read_lens)
    for c in hittable.COLUMNS:
        assert np.array_equal(a.cols[c], b.cols[c]), c


def _rbk_groups(n_barcodes, group_cls=BarcodeGroup):
    """The flagship kit's group cut to ``n_barcodes``; each engine gets
    groups built by its own package's classes."""
    groups = group_cls.from_kit("SQK-RBK114-96", False)
    for g in groups:
        g.barcodes = g.barcodes[:n_barcodes]
        g.patterns_fwd = g.patterns_fwd[:n_barcodes]
        g.patterns_rc = g.patterns_rc[:n_barcodes]
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def _chain_read(rng, bseq, junk_pre, gap, body):
    """junk + adapter + gap + adapter + body: its second link lies past
    the shallow claim, so the two-tier engine rescues the read."""
    ad = rapid_adapter(bseq)
    return (
        bytes(random_sequence(rng, junk_pre)) + ad
        + bytes(random_sequence(rng, gap)) + ad
        + bytes(random_sequence(rng, body))
    )


def _one_jax_device(monkeypatch):
    """The JAX stages build their engine on every visible device; the
    test suite's eight virtual CPU devices would send them down the
    sharded path, so they see one, as the port runs on one."""
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)


def _write_fastq(path, recs):
    with open(path, "w") as fh:
        for rid, seq in recs:
            s = seq.decode()
            fh.write(f"@{rid} sample=x\n{s}\n+\n{'I' * len(s)}\n")


def test_whole_read_engine_matches_jax():
    """Whole-read scan at 512-wide rows: 0.6-2 kb reads become forward +
    rc chunk rows (step = 512 - PADDING - halo = 379), one construct
    straddles the first seam, and rc reads, an N read and short simple
    reads share the batch."""
    rng = random.Random(13)
    bcs = default_barcodes(12)
    ids, seqs = [], []
    for i, n in enumerate([150, 1700, 900, 600, 60, 1300]):
        label, bseq = bcs[i]
        seq = rapid_adapter(bseq) + bytes(random_sequence(rng, n))
        if i % 2:
            seq = dna.reverse_complement_bytes(seq)
        ids.append(f"w{i}")
        seqs.append(mutate_sequence(rng, seq, 0, 4))
    seqs[2] = seqs[2][:35] + b"NN" + seqs[2][37:]  # N inside the flank
    seam = (bytes(random_sequence(rng, 330)) + rapid_adapter(bcs[9][1])
            + bytes(random_sequence(rng, 700)))
    ids.append("seam")
    seqs.append(seam)
    port = TorchDemuxEngine(_rbk_groups(12, port_barcodes.BarcodeGroup),
                            max_row_len=512, device="cpu")
    ref = JaxDemuxEngine(_rbk_groups(12), max_row_len=512, devices=_cpu1())
    lens = np.array([len(s) for s in seqs])
    assert port._choose_L(lens) == ref._choose_L(lens) == 512
    got = port.demux_batch_table(ids, seqs)
    _assert_tables_equal(got, ref.demux_batch_table(ids, seqs))
    # the seam read's construct was found (in a chunk row)
    assert got.rows_per_read()[ids.index("seam")] >= 1


def _annotate_inputs(tmp_path):
    rng = random.Random(41)
    bcs = default_barcodes(6)
    recs = []
    for i in range(8):
        label, bseq = bcs[i % 6]
        seq = rapid_adapter(bseq) + bytes(
            random_sequence(rng, rng.randrange(100, 900))
        )
        if i % 2:
            seq = dna.reverse_complement_bytes(seq)
        recs.append((f"a{i}", mutate_sequence(rng, seq, 0, 4)))
    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, recs)
    return fq, bcs


@pytest.mark.parametrize("queries", ["kit", "fasta"])
def test_annotate_matches_jax(tmp_path, monkeypatch, queries):
    """The stepwise pipeline's first step in its default whole-read scan,
    with the kit's groups or with custom query FASTAs (``-q/-b``): the
    annotation TSVs are byte-identical."""
    _one_jax_device(monkeypatch)
    fq, bcs = _annotate_inputs(tmp_path)
    outs = {}
    for name, mod, btype, backend, kw in (
        ("port", port_annotate, port_records.BarcodeType.Ftag, "torch",
         {"device": "cpu"}),
        ("jax", jax_annotate, BarcodeType.Ftag, "jax", {}),
    ):
        out = str(tmp_path / f"{name}.tsv")
        cfg = mod.AnnotateConfig(backend=backend, batch_size=4)
        if queries == "kit":
            mod.annotate_with_kit([str(fq)], out, "SQK-RBK114-96", cfg, **kw)
        else:
            qf = tmp_path / "queries.fasta"
            with open(qf, "w") as fh:
                for label, bseq in bcs:
                    fh.write(f">{label}\n{rapid_adapter(bseq).decode()}\n")
            mod.annotate_with_files([str(fq)], [str(qf)], [btype], out, cfg,
                                    **kw)
        outs[name] = open(out, "rb").read()
    assert outs["port"] == outs["jax"]
    assert outs["port"].count(b"\n") >= 9  # header + a row per read


def test_kit_full_scan_matches_jax(tmp_path, monkeypatch):
    """``kit --full-scan``: the whole-read engine through the streaming
    runner writes the same stage files as the JAX runner."""
    _one_jax_device(monkeypatch)
    fq, _ = _annotate_inputs(tmp_path)
    outs = {}
    for name, fn, cfg_cls, backend, kw in (
        ("port", demux_using_kit, PortKitRunConfig, "torch", {"device": "cpu"}),
        ("jax", jax_demux_using_kit, KitRunConfig, "jax", {}),
    ):
        out = tmp_path / name
        fn([str(fq)], cfg_cls(kit_name="SQK-RBK114-96", output_folder=str(out),
                              backend=backend, batch_size=8, full_scan=True),
           **kw)
        outs[name] = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
    assert outs["port"] == outs["jax"]
    assert sum(n.endswith(".trimmed.fastq") for n in outs["port"]) >= 3


def test_two_tier_engine_matches_jax():
    rng = random.Random(11)
    bcs = default_barcodes(12)
    ids, seqs = [], []
    for i, n in enumerate([300, 1200, 700, 2600, 450, 1900]):
        label, bseq = bcs[i]
        seq = rapid_adapter(bseq) + bytes(random_sequence(rng, n))
        if i % 2:
            seq = dna.reverse_complement_bytes(seq)  # rc read
        ids.append(f"r{i}")
        seqs.append(mutate_sequence(rng, seq, 0, 5))
    seqs[2] = seqs[2][:30] + b"NNNN" + seqs[2][34:]  # N inside the flank
    seqs.append(rapid_adapter(bcs[7][1])[:-5])  # short simple row
    ids.append("short")
    for i, gap in enumerate((200, 240)):  # deep-rescue triggers
        seqs.append(_chain_read(rng, bcs[8 + i][1], 200, gap, 1500))
        ids.append(f"chain{i}")
    port = make_ends_engine(_rbk_groups(12, port_barcodes.BarcodeGroup),
                            port_twotier.EndsPlan(**PLAN), device="cpu")
    assert isinstance(port, TwoTierDemuxEngine)
    ref = jax_ends_engine(_rbk_groups(12), EndsPlan(**PLAN), devices=_cpu1())
    _assert_tables_equal(
        port.demux_batch_table(ids, seqs), ref.demux_batch_table(ids, seqs)
    )
    assert port.last_rescued == ref.last_rescued == 2


def test_engine_overflow_and_retry_match_jax():
    """Hit-dense reads (~18 constructs in one row) exceed the 8 Myers
    valley slots — their rows take the scalar fallback — and a strand
    half of the initial hit capacity, so the sticky retry fires (the
    JAX engine's CPU path packs unsplit lanes, so it need not retry)."""
    rng = random.Random(7)

    def rand_seq(n):
        return bytes(rng.choice(b"ACGT") for _ in range(n))

    pre, suf = rand_seq(5), rand_seq(8)
    seqs = [pre + rand_seq(12) + suf for _ in range(3)]

    def group(group_cls, btype):
        g = group_cls.from_seqs(seqs, ["B0", "B1", "B2"], btype)
        g.set_flank_threshold(max(1, get_edit_cut_off(g.get_effective_len())))
        return g

    ids, reads = [], []
    for i in range(24):
        parts = [seqs[rng.randrange(3)] + rand_seq(3) for _ in range(24)]
        ids.append(f"d{i}")
        reads.append(b"".join(parts)[: 300 + 40 * (i % 8)])
    port = TorchDemuxEngine(
        [group(port_barcodes.BarcodeGroup, port_records.BarcodeType.Ftag)],
        ends_window=(512, 512), device="cpu",
    )
    ref = JaxDemuxEngine([group(BarcodeGroup, BarcodeType.Ftag)],
                         devices=_cpu1(), ends_window=(512, 512))
    _assert_tables_equal(
        port.demux_batch_table(ids, reads), ref.demux_batch_table(ids, reads)
    )
    assert port._h_cap_hint > 0  # the retry fired
    assert port._fallback is not None  # overflow rows went to the oracle


def test_kit_runner_matches_jax(tmp_path, monkeypatch):
    """The JAX runner runs on one CPU device, as the port does."""
    _one_jax_device(monkeypatch)
    rng = random.Random(23)
    bcs = default_barcodes(96)
    recs = []
    for i in range(20):
        label, bseq = bcs[rng.randrange(96)]
        if i == 3:
            seq = _chain_read(rng, bseq, 180, 220, 1200)
        else:
            seq = rapid_adapter(bseq) + bytes(
                random_sequence(rng, rng.randrange(250, 1800))
            )
            if rng.random() < 0.5:
                seq = dna.reverse_complement_bytes(seq)
            seq = mutate_sequence(rng, seq, 0, 5)
        recs.append((f"k{i}", seq))
    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, recs)

    def run(fn, cfg_cls, backend, out, **kw):
        fn([str(fq)], cfg_cls(kit_name="SQK-RBK114-96",
                              output_folder=str(out), backend=backend,
                              batch_size=20), **kw)
        return {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}

    got = run(demux_using_kit, PortKitRunConfig, "torch", tmp_path / "port",
              device="cpu")
    want = run(jax_demux_using_kit, KitRunConfig, "jax", tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert sum(n.endswith(".trimmed.fastq") for n in got) >= 3
