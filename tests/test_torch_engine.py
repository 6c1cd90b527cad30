"""The port's engines and kit runner on the CPU against the JAX package:
equal HitTable columns batch for batch, and byte-identical stage files
from the kit runner."""

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
from barbell_tpu.stages.kit import KitRunConfig  # noqa: E402
from barbell_tpu.stages.kit import demux_using_kit as jax_demux_using_kit  # noqa: E402
from barbell_tpu.utils import dna  # noqa: E402
from barbell_tpu_torch.models.pipeline import TorchDemuxEngine  # noqa: E402
from barbell_tpu_torch.models.twotier import (  # noqa: E402
    TwoTierDemuxEngine,
    make_ends_engine,
)
from barbell_tpu_torch.stages.kit import demux_using_kit  # noqa: E402

PLAN = EndsPlan(shallow=(512, 512), deep=(896, 512), trigger_margin=374)


def _cpu1():
    return jax.devices()[:1]


def _assert_tables_equal(a, b):
    assert a.read_ids == b.read_ids
    assert np.array_equal(a.read_lens, b.read_lens)
    for c in hittable.COLUMNS:
        assert np.array_equal(a.cols[c], b.cols[c]), c


def _rbk_groups(n_barcodes):
    groups = BarcodeGroup.from_kit("SQK-RBK114-96", False)
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
    groups = _rbk_groups(12)
    port = make_ends_engine(groups, PLAN, device="cpu")
    assert isinstance(port, TwoTierDemuxEngine)
    ref = jax_ends_engine(groups, PLAN, devices=_cpu1())
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
    group = BarcodeGroup.from_seqs(seqs, ["B0", "B1", "B2"], BarcodeType.Ftag)
    group.set_flank_threshold(max(1, get_edit_cut_off(group.get_effective_len())))
    ids, reads = [], []
    for i in range(24):
        parts = [seqs[rng.randrange(3)] + rand_seq(3) for _ in range(24)]
        ids.append(f"d{i}")
        reads.append(b"".join(parts)[: 300 + 40 * (i % 8)])
    port = TorchDemuxEngine([group], ends_window=(512, 512), device="cpu")
    ref = JaxDemuxEngine([group], devices=_cpu1(), ends_window=(512, 512))
    _assert_tables_equal(
        port.demux_batch_table(ids, reads), ref.demux_batch_table(ids, reads)
    )
    assert port._h_cap_hint > 0  # the retry fired
    assert port._fallback is not None  # overflow rows went to the oracle


def test_kit_runner_matches_jax(tmp_path, monkeypatch):
    """The JAX runner runs on one CPU device, as the port does (the test
    suite's eight virtual devices would send it down its sharded path)."""
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
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
    with open(fq, "w") as fh:
        for rid, seq in recs:
            s = seq.decode()
            fh.write(f"@{rid} sample=x\n{s}\n+\n{'I' * len(s)}\n")

    def run(fn, backend, out, **kw):
        fn([str(fq)], KitRunConfig(kit_name="SQK-RBK114-96",
                                   output_folder=str(out), backend=backend,
                                   batch_size=20), **kw)
        return {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}

    got = run(demux_using_kit, "torch", tmp_path / "port", device="cpu")
    want = run(jax_demux_using_kit, "jax", tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert sum(n.endswith(".trimmed.fastq") for n in got) >= 3
