"""The port's reads mesh on the CPU against the JAX package: the read
partition equals ``JaxDemuxEngine._partition_reads``, and
``TorchDemuxEngine(devices=["cpu"] * D)`` for D = 2 and 3 gives the
tables of ``JaxDemuxEngine`` on one CPU device, for the counterparts of
tests/test_parallel.py's sharded-engine cases (chunk rows with IUPAC
bytes, the nibble re-pack, two groups fused with the overflow retry)
and for an ends plan.  Groups are cut to 12 barcodes; the JAX
side runs its jnp path (its default on the CPU)."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs
jax = pytest.importorskip("jax")

from barbell_tpu.models import hittable  # noqa: E402
from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.models.pipeline import JaxDemuxEngine  # noqa: E402
from barbell_tpu.models.twotier import EndsPlan  # noqa: E402
from barbell_tpu.models.twotier import make_ends_engine as jax_ends_engine  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.sim.simulate import (  # noqa: E402
    default_barcodes,
    mutate_sequence,
    rapid_adapter,
    random_sequence,
)
from barbell_tpu.utils import dna  # noqa: E402
from barbell_tpu_torch.models import barcodes as port_barcodes  # noqa: E402
from barbell_tpu_torch.models import pipeline as port_pipeline  # noqa: E402
from barbell_tpu_torch.models import twotier as port_twotier  # noqa: E402
from barbell_tpu_torch.models.pipeline import TorchDemuxEngine  # noqa: E402
from barbell_tpu_torch.ops import composite as tcomp  # noqa: E402
from barbell_tpu_torch.stages import annotate as port_annotate  # noqa: E402
from barbell_tpu_torch.parallel.mesh import resolve_devices  # noqa: E402

N_BARCODES = 12


def _groups(group_cls, use_extended=False):
    """The flagship kit (with ``use_extended``: its two groups) cut to
    N_BARCODES; each engine gets its own package's classes."""
    groups = group_cls.from_kit("SQK-RBK114-96", use_extended)
    for g in groups:
        g.barcodes = g.barcodes[:N_BARCODES]
        g.patterns_fwd = g.patterns_fwd[:N_BARCODES]
        g.patterns_rc = g.patterns_rc[:N_BARCODES]
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def _reads(n, seed, long_at=(), iupac_at=(), lo=150, hi=600, long_len=1500):
    rng = random.Random(seed)
    bars = default_barcodes(N_BARCODES)
    ids, seqs = [], []
    for i in range(n):
        _label, bseq = bars[rng.randrange(N_BARCODES)]
        body = long_len if i in long_at else rng.randrange(lo, hi)
        seq = rapid_adapter(bseq) + bytes(random_sequence(rng, body))
        if i in iupac_at:
            seq = seq[:40] + b"NNRYK" + seq[45:]
        if rng.random() < 0.5:
            seq = dna.reverse_complement_bytes(seq)
        ids.append(f"r{i}")
        seqs.append(mutate_sequence(rng, seq, 0, 4))
    return ids, seqs


def _tables_equal(a, b):
    assert a.read_ids == b.read_ids
    assert np.array_equal(a.read_lens, b.read_lens)
    for c in hittable.COLUMNS:
        assert np.array_equal(a.cols[c], b.cols[c]), c


class _PackSpy:
    """Records the pack mode of every fused call the port makes."""

    def __init__(self, monkeypatch):
        self.modes = []
        orig = tcomp.demux_call_fused

        def call(groups, parts, **kw):
            self.modes.append(kw["pack_mode"])
            return orig(groups, parts, **kw)

        monkeypatch.setattr(tcomp, "demux_call_fused", call)


def _case_chunk_rows_iupac(monkeypatch):
    """test_engine_sharded_matches_single_device: chunk rows of two long
    reads at 512-wide rows and IUPAC bytes on the exception list."""
    ids, seqs = _reads(11, seed=21, long_at=(4, 9), iupac_at=(2, 4))
    spy = _PackSpy(monkeypatch)

    def run(D):
        port = TorchDemuxEngine(_groups(port_barcodes.BarcodeGroup),
                                max_row_len=512, devices=["cpu"] * D)
        spy.modes.clear()
        got = port.demux_batch_table(ids, seqs)
        assert port.last_dispatch == "sharded" and spy.modes == [2] * D
        return got

    ref = JaxDemuxEngine(_groups(BarcodeGroup), max_row_len=512,
                         devices=jax.devices()[:1])
    return ids, seqs, ref, "single", run


def _case_nibble_fallback(monkeypatch):
    """test_engine_sharded_nibble_fallback_matches: one shard's
    exception list overflows its cap, so every shard re-packs as nibble
    rows (the cap is lowered so that a short read overflows it)."""
    ids, seqs = _reads(9, seed=5)
    seqs[3] = seqs[3][:100] + b"ANCG" * 6 + seqs[3][124:]  # 6 N bytes
    monkeypatch.setattr(port_pipeline, "_EXC_CAP", 4)
    spy = _PackSpy(monkeypatch)

    def run(D):
        port = TorchDemuxEngine(_groups(port_barcodes.BarcodeGroup),
                                devices=["cpu"] * D)
        spy.modes.clear()
        got = port.demux_batch_table(ids, seqs)
        assert port.last_dispatch == "sharded" and spy.modes == [0] * D
        return got

    ref = JaxDemuxEngine(_groups(BarcodeGroup), devices=jax.devices()[:1])
    return ids, seqs, ref, "single", run


def _construct(g, i):
    """Group ``g``'s flank around its ``i``-th barcode."""
    a, b = g.bar_region
    p0 = g.pad_region[0]
    return g.flank[:a] + g.barcodes[i].seq[a - p0 : b - p0 + 1] + g.flank[b + 1 :]


def _case_fused_retry(monkeypatch):
    """test_engine_sharded_fused_multi_group: ``--use-extended``'s two
    groups in one fused call a shard, on reads with a standard construct
    and one with a fusion construct too.  On two shards the first hit
    capacity is cut to 2 lanes (and the retry's to the measured total + 8,
    to keep the plain versions cheap), so that the retry runs each
    overflowed group on every shard."""
    rng = random.Random(5)
    ids, seqs = _reads(7, seed=77, lo=100, hi=200)
    g1, g2 = _groups(BarcodeGroup, True)
    seqs[2] += _construct(g2, 3) + bytes(random_sequence(rng, 80))
    monkeypatch.setattr(port_pipeline, "_retry_cap", lambda total, h: total + 8)

    def run(D):
        port = TorchDemuxEngine(_groups(port_barcodes.BarcodeGroup, True),
                                devices=["cpu"] * D)
        if D == 2:
            monkeypatch.setattr(port, "_h_cap", lambda *a: 2)
        got = port.demux_batch_table(ids, seqs)
        assert port.last_dispatch == "sharded-fused"
        assert (port._h_cap_hint > 2) == (D == 2)  # the overflow retry fired
        # both groups found their constructs
        assert {lab >= N_BARCODES for lab in got.cols["label"].tolist()} == {False, True}
        return got

    ref = JaxDemuxEngine(_groups(BarcodeGroup, True), devices=jax.devices()[:1])
    return ids, seqs, ref, "single-fused", run


def _case_ends_plan(monkeypatch):
    """The kit's ends scan (an ends plan without a deep tier, through the
    annotate stage's ``make_engine``): reads longer than the 512-base
    windows as prefix/suffix row pairs."""
    ids, seqs = _reads(9, seed=13, long_at=(1, 6), long_len=1800)

    def run(D):
        port = port_annotate.make_engine(
            _groups(port_barcodes.BarcodeGroup),
            port_annotate.AnnotateConfig(ends_window=port_twotier.EndsPlan((512, 512))),
            devices=["cpu"] * D)
        got = port.demux_batch_table(ids, seqs)
        assert port.ends_window == 512 and port.last_dispatch == "sharded"
        return got

    ref = jax_ends_engine(_groups(BarcodeGroup), EndsPlan((512, 512)),
                          devices=jax.devices()[:1])
    return ids, seqs, ref, "single", run


CASES = {"chunk_rows_iupac": _case_chunk_rows_iupac,
         "nibble_fallback": _case_nibble_fallback,
         "fused_retry": _case_fused_retry,
         "ends_plan": _case_ends_plan}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_matches_jax_one_device(case, monkeypatch):
    """Two and three CPU shards give the JAX engine's table on one
    device."""
    ids, seqs, ref, ref_dispatch, run = CASES[case](monkeypatch)
    want = ref.demux_batch_table(ids, seqs)
    assert ref.last_dispatch == ref_dispatch
    assert want.n_rows >= len(ids) - 1
    for D in (2, 3):
        _tables_equal(run(D), want)


@pytest.mark.parametrize("ends", [None, (512, 512)], ids=["whole", "ends"])
def test_partition_reads_matches_jax(ends):
    """Greedy row-count balance with a read's rows on one shard, over
    seeded random lengths (chunked, ends-row and simple reads)."""
    port = TorchDemuxEngine(_groups(port_barcodes.BarcodeGroup),
                            ends_window=ends, max_row_len=1024, device="cpu")
    ref = JaxDemuxEngine(_groups(BarcodeGroup), ends_window=ends,
                         max_row_len=1024, devices=jax.devices()[:1])
    rng = np.random.default_rng(7)
    for trial in range(20):
        lens = rng.integers(0, 5000, size=int(rng.integers(1, 64)))
        L = port._choose_L(lens) if lens.max() else 256
        step = L - 10 - port.halo
        for D in (2, 3, 8):
            got = port._partition_reads(lens, L, step, D)
            assert got == ref._partition_reads(lens, L, step, D), (trial, D)
            assert sorted(r for b in got for r in b) == list(range(len(lens)))


def test_resolve_devices():
    """``devices`` as given, repeats allowed; ``[device]`` otherwise."""
    assert resolve_devices("cpu") == [torch.device("cpu")]
    assert resolve_devices("cuda", ["cpu"] * 2) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="at least one"):
        resolve_devices("cpu", [])
    one = TorchDemuxEngine(_groups(port_barcodes.BarcodeGroup), device="cpu")
    assert one.devices == [torch.device("cpu")]
    ids, seqs = _reads(3, seed=1)
    one.demux_batch_table(ids, seqs)
    assert one.last_dispatch == "single"
