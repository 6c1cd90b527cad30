"""The port's multi-group fused dispatch against the JAX package's: the
fused call's packed buffer against JAX ``demux_call_fused`` (integers
equal), and the engine's tables fused, per group and from
``JaxDemuxEngine`` on one CPU device, for the two groups of ``kit
--use-extended`` (the RBK114 template and its fusion/artefact template)
and for the Ftag/Rtag groups of the PCR kit ``EXP-PBC096``, in the
whole-read scan and under the kit's ends plan.  Groups are cut to 12
barcodes; the JAX side runs its jnp path (its default on the CPU)."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu import PADDING  # noqa: E402
from barbell_tpu.kits.database import get_kit_info  # noqa: E402
from barbell_tpu.kits.presets import preset_patterns  # noqa: E402
from barbell_tpu.models import hittable  # noqa: E402
from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.models.demux import Demuxer  # noqa: E402
from barbell_tpu.models.pipeline import JaxDemuxEngine  # noqa: E402
from barbell_tpu.models.twotier import make_ends_engine as jax_ends_engine  # noqa: E402
from barbell_tpu.ops import composite as jcomp  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.sim.simulate import mutate_sequence, random_sequence  # noqa: E402
from barbell_tpu.stages.kit import ends_plan_for_patterns  # noqa: E402
from barbell_tpu.stages.pattern import pattern_from_str  # noqa: E402
from barbell_tpu.utils import dna  # noqa: E402
from barbell_tpu_torch.models import barcodes as port_barcodes  # noqa: E402
from barbell_tpu_torch.models import twotier as port_twotier  # noqa: E402
from barbell_tpu_torch.models.pipeline import (  # noqa: E402
    TorchDemuxEngine,
    _pow2_at_least,
)
from barbell_tpu_torch.ops import composite as tcomp  # noqa: E402

N_BARCODES = 12
KITS = {"extended": ("SQK-RBK114-96", True), "pcr": ("EXP-PBC096", False)}


def _groups(kit, group_cls=BarcodeGroup):
    name, ext = KITS[kit]
    groups = group_cls.from_kit(name, ext)
    assert len(groups) == 2
    for g in groups:
        g.barcodes = g.barcodes[:N_BARCODES]
        g.patterns_fwd = g.patterns_fwd[:N_BARCODES]
        g.patterns_rc = g.patterns_rc[:N_BARCODES]
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def _construct(g, i):
    """Group ``g``'s flank around its ``i``-th barcode."""
    a, b = g.bar_region
    p0 = g.pad_region[0]
    return g.flank[:a] + g.barcodes[i].seq[a - p0 : b - p0 + 1] + g.flank[b + 1 :]


def _reads(kit, n=6, seed=8):
    """``extended``: a standard construct at the start and a fusion
    construct mid-read (as tests/test_e2e_extra.py builds them);
    ``pcr``: an Ftag construct at the start and an rc Rtag construct at
    the end, every other read reverse complemented.  One read carries
    an N inside its first flank."""
    rng = random.Random(seed)
    g1, g2 = _groups(kit)
    ids, seqs = [], []
    for i in range(n):
        bc = rng.randrange(N_BARCODES)
        body1 = bytes(random_sequence(rng, rng.randrange(100, 300)))
        body2 = bytes(random_sequence(rng, rng.randrange(100, 300)))
        c2 = _construct(g2, (bc + 7) % N_BARCODES)
        if kit == "extended":
            seq = _construct(g1, bc) + body1 + c2 + body2
        else:
            seq = _construct(g1, bc) + body1 + body2 + dna.reverse_complement_bytes(c2)
            if i % 2:
                seq = dna.reverse_complement_bytes(seq)
        ids.append(f"{kit}{i}")
        seqs.append(mutate_sequence(rng, seq, 0, 4))
    seqs[1] = seqs[1][:5] + b"N" + seqs[1][6:]
    return ids, seqs


def _tables_equal(a, b):
    assert a.read_ids == b.read_ids
    assert np.array_equal(a.read_lens, b.read_lens)
    for c in hittable.COLUMNS:
        assert np.array_equal(a.cols[c], b.cols[c]), c


@pytest.mark.parametrize("kit", list(KITS))
def test_fused_buffer_matches_jax(kit):
    """One whole-read batch at 512-wide rows (reads longer than that as
    chunk rows), both groups in one call: the port's flat int32 buffer
    equals JAX ``demux_call_fused``'s on the same host arrays.  The hit
    capacity is not a multiple of 256, so both rank every lane against
    both strands' patterns (the JAX jnp path's one form)."""
    ids, seqs = _reads(kit)
    jeng = JaxDemuxEngine(_groups(kit), devices=jax.devices()[:1],
                          max_row_len=512)
    teng = TorchDemuxEngine(_groups(kit, port_barcodes.BarcodeGroup),
                            max_row_len=512, device="cpu")
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    L = teng._choose_L(lens)
    assert L == jeng._choose_L(lens) == 512
    step = L - PADDING - teng.halo
    tplan = teng._plan(lens, L, step)
    jplan = jeng._plan_shard(seqs, lens, range(len(seqs)), L, step)
    R_host_pad = _pow2_at_least(tplan.R_host, 8)
    S_pad = _pow2_at_least(tplan.F, 8)
    assert tplan.rows_meta  # chunk rows of both strands
    tmat = teng._materialize(tplan, seqs, lens, L, R_host_pad, S_pad)
    jmat = jeng._materialize(jplan, seqs, lens, L, R_host_pad, S_pad)
    for name in ("host_packed", "rowdesc", "chunk_meta", "exc"):
        t, j = getattr(tmat, name), getattr(jmat, name)
        assert np.array_equal(j[: t.shape[0]], t), name
    H_cap = 160
    blob, spans = jcomp.build_blob_desc_np(jmat.host_packed, jmat.rowdesc,
                                           jmat.chunk_meta, jmat.exc)
    group_statics, common = jeng._fused_statics(
        2, L, step, H_cap, {"meta_mode": "desc", "S_pad": S_pad})
    want = np.asarray(jcomp.demux_call_fused(
        jeng._group_args(), jnp.asarray(blob), spans=spans,
        group_statics=group_statics, common=common))

    parts = {k: torch.from_numpy(getattr(tmat, k))
             for k in ("host_packed", "rowdesc", "chunk_meta", "exc")}
    got = tcomp.demux_call_fused(
        [teng._group_args(g, step) for g in teng.plans], parts,
        K=teng.K, H_cap=H_cap, pack_mode=2, L_rows=L, S_pad=S_pad, ends_w=0,
        ends_wr=0, halo=teng.halo, padding=PADDING,
    ).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # per group: H_cap * record lanes + overflow words + total, in order
    nw = (R_host_pad + S_pad + 31) // 32
    sizes = [H_cap * teng._rec_wire(g, L, R_host_pad + S_pad)[0] + nw + 1
             for g in teng.plans]
    assert got.shape[0] == sum(sizes)
    totals = [int(got[sum(sizes[: i + 1]) - 1]) for i in range(2)]
    assert all(1 <= t <= H_cap for t in totals), totals


@pytest.mark.parametrize("kit", list(KITS))
def test_engine_fused_matches_per_group_and_jax(kit):
    """The whole-read engine: the fused dispatch (one call and one fetch
    a batch), the per-group dispatch, JAX's engine on one CPU device and
    the scalar ``Demuxer`` give the same rows."""
    ids, seqs = _reads(kit)
    port = TorchDemuxEngine(_groups(kit, port_barcodes.BarcodeGroup),
                            device="cpu")
    fused = port.demux_batch_table(ids, seqs)
    assert port.last_dispatch == "single-fused"
    port.fuse_groups = False
    per_group = port.demux_batch_table(ids, seqs)
    assert port.last_dispatch == "single"
    _tables_equal(fused, per_group)
    ref = JaxDemuxEngine(_groups(kit), devices=jax.devices()[:1])
    _tables_equal(fused, ref.demux_batch_table(ids, seqs))
    assert ref.last_dispatch == "single-fused"
    d = Demuxer(alpha=0.4)
    for g in _groups(kit):
        d.add_query_group(g)
    rows = hittable.table_to_matches(fused)
    for rid, seq, got in zip(ids, seqs, rows):
        assert got == d.demux(rid, seq), rid
    # both groups found constructs
    assert len(set(fused.cols["label"].tolist()) - {port.flank_label}) >= 4


def test_two_group_ends_plan_matches_jax():
    """The PCR kit's two groups under the ends plan its preset patterns
    give (the two-tier engine when the plan has a deep tier): the fused
    dispatch and JAX's engine agree."""
    kit_info = get_kit_info(KITS["pcr"][0])
    pats = [pattern_from_str(p)
            for p in preset_patterns(kit_info.pattern_class, False)]
    jplan = ends_plan_for_patterns(pats, _groups("pcr"))
    assert jplan is not None
    plan = port_twotier.EndsPlan(jplan.shallow, jplan.deep, jplan.trigger_margin)
    ids, seqs = _reads("pcr", n=8, seed=3)
    seqs[2] += bytes(random_sequence(random.Random(1), 1500))  # an ends read
    port = port_twotier.make_ends_engine(
        _groups("pcr", port_barcodes.BarcodeGroup), plan, device="cpu")
    fused = port.demux_batch_table(ids, seqs)
    assert port.last_dispatch == "single-fused"
    ref = jax_ends_engine(_groups("pcr"), jplan, devices=jax.devices()[:1])
    _tables_equal(fused, ref.demux_batch_table(ids, seqs))
    assert fused.n_rows >= 8
