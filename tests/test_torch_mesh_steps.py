"""The mesh's public sharded demux steps (``barbell_tpu_torch.parallel.mesh``
``make_mesh``, ``sharded_demux_step``, ``sharded_demux_step_fused`` and
``sharded_demux_step_mono``) on ``["cpu"] * 2`` against
``barbell_tpu.parallel.mesh``'s on a two-device CPU mesh (the jnp path):
shard by shard, the flat buffers equal (integers, and the Lodhi scores
in them bit for bit) and the summed hit count equal.  The rows are
``tests/test_parallel.py``'s (``__graft_entry__._example_batch``); the
fused form runs two groups on each shard's blob.  Each step is one
compiled call a shard; through a stand-in capture under the strict
capture-safety checker it records no host sync and no host read."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _example_batch  # noqa: E402
from barbell_tpu import PADDING  # noqa: E402
from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.models.pipeline import _GroupPlan  # noqa: E402
from barbell_tpu.ops import composite as jcomp  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.ops.oracle import scale_alpha  # noqa: E402
from barbell_tpu.parallel import mesh as jmesh  # noqa: E402
from barbell_tpu_torch.models import barcodes as port_barcodes  # noqa: E402
from barbell_tpu_torch.models import graphs  # noqa: E402
from barbell_tpu_torch.models.groups import GroupPlan  # noqa: E402
from barbell_tpu_torch.parallel import mesh as pmesh  # noqa: E402

from test_torch_compiled import through_cache  # noqa: E402,F401

D, PER, L = 2, 2, 256
R_PAD = S_PAD = 4
CPU2 = ["cpu"] * D


def _groups(cls, two: bool):
    """SQK-RBK114-24's group, or SQK-RBK114-96's two (standard and
    fusion templates) cut to 12 barcodes; each package's own classes."""
    if two:
        groups = cls.from_kit("SQK-RBK114-96", True)
        for g in groups:
            g.barcodes = g.barcodes[:12]
            g.patterns_fwd = g.patterns_fwd[:12]
            g.patterns_rc = g.patterns_rc[:12]
    else:
        groups = cls.from_kit("SQK-RBK114-24")[:1]
    for g in groups:
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def _statics(plan, H_cap):
    """``demux_call``'s group and call statics, as test_parallel.py
    gives them (nibble rows, uploaded metadata)."""
    gi = (int(scale_alpha(0.4)), int(plan.mask_start), int(plan.mask_end),
          int(plan.k1_scaled), int(plan.rel_bar_start), int(plan.rel_bar_end), L)
    gf = (float(np.float32(plan.perfect)), 0.2, 0.1)
    return dict(gi=gi, gf=gf, K=8, m=plan.m, k_units=plan.k_units,
                W_words=plan.W_words, top_bit=plan.top_bit, Wf=plan.span,
                plen=plan.plen, Wb=plan.barcode_window, P=plan.n_patterns,
                H_cap=H_cap, padding=PADDING, use_pallas=False, interpret=False)


def _shards(seed):
    """Each shard's (host_packed, simple_idx, packed meta, exc,
    row_start) numpy arrays: test_parallel.py's rows, two reads a
    shard, padded to 4 host rows and 4 rc twins."""
    rows, lens = _example_batch(B=D * PER, L=L, seed=seed)
    shards = []
    for d in range(D):
        padded = np.zeros((R_PAD, L), dtype=np.uint8)
        padded[:PER] = rows[d * PER : (d + 1) * PER]
        meta = np.zeros((R_PAD + S_PAD, jcomp.META_COLS), dtype=np.int32)
        meta[:, jcomp.M_HI] = -1
        for i in range(PER):
            n = int(lens[d * PER + i])
            meta[i] = (0, n, 1, 1, 0, n, 0, n, 0, i, 0, 1, 0)
            meta[R_PAD + i] = (L - n, L, 1, 1, L - n, L, 0, n, 1, i, 0, 1, 0)
        shards.append((jcomp.pack_rows_np(padded), np.arange(S_PAD, dtype=np.int32),
                       jcomp.pack_meta_np(meta), np.zeros((1, 2), dtype=np.int32),
                       np.zeros(R_PAD, dtype=np.int32)))
    return shards


def _jax_mesh():
    return jmesh.make_mesh(jax.devices()[:D])


def _port_group(g):
    t = GroupPlan(g, "cpu").tensors
    return t.flank, t.patw, t.patterns_all


def _jax_group(plan):
    return jnp.asarray(plan.flank), jnp.asarray(plan.patw), jnp.asarray(plan.patterns_all)


def _check(outs, total, want, want_total):
    """Per-shard port buffers against the JAX step's sharded output."""
    want = np.asarray(want).reshape(D, -1)
    assert len(outs) == D
    for d, o in enumerate(outs):
        assert o.dtype == torch.int32
        assert np.array_equal(o.numpy(), want[d]), d
    assert int(total) == int(want_total)


@contextlib.contextmanager
def _as_written():
    """Compiled calls inside run as written (as inside another compiled
    call), not through the cache."""
    graphs._inline.depth = getattr(graphs._inline, "depth", 0) + 1
    try:
        yield
    finally:
        graphs._inline.depth -= 1


def _blobs(shards):
    built = [jcomp.build_blob_np(*s) for s in shards]
    spans = built[0][1]
    assert all(b[1] == spans for b in built)
    return np.stack([b for b, _spans in built]), spans


def test_make_mesh(monkeypatch):
    assert pmesh.make_mesh(CPU2) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.make_mesh() == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_sharded_demux_step_matches_jax():
    """test_parallel.py's step on two devices: per-shard buffers and the
    summed hit count equal JAX's, and each reads from a one-device
    ``demux_call`` on its shard."""
    jg = _groups(BarcodeGroup, False)[0]
    plan = _GroupPlan(jg)
    statics = _statics(plan, R_PAD + S_PAD)
    shards = _shards(seed=4)
    cols = [np.concatenate([s[i] for s in shards]) for i in range(5)]
    mesh = _jax_mesh()
    want, want_total = jmesh.sharded_demux_step(mesh, **statics)(
        *_jax_group(plan), *jmesh.shard_rows(mesh, *cols))
    step = pmesh.sharded_demux_step(CPU2, **statics)
    outs, total = step(*_port_group(_groups(port_barcodes.BarcodeGroup, False)[0]),
                       *pmesh.shard_rows(CPU2, *cols))
    _check(outs, total, want, want_total)
    assert int(total) == D * PER  # one hit a read, as test_parallel.py finds


def test_sharded_demux_step_mono_matches_jax():
    jg = _groups(BarcodeGroup, False)[0]
    plan = _GroupPlan(jg)
    statics = _statics(plan, R_PAD + S_PAD)
    blobs, spans = _blobs(_shards(seed=5))
    mesh = _jax_mesh()
    want, want_total = jmesh.sharded_demux_step_mono(mesh, spans=spans, **statics)(
        *_jax_group(plan), *jmesh.shard_rows(mesh, blobs))
    step = pmesh.sharded_demux_step_mono(CPU2, spans=spans, **statics)
    outs, total = step(*_port_group(_groups(port_barcodes.BarcodeGroup, False)[0]),
                       *pmesh.shard_rows(CPU2, blobs))
    _check(outs, total, want, want_total)


def _fused_statics(plans, H_cap):
    """The JAX engine's ``_fused_statics`` layout: each group's own
    items, then the shared ones."""
    per = [_statics(p, H_cap) for p in plans]
    common = {k: v for k, v in per[0].items() if k not in pmesh.GROUP_STATICS}
    groups = tuple(tuple(sorted((k, v) for k, v in st.items() if k not in common))
                   for st in per)
    return groups, tuple(sorted(common.items()))


def test_sharded_demux_step_fused_matches_jax():
    """Two groups in one call a shard on each shard's blob: every
    shard's buffers in plan order and the hit count equal JAX's."""
    plans = [_GroupPlan(g) for g in _groups(BarcodeGroup, True)]
    group_statics, common = _fused_statics(plans, R_PAD + S_PAD)
    blobs, spans = _blobs(_shards(seed=6))
    mesh = _jax_mesh()
    want, want_total = jmesh.sharded_demux_step_fused(
        mesh, spans=spans, group_statics=group_statics, common=common)(
        tuple(_jax_group(p) for p in plans), *jmesh.shard_rows(mesh, blobs))
    step = pmesh.sharded_demux_step_fused(CPU2, spans=spans,
                                          group_statics=group_statics, common=common)
    outs, total = step([_port_group(g) for g in _groups(port_barcodes.BarcodeGroup, True)],
                       *pmesh.shard_rows(CPU2, blobs))
    _check(outs, total, want, want_total)
    assert int(total) > 0


def test_demux_statics_are_checked():
    plan = _GroupPlan(_groups(BarcodeGroup, False)[0])
    statics = _statics(plan, 8)
    with pytest.raises(ValueError, match="top_bit"):
        pmesh.sharded_demux_step(CPU2, **{**statics, "top_bit": plan.top_bit + 1})
    with pytest.raises(ValueError, match="W_words"):
        pmesh.sharded_demux_step(CPU2, **{**statics, "W_words": plan.W_words + 1})
    with pytest.raises(TypeError, match="unknown demux statics"):
        pmesh.sharded_demux_step(CPU2, **statics, _stages=2)
    with pytest.raises(ValueError, match="meta_mode"):
        pmesh.sharded_demux_step(CPU2, **statics, meta_mode="rows")


@pytest.mark.parametrize("form", ["step", "mono", "fused"])
def test_demux_steps_are_one_compiled_call_a_shard(through_cache, form):  # noqa: F811
    """Each shard is one compiled call of one key (one capture, then
    replays), and the shards' hit sum one more (a key of its own), under
    the strict checker; two steps on other rows equal the steps run as
    written (on the CPU)."""
    cache, mode, _eager = through_cache
    two = form == "fused"
    jplans = [_GroupPlan(g) for g in _groups(BarcodeGroup, two)]
    gts = [_port_group(g) for g in _groups(port_barcodes.BarcodeGroup, two)]
    statics = _statics(jplans[0], R_PAD + S_PAD)
    spans = _blobs(_shards(seed=0))[1]
    if form == "step":
        step = pmesh.sharded_demux_step(CPU2, **statics)
    elif form == "mono":
        step = pmesh.sharded_demux_step_mono(CPU2, spans=spans, **statics)
    else:
        group_statics, common = _fused_statics(jplans, R_PAD + S_PAD)
        step = pmesh.sharded_demux_step_fused(CPU2, spans=spans,
                                              group_statics=group_statics, common=common)

    def run(seed):
        shards = _shards(seed)
        if form == "step":
            cols = [np.concatenate([s[i] for s in shards]) for i in range(5)]
            return step(*gts[0], *pmesh.shard_rows(CPU2, *cols))
        blobs = pmesh.shard_rows(CPU2, _blobs(shards)[0])
        return step(gts, *blobs) if two else step(*gts[0], *blobs)

    got = [run(seed) for seed in (7, 8)]
    # shard calls: a capture, then 3 replays; the sum: a capture, then 1
    assert (cache.captures, cache.replays, len(cache.keys())) == (2, 4, 2)
    assert mode.ops > 100
    for seed, (outs, total) in zip((7, 8), got):
        with _as_written():
            want, want_total = run(seed)
        for o, w in zip(outs, want):
            assert torch.equal(o, w)
        assert int(total) == int(want_total)
