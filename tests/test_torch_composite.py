"""The port's fused demux call against the JAX package's ``demux_call``
(``pack_mode=2, meta_mode='desc'``) on one small ends-mode batch with
rc reads, an IUPAC-carrying read and long (end-window) reads: the hit
records must be identical integers, against the JAX jnp path and
against its Pallas kernels in interpret mode."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu import PADDING  # noqa: E402
from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.models.pipeline import JaxDemuxEngine  # noqa: E402
from barbell_tpu.ops import composite as jcomp  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.sim.simulate import (  # noqa: E402
    default_barcodes,
    mutate_sequence,
    rapid_adapter,
    random_sequence,
)
from barbell_tpu.utils import dna  # noqa: E402
from barbell_tpu_torch.models.pipeline import TorchDemuxEngine  # noqa: E402
from barbell_tpu_torch.ops import composite as tcomp  # noqa: E402

ENDS = (512, 512)


def _groups(n_barcodes=8):
    groups = BarcodeGroup.from_kit("SQK-RBK114-96", False)
    for g in groups:
        g.barcodes = g.barcodes[:n_barcodes]
        g.patterns_fwd = g.patterns_fwd[:n_barcodes]
        g.patterns_rc = g.patterns_rc[:n_barcodes]
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def _reads():
    rng = random.Random(17)
    bcs = default_barcodes(8)
    seqs = []
    for i in range(6):
        label, bseq = bcs[i]
        body = bytes(random_sequence(rng, [300, 900, 1400, 200, 2600, 700][i]))
        seq = rapid_adapter(bseq) + body
        if i % 2:
            seq = dna.reverse_complement_bytes(seq)
        seqs.append(mutate_sequence(rng, seq, 0, 4))
    seqs[2] = seqs[2][:40] + b"NNRY" + seqs[2][44:]  # IUPAC in the flank
    return [f"c{i}" for i in range(len(seqs))], seqs


def _run_both(use_pallas):
    """(JAX output, port output, R_host_pad, wbits) for one batch; the
    JAX call on its Pallas kernels in interpret mode or on its jnp path."""
    groups = _groups()
    ids, seqs = _reads()
    jeng = JaxDemuxEngine(groups, use_pallas=use_pallas,
                          devices=jax.devices()[:1], ends_window=ENDS)
    teng = TorchDemuxEngine(groups, ends_window=ENDS, device="cpu")
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    L = jeng._choose_L(lens)
    assert L == teng._choose_L(lens) == 512
    step = L - PADDING - jeng.halo
    plan = jeng._plan_shard(seqs, lens, range(len(seqs)), L, step)
    R_host_pad = S_pad = 16
    mat = jeng._materialize(plan, seqs, lens, L, R_host_pad, S_pad)
    assert mat.pack_mode == 2
    tmat = teng._materialize(teng._plan(lens, L), seqs, lens, L, R_host_pad, S_pad)
    for a, b in ((mat.host_packed, tmat.host_packed), (mat.rowdesc, tmat.rowdesc),
                 (mat.exc, tmat.exc), (mat.meta, tmat.meta)):
        assert np.array_equal(a[: b.shape[0]], b)
    assert (tmat.exc[:, 0] < R_host_pad * L).sum() == 4  # the IUPAC bytes

    (gplan,) = jeng.plans
    statics = jeng._group_statics(
        gplan, 2, L, step, H_CAP, {"meta_mode": "desc", "S_pad": S_pad}
    )
    assert statics["use_pallas"] == use_pallas and statics["interpret"]
    want = np.asarray(
        jcomp.demux_call(
            gplan.flank_dev, gplan.patw_dev, gplan.patterns_all_dev,
            jnp.asarray(mat.host_packed), jnp.asarray(mat.chunk_meta),
            jnp.asarray(mat.rowdesc), jnp.asarray(mat.exc),
            jnp.zeros(1, dtype=jnp.int32), **statics,
        )
    )
    (tplan,) = teng.plans
    gi, gf = teng._group_scalars(tplan)
    t = tplan.tensors
    got = tcomp.demux_call(
        t.flank, t.patw, t.patterns_all, torch.from_numpy(tmat.host_packed),
        torch.from_numpy(tmat.rowdesc), torch.from_numpy(tmat.exc),
        gi=gi, gf=gf, K=teng.K, m=tplan.m, k_units=tplan.k_units,
        Wf=tplan.span, plen=tplan.plen, Wb=tplan.barcode_window,
        P=tplan.n_patterns, H_cap=H_CAP, padding=PADDING, L_rows=L,
        ends_w=ENDS[0], ends_wr=ENDS[1], halo=teng.halo, S_pad=S_pad,
    )
    assert got.dtype == torch.int32
    wbits = tcomp.rec_wire_spec(L, R_host_pad + S_pad, tplan.k_units,
                                tplan.n_patterns, tplan.plen,
                                tplan.barcode_window)
    return want, got.numpy(), R_host_pad, wbits


H_CAP = 256


def test_demux_call_matches_jax_jnp_path():
    """Against the JAX package's jnp path (``use_pallas=False``), which
    it holds equal to the kernel path.  That path packs hits into lanes
    in flat row order instead of the strand-split halves, so the hit
    records are compared as sets sorted by (row, column); the overflow
    words must be identical and the totals must agree."""
    want, got, R_host_pad, wbits = _run_both(use_pallas=False)
    assert wbits is not None
    n = H_CAP * tcomp.REC_WIRE_COLS
    jrec = tcomp.unpack_rec_np(want, H_CAP, wbits)
    trec = tcomp.unpack_rec_np(got, H_CAP, wbits)
    total = int(want[-1])
    jrec = jrec[:total]
    n_fwd = int((jrec[:, tcomp.REC_ROW] < R_host_pad).sum())
    n_rc = total - n_fwd
    half = H_CAP // 2
    trec = np.concatenate([trec[:n_fwd], trec[half : half + n_rc]])

    def by_row_col(r):
        return r[np.lexsort((r[:, tcomp.REC_COL], r[:, tcomp.REC_ROW]))]

    assert 6 <= total <= half
    assert np.array_equal(by_row_col(trec), by_row_col(jrec))
    assert np.array_equal(got[n:-1], want[n:-1])  # overflow bitmask words
    assert int(got[-1]) == max(total, 2 * max(n_fwd, n_rc))


def test_demux_call_matches_jax_pallas_interpret():
    """Same batch, JAX side on its Pallas kernels in interpret mode
    (~30 s on one CPU core): the packed int32 buffers are identical."""
    want, got, _, _ = _run_both(use_pallas=True)
    assert np.array_equal(got, want)
    assert 6 <= int(want[-1]) <= H_CAP
