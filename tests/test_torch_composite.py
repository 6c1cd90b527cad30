"""The port's fused demux call against the JAX package's ``demux_call``
(``pack_mode=2, meta_mode='desc'``) on small batches with rc reads and
IUPAC-carrying reads: ends-mode batches with long (end-window) reads,
and whole-read-scan batches (``ends_w = 0``) whose long reads become
forward + rc chunk rows, in both rank forms.  The hit records must be
identical integers, against the JAX jnp path and against its Pallas
kernels in interpret mode.

The Pallas comparisons use a 4-barcode group with 11-base barcode
patterns: the rank kernel unrolls its pattern rows, and in interpret
mode its XLA compile grows steeply with the pattern length (about 270 s
on one CPU core for the flagship's 44).  Each kernel's plain version is
held to its Pallas kernel at other widths by the per-kernel tests; these
show the glue around them."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu import PADDING  # noqa: E402
from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.models.pipeline import JaxDemuxEngine  # noqa: E402
from barbell_tpu.models.records import BarcodeType  # noqa: E402
from barbell_tpu.ops import composite as jcomp  # noqa: E402
from barbell_tpu.ops import pallas_myers  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.sim.simulate import (  # noqa: E402
    default_barcodes,
    mutate_sequence,
    rapid_adapter,
    random_sequence,
)
from barbell_tpu.utils import dna  # noqa: E402
from barbell_tpu_torch.models import barcodes as port_barcodes  # noqa: E402
from barbell_tpu_torch.models import records as port_records  # noqa: E402
from barbell_tpu_torch.models.pipeline import (  # noqa: E402
    TorchDemuxEngine,
    _pow2_at_least,
)
from barbell_tpu_torch.ops import composite as tcomp  # noqa: E402

ENDS = (512, 512)
N_BARCODES = 4
H_CAP = 256


@pytest.fixture(autouse=True)
def _myers_unroll_1(monkeypatch):
    """The Pallas Myers kernel unrolls its position loop 16-fold for the
    TPU's scheduler (``BARBELL_MYERS_UNROLL``); the arithmetic is the
    same at any factor, and at 1 its interpret-mode trace compiles about
    16 times faster on the CPU."""
    monkeypatch.setattr(pallas_myers, "UNROLL", 1)


def _groups(group_cls, _btype):
    groups = group_cls.from_kit("SQK-RBK114-96", False)
    for g in groups:
        g.barcodes = g.barcodes[:N_BARCODES]
        g.patterns_fwd = g.patterns_fwd[:N_BARCODES]
        g.patterns_rc = g.patterns_rc[:N_BARCODES]
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


PRE, SUF = b"GCTA", b"TCA"  # the small group's flank around its barcode
SMALL_BCS = [b"ACGT", b"TTGC", b"CAAG", b"GGTA"]
SMALL_ENDS = (128, 128)


def _small_groups(group_cls, btype):
    g = group_cls.from_seqs(
        [PRE + b + SUF for b in SMALL_BCS],
        [f"S{i}" for i in range(len(SMALL_BCS))], btype,
    )
    g.set_flank_threshold(1)
    return [g]


def _small_reads(lengths, seam_at=None):
    """Constructs of the small group at a read's start (rc for odd
    reads), one N inside a flank, and optionally a construct planted at
    ``seam_at`` across a chunk seam."""
    rng = random.Random(31)
    seqs = []
    for i, n in enumerate(lengths):
        c = PRE + SMALL_BCS[i % len(SMALL_BCS)] + SUF
        seq = bytes(random_sequence(rng, 6)) + c + bytes(random_sequence(rng, n))
        if seam_at is not None and i == 1:
            c2 = PRE + SMALL_BCS[2] + SUF
            seq = seq[:seam_at] + c2 + seq[seam_at + len(c2):]
        if i % 2:
            seq = dna.reverse_complement_bytes(seq)
        seqs.append(mutate_sequence(rng, seq, 0, 1))
    seqs[2] = seqs[2][:7] + b"N" + seqs[2][8:]  # N inside the flank
    return seqs


def _ends_reads():
    rng = random.Random(17)
    bcs = default_barcodes(N_BARCODES)
    seqs = []
    for i, n in enumerate([300, 900, 1400, 200]):
        label, bseq = bcs[i]
        seq = rapid_adapter(bseq) + bytes(random_sequence(rng, n))
        if i % 2:
            seq = dna.reverse_complement_bytes(seq)
        seqs.append(mutate_sequence(rng, seq, 0, 4))
    seqs[2] = seqs[2][:40] + b"NNRY" + seqs[2][44:]  # IUPAC in the flank
    return seqs


def _host_arrays(eng, seqs, L):
    """(plan, lens, R_host_pad, S_pad) of one batch, as the engine pads it."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    step = L - PADDING - eng.halo
    if isinstance(eng, TorchDemuxEngine):
        plan = eng._plan(lens, L, step)
    else:
        plan = eng._plan_shard(seqs, lens, range(len(seqs)), L, step)
    return plan, lens, _pow2_at_least(plan.R_host, 8), _pow2_at_least(plan.F, 8)


def _run_both(make_groups, use_pallas, seqs, ends, L_want, H_cap=None):
    """(JAX output, port output, port plan, R_host_pad, wbits, H_cap) for
    one batch; the JAX call on its Pallas kernels in interpret mode or on
    its jnp path.  Each engine gets groups built by its own package's
    classes (``make_groups(group_cls, barcode_type)``).  The host arrays
    of both engines must be identical first.  ``H_cap`` None is the
    engine's own initial capacity."""
    jeng = JaxDemuxEngine(make_groups(BarcodeGroup, BarcodeType.Ftag),
                          use_pallas=use_pallas, devices=jax.devices()[:1],
                          ends_window=ends, max_row_len=L_want)
    teng = TorchDemuxEngine(
        make_groups(port_barcodes.BarcodeGroup, port_records.BarcodeType.Ftag),
        ends_window=ends, device="cpu", max_row_len=L_want,
    )
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    L = jeng._choose_L(lens)
    assert L == teng._choose_L(lens) == L_want
    step = L - PADDING - jeng.halo
    plan, lens, R_host_pad, S_pad = _host_arrays(jeng, seqs, L)
    tplan, _, tR, tS = _host_arrays(teng, seqs, L)
    assert (tR, tS) == (R_host_pad, S_pad)
    mat = jeng._materialize(plan, seqs, lens, L, R_host_pad, S_pad)
    assert mat.pack_mode == 2
    tmat = teng._materialize(tplan, seqs, lens, L, R_host_pad, S_pad)
    for a, b in ((mat.host_packed, tmat.host_packed), (mat.rowdesc, tmat.rowdesc),
                 (mat.exc, tmat.exc), (mat.meta, tmat.meta),
                 (mat.chunk_meta, tmat.chunk_meta)):
        assert np.array_equal(a[: b.shape[0]], b)
    assert (tmat.exc[:, 0] < R_host_pad * L).sum() >= 1  # the IUPAC bytes
    R_total_pad = R_host_pad + S_pad
    if H_cap is None:
        H_cap = teng._h_cap(len(seqs), tplan, R_total_pad)
        assert H_cap == jeng._h_cap(len(seqs), plan, R_total_pad)

    (gplan,) = jeng.plans
    statics = jeng._group_statics(
        gplan, 2, L, step, H_cap, {"meta_mode": "desc", "S_pad": S_pad}
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
    (gp,) = teng.plans
    gi, gf = teng._group_scalars(gp, step)
    t = gp.tensors
    got = tcomp.demux_call(
        t.flank, t.patw, t.patterns_all, torch.from_numpy(tmat.host_packed),
        torch.from_numpy(tmat.rowdesc), torch.from_numpy(tmat.chunk_meta),
        torch.from_numpy(tmat.exc),
        gi=gi, gf=gf, K=teng.K, m=gp.m, k_units=gp.k_units,
        Wf=gp.span, plen=gp.plen, Wb=gp.barcode_window,
        P=gp.n_patterns, H_cap=H_cap, padding=PADDING, L_rows=L,
        ends_w=teng.ends_wl, ends_wr=teng.ends_wr, halo=teng.halo,
        S_pad=S_pad,
    )
    assert got.dtype == torch.int32
    wbits = tcomp.rec_wire_spec(L, R_total_pad, gp.k_units, gp.n_patterns,
                                gp.plen, gp.barcode_window)
    return want, got.numpy(), tplan, R_host_pad, wbits, H_cap


def test_demux_call_matches_jax_jnp_path():
    """Against the JAX package's jnp path (``use_pallas=False``), which
    it holds equal to the kernel path.  That path packs hits into lanes
    in flat row order instead of the strand-split halves, so the hit
    records are compared as sets sorted by (row, column); the overflow
    words must be identical and the totals must agree."""
    want, got, _, R_host_pad, wbits, _ = _run_both(
        _groups, False, _ends_reads(), ENDS, 512, H_CAP
    )
    assert wbits is not None
    n = H_CAP * tcomp.REC_WIRE_COLS
    total = int(want[-1])
    jrec = tcomp.unpack_rec_np(want, H_CAP, wbits)[:total]
    trec = tcomp.unpack_rec_np(got, H_CAP, wbits)
    n_fwd = int((jrec[:, tcomp.REC_ROW] < R_host_pad).sum())
    n_rc = total - n_fwd
    half = H_CAP // 2
    trec = np.concatenate([trec[:n_fwd], trec[half : half + n_rc]])

    def by_row_col(r):
        return r[np.lexsort((r[:, tcomp.REC_COL], r[:, tcomp.REC_ROW]))]

    assert 4 <= total <= half
    assert np.array_equal(by_row_col(trec), by_row_col(jrec))
    assert np.array_equal(got[n:-1], want[n:-1])  # overflow bitmask words
    assert int(got[-1]) == max(total, 2 * max(n_fwd, n_rc))


def test_demux_call_matches_jax_pallas_interpret():
    """An ends-mode batch of the small group (reads longer than the
    256-wide rows ship as 128-base end windows), JAX side on its Pallas
    kernels in interpret mode: the packed int32 buffers are identical."""
    seqs = _small_reads([40, 300, 120, 500, 20])
    want, got, plan, *_ = _run_both(
        _small_groups, True, seqs, SMALL_ENDS, 256, H_CAP
    )
    assert plan.E == 2  # two reads as prefix/suffix window pairs
    assert np.array_equal(got, want)
    assert 5 <= int(want[-1]) <= H_CAP


@pytest.mark.parametrize("form", ["nonsplit", "split"])
def test_demux_call_full_scan_matches_jax_pallas_interpret(form):
    """Whole-read scan (``ends_w = 0``) of the small group at 256-wide
    rows: long reads ship as forward + rc chunk rows (tag-3 descriptors
    with packed chunk metadata), and a construct straddles the seam at
    ``step`` = 221.  ``H_cap`` is the engine's own, ``R_total_pad`` (not
    a multiple of 256: the non-split rank), or 256 (the strand-split
    rank).  The packed int32 buffers are identical to the JAX package's
    on its Pallas kernels."""
    seqs = _small_reads([60, 600, 90, 330, 30], seam_at=210)
    want, got, plan, _, _, H_cap = _run_both(
        _small_groups, True, seqs, None, 256,
        None if form == "nonsplit" else 256,
    )
    assert (H_cap % 256 != 0) == (form == "nonsplit")
    assert len(plan.rows_meta) >= 8  # chunk rows of both strands
    assert np.array_equal(got, want)
    assert 6 <= int(want[-1]) <= H_cap
