"""The engine's other host forms against its default (2-bit concatenated
rows, descriptor metadata) and against the JAX package: nibble rows
(pack mode 0) under ``BARBELL_PACK_MODE=0``, for a batch with more than
4096 non-ACGT bytes and without the native IO library (the numpy
encoder); uploaded ("wire") metadata under ``meta_mode='wire'`` /
``BARBELL_META_MODE=wire``."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs
jax = pytest.importorskip("jax")

from barbell_tpu import PADDING  # noqa: E402
from barbell_tpu.models import hittable  # noqa: E402
from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.models.pipeline import JaxDemuxEngine  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.sim.simulate import (  # noqa: E402
    default_barcodes,
    mutate_sequence,
    rapid_adapter,
    random_sequence,
)
from barbell_tpu.utils import dna  # noqa: E402
from barbell_tpu_torch.models import barcodes as port_barcodes  # noqa: E402
from barbell_tpu_torch.models import pipeline  # noqa: E402
from barbell_tpu_torch.models.pipeline import TorchDemuxEngine, _pow2_at_least  # noqa: E402
from barbell_tpu_torch.ops import composite as tcomp  # noqa: E402

N_BARCODES = 8


def _groups(group_cls=BarcodeGroup):
    groups = group_cls.from_kit("SQK-RBK114-96", False)
    for g in groups:
        g.barcodes = g.barcodes[:N_BARCODES]
        g.patterns_fwd = g.patterns_fwd[:N_BARCODES]
        g.patterns_rc = g.patterns_rc[:N_BARCODES]
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def _reads(lengths, seed=5, n_every=0):
    """RBK constructs at the start of random bodies (rc for odd reads),
    IUPAC bytes in one flank, and with ``n_every`` an N at every
    ``n_every``-th base of every body."""
    rng = random.Random(seed)
    bcs = default_barcodes(N_BARCODES)
    ids, seqs = [], []
    for i, n in enumerate(lengths):
        body = random_sequence(rng, n)
        if n_every:
            body[::n_every] = b"N" * len(body[::n_every])
        body = bytes(body)
        seq = rapid_adapter(bcs[i % N_BARCODES][1]) + body
        if i % 2:
            seq = dna.reverse_complement_bytes(seq)
        ids.append(f"f{i}")
        seqs.append(mutate_sequence(rng, seq, 0, 3))
    seqs[0] = seqs[0][:40] + b"NRY" + seqs[0][43:]
    return ids, seqs


def _tables_equal(a, b):
    assert a.read_ids == b.read_ids
    for c in hittable.COLUMNS:
        assert np.array_equal(a.cols[c], b.cols[c]), c


class _Spy:
    """Records the pack mode and metadata layout of every fused call."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = tcomp.demux_call_fused

        def spy(groups, parts, **kw):
            self.calls.append((kw["pack_mode"],
                               "desc" if "rowdesc" in parts else "wire"))
            return orig(groups, parts, **kw)

        monkeypatch.setattr(tcomp, "demux_call_fused", spy)


def _port(**kw):
    return TorchDemuxEngine(_groups(port_barcodes.BarcodeGroup), device="cpu",
                            max_row_len=512, **kw)


@pytest.mark.parametrize("ends", [(256, 256), None], ids=["ends", "whole"])
def test_pack_mode0_matches_2bit(monkeypatch, ends):
    """``BARBELL_PACK_MODE=0``: nibble rows with wire metadata, ends rows
    or forward + rc chunk rows of the reads longer than the 512-wide
    rows, give the 2-bit path's table."""
    ids, seqs = _reads([150, 900, 400, 1300, 60])
    want = _port(ends_window=ends).demux_batch_table(ids, seqs)
    spy = _Spy(monkeypatch)
    monkeypatch.setenv("BARBELL_PACK_MODE", "0")
    got = _port(ends_window=ends).demux_batch_table(ids, seqs)
    assert spy.calls == [(0, "wire")]
    _tables_equal(got, want)
    assert want.n_rows >= 5


def test_exception_overflow_takes_nibble_and_matches_jax(monkeypatch):
    """More than 4096 N bytes in one batch (20 reads whose bodies carry
    an N at every fourth base, shipped as 512-base end windows) overflow
    the 2-bit exception list: the batch takes pack mode 0 by itself, and
    its table equals the JAX engine's."""
    ids, seqs = _reads([900 + 7 * i for i in range(20)], seed=9, n_every=4)
    spy = _Spy(monkeypatch)
    port = _port(ends_window=(512, 512))
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    plan = port._plan(lens, 512, 512 - PADDING - port.halo)
    shipped = sum(s[:512].count(b"N") + s[-512:].count(b"N") for s in seqs)
    assert plan.E == 20 and shipped > 4096
    got = port.demux_batch_table(ids, seqs)
    assert spy.calls == [(0, "wire")]
    ref = JaxDemuxEngine(_groups(), devices=jax.devices()[:1], max_row_len=512,
                         ends_window=(512, 512))
    _tables_equal(got, ref.demux_batch_table(ids, seqs))
    assert got.n_rows >= 5


def test_no_native_library_uses_numpy_encoder(monkeypatch):
    """Without the native IO library the engine packs nibble rows with
    its numpy encoder: the bytes equal the native nibble encoder's
    (``force_nibble``) and the JAX engine's, and the table equals the
    JAX engine's."""
    ids, seqs = _reads([150, 900, 400, 1300, 60], seed=2)
    port = _port()
    ref = JaxDemuxEngine(_groups(), devices=jax.devices()[:1], max_row_len=512)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    L = port._choose_L(lens)
    step = L - PADDING - port.halo
    plan = port._plan(lens, L, step)
    jplan = ref._plan_shard(seqs, lens, range(len(seqs)), L, step)
    R_host_pad, S_pad = _pow2_at_least(plan.R_host, 8), _pow2_at_least(plan.F, 8)
    assert plan.rows_meta  # chunk rows
    native = port._materialize(plan, seqs, lens, L, R_host_pad, S_pad,
                               force_nibble=True)
    jmat = ref._materialize(jplan, seqs, lens, L, R_host_pad, S_pad,
                            force_nibble=True)

    monkeypatch.setattr(pipeline, "get_lib", lambda: None)
    mat = port._materialize(plan, seqs, lens, L, R_host_pad, S_pad)
    assert mat.pack_mode == native.pack_mode == jmat.pack_mode == 0
    for name in ("host_packed", "simple_idx", "meta"):
        for other in (native, jmat):
            assert np.array_equal(getattr(mat, name), getattr(other, name)), name
    spy = _Spy(monkeypatch)
    got = port.demux_batch_table(ids, seqs)
    assert spy.calls == [(0, "wire")]
    _tables_equal(got, ref.demux_batch_table(ids, seqs))


def test_wire_meta_matches_desc(monkeypatch):
    """Uploaded ("wire") metadata with the 2-bit rows, chosen by the
    engine's argument or by ``BARBELL_META_MODE=wire``: the table of an
    ends-scan batch equals the descriptor layout's."""
    ids, seqs = _reads([150, 900, 400, 1300, 60], seed=4)
    want = _port(ends_window=(256, 256)).demux_batch_table(ids, seqs)
    spy = _Spy(monkeypatch)
    port = _port(ends_window=(256, 256), meta_mode="wire")
    _tables_equal(port.demux_batch_table(ids, seqs), want)
    assert spy.calls == [(2, "wire")]
    monkeypatch.setenv("BARBELL_META_MODE", "wire")
    assert _port().meta_mode == "wire"
    monkeypatch.setenv("BARBELL_META_MODE", "desc")
    assert _port().meta_mode == "desc"
