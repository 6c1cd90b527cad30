"""The port's upload forms and engine switches against the JAX
package's, on the CPU and on a two-device reads mesh (``["cpu"] * 2``):

* the one-blob upload (``mono_upload``, the default) against separate
  uploads: equal tables, the blob layout byte for byte, and the
  dispatch rule (``last_dispatch``) of ``JaxDemuxEngine`` with the same
  switches on one device and on two;
* fine (1/8-octave) row buckets against powers of two, in the ends and
  the whole-read scan, at non-power-of-two row counts;
* pack mode 1 (padded 2-bit rows) against pack mode 2;
* ``max_hits_per_row`` and ``cat_align``, their environment variables,
  the object API ``demux_batch`` of both engines against the scalar
  ``Demuxer``, and ``sharded_flank_step`` against JAX's.

Groups are cut to a few barcodes; the JAX side runs its jnp path."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu.models import hittable  # noqa: E402
from barbell_tpu.models import records as jax_records  # noqa: E402
from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.models.pipeline import JaxDemuxEngine  # noqa: E402
from barbell_tpu.models.pipeline import _mantissa_bucket as jax_mantissa  # noqa: E402
from barbell_tpu.ops import composite as jcomp  # noqa: E402
from barbell_tpu.ops import device as jdev  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.ops.oracle import scale_alpha, scale_k  # noqa: E402
from barbell_tpu.parallel.mesh import make_mesh  # noqa: E402
from barbell_tpu.parallel.mesh import shard_rows as jax_shard_rows  # noqa: E402
from barbell_tpu.parallel.mesh import sharded_flank_step as jax_flank_step  # noqa: E402
from barbell_tpu.utils import dna  # noqa: E402
from barbell_tpu_torch.models import barcodes as port_barcodes  # noqa: E402
from barbell_tpu_torch.models import pipeline as port_pipeline  # noqa: E402
from barbell_tpu_torch.models import records as port_records  # noqa: E402
from barbell_tpu_torch.models.demux import Demuxer  # noqa: E402
from barbell_tpu_torch.models.pipeline import TorchDemuxEngine  # noqa: E402
from barbell_tpu_torch.models.twotier import EndsPlan, TwoTierDemuxEngine  # noqa: E402
from barbell_tpu_torch.ops import composite as tcomp  # noqa: E402
from barbell_tpu_torch.parallel.mesh import shard_rows, sharded_flank_step  # noqa: E402

N_BARCODES = 6
#: the two groups' (seed, barcode type name): an Ftag and an Rtag group
GROUPS = ((11, "Ftag"), (12, "Rtag"))
PORT = (port_barcodes.BarcodeGroup, port_records.BarcodeType)
JAX = (BarcodeGroup, jax_records.BarcodeType)


def _rand(rng, n):
    return bytes(rng.choice(b"ACGT") for _ in range(n))


def _queries(seed):
    """N_BARCODES queries: 12-base prefix, 14-base barcode, 14-base suffix
    (short flanks keep the plain versions quick on the CPU)."""
    rng = random.Random(seed)
    pre, suf = _rand(rng, 12), _rand(rng, 14)
    return [pre + _rand(rng, 14) + suf for _ in range(N_BARCODES)]


def _groups(pkg, two=False):
    """The test's groups built by one package's classes (``PORT`` or
    ``JAX``): the Ftag group, and with ``two`` the Rtag group too."""
    cls, btype = pkg
    out = []
    for seed, tname in GROUPS[: 2 if two else 1]:
        g = cls.from_seqs(_queries(seed), [f"{tname}{i}" for i in range(N_BARCODES)],
                          getattr(btype, tname))
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
        out.append(g)
    return out


def _reads(n, seed, long_at=(), iupac_at=(), lo=60, hi=240, long_len=700):
    """Reads with an Ftag construct at the start and an rc Rtag
    construct at the end (half of them reverse complemented), bodies of
    ``lo``-``hi`` bases (``long_len`` at ``long_at``: chunk rows at
    256-wide rows) and IUPAC bytes at ``iupac_at``."""
    rng = random.Random(seed)
    front, rear = _queries(GROUPS[0][0]), _queries(GROUPS[1][0])
    ids, seqs = [], []
    for i in range(n):
        body = long_len if i in long_at else rng.randrange(lo, hi)
        seq = (front[rng.randrange(N_BARCODES)] + _rand(rng, body)
               + dna.reverse_complement_bytes(rear[rng.randrange(N_BARCODES)]))
        if i in iupac_at:
            seq = seq[:20] + b"NRYK" + seq[24:]
        if rng.random() < 0.5:
            seq = dna.reverse_complement_bytes(seq)
        ids.append(f"r{i}")
        seqs.append(seq)
    return ids, seqs


def _tables_equal(a, b):
    assert a.read_ids == b.read_ids
    assert np.array_equal(a.read_lens, b.read_lens)
    for c in hittable.COLUMNS:
        assert np.array_equal(a.cols[c], b.cols[c]), c


class _CallSpy:
    """Records every fused call's pack mode, whether its parts are views
    of one storage (the blob) and the row and lane counts it ran at."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = tcomp.demux_call_fused

        def call(groups, parts, **kw):
            ptrs = {p.untyped_storage().data_ptr() for p in parts.values()}
            self.calls.append(dict(
                pack_mode=kw["pack_mode"], one_blob=len(ptrs) == 1,
                desc="rowdesc" in parts, H_cap=kw["H_cap"],
                R_total=parts["meta"].shape[0] if "meta" in parts else None))
            return orig(groups, parts, **kw)

        monkeypatch.setattr(tcomp, "demux_call_fused", call)


def _jax(n_dev, two=False, **kw):
    return JaxDemuxEngine(_groups(JAX, two), devices=jax.devices()[:n_dev],
                          max_row_len=256, **kw)


def _port(n_dev, two=False, **kw):
    return TorchDemuxEngine(_groups(PORT, two), devices=["cpu"] * n_dev,
                            max_row_len=256, **kw)


@pytest.mark.parametrize("n_dev", [1, 2], ids=["one", "mesh"])
@pytest.mark.parametrize("mono", [True, False], ids=["mono", "separate"])
def test_upload_and_dispatch_match_jax(monkeypatch, mono, n_dev):
    """Two groups over chunk rows and IUPAC bytes: fused on the blob, one
    call a group on separate uploads, as the reference decides; the
    blob's parts are views of one storage; on the mesh the descriptor
    metadata rides the blob only."""
    ids, seqs = _reads(8, seed=3, long_at=(2,), iupac_at=(1, 2))
    spy = _CallSpy(monkeypatch)
    port = _port(n_dev, two=True, mono_upload=mono)
    ref = _jax(n_dev, two=True, mono_upload=mono)
    got = port.demux_batch_table(ids, seqs)
    assert got.n_rows >= 16
    _tables_equal(got, ref.demux_batch_table(ids, seqs))
    assert port.last_dispatch == ref.last_dispatch
    want = ("sharded" if n_dev > 1 else "single") + ("-fused" if mono else "")
    assert port.last_dispatch == want
    assert spy.calls and all(c["one_blob"] == mono for c in spy.calls)
    assert all(c["desc"] == (mono or n_dev == 1) for c in spy.calls)
    assert len(spy.calls) == n_dev * (1 if mono else 2)


def test_blob_layout_matches_jax():
    """The blob layout functions give the reference's bytes and spans; on the
    device side every segment is a view of the blob, int32 segments
    reinterpreted in place."""
    rng = np.random.default_rng(0)
    hp = rng.integers(0, 256, 1001, dtype=np.uint8)  # odd: pads the next segment
    rowdesc = rng.integers(0, 2**20, 24, dtype=np.int32)
    cmeta = rng.integers(-2**31, 2**31, (8, 6), dtype=np.int64).astype(np.int32)
    exc = rng.integers(0, 2**20, (64, 2), dtype=np.int32)
    row_start = rng.integers(0, 2**20, 24, dtype=np.int32)
    for args, fn in (((hp, rowdesc, cmeta, exc), "build_blob_desc_np"),
                     ((hp, row_start, cmeta, exc, row_start), "build_blob_np")):
        blob, spans = getattr(tcomp, fn)(*args)
        jblob, jspans = getattr(jcomp, fn)(*args)
        assert np.array_equal(blob, jblob)
        assert [(n, o, tuple(s)) for n, o, s in spans] == \
               [(n, o, tuple(s)) for n, o, s in jspans]
        t = torch.from_numpy(blob)
        parts = tcomp._blob_parts(t, spans)
        jparts = jcomp._blob_parts(jnp.asarray(jblob), jspans)
        for name, p in parts.items():
            assert p.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
            assert np.array_equal(p.numpy(), np.asarray(jparts[name])), name


@pytest.mark.parametrize("ends", [(128, 128), None], ids=["ends", "whole"])
def test_fine_rows_match_pow2_and_jax(monkeypatch, ends):
    """20 reads (one chunked in the whole-read scan): 1/8-octave buckets
    give non-power-of-two row counts and hit capacities (the split rank
    in the ends scan, whose capacity keeps its 256 granule) and the
    tables of powers of two and of the JAX engine under fine rows."""
    ids, seqs = _reads(20, seed=5, long_at=(7,) if ends is None else ())
    spy = _CallSpy(monkeypatch)
    monkeypatch.setenv("BARBELL_META_MODE", "wire")  # the calls show the rows
    want = _port(1, ends_window=ends).demux_batch_table(ids, seqs)
    pow2_rows = spy.calls[-1]["R_total"]
    fine = _port(1, ends_window=ends, fine_rows=True)
    got = fine.demux_batch_table(ids, seqs)
    _tables_equal(got, want)
    _tables_equal(got, _jax(1, ends_window=ends, fine_rows=True).demux_batch_table(ids, seqs))
    R_total, H_cap = spy.calls[-1]["R_total"], spy.calls[-1]["H_cap"]
    assert R_total & (R_total - 1) and R_total < pow2_rows, (R_total, pow2_rows)
    if ends is None:
        assert H_cap == R_total and H_cap % 256  # the non-split rank form
    else:
        assert H_cap % 256 == 0  # the strand-split rank form


@pytest.mark.parametrize("x", [1, 8, 9, 20, 25, 129, 640, 1000, 1153, 131073, 2**20])
def test_mantissa_bucket_matches_jax(x):
    b = port_pipeline._mantissa_bucket(x, 8)
    assert b == jax_mantissa(x, 8) >= x
    assert port_pipeline._row_bucket(x, 8, fine=False) == port_pipeline._pow2_at_least(x, 8)


@pytest.mark.parametrize("n_dev", [1, 2], ids=["one", "mesh"])
def test_pack_mode1_matches_pack_mode2(monkeypatch, n_dev):
    """``BARBELL_PACK_MODE=1``: padded 2-bit rows [R_host, L/4] with the
    exception list (IUPAC bytes, chunk rows of both strands) give pack
    mode 2's table and the JAX engine's under pack mode 1."""
    ids, seqs = _reads(9, seed=11, long_at=(3,), iupac_at=(3, 5))
    want = _port(n_dev).demux_batch_table(ids, seqs)
    spy = _CallSpy(monkeypatch)
    monkeypatch.setenv("BARBELL_PACK_MODE", "1")
    got = _port(n_dev).demux_batch_table(ids, seqs)
    assert {c["pack_mode"] for c in spy.calls} == {1}
    assert not any(c["desc"] for c in spy.calls)
    _tables_equal(got, want)
    _tables_equal(got, _jax(1).demux_batch_table(ids, seqs))


def test_pack_mode1_past_the_exception_cap_falls_back(monkeypatch):
    """More than 4096 non-ACGT bytes (every fourth base an N, on chunk
    rows of both strands): pack mode 1 gives up, as the reference's host
    rule does, and the batch rides nibble rows."""
    ids, seqs = _reads(10, seed=2, lo=900, hi=1000)
    seqs = [s[:60] + bytes(78 if i % 4 == 0 else c for i, c in enumerate(s[60:-60]))
            + s[-60:] for s in seqs]
    assert 2 * sum(s.count(b"N") for s in seqs) > 4096
    spy = _CallSpy(monkeypatch)
    monkeypatch.setenv("BARBELL_PACK_MODE", "1")
    got = _port(1).demux_batch_table(ids, seqs)
    assert {c["pack_mode"] for c in spy.calls} == {0}
    _tables_equal(got, _jax(1).demux_batch_table(ids, seqs))


def test_switch_defaults_and_environment(monkeypatch):
    """The switches' defaults are the reference's (blob on, fine rows off,
    64-byte rows, K = 16); each environment variable sets its switch;
    a bad alignment is refused."""
    for var in ("BARBELL_MONO_UPLOAD", "BARBELL_CAT_ALIGN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(port_pipeline, "_FINE_ROWS", False)
    e = _port(1)
    ref = _jax(1)
    assert (e.mono_upload, e.fine_rows, e.cat_align, e.K) == \
           (ref.mono_upload, ref.fine_rows, ref.cat_align, ref.K) == (True, False, 64, 16)
    monkeypatch.setenv("BARBELL_MONO_UPLOAD", "0")
    monkeypatch.setenv("BARBELL_CAT_ALIGN", "32")
    monkeypatch.setattr(port_pipeline, "_FINE_ROWS", True)
    e = _port(1)
    assert (e.mono_upload, e.fine_rows, e.cat_align) == (False, True, 32)
    e = _port(1, mono_upload=True, fine_rows=False, cat_align=128, max_hits_per_row=4)
    assert (e.mono_upload, e.fine_rows, e.cat_align, e.K) == (True, False, 128, 4)
    with pytest.raises(ValueError, match="cat_align"):
        _port(1, cat_align=48)


@pytest.mark.parametrize("knobs", [dict(cat_align=16), dict(max_hits_per_row=2)],
                         ids=["cat_align", "max_hits"])
def test_knobs_match_jax(knobs):
    """A 16-byte row alignment (the descriptor layout re-derives the row
    starts with it), and K = 2 valleys a row (a read with more goes to
    the scalar fallback): the JAX engine's table with the same knob."""
    ids, seqs = _reads(8, seed=13, long_at=(4,))
    ids.append("multi")
    seqs.append(seqs[0] + seqs[1] + seqs[3])  # six constructs in one row
    got = _port(1, **knobs).demux_batch_table(ids, seqs)
    _tables_equal(got, _jax(1, **knobs).demux_batch_table(ids, seqs))


def test_demux_batch_matches_scalar_demuxer():
    """The object API of both engines: per-read ``BarbellMatch`` lists
    equal to the scalar ``Demuxer``'s; the two-tier engine rescues the
    read whose construct ends inside the shallow window's trigger zone,
    and its deep tier keeps power-of-two rows."""
    groups = _groups(PORT, two=True)
    ids, seqs = _reads(6, seed=17)
    rng = random.Random(4)
    ids.append("chain")
    seqs.append(_rand(rng, 70) + _queries(GROUPS[0][0])[2] + _rand(rng, 700))
    scalar = Demuxer(alpha=0.4)
    for g in groups:
        scalar.add_query_group(g)
    want = [scalar.demux(r, s) for r, s in zip(ids, seqs)]
    assert TorchDemuxEngine(groups, device="cpu").demux_batch(ids, seqs) == want
    two = TwoTierDemuxEngine(groups, EndsPlan((160, 160), (320, 160), 60),
                             device="cpu", fine_rows=True)
    assert two.deep.fine_rows is False and two.shallow.fine_rows is True
    assert two.demux_batch(ids, seqs) == want
    assert two.last_rescued == 1


def test_sharded_flank_step_matches_jax():
    """The plain flank stages on a two-device mesh: per-shard hits
    concatenate to JAX's ``sharded_flank_step`` hits on one CPU device,
    and the rows-with-hits sum lands on the first device."""
    g = _groups(PORT)[0]
    rng = np.random.default_rng(1)
    B, L = 8, 160
    flank = np.asarray(g.flank_masks, dtype=np.uint8)
    rows = np.array([1, 2, 4, 8], np.uint8)[rng.integers(0, 4, (B, L))]
    for b in range(0, B, 2):
        p = int(rng.integers(0, 100))
        rows[b, p : p + len(flank)] = flank
    lens = rng.integers(140, L + 1, B).astype(np.int32)
    for b in range(B):
        rows[b, lens[b]:] = 0
    start = np.zeros(B, np.int32)
    lo = np.zeros(B, np.int32)
    k_scaled, alpha = scale_k(g.k_cutoff), scale_alpha(0.4)
    mesh = make_mesh(jax.devices()[:1])
    want, want_found = jax_flank_step(mesh, K=8)(
        jnp.asarray(flank), *jax_shard_rows(mesh, rows, start, lens, lo, lens),
        np.int32(k_scaled), np.int32(alpha))
    step = sharded_flank_step(["cpu"] * 2, K=8)
    hits, found = step(torch.from_numpy(flank),
                       *shard_rows(["cpu"] * 2, rows, start, lens, lo, lens),
                       k_scaled, alpha)
    assert len(hits) == 2 and hits[0].pos.shape == (B // 2, 8)
    for name in jdev.Hits._fields:
        got = torch.cat([getattr(h, name) for h in hits]).numpy()
        assert np.array_equal(got, np.asarray(getattr(want, name))), name
    assert int(found) == int(want_found) >= B // 2
