"""The port beyond the rapid kit, on the CPU against the JAX package:

* for every registered kit family, the port's ``kit_plan`` (safe and
  ``--maximize``) and its groups' shapes equal what ``barbell_tpu``'s
  kit runner builds from the same presets and groups;
* the port's ends engine (two-tier where the plan has a deep tier) gives
  JAX's ``HitTable`` on 8 reads of ``make_reads_kit`` for a
  native-barcoding kit (NB96), the two-template PCR kit (PCR96) and 16S,
  LWB24, MAB and VMK, safe and ``--maximize``; for PCR96 the last read
  is a chain that the deep tier rescues under ``--maximize`` (both
  groups at the 1152-deep tier);
* one kit-runner run of ``SQK-NBD114-96 --maximize`` (one read rescued
  at the 1024-deep tier) writes JAX's files byte for byte.

JAX runs its jnp path (the CPU default); no Pallas kernel is compiled."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs
jax = pytest.importorskip("jax")

from barbell_tpu.kits.database import get_kit_info as jax_kit_info  # noqa: E402
from barbell_tpu.kits.presets import preset_patterns as jax_presets  # noqa: E402
from barbell_tpu.models import hittable  # noqa: E402
from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.models.pipeline import _GroupPlan  # noqa: E402
from barbell_tpu.models.twotier import make_ends_engine as jax_ends_engine  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.stages.kit import KitRunConfig  # noqa: E402
from barbell_tpu.stages.kit import demux_using_kit as jax_demux_using_kit  # noqa: E402
from barbell_tpu.stages.kit import ends_plan_for_patterns as jax_plan_for  # noqa: E402
from barbell_tpu.stages.pattern import pattern_from_str as jax_pattern  # noqa: E402
from barbell_tpu_torch.kits.database import _KITS, expand_template, supported_kits  # noqa: E402
from barbell_tpu_torch.models.groups import GroupPlan  # noqa: E402
from barbell_tpu_torch.models.twotier import make_ends_engine  # noqa: E402
from barbell_tpu_torch.sim import make_reads_kit, write_fastq  # noqa: E402
from barbell_tpu_torch.sim.simulate import random_sequence  # noqa: E402
from barbell_tpu_torch.stages.kit import KitRunConfig as PortKitRunConfig  # noqa: E402
from barbell_tpu_torch.stages.kit import demux_using_kit, kit_groups, kit_plan  # noqa: E402
from barbell_tpu_torch.utils import dna  # noqa: E402

#: one alias of each registered family, in registry order
FAMILIES = {}
for _alias in supported_kits():
    FAMILIES.setdefault(_KITS[_alias].name, _alias)

#: the kits the engine is held to JAX on: a native-barcoding kit, the
#: two-template PCR kit, and the other shapes of rows and flanks; PCR96
#: with a read that the deep tier rescues (a deep tier's first call is a
#: JAX compile of its own, so the others go without; the kit runner's
#: test rescues an NB96 read)
ENGINE_KITS = ["SQK-NBD114-96", "EXP-PBC096", "SQK-16S024", "SQK-PCB111-24",
               "SQK-MAB114-24", "VSK-VMK001"]
RESCUE_KITS = ("EXP-PBC096",)


def _jax_groups(kit):
    """The JAX kit runner's groups: its flank thresholds, no extended
    templates."""
    groups = BarcodeGroup.from_kit(kit, False)
    for g in groups:
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def _jax_plan(kit, maximize):
    """The ends plan JAX's kit runner builds from the kit's presets."""
    pats = [jax_pattern(s) for s in jax_presets(jax_kit_info(kit).pattern_class, maximize)]
    return jax_plan_for(pats, _jax_groups(kit))


def _plan_tuple(plan):
    return None if plan is None else (plan.shallow, plan.deep, plan.trigger_margin)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_kit_plan_and_groups_match_jax(family):
    kit = FAMILIES[family]
    for maximize in (False, True):
        assert _plan_tuple(kit_plan(kit, maximize)) == _plan_tuple(_jax_plan(kit, maximize))
    got, want = kit_groups(kit), _jax_groups(kit)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gp, wp = GroupPlan(g, "cpu"), _GroupPlan(w)
        for attr in ("m", "k_units", "span", "plen", "barcode_window", "n_patterns",
                     "mask_start", "mask_end", "rel_bar_start", "rel_bar_end",
                     "k1_scaled", "perfect"):
            assert getattr(gp, attr) == getattr(wp, attr), attr
        assert gp.patw.shape[1] == wp.W_words
        assert np.array_equal(gp.flank, wp.flank)
        assert np.array_equal(gp.patterns_all, wp.patterns_all)
        assert [b.label for b in g.barcodes] == [b.label for b in w.barcodes]


def _chain_read(kit, seed):
    """A read whose first construct lies past the shallow tier's trigger
    depth and repeats after a gap, then a body and the kit's other end:
    the two-tier engine rescues it under ``--maximize``."""
    import random

    rng = random.Random(seed)
    spec = _KITS[kit]
    sides = {"left": [], "right": []}
    for t in spec.templates:
        if not t.extended:
            sides[t.side].append(expand_template(t)[1][0].encode())
    front = b"".join(sides["left"])
    rear = b"".join(dna.reverse_complement_bytes(c) for c in sides["right"])
    if spec.pattern_class == "double" and not sides["right"]:
        rear = dna.reverse_complement_bytes(front)
    junk, gap, body = (bytes(random_sequence(rng, n)) for n in (180, 220, 1200))
    return junk + front + gap + front + body + rear


def _reads(kit, n, seed, chain: bool):
    """``n`` reads of ``make_reads_kit``, the last a chain read when
    ``chain``."""
    reads = make_reads_kit(kit, n - chain, seed)
    ids = [r for r, _s, _l in reads] + ["chain"] * chain
    seqs = [s for _r, s, _l in reads] + [_chain_read(kit, seed)] * chain
    return ids, seqs


@pytest.mark.parametrize("kit", ENGINE_KITS)
def test_ends_engine_matches_jax(kit):
    """Safe and ``--maximize`` in one test (the two plans share a shallow
    tier, so JAX compiles it once)."""
    ids, seqs = _reads(kit, 8, seed=11, chain=kit in RESCUE_KITS)
    for maximize in (False, True):
        plan = kit_plan(kit, maximize)
        port = make_ends_engine(kit_groups(kit), plan, device="cpu")
        ref = jax_ends_engine(_jax_groups(kit), _jax_plan(kit, maximize),
                              devices=jax.devices()[:1])
        got, want = port.demux_batch_table(ids, seqs), ref.demux_batch_table(ids, seqs)
        assert got.read_ids == want.read_ids
        assert np.array_equal(got.read_lens, want.read_lens)
        for c in hittable.COLUMNS:
            assert np.array_equal(got.cols[c], want.cols[c]), (maximize, c)
        assert got.n_rows >= len(ids)
        if plan.deep:
            assert port.last_rescued == ref.last_rescued == (kit in RESCUE_KITS)
        if len(port.groups) > 1:
            assert port.last_dispatch == "single-fused"


def test_kit_runner_nbd_maximize_matches_jax(tmp_path, monkeypatch):
    """``kit -k SQK-NBD114-96 --maximize`` on 20 reads (one rescued by
    the deep tier): every file byte-identical to the JAX runner's, which
    runs on one CPU device as the port does."""
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    ids, seqs = _reads("SQK-NBD114-96", 20, seed=12, chain=True)
    fq = tmp_path / "reads.fastq"
    write_fastq(str(fq), list(zip(ids, seqs)))

    def run(fn, cfg_cls, backend, out, **kw):
        fn([str(fq)], cfg_cls(kit_name="SQK-NBD114-96", output_folder=str(out),
                              backend=backend, batch_size=20, maximize=True), **kw)
        return {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}

    got = run(demux_using_kit, PortKitRunConfig, "torch", tmp_path / "port", device="cpu")
    want = run(jax_demux_using_kit, KitRunConfig, "jax", tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert sum(n.endswith(".trimmed.fastq") for n in got) >= 10


def test_ends_scan_leaves_out_mid_read_hits_as_jax_does(tmp_path, monkeypatch):
    """``docs/SEMANTICS.md`` deviation 7, found by ``chip_smoke.py``'s
    ``[kits]`` on ``make_reads_kit("SQK-MAB114-24", ..., seed=0)``'s read
    46 (1588 bp): a flank-only (Fflank) hit 353-399 bases from its end,
    in the middle that the default ends scan (384-base windows) does not
    scan.  The port's kit runner writes the JAX package's files there
    (the hit left out, the read kept by the filter), and under
    ``--full-scan`` the oracle backend's (the hit in, the read dropped)."""
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    kit = "SQK-MAB114-24"
    read = make_reads_kit(kit, 47, seed=0)[46]
    fq = tmp_path / "reads.fastq"
    write_fastq(str(fq), [read])

    def run(fn, cfg_cls, backend, name, **kw):
        out = tmp_path / name
        full = kw.pop("full_scan", False)
        fn([str(fq)], cfg_cls(kit_name=kit, output_folder=str(out), backend=backend,
                              full_scan=full), **kw)
        return {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}

    ends = run(demux_using_kit, PortKitRunConfig, "torch", "ends", device="cpu")
    assert ends == run(jax_demux_using_kit, KitRunConfig, "jax", "jax")
    full = run(demux_using_kit, PortKitRunConfig, "torch", "full", device="cpu",
               full_scan=True)
    assert full == run(demux_using_kit, PortKitRunConfig, "oracle", "oracle",
                       device="cpu")
    mid = [r for r in full["annotation.tsv"].decode().splitlines()[1:]
           if r.split("\t")[9] == "Fflank"]
    assert len(mid) == 1 and int(mid[0].split("\t")[2]) == -399
    assert mid[0] not in ends["annotation.tsv"].decode()
    assert "AB16.trimmed.fastq" in ends and "AB16.trimmed.fastq" not in full
