"""The port's multi-host record striping and merge on the CPU, the
counterparts of tests/test_distributed.py: striped shards merge to the
one-process output byte for byte (the oracle backend; the torch engine
in three shards against the JAX package's one-process run), the command
line's shard flags and their errors, missing, truncated and all-empty
shards, the merge's bytes against the reference's merge on the same
shard files, and ``initialize`` with and without a coordinator.  Groups
are cut to 8 barcodes."""

import os
import shutil
import socket

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs
jax = pytest.importorskip("jax")

from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.parallel import distributed as ref_dist  # noqa: E402
from barbell_tpu.sim.simulate import (  # noqa: E402
    create_testdata,
    default_barcodes,
    rapid_adapter,
)
from barbell_tpu.stages import annotate as jax_annotate  # noqa: E402
from barbell_tpu_torch import cli  # noqa: E402
from barbell_tpu_torch.models import barcodes as port_barcodes  # noqa: E402
from barbell_tpu_torch.models.records import TSV_COLUMNS  # noqa: E402
from barbell_tpu_torch.parallel.distributed import (  # noqa: E402
    has_completion_marker,
    initialize,
    merge_annotation_shards,
    shard_output_path,
    write_completion_marker,
)
from barbell_tpu_torch.stages.annotate import (  # noqa: E402
    AnnotateConfig,
    annotate_with_groups,
)

N_BARCODES = 8
HEADER = "\t".join(TSV_COLUMNS)


def _groups(group_cls):
    groups = group_cls.from_kit("SQK-RBK110-96", False)
    for g in groups:
        g.barcodes = g.barcodes[:N_BARCODES]
        g.patterns_fwd = g.patterns_fwd[:N_BARCODES]
        g.patterns_rc = g.patterns_rc[:N_BARCODES]
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def _sim(tmp_path, n, seed, rc_frac, groups=("GroupII",)):
    create_testdata(n, str(tmp_path / "sim"), barcodes=default_barcodes(4),
                    rc_frac=rc_frac, seed=seed, groups=groups)
    return [str(tmp_path / "sim" / f"{g}.fastq") for g in groups]


def _read(path):
    with open(path) as fh:
        return fh.read()


def test_record_striped_shards_merge_to_single_run(tmp_path):
    """Oracle backend: two striped shards and their sidecars merge to
    the one-process file byte for byte; the merge removes them."""
    fastqs = _sim(tmp_path, 10, seed=11, rc_frac=0.0)
    single = str(tmp_path / "single.tsv")
    annotate_with_groups(fastqs, single, _groups(port_barcodes.BarcodeGroup),
                         AnnotateConfig(backend="oracle", batch_size=4))
    base, world = str(tmp_path / "sharded.tsv"), 2
    for rank in range(world):
        annotate_with_groups(
            fastqs, shard_output_path(base, rank, world),
            _groups(port_barcodes.BarcodeGroup),
            AnnotateConfig(backend="oracle", batch_size=4, shard=(rank, world)),
        )
        write_completion_marker(str(tmp_path), "annotate", rank)
    assert all(has_completion_marker(str(tmp_path), "annotate", r)
               for r in range(world))
    merge_annotation_shards(base, world)
    assert _read(base) == _read(single) and _read(single).count("\n") > 10
    assert not os.path.exists(shard_output_path(base, 0, world))
    assert not os.path.exists(shard_output_path(base, 0, world) + ".idx")


def test_record_striped_torch_engine_merges_to_jax_run(tmp_path, monkeypatch):
    """The port's torch engine on the CPU, striped into 3 shards (batches
    of 4 reads) and merged, writes the JAX package's one-process
    ``annotation.tsv`` (its device engine, on one CPU device) byte for
    byte, rc reads included."""
    fastqs = _sim(tmp_path, 8, seed=17, rc_frac=0.5)
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    want = str(tmp_path / "jax.tsv")
    jax_annotate.annotate_with_groups(
        fastqs, want, _groups(BarcodeGroup),
        jax_annotate.AnnotateConfig(backend="jax", batch_size=4))
    base, world = str(tmp_path / "sharded.tsv"), 3
    for rank in range(world):
        annotate_with_groups(
            fastqs, shard_output_path(base, rank, world),
            _groups(port_barcodes.BarcodeGroup),
            AnnotateConfig(backend="torch", batch_size=4, shard=(rank, world)),
            device="cpu",
        )
    merge_annotation_shards(base, world)
    assert _read(base) == _read(want) and _read(want).count("\n") > 4


def _query_fasta(tmp_path):
    qf = tmp_path / "q.fasta"
    with open(qf, "w") as fh:
        for lab, bs in default_barcodes(4):
            fh.write(f">{lab}\n{rapid_adapter(bs).decode()}\n")
    return str(qf)


def test_cli_shard_flags(tmp_path):
    """``annotate --shard-rank r --shard-world 2`` writes each rank's
    stripe to ``<output>.shard-r.tsv``; the merge holds every read; a rank
    without a world, or outside [0, world), exits 1."""
    (fastq,) = _sim(tmp_path, 6, seed=13, rc_frac=0.0)
    out = str(tmp_path / "ann.tsv")
    args = ["annotate", "-i", fastq, "-o", out, "-q", _query_fasta(tmp_path),
            "--backend", "oracle", "--batch-size", "4"]
    for rank in range(2):
        assert cli.main(args + ["--shard-rank", str(rank), "--shard-world", "2"]) == 0
        assert os.path.exists(str(tmp_path / f"ann.shard-{rank}.tsv.idx"))
    merge_annotation_shards(out, 2)
    lines = [ln for ln in _read(out).splitlines() if ln.strip()]
    assert lines[0] == HEADER
    assert len({ln.split("\t", 1)[0] for ln in lines[1:]}) == 6
    assert cli.main(args + ["--shard-rank", "1"]) == 1
    assert cli.main(args + ["--shard-rank", "2", "--shard-world", "2"]) == 1
    assert cli.main(args + ["--shard-world", "0"]) == 1


def test_merge_missing_shard_raises(tmp_path):
    """A missing shard means a rank never finished: fail loudly and leave
    the survivors in place."""
    base = str(tmp_path / "anno.tsv")
    shard0 = shard_output_path(base, 0, 2)
    open(shard0, "w").close()
    with open(shard0 + ".idx", "w") as fh:
        fh.write("0\t0\n")
    with pytest.raises(FileNotFoundError, match="missing"):
        merge_annotation_shards(base, 2)
    assert os.path.exists(shard0)


def test_merge_truncated_shard_raises(tmp_path):
    """A shard whose sidecar promises more rows than it holds is a
    truncated write."""
    base = str(tmp_path / "anno.tsv")
    for rank in range(2):
        shard = shard_output_path(base, rank, 2)
        with open(shard, "w") as fh:
            fh.write(HEADER + "\n")
        with open(shard + ".idx", "w") as fh:
            fh.write(f"{rank}\t1\n")
    with pytest.raises(ValueError, match="truncated"):
        merge_annotation_shards(base, 2)


def test_merge_all_empty_shards_stays_empty(tmp_path):
    """All-empty shards merge to a 0-byte file, as a zero-row
    one-process run writes (lazy header)."""
    base = str(tmp_path / "anno.tsv")
    for rank in range(2):
        shard = shard_output_path(base, rank, 2)
        open(shard, "w").close()
        with open(shard + ".idx", "w") as fh:
            fh.write(f"{rank}\t0\n")
    merge_annotation_shards(base, 2)
    assert os.path.getsize(base) == 0


@pytest.mark.parametrize("sidecars", [True, False], ids=["interleave", "concat"])
def test_merge_matches_reference_merge(tmp_path, sidecars):
    """On the same three shard files (reads with 0-3 rows each), the
    port's merge writes the reference's bytes: interleaved by the
    sidecars, or concatenated in rank order without them."""
    world = 3
    for name in ("port", "ref"):
        (tmp_path / name).mkdir()
    counts = [2, 0, 1, 3, 1, 0, 0, 2, 1, 1]
    rows = {r: [] for r in range(world)}
    idx = {r: [] for r in range(world)}
    for si, n in enumerate(counts):
        rank = si % world
        idx[rank].append(f"{si}\t{n}\n")
        for j in range(n):
            rows[rank].append("\t".join([f"read{si}"] + [str(j)] * (len(TSV_COLUMNS) - 1)) + "\n")
    for rank in range(world):
        path = shard_output_path(str(tmp_path / "port" / "a.tsv"), rank, world)
        with open(path, "w") as fh:
            fh.write((HEADER + "\n" if rows[rank] else "") + "".join(rows[rank]))
        if sidecars:
            with open(path + ".idx", "w") as fh:
                fh.write("".join(idx[rank]))
        for f in (path, path + ".idx"):
            if os.path.exists(f):
                shutil.copy(f, str(tmp_path / "ref" / os.path.basename(f)))
    merge_annotation_shards(str(tmp_path / "port" / "a.tsv"), world)
    ref_dist.merge_annotation_shards(str(tmp_path / "ref" / "a.tsv"), world)
    got = _read(tmp_path / "port" / "a.tsv")
    assert got == _read(tmp_path / "ref" / "a.tsv")
    assert got.count("\n") == sum(counts) + 1


def test_initialize(monkeypatch):
    """Without a coordinator: rank 0 of 1.  With ``BARBELL_COORDINATOR``
    (and WORLD_SIZE / RANK): a gloo process group on that address."""
    import torch.distributed as dist

    monkeypatch.delenv("BARBELL_COORDINATOR", raising=False)
    assert initialize() == (0, 1)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("BARBELL_COORDINATOR", f"localhost:{port}")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert initialize() == (0, 1)
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
