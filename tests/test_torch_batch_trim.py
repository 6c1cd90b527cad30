"""The kit runner's batch path against its object path, byte for byte.

The streaming runner walks a batch's runs in one native call
(``kit_columnar.close_runs``), which closes the runs of one read and
hands every other run to the object path; without the native library
``kit_columnar.walk_runs`` walks the batch and hands over every run.
Each case runs ``kit`` twice on the same reads: as it is, and with
``close_runs`` replaced by ``walk_runs``, so that the object path takes
every read.  Every output file, the progress counts and the pattern
summary must be the same, and the batch path must have closed runs.
The engine is the port's scalar oracle (the runner wraps it in
``TableAdapter``), memoised by sequence, on reads with short bodies.
The two walks are also held to the same runs directly, on batches where
the native call may close none.
"""

import gzip
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs

from barbell_tpu_torch import cli, timing  # noqa: E402
from barbell_tpu_torch.kits.database import expand_template, get_kit_info  # noqa: E402
from barbell_tpu_torch.sim.simulate import mutate_sequence, random_sequence  # noqa: E402
from barbell_tpu_torch.stages import annotate, kit_columnar  # noqa: E402
from barbell_tpu_torch.utils import dna  # noqa: E402

RBK, NBD, PCR = "SQK-RBK114-96", "SQK-NBD114-96", "EXP-PBC096"

#: (groups, sequence) -> the oracle's matches, shared by the cases of a worker
_MEMO: dict = {}


class _MemoOracle(annotate._OracleEngine):
    """The scalar oracle, each sequence's matches computed once."""

    def __init__(self, groups, config):
        super().__init__(groups, config)
        self._key = tuple((g.flank, len(g.barcodes), g.k_cutoff) for g in groups)

    def demux_batch(self, read_ids, seqs):
        out = []
        for rid, seq in zip(read_ids, seqs):
            key = (self._key, seq)
            if key not in _MEMO:
                _MEMO[key] = self._demuxer.demux(rid, seq)
            out.append(_MEMO[key])
        return out


def _constructs(kit):
    """(front, rear) construct a barcode label, as ``sim.make_reads_kit``
    puts them on a read."""
    spec = get_kit_info(kit)
    sides = {"left": [], "right": []}
    for tmpl in spec.templates:
        if not tmpl.extended:
            labels, seqs = expand_template(tmpl)
            sides[tmpl.side].append(dict(zip(labels, (s.encode() for s in seqs))))
    labels = list((sides["left"] or sides["right"])[0])
    both_ends = spec.pattern_class == "double" and not sides["right"]
    out = {}
    for lab in labels[:6]:
        front = b"".join(c[lab] for c in sides["left"])
        rear = b"".join(dna.reverse_complement_bytes(c[lab]) for c in sides["right"])
        if both_ends:
            rear = dna.reverse_complement_bytes(front)
        out[lab] = (front, rear)
    return out


def _read(rng, kit, kind):
    """One read of ``kind``: ``fw`` (construct(s) around a body), ``rc``
    (its reverse complement), ``cut`` (the front construct cut by 1-20
    bases, as barbell's GroupIII), ``bare`` (the constructs alone, no
    body: empty trim slices) or ``none`` (a body alone: no rows)."""
    body = bytes(random_sequence(rng, rng.randrange(80, 200)))
    if kind == "none":
        return body
    front, rear = rng.choice(list(_constructs(kit).values()))
    if kind == "cut":
        front = front[rng.randrange(1, 21):]
    seq = front + (b"" if kind == "bare" else body) + rear
    if kind == "rc":
        seq = dna.reverse_complement_bytes(seq)
    return mutate_sequence(rng, seq, 0, 2)


def _fastq(path, records):
    with open(path, "w") as fh:
        for rid, desc, seq in records:
            head = f"{rid} {desc}" if desc else rid
            qual = "".join(chr(33 + (i * 7) % 40) for i in range(len(seq)))
            fh.write(f"@{head}\n{seq.decode()}\n+\n{qual}\n")


def _records(kit, kinds, seed, ids=None):
    """FASTQ records of reads of ``kinds`` (fresh ids, or ``ids``), every
    third with an empty description."""
    rng = random.Random(seed)
    out = []
    for i, kind in enumerate(kinds):
        rid = ids[i] if ids else f"r{seed}_{i}"
        out.append((rid, "" if i % 3 == 2 else f"runid=x ch={i}", _read(rng, kit, kind)))
    return out


MIX = ["fw", "rc", "cut", "bare", "none", "fw", "cut", "fw", "rc", "bare", "fw", "none"]


def _case(name):
    """(kit, records, extra kit flags, batch size) of case ``name``."""
    if name == "rbk_ends":
        return RBK, _records(RBK, MIX * 2, 1), ["--failed-out"], 8
    if name == "nbd_ends":
        return NBD, _records(NBD, MIX * 2, 2), ["--failed-out"], 8
    if name == "rbk_rc":
        return RBK, _records(RBK, ["rc"] * 6 + ["fw"] * 4, 3), [], 4
    if name == "dup_in_batch":
        ids = ["a", "b", "b", "c", "d", "d", "d", "e", "f", "g", "h", "h"]
        return RBK, _records(RBK, ["fw", "fw", "cut", "fw", "fw", "rc", "fw", "fw", "bare",
                                   "fw", "fw", "fw"], 4, ids), ["--failed-out"], 12
    if name == "dup_across_batches":
        ids = ["a", "b", "c", "d", "d", "d", "e", "f", "g", "h", "h", "i"]
        return RBK, _records(RBK, ["fw"] * 12, 5, ids), [], 4
    if name == "rowless_live_id":
        # x, then a read of x without rows (joins x's run); y, a read of
        # z without rows between two reads of y (z is passed over, y's
        # run goes on), then y again without rows
        ids = ["w", "x", "x", "y", "z", "y", "y", "q", "q2", "r", "r", "s"]
        kinds = ["fw", "fw", "none", "fw", "none", "fw", "none", "fw", "none", "fw",
                 "none", "fw"]
        return NBD, _records(NBD, kinds, 6, ids), ["--failed-out"], 5
    if name == "pcr":
        return PCR, _records(PCR, MIX, 7), ["--failed-out"], 6
    if name == "maximize":
        return NBD, _records(NBD, MIX * 2, 8), ["--maximize", "--failed-out"], 8
    if name == "gzip_threads":
        return RBK, _records(RBK, MIX * 2, 9), ["--gzip", "--threads", "2"], 8
    if name == "open_run_continues":
        # each batch's last read's id begins the next batch
        ids = ["a", "b", "c", "d", "d", "e", "f", "g", "g", "h"]
        kinds = ["fw", "fw", "fw", "fw", "cut", "fw", "fw", "fw", "none", "fw"]
        return RBK, _records(RBK, kinds, 10, ids), [], 4
    raise KeyError(name)


CASES = ["rbk_ends", "nbd_ends", "rbk_rc", "dup_in_batch", "dup_across_batches",
         "rowless_live_id", "pcr", "maximize", "gzip_threads", "open_run_continues"]


def _files(out):
    """Each output file's bytes (a gzip file's, decompressed, beside its own)."""
    files = {}
    for p in sorted(out.iterdir()):
        data = p.read_bytes()
        files[p.name] = data
        if p.name.endswith(".gz"):
            files[p.name + ":data"] = gzip.decompress(data)
    return files


def _run(tmp_path, monkeypatch, capsys, name, object_path):
    kit, records, extra, batch = _case(name)
    fq = tmp_path / "reads.fastq"
    _fastq(fq, records)
    out = tmp_path / ("object" if object_path else "batch")
    flags = list(extra)
    if "--failed-out" in flags:
        k = flags.index("--failed-out")
        flags[k + 1:k + 1] = [str(out / "failed.txt")]
    with monkeypatch.context() as m:
        m.setattr(annotate, "_OracleEngine", _MemoOracle)
        m.setattr(timing, "ENABLED", True)
        if object_path:
            m.setattr(kit_columnar, "close_runs", kit_columnar.walk_runs)
        timing.TIMINGS.clear()
        capsys.readouterr()
        assert cli.main(["kit", "-k", kit, "-i", str(fq), "-o", str(out), "--backend",
                         "oracle", "--batch-size", str(batch), *flags]) == 0
        std = capsys.readouterr()
        counts = {k: timing.TIMINGS.get(k, [0.0, 0])[1]
                  for k in ("trim.batch_reads", "trim.object_reads")}
        timing.TIMINGS.clear()
    progress = [ln for ln in std.err.splitlines() if ln.startswith(("Total:", "\rTotal:"))]
    summary = std.out[std.out.index("Found "):std.out.index("Want to see")]
    return _files(out), progress[-1:], summary, counts


@pytest.mark.parametrize("name", CASES)
def test_batch_path_writes_the_object_paths_bytes(tmp_path, monkeypatch, capsys, name):
    got, got_progress, got_summary, got_counts = _run(tmp_path, monkeypatch, capsys, name,
                                                      False)
    want, want_progress, want_summary, want_counts = _run(tmp_path, monkeypatch, capsys,
                                                          name, True)
    assert got.keys() == want.keys()
    for fname in want:
        assert got[fname] == want[fname], fname
    assert got_progress == want_progress and got_progress
    assert got_summary == want_summary
    if name == "pcr":
        # two templates: an Ftag and an Rtag row a read, which no preset
        # covers, so no read passes and none is trimmed
        assert b"Rtag[" in got["pattern_per_read.tsv"]
    else:
        assert any(f.endswith((".trimmed.fastq", ".trimmed.fastq.gz")) for f in got)
    # the same reads with rows either way; the batch path closed some
    assert want_counts["trim.batch_reads"] == 0
    assert sum(got_counts.values()) == want_counts["trim.object_reads"]
    assert got_counts["trim.batch_reads"] > 0
    if name in ("rbk_ends", "nbd_ends"):
        assert got["failed.txt"]  # empty slices, written as failed


def _walk_args(rng, n, pend):
    """close_runs's arguments for ``n`` reads of few ids, a third
    without rows, every read that has rows passing with another cut
    shape than the preset's (so the native call closes no run), and the
    run ``pend`` ((id, records) or None) left open by a batch before."""
    ids = [rng.choice("aabbcdd") for _ in range(n)]
    n_rows = np.array([0 if rng.random() < 0.35 else rng.randint(1, 3) for _ in range(n)],
                      dtype=np.int64)
    seg_start = np.cumsum(n_rows) - n_rows
    rows = int(n_rows.sum())
    slabels = [f"Ftag[fw, @{i}]" if k else None for i, k in enumerate(n_rows.tolist())]
    lines = [f"{ids[i]}\trow{j}" for i, k in enumerate(n_rows.tolist()) for j in range(k)]
    assert len(lines) == rows
    zeros = np.zeros(n, dtype=np.int64)
    plan = (np.zeros(n, dtype=bool), zeros, np.full(n, -1, dtype=np.int64), zeros)
    pend_id, pend_n = pend or (None, 0)
    return (ids, [""] * n, [b"ACGT"] * n, [b"IIII"] * n, slabels, lines, [["\tc"] * 3],
            ["none"], seg_start, n_rows, zeros, n_rows > 0, plan, np.zeros(1, dtype=np.int64),
            pend_id, pend_n)


@pytest.mark.parametrize("seed", range(6))
def test_native_walk_hands_over_the_python_walks_runs(seed):
    """Where no run can be closed natively, the native walk hands the
    object path the same runs, with the same flags, as the Python walk:
    fresh batches and batches that go on with an open run, with an
    early-flush count low enough to close runs."""
    from barbell_tpu_torch.native import get_pylib

    if get_pylib() is None:
        pytest.skip("the native library could not be built here (no compiler or headers)")
    rng = random.Random(seed)
    for trial in range(40):
        pend = rng.choice([None, ("a", 1), ("b", 3), ("c", 1)])
        cap = rng.choice([2, 3, 100_000])
        if pend is not None and pend[1] >= cap:
            pend = (pend[0], cap - 1)
        args = _walk_args(rng, rng.randint(0, 14), pend)
        want = kit_columnar.walk_runs(*args, cap)
        got = kit_columnar.close_runs(*args, cap)
        assert [tuple(ev) for ev in got] == want, (seed, trial)
        if pend is not None:
            assert want[0][0] & kit_columnar.CARRY
