"""The port's tracing and pipeline knobs on the CPU: ``annotate`` under
``BARBELL_PROFILE_DIR`` writes a trace and the TSV it writes without
one; the phase timers name every phase;
``engine_map_batches`` keeps ``depth`` (and ``BARBELL_PIPELINE_DEPTH``)
batches in flight and yields the same tables in order at any depth."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs

from barbell_tpu_torch import timing  # noqa: E402
from barbell_tpu_torch.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu_torch.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu_torch.sim.simulate import (  # noqa: E402
    default_barcodes,
    mutate_sequence,
    rapid_adapter,
    random_sequence,
)
from barbell_tpu_torch.models import hittable  # noqa: E402
from barbell_tpu_torch.models import pipeline  # noqa: E402
from barbell_tpu_torch.models.pipeline import (  # noqa: E402
    TorchDemuxEngine,
    engine_map_batches,
)
from barbell_tpu_torch.stages.annotate import (  # noqa: E402
    AnnotateConfig,
    annotate_with_groups,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BARCODES = 8
PHASES = {"encode", "pack_upload", "upload.copy", "demux_call.dispatch",
          "demux_call.fetch", "assemble.host", "engine.inflight"}


def _groups():
    groups = BarcodeGroup.from_kit("SQK-RBK114-96", False)
    for g in groups:
        g.barcodes = g.barcodes[:N_BARCODES]
        g.patterns_fwd = g.patterns_fwd[:N_BARCODES]
        g.patterns_rc = g.patterns_rc[:N_BARCODES]
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def _reads(n, seed):
    rng = random.Random(seed)
    bars = default_barcodes(N_BARCODES)
    out = []
    for i in range(n):
        seq = rapid_adapter(bars[i % N_BARCODES][1]) + bytes(
            random_sequence(rng, rng.randrange(60, 150)))
        out.append((f"p{i}", mutate_sequence(rng, seq, 0, 3)))
    return out


def _fastq(path, recs):
    with open(path, "w") as fh:
        for rid, seq in recs:
            fh.write(f"@{rid}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")


def test_profile_dir_writes_trace_and_same_tsv(tmp_path, monkeypatch):
    """One traced and one untraced ``annotate`` on the torch engine (CPU)
    write the same bytes; the traced run leaves one Chrome trace in the
    directory."""
    fq = str(tmp_path / "r.fastq")
    _fastq(fq, _reads(6, seed=3))
    plain = str(tmp_path / "plain.tsv")
    annotate_with_groups([fq], plain, _groups(),
                         AnnotateConfig(batch_size=8), device="cpu")
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("BARBELL_PROFILE_DIR", str(trace_dir))
    traced = str(tmp_path / "traced.tsv")
    annotate_with_groups([fq], traced, _groups(),
                         AnnotateConfig(batch_size=8), device="cpu")
    with open(plain) as b, open(traced) as c:
        text = b.read()
        assert text == c.read() and text.count("\n") >= 6
    (trace,) = trace_dir.iterdir()
    assert trace.name.endswith(".trace.json") and trace.stat().st_size > 0


def test_profiler_that_cannot_start_does_not_fail_the_run(tmp_path, monkeypatch,
                                                         capsys):
    """A profiler that fails to start costs the trace, not the run: one
    line on stderr, and the TSV is written."""
    import torch.profiler

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    monkeypatch.setenv("BARBELL_PROFILE_DIR", str(tmp_path / "trace"))
    fq = str(tmp_path / "r.fastq")
    _fastq(fq, _reads(3, seed=4))
    out = str(tmp_path / "a.tsv")
    annotate_with_groups([fq], out, _groups(),
                         AnnotateConfig(backend="oracle", batch_size=8))
    assert os.path.getsize(out) > 0
    err = capsys.readouterr().err
    assert [ln for ln in err.splitlines() if "BARBELL_PROFILE_DIR" in ln] == [
        "BARBELL_PROFILE_DIR: profiler did not start (no profiler here); "
        "running without a trace"]


def test_timing_report_names_every_phase(monkeypatch):
    """With the timing flag on, one batch through the engine accumulates
    all six phases and the calls in flight, each at least once."""
    monkeypatch.setattr(timing, "ENABLED", True)
    pipeline.TIMINGS.clear()
    ids, seqs = zip(*_reads(4, seed=5))
    engine = TorchDemuxEngine(_groups(), device="cpu")
    try:
        engine.demux_batch_table(list(ids), list(seqs))
        assert set(pipeline.TIMINGS) == PHASES
        assert all(n >= 1 and s >= 0 for s, n, *_cpu in pipeline.TIMINGS.values())
        report = pipeline.timing_report()
        assert all(f"  {name}" in report for name in PHASES)
    finally:
        pipeline.TIMINGS.clear()


def test_engine_map_batches_same_tables_at_any_depth():
    """depth=1 and depth=8 yield the same tables, in batch order."""
    recs = _reads(5, seed=6)
    batches = [([r for r, _ in recs[i : i + 3]], [s for _, s in recs[i : i + 3]])
               for i in range(0, 5, 3)]
    engine = TorchDemuxEngine(_groups(), device="cpu")
    runs = {d: list(engine_map_batches(engine, iter(batches), depth=d))
            for d in (1, 8)}
    for (ids1, _s1, t1), (ids8, _s8, t8), (ids, _) in zip(runs[1], runs[8], batches):
        assert ids1 == ids8 == ids == t1.read_ids == t8.read_ids
        for c in hittable.COLUMNS:
            assert np.array_equal(t1.cols[c], t8.cols[c]), c
    assert len(runs[1]) == len(runs[8]) == 2


DEPTH_SCRIPT = r"""
import itertools
from barbell_tpu_torch.models import pipeline

class Echo:
    def demux_batch_table(self, ids, seqs):
        return len(ids)

pulled = []
def batches():
    for i in itertools.count():
        if i == 20:
            return
        pulled.append(i)
        yield [i], [b"A"]

gen = pipeline.engine_map_batches(Echo(), batches(), depth=@DEPTH@)
first = next(gen)
n_pulled = len(pulled)
rest = list(gen)
print(pipeline.DEFAULT_PIPELINE_DEPTH, n_pulled, first[0],
      [r[0][0] for r in rest] == list(range(1, 20)))
"""


@pytest.mark.parametrize("depth", ["None", "1", "8"])
def test_pipeline_depth_is_honoured(depth):
    """The first result comes out once depth + 1 batches were pulled:
    ``depth=`` when given, else BARBELL_PIPELINE_DEPTH (here 3)."""
    env = dict(os.environ, PYTHONPATH=REPO, BARBELL_PIPELINE_DEPTH="3")
    res = subprocess.run(
        [sys.executable, "-c", DEPTH_SCRIPT.replace("@DEPTH@", depth)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    default, pulled, first, in_order = res.stdout.split()
    want = 3 if depth == "None" else int(depth)
    assert (int(default), int(pulled), first, in_order) == (3, want + 1, "[0]", "True")
