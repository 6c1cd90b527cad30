"""The port's span and counter recorder (``barbell_tpu_torch/timing.py``)
on the CPU, where it is placed and what reads it:

* with the flag off nothing is recorded, no clock is read and no lock
  taken;
* a span records wall, count and thread CPU; ``upload.copy`` nests in
  ``pack_upload``; an overflow retry is ``demux_call.retry`` and a retry
  that overflows too counts ``fallback.batches``; a graph cache records
  ``graph.capture`` and ``graph.replay``; ``engine.inflight`` counts the
  union of overlapping calls;
* a small ``kit`` run through the command line records the runner's
  five spans, prints the report under ``BARBELL_TIMING=1`` and writes
  the spans into its ``BARBELL_PROFILE_DIR`` trace;
* each per-layer metric of the benchmark that reads them gives its
  number from a synthetic context and None without its spans."""

import contextlib
import importlib.util
import io
import json
import os
import random
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs

from barbell_tpu_torch import cli, timing  # noqa: E402
from barbell_tpu_torch.models import pipeline  # noqa: E402
from barbell_tpu_torch.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu_torch.models.graphs import GraphCache  # noqa: E402
from barbell_tpu_torch.models.pipeline import TorchDemuxEngine  # noqa: E402
from barbell_tpu_torch.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu_torch.sim.simulate import (  # noqa: E402
    default_barcodes,
    mutate_sequence,
    rapid_adapter,
    random_sequence,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BARCODES = 8
RUNNER = ("runner.parse", "runner.result_wait", "runner.annotate",
          "runner.filter", "runner.trim")


@pytest.fixture
def recording(monkeypatch):
    """Spans on, an empty TIMINGS, and no interval kept afterwards."""
    monkeypatch.setattr(timing, "ENABLED", True)
    timing.TIMINGS.clear()
    yield timing.TIMINGS
    timing.stop_keeping()
    timing.TIMINGS.clear()


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
    ids, seqs = [], []
    for i in range(n):
        seq = rapid_adapter(bars[i % N_BARCODES][1]) + bytes(
            random_sequence(rng, rng.randrange(60, 150)))
        ids.append(f"p{i}")
        seqs.append(mutate_sequence(rng, seq, 0, 3))
    return ids, seqs


def test_timings_is_the_recorders_dict():
    """The benchmark clears and reads ``pipeline.TIMINGS``: it is the
    recorder's dict, not a copy."""
    assert pipeline.TIMINGS is timing.TIMINGS
    assert pipeline.timing_report is timing.timing_report


class _Refuse:
    """Stands in for the clock module and the lock: any use fails."""

    def __getattr__(self, name):
        raise AssertionError(f"spans used {name} with the flag off")

    def __enter__(self):
        raise AssertionError("spans took the lock with the flag off")

    def __exit__(self, *exc):
        return False


def test_flag_off_records_nothing_and_reads_no_clock(monkeypatch):
    """Flag off: an engine batch and every entry point of the recorder
    leave TIMINGS empty, read no clock and take no lock."""
    monkeypatch.setattr(timing, "ENABLED", False)
    monkeypatch.setattr(timing, "time", _Refuse())
    monkeypatch.setattr(timing, "_LOCK", _Refuse())
    timing.TIMINGS.clear()
    ids, seqs = _reads(3, seed=1)
    TorchDemuxEngine(_groups(), device="cpu").demux_batch_table(ids, seqs)
    with timing.span("x", 0), timing.inflight():
        timing.count("y", 3)
    fn = timing.tagged(len, 0)
    assert fn is len and timing.TIMINGS == {}


@pytest.mark.parametrize("work", ["busy", "sleep"])
def test_span_records_wall_count_and_thread_cpu(recording, work):
    """A busy span's thread CPU is most of its wall time; a sleeping
    span's is almost none of it; two calls count 2."""
    for _ in range(2):
        with timing.span("s"):
            if work == "busy":
                t_end = time.perf_counter() + 0.02
                while time.perf_counter() < t_end:
                    pass
            else:
                time.sleep(0.02)
    wall, n, cpu = recording["s"]
    assert n == 2 and wall >= 0.04
    if work == "busy":
        assert 0.5 * wall <= cpu <= wall * 1.05 + 0.002
    else:
        assert cpu < 0.5 * wall


def test_engine_phases_nest_and_keep_their_serial(recording):
    """One engine batch: every phase and the call in flight recorded,
    each span as [wall, count, thread CPU]; each ``upload.copy``
    interval lies inside a ``pack_upload`` interval of its thread, which
    lies inside the call's ``engine.inflight`` period; spans of a batch
    run through :func:`timing.tagged` carry its serial."""
    timing.keep_intervals()
    ids, seqs = _reads(4, seed=2)
    engine = TorchDemuxEngine(_groups(), device="cpu")
    timing.tagged(engine.demux_batch_table, 7)(ids, seqs)
    kept = timing.stop_keeping()
    for name in ("encode", "pack_upload", "upload.copy", "demux_call.dispatch",
                 "demux_call.fetch", "assemble.host"):
        wall, n, cpu = recording[name]
        assert n >= 1 and wall >= 0 and cpu >= 0, name
    assert recording["upload.copy"][0] <= recording["pack_upload"][0]
    assert recording["engine.inflight"][1] == 1
    by = {}
    for name, tid, t0, t1, serial in kept:
        by.setdefault(name, []).append((tid, t0, t1, serial))
    ((_i, i0, i1, _s),) = by["engine.inflight"]
    for tid, t0, t1, serial in by["upload.copy"]:
        assert serial == 7
        assert any(ptid == tid and p0 <= t0 and t1 <= p1
                   for ptid, p0, p1, _s in by["pack_upload"])
    for tid, t0, t1, serial in by["pack_upload"] + by["demux_call.fetch"]:
        assert i0 <= t0 and t1 <= i1


@pytest.mark.parametrize("retry_holds", [True, False], ids=["retry", "fallback"])
def test_overflow_retry_is_timed(recording, monkeypatch, retry_holds):
    """The first hit capacity cut to 2 lanes: the retry's dispatch and
    fetch are ``demux_call.retry``; a retry that overflows too sends the
    batch whole to the scalar fallback, ``fallback.batches``."""
    monkeypatch.setattr(pipeline, "_retry_cap",
                        (lambda total, h: total + 8) if retry_holds
                        else (lambda total, h: h))
    ids, seqs = _reads(5, seed=3)
    engine = TorchDemuxEngine(_groups(), device="cpu")
    monkeypatch.setattr(engine, "_h_cap", lambda *a: 2)
    table = engine.demux_batch_table(ids, seqs)
    assert table.n_rows >= 4
    wall, n, cpu = recording["demux_call.retry"]
    assert n == 1 and wall > 0
    assert recording["demux_call.dispatch"][1] == 1
    assert recording.get("fallback.batches", [0.0, 0])[1] == (0 if retry_holds else 1)


class _Rerun:
    """CPU stand-in for a captured graph: each replay reruns the call on
    the instance's static inputs into its static output."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, inputs
        self.output = fn(inputs)

    def replay(self):
        self.output.copy_(self.fn(self.inputs))


def test_graph_cache_records_captures_and_replays(recording):
    """A key's first use is one ``graph.capture`` span, the next three
    replays count ``graph.replay``; the cache's own counters agree."""
    cache = GraphCache(per_key=1, capture=lambda fn, inp, dev: (
        lambda r: (r, r.output))(_Rerun(fn, inp)))
    for i in range(4):
        x = torch.full((3,), float(i))
        out, inst = cache.run("k", lambda inp: inp["x"] * 2, {"x": x})
        assert torch.equal(out, 2 * x)
        cache.release(inst)
    wall, n, cpu = recording["graph.capture"]
    assert n == 1 and wall > 0
    assert recording["graph.replay"] == [0.0, 3]
    assert (cache.captures, cache.replays) == (1, 3)


class _Clock:
    """Scripted monotonic clock: ``now`` nanoseconds."""

    now = 0

    def perf_counter_ns(self):
        return self.now


def test_inflight_counts_the_union_of_overlapping_calls(recording, monkeypatch):
    """Calls A (0-10 ns) and B (5-20 ns) on two threads overlap: one
    period of 20 ns; a later call C (30-34 ns) opens a second."""
    clock = _Clock()
    monkeypatch.setattr(timing, "time", clock)
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()

    def call_a():
        with timing.inflight():
            a_in.set()
            b_in.wait(5)
            clock.now = 10
        a_out.set()

    def call_b():
        a_in.wait(5)
        clock.now = 5
        with timing.inflight():
            b_in.set()
            a_out.wait(5)
            clock.now = 20

    threads = [threading.Thread(target=f) for f in (call_a, call_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert recording["engine.inflight"] == [pytest.approx(20e-9), 1]
    clock.now = 30
    with timing.inflight():
        clock.now = 34
    assert recording["engine.inflight"] == [pytest.approx(24e-9), 2]


@pytest.fixture(scope="module")
def kit_run(tmp_path_factory):
    """One ``kit --full-scan`` through the command line on the CPU engine
    (6 reads, batches of 4) under ``BARBELL_TIMING=1`` and ``BARBELL_PROFILE_DIR``:
    (TIMINGS after the run, stderr, the trace's events, the main
    thread's id)."""
    d = tmp_path_factory.mktemp("kit")
    rng = random.Random(1)
    fq = d / "r.fastq"
    with open(fq, "w") as fh:
        for i, (_label, bseq) in enumerate(default_barcodes(6)):
            s = (rapid_adapter(bseq) + bytes(random_sequence(rng, 700))).decode()
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    saved = (timing.ENABLED, cli.DEVICE, os.environ.get("BARBELL_PROFILE_DIR"))
    timing.ENABLED, cli.DEVICE = True, "cpu"
    os.environ["BARBELL_PROFILE_DIR"] = str(d / "trace")
    timing.TIMINGS.clear()
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["kit", "-k", "SQK-RBK114-96", "-i", str(fq), "-o",
                             str(d / "out"), "--batch-size", "4", "--full-scan"]) == 0
        timings = {k: list(v) for k, v in timing.TIMINGS.items()}
    finally:
        timing.ENABLED, cli.DEVICE = saved[:2]
        if saved[2] is None:
            del os.environ["BARBELL_PROFILE_DIR"]
        else:
            os.environ["BARBELL_PROFILE_DIR"] = saved[2]
        timing.TIMINGS.clear()
    (trace,) = (d / "trace").iterdir()
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    return timings, err.getvalue(), events, threading.get_native_id()


def test_kit_run_records_the_runner_spans_and_prints_the_report(kit_run):
    """Two batches: each of the runner's five spans at least twice
    (``runner.parse`` once more, for the end of the input), the engine's
    phases beside them, and the report on stderr names every entry with
    its wall, count and thread CPU."""
    timings, err, _events, _tid = kit_run
    for name in RUNNER:
        wall, n, cpu = timings[name]
        assert n >= 2 and wall >= 0 and cpu >= 0, name
    assert timings["runner.parse"][1] == 3
    assert timings["demux_call.dispatch"][1] >= 2
    assert "BARBELL_TIMING: kit spans" in err
    for name, acc in timings.items():
        line = next(ln for ln in err.splitlines() if ln.startswith(f"  {name} "))
        assert f"n={acc[1]}" in line
        if len(acc) > 2:
            assert "cpu" in line


def test_profile_trace_holds_the_programs_spans(kit_run):
    """The kit run's trace holds its spans on the profiler's timeline:
    the runner's on the main thread with their batch serials, the
    engine's on worker threads, the inflight periods on their own row,
    each inside the trace's own first and last event."""
    _timings, _err, events, main_tid = kit_run
    mine = [e for e in events if e.get("cat") == "program_span"]
    others = [e for e in events if e.get("ph") == "X" and e.get("cat") != "program_span"]
    names = {e["name"] for e in mine}
    assert set(RUNNER) | {"encode", "pack_upload", "upload.copy",
                          "demux_call.dispatch", "engine.inflight"} <= names
    assert {e["args"]["serial"] for e in mine if e["name"] == "runner.filter"} == {0, 1}
    assert all(e["tid"] == main_tid for e in mine if e["name"].startswith("runner."))
    assert all(e["tid"] != main_tid for e in mine if e["name"] == "encode")
    assert {e["tid"] for e in mine if e["name"] == "engine.inflight"} == {timing.INFLIGHT_TID}
    lo = min(float(e["ts"]) for e in mine + others)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in mine + others)
    # the profiler's own events fall within the spans' stretch of time
    assert others and all(lo <= float(e["ts"]) <= hi for e in others)
    first = min(float(e["ts"]) for e in mine)
    assert abs(first - min(float(e["ts"]) for e in others)) < 60e6  # same clock


def _metric(name):
    path = os.path.join(REPO, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"trace_test_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


#: a window of 2000 reads in 4 s: each new metric's spans, and the
#: number it reads from them
TIMINGS = {
    "runner.parse": [0.25, 3, 0.2], "runner.annotate": [0.5, 2, 0.5],
    "runner.filter": [0.75, 2, 0.7], "runner.trim": [1.5, 2, 1.4],
    "runner.result_wait": [1.0, 2, 0.0],
    "encode": [0.4, 2, 0.3], "pack_upload": [0.2, 2, 0.1],
    "assemble.host": [0.3, 2, 0.2], "upload.copy": [0.004, 2, 0.004],
    "demux_call.dispatch": [0.2, 4, 0.2], "demux_call.fetch": [0.016, 4, 0.01],
    "demux_call.retry": [0.05, 1, 0.04], "engine.inflight": [1.0, 3],
    "graph.capture": [0.3, 2, 0.25], "graph.replay": [0.0, 3],
    "trim.batch_reads": [0.0, 1995], "trim.object_reads": [0.0, 5],
}
EXPECT = {
    "runner.self_s_per_kread": 1.5,  # (0.25 + 0.5 + 0.75 + 1.5) / 2
    "runner.result_wait_s_per_kread": 0.5,
    "engine.offcpu_s_per_kread": 0.15,  # (0.1 + 0.1 + 0.1) / 2
    "engine.copy_ms_per_call": 5.0,  # 1000 x (0.004 + 0.016) / 4
    "engine.starved_share": 75.0,  # 100 x (1 - 1 / 4)
    "engine.calls_per_kread": 2.5,  # (4 + 1) / 2
    "engine.capture_s": 0.3,
    "runner.batch_share": 99.75,  # 100 x 1995 / (1995 + 5)
}
#: what the parent's recorder wrote: the five phases as [wall, count]
PARENT = {"encode": [0.4, 2], "pack_upload": [0.2, 2], "assemble.host": [0.3, 2],
          "demux_call.dispatch": [0.2, 4], "demux_call.fetch": [0.016, 4]}


@pytest.mark.parametrize("name", list(EXPECT))
def test_metric_reads_its_spans(name):
    read = _metric(name)
    ctx = {"reads": 2000, "window_s": 4.0, "timings": TIMINGS}
    assert read(ctx) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", list(EXPECT))
def test_metric_is_none_without_its_spans(name):
    """None from an untimed run and from the parent's five phases."""
    read = _metric(name)
    for timings in ({}, PARENT):
        assert read({"reads": 2000, "window_s": 4.0, "timings": timings}) is None


def test_capture_s_reads_zero_when_calls_ran_without_a_capture():
    read = _metric("engine.capture_s")
    timings = {k: v for k, v in TIMINGS.items() if k != "graph.capture"}
    assert read({"reads": 2000, "window_s": 4.0, "timings": timings}) == 0.0


def _kit_on_oracle(tmp_path, ids):
    """``kit`` on the scalar oracle over reads named ``ids`` (batches of
    4), each a rapid construct and a short body but every fourth a body
    alone: (the counters trim.batch_reads / trim.object_reads, the reads
    with rows)."""
    rng = random.Random(2)
    bars = default_barcodes(4)
    fq = tmp_path / "r.fastq"
    with open(fq, "w") as fh:
        for i, rid in enumerate(ids):
            body = bytes(random_sequence(rng, 120))
            s = (body if i % 4 == 3 else rapid_adapter(bars[i % 4][1]) + body).decode()
            fh.write(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n")
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["kit", "-k", "SQK-RBK114-96", "-i", str(fq), "-o",
                         str(tmp_path / "out"), "--backend", "oracle",
                         "--batch-size", "4"]) == 0
    anno = (tmp_path / "out" / "annotation.tsv").read_text().splitlines()[1:]
    counts = [timing.TIMINGS.get(k, [0.0, 0])[1]
              for k in ("trim.batch_reads", "trim.object_reads")]
    return counts, len({line.split("\t")[0] for line in anno})


def test_trim_counters_cover_the_reads_with_rows(recording, tmp_path):
    """Every read with rows is counted once: closed in its batch by the
    native call, or taken by the object path (at least the run each
    batch leaves open)."""
    (batch, obj), with_rows = _kit_on_oracle(tmp_path, [f"u{i}" for i in range(10)])
    assert with_rows >= 6
    assert batch + obj == with_rows
    assert batch > 0 and obj >= 2


def test_trim_counters_on_one_repeated_id(recording, tmp_path):
    """Reads that all share one id make one run of many reads: the
    object path takes it whole, the native call closes nothing."""
    (batch, obj), with_rows = _kit_on_oracle(tmp_path, ["same"] * 10)
    assert with_rows == 1
    assert batch == 0 and obj >= 6
