"""Spans and counters of the port's host work (``BARBELL_TIMING=1``).

One recorder for the engine's phases, the kit runner's stages, the
graph cache and the two-tier rescue.  Everything lands in
:data:`TIMINGS` (``models.pipeline.TIMINGS`` is this same dict):

* a span (:func:`span`) is ``[wall_s, count, thread_cpu_s]``: wall
  seconds and CPU seconds of the thread that ran it
  (``time.thread_time_ns``), summed over its calls on every thread;
* a counter (:func:`count`) is ``[0.0, n]``;
* ``engine.inflight`` (:func:`inflight`) is ``[seconds, periods]``: the
  seconds in which at least one engine call was between the start of
  its upload and the end of its last fetch, on any thread, and the
  number of such periods.

With the flag off a span or counter costs one test of :data:`ENABLED`:
no clock read, no lock.  Spans are per batch or per call, never per
read.

While :func:`keep_intervals` is on (``BARBELL_PROFILE_DIR``, see
``stages.annotate.profile_trace``) each span's interval is kept too:
name, thread, start, end and the batch serial (the index of the batch
in the stream that :func:`tagged` gives the engine's worker threads).
:func:`add_to_chrome_trace` writes them into a profiler's Chrome trace
on the profiler's clock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

#: name -> [wall_s, count, thread_cpu_s] (span), [0.0, n] (counter),
#: [seconds, periods] (engine.inflight)
TIMINGS: Dict[str, List[float]] = {}
#: record spans and counters; read at every call, so it may be switched
ENABLED = os.environ.get("BARBELL_TIMING", "") not in ("", "0")

_LOCK = threading.Lock()
_tls = threading.local()  # .serial: the batch an engine worker is on
#: kept intervals (name, native thread id, start ns, end ns, serial), or
#: None when no trace is being recorded
_kept: Optional[list] = None
_thread_names: Dict[int, str] = {}
#: intervals a trace keeps at most (a few dozen a batch)
KEEP_CAP = 2_000_000
#: the trace's row for the engine.inflight periods
INFLIGHT_TID = "engine.inflight"


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _keep(name: str, t0: int, t1: int, serial, tid=None) -> None:
    """Keep one interval (under ``_LOCK``)."""
    if len(_kept) >= KEEP_CAP:
        return
    if tid is None:
        tid = threading.get_native_id()
        if tid not in _thread_names:
            _thread_names[tid] = threading.current_thread().name
    if serial is None:
        serial = getattr(_tls, "serial", None)
    _kept.append((name, tid, t0, t1, serial))


class _Span:
    __slots__ = ("name", "serial", "t0", "c0")

    def __init__(self, name: str, serial: Optional[int]):
        self.name = name
        self.serial = serial

    def __enter__(self):
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        c1 = time.thread_time_ns()
        with _LOCK:
            acc = TIMINGS.get(self.name)
            if acc is None:
                acc = TIMINGS[self.name] = [0.0, 0, 0.0]
            acc[0] += (t1 - self.t0) * 1e-9
            acc[1] += 1
            acc[2] += (c1 - self.c0) * 1e-9
            if _kept is not None:
                _keep(self.name, self.t0, t1, self.serial)
        return False


def span(name: str, serial: Optional[int] = None):
    """Context manager timing its block as span ``name``; ``serial`` is
    the batch it works on (default: the worker thread's, see
    :func:`tagged`)."""
    if not ENABLED:
        return _NOOP
    return _Span(name, serial)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    if not ENABLED:
        return
    with _LOCK:
        acc = TIMINGS.get(name)
        if acc is None:
            acc = TIMINGS[name] = [0.0, 0]
        acc[1] += n


class _Inflight:
    """Engine calls between upload and last fetch, counted across
    threads: a period opens when the first call enters and closes when
    the last one leaves."""

    __slots__ = ()
    active = 0
    opened = 0

    def __enter__(self):
        now = time.perf_counter_ns()
        with _LOCK:
            if _Inflight.active == 0:
                _Inflight.opened = now
            _Inflight.active += 1
        return self

    def __exit__(self, *exc):
        now = time.perf_counter_ns()
        with _LOCK:
            _Inflight.active -= 1
            if _Inflight.active == 0:
                acc = TIMINGS.get("engine.inflight")
                if acc is None:
                    acc = TIMINGS["engine.inflight"] = [0.0, 0]
                acc[0] += (now - _Inflight.opened) * 1e-9
                acc[1] += 1
                if _kept is not None:
                    _keep("engine.inflight", _Inflight.opened, now, -1,
                          INFLIGHT_TID)
        return False


_INFLIGHT = _Inflight()


def inflight():
    """Context manager around the device part of one engine call."""
    if not ENABLED:
        return _NOOP
    return _INFLIGHT


def tagged(fn, serial: int):
    """``fn`` run with ``serial`` as its thread's batch serial (what its
    spans record); ``fn`` itself when spans are off."""
    if not ENABLED:
        return fn

    def run(*args):
        _tls.serial = serial
        try:
            return fn(*args)
        finally:
            _tls.serial = None

    return run


def timing_report() -> str:
    """One line a span (wall, count, thread CPU) or counter, by name."""
    lines = []
    for name, acc in sorted(TIMINGS.items()):
        if len(acc) > 2:
            lines.append(f"  {name:24s} {acc[0]:9.3f}s  n={acc[1]:<8d} "
                         f"cpu {acc[2]:9.3f}s")
        elif name == "engine.inflight":
            lines.append(f"  {name:24s} {acc[0]:9.3f}s  n={acc[1]:<8d} (periods)")
        else:
            lines.append(f"  {name:24s} {'':10s}  n={acc[1]}")
    return "\n".join(lines)


def keep_intervals() -> Tuple[int, int]:
    """Start keeping every span's interval; returns the clock anchor
    ``(time.time_ns(), time.perf_counter_ns())`` read together, which
    maps the spans' monotonic stamps onto the epoch clock a profiler
    trace uses."""
    global _kept
    with _LOCK:
        _kept = []
    return time.time_ns(), time.perf_counter_ns()


def stop_keeping() -> list:
    """Stop keeping intervals; returns those kept."""
    global _kept
    with _LOCK:
        kept, _kept = _kept or [], None
    return kept


def add_to_chrome_trace(path: str, kept: list, anchor: Tuple[int, int]) -> None:
    """Append the kept intervals to the Chrome trace at ``path`` as
    ``ph: X`` events of category ``program_span`` on the trace's own
    clock: its stamps are microseconds from ``baseTimeNanoseconds`` (0
    where the trace has none) on the epoch clock, onto which ``anchor``
    maps the spans' monotonic stamps.  Each span sits on the row of the
    thread that ran it, named after the thread, with its batch serial;
    the inflight periods have a row of their own."""
    with open(path) as fh:
        trace = json.load(fh)
    pid = os.getpid()
    wall0, mono0 = anchor
    shift = wall0 - mono0 - int(trace.get("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    tids = set()
    for name, tid, t0, t1, serial in kept:
        ev = {"ph": "X", "cat": "program_span", "name": name, "pid": pid,
              "tid": tid, "ts": (t0 + shift) / 1000, "dur": (t1 - t0) / 1000}
        if serial is not None and serial >= 0:
            ev["args"] = {"serial": serial}
        events.append(ev)
        tids.add(tid)
    names = {**_thread_names, INFLIGHT_TID: INFLIGHT_TID}
    for tid in sorted(tids, key=str):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": names.get(tid, str(tid))}})
    with open(path, "w") as fh:
        json.dump(trace, fh, separators=(",", ":"))
