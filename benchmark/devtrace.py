"""Reduction of an in-memory ``torch.profiler`` trace of the timed call:
device busy time (the union of kernel, copy and set intervals, the
arithmetic of ``chip_smoke.py``'s ``_trace_device_time``), device time by
operation name, and the longest idle gaps named by what the host was
doing then."""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


#: how far before a gap a host operation that overlaps it may start
HOST_LOOKBACK_S = 5.0


@dataclass
class Trace:
    busy_s: float
    device_s: Dict[str, float]  # device seconds by operation name
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest idle gaps
    runtime: Dict[str, list] = field(default_factory=dict)  # CUDA runtime calls: [n, s]


def union_seconds(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    if not spans:
        return 0.0
    spans = sorted(spans)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo


def gaps_between(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle intervals between merged busy intervals."""
    out = []
    hi = None
    for a, b in sorted(spans):
        if hi is not None and a > hi:
            out.append((hi, a))
        hi = b if hi is None else max(hi, b)
    return out


def short_name(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def reduce_events(device: List[Tuple[str, float, float]],
                  host: List[Tuple[str, float, float]], n_gaps: int = 10) -> Trace:
    """``device`` and ``host``: (name, start s, end s) of the card's
    operations and of the host's recorded operations."""
    spans = [(a, b) for _n, a, b in device]
    dev_s: Dict[str, float] = {}
    for n, a, b in device:
        k = short_name(n)
        dev_s[k] = dev_s.get(k, 0.0) + (b - a)
    gaps = sorted(gaps_between(spans), key=lambda g: g[0] - g[1])[:n_gaps]
    host = sorted(host, key=lambda e: e[1])
    starts = [a for _n, a, _b in host]
    named = []
    for lo, hi in gaps:
        best, best_ov = "host code outside any recorded operation", 0.0
        first = bisect.bisect_left(starts, lo - HOST_LOOKBACK_S)
        for n, a, b in host[first:bisect.bisect_left(starts, hi)]:
            ov = min(b, hi) - max(a, lo)
            if ov > best_ov:
                best, best_ov = n, ov
        named.append((best, hi - lo))
    runtime: Dict[str, list] = {}
    for n, a, b in host:
        if n.startswith("cuda"):
            acc = runtime.setdefault(n, [0, 0.0])
            acc[0] += 1
            acc[1] += b - a
    return Trace(union_seconds(spans), dev_s, named, runtime)


def from_profiler(prof) -> Trace:
    """The card's and the host's operations of a stopped profiler."""
    import torch

    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == cuda:
            device.append((e.name(), a, b))
        elif b > a:
            host.append((e.name(), a, b))
    if not device:
        raise RuntimeError("the trace holds no device operation")
    return reduce_events(device, host)
