"""The comparison that decides ``correct``: every output record of every
sampled pool read, in every pass the feeder wrote it, against the plain
reference's, byte for byte.

The sample is drawn from the seed (``Pool.sample``, the traffic file's
``reference_sample`` reads).  The reference runs once per sampled read
(its outputs differ between passes only in the read id) after the window
has closed, in worker processes that import only NumPy and
``benchmark.reference``.
"""

from __future__ import annotations

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List

from benchmark import traffic
from benchmark.reference.kit import ID, KitReference

_REF = None


def _init(config: dict, full_scan: bool, precision: str) -> None:
    global _REF
    _REF = KitReference(config, full_scan, precision)


def _expect(job):
    return [(i, _REF.expected(seq, qual, desc)) for i, seq, qual, desc in job]


def reference_outputs(pool, config: dict, full_scan: bool, precision: str = "float32",
                      workers: int = 0) -> Dict[int, Dict[str, List[str]]]:
    """{pool index: {file: [records, read id as ``ID``]}} of the sample."""
    jobs = [(int(i), pool.seqs[i], pool.quals[i], pool.descs[i]) for i in pool.sample]
    if workers <= 1:
        _init(config, full_scan, precision)
        return dict(_expect(jobs))
    chunks = [jobs[k::workers * 4] for k in range(workers * 4)]
    ctx = multiprocessing.get_context("spawn")
    out: dict = {}
    with ProcessPoolExecutor(workers, mp_context=ctx, initializer=_init,
                             initargs=(config, full_scan, precision)) as ex:
        for part in ex.map(_expect, [c for c in chunks if c]):
            out.update(part)
    _stop_resource_tracker()
    return out


def _stop_resource_tracker() -> None:
    """Ends the helper process multiprocessing starts for the pool's
    locks, so that the run leaves no process behind when it exits."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def default_workers() -> int:
    return max(1, min(8, (os.cpu_count() or 2) - 1))


def compare(pool, expected: dict, kept: dict, reads_fed: int, rid, orders=()) -> dict:
    """Mismatching sampled read instances (read fed in some pass whose
    records in some file differ from the reference's, arrive in a file
    after a later-fed read's, or appear though never fed), with the
    first few differences shown.  ``orders``: per file, the (pass, pool
    index) of its sampled records in the order they came."""
    n = len(pool)
    late = set()
    for order in orders:
        top = (-1, -1)
        for key in order:
            if key < top:
                late.add(key)
            top = max(top, key)
    files_of: dict = {}
    for (f, p, i) in kept:
        files_of.setdefault((p, i), []).append(f)
    fed = set()
    bad = 0
    shown = []
    for i in pool.sample:
        i = int(i)
        for p in range(reads_fed // n + 1):
            if p * n + i >= reads_fed:
                break
            fed.add((p, i))
            r = rid(p, i)
            exp = {f: [x.replace(ID, r) for x in recs] for f, recs in expected[i].items()}
            files = set(exp) | set(files_of.get((p, i), ()))
            diff = [f for f in sorted(files) if exp.get(f, []) != kept.get((f, p, i), [])]
            if (p, i) in late:
                diff.append("(order)")
            if diff:
                bad += 1
                if len(shown) < 3:
                    f = diff[0]
                    shown.append(f"read {r} file {f}: expected {exp.get(f, [])!r:.600} "
                                 f"got {kept.get((f, p, i), [])!r:.600}")
    stray = {(p, i) for (_f, p, i) in kept} - fed
    return {"compared": len(fed), "mismatched": bad + len(stray), "shown": shown}


def accuracy(pool, kept: dict, reads_fed: int) -> tuple:
    """(assigned share, correct share of assigned) over the sampled fed
    reads that carry a construct: assigned = trimmed into a barcode's
    file."""
    n = len(pool)
    by_read: dict = {}
    for (f, p, i) in kept:
        if f.endswith(".trimmed.fastq") and not f.startswith("none."):
            by_read.setdefault((p, i), set()).add(f[: -len(".trimmed.fastq")])
    total = assigned = correct = 0
    for i in pool.sample:
        i = int(i)
        if pool.labels[i] is None:
            continue
        for p in range(reads_fed // n + 1):
            if p * n + i >= reads_fed:
                break
            total += 1
            labs = by_read.get((p, i))
            if labs:
                assigned += 1
                correct += labs == {pool.labels[i]}
    return (assigned / total if total else 0.0, correct / assigned if assigned else 0.0)


def record_id(pool, pass_no: int, idx: int) -> str:
    """The read id the feeder gives pool read ``idx`` in pass ``pass_no``."""
    return traffic.record(pool, pass_no, idx)[1:].split(b" ", 1)[0].decode()


def judge(pool, config: dict, full_scan: bool, kept: dict, orders, reads_fed: int,
          workers: int = 0) -> dict:
    """The comparison that decides ``correct``: the reference's outputs of
    the sample against ``kept`` (what the timed call wrote for it, as
    the digester kept it), each compared number beside its limit."""
    t = time.monotonic()
    expected = reference_outputs(pool, config, full_scan, workers=workers or default_workers())
    ref_s = time.monotonic() - t
    res = compare(pool, expected, kept, reads_fed, lambda p, i: record_id(pool, p, i), orders)
    # the one number compared, with its limit: an exact comparison
    numbers = {"mismatched_reads": (res["mismatched"], 0)}
    correct = res["compared"] > 0 and all(v <= lim for v, lim in numbers.values())
    return {"correct": correct, "numbers": numbers, "compared": res["compared"],
            "mismatched": res["mismatched"], "shown": res["shown"], "reference_s": ref_s}
