"""Benchmark of barbell_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: torch and the port, the card, the cell's read pool from the
seed, and one short warm-up call of the timed entry on two batches of
the pool.  The window: one call of
``barbell_tpu_torch.stages.kit.demux_using_kit`` (what ``python -m
barbell_tpu_torch kit`` runs) on a named pipe that a feeder process
fills with the pool, pass after pass with fresh read ids, for
``--seconds`` from the call's start; every output file is a named pipe
that a digester process reads.  After the window: the plain reference
on the seed's sample of pool reads, compared with every record the call
wrote for them.  The last line of standard output is the result (JSON).
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import platform  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare as cmp  # noqa: E402
from benchmark import traffic  # noqa: E402
from benchmark.cells import Cell, load_cell  # noqa: E402

#: top-level module names that may not be loaded in the process that
#: reports (compared whole: barbell_tpu_torch is the program under test)
FORBIDDEN = ("jax", "jaxlib", "flax", "barbell_tpu")
#: a run whose feeder or digester was busy more than this share of the
#: window measured the side process, not the program
SIDE_LIMIT = 0.8
WARM_BATCHES = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_check(chips: int):
    """(torch, device name); exits without a result when the card is absent."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"benchmark: needs {chips} CUDA device(s), found {n}; no result")
        sys.exit(3)
    return torch, torch.cuda.get_device_name(0)


def kit_config(cell: Cell, out_dir: str):
    from barbell_tpu_torch.stages.kit import KitRunConfig

    names = {f.name for f in dataclasses.fields(KitRunConfig)}
    opts = {k: v for k, v in cell.run_options.items() if k in names}
    return KitRunConfig(kit_name=cell.config["kit"], output_folder=out_dir, **opts)


def output_names(cell: Cell):
    labels = [lab for t in cell.config["templates"] for lab in t["constructs"]]
    return (["annotation.tsv", "pattern_per_read.tsv", "filtered.tsv"]
            + [f"{lab}.trimmed.fastq" for lab in dict.fromkeys(labels)]
            + ["none.trimmed.fastq"])


def _siblings(cpu: int) -> set:
    """The logical cores that share ``cpu``'s physical core."""
    try:
        with open(f"/sys/devices/system/cpu/cpu{cpu}/topology/thread_siblings_list") as fh:
            text = fh.read().strip()
    except OSError:
        return {cpu}
    out = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return out


def core_plan():
    """(this process's cores, the feeder's core, the digester's core), or
    None with fewer than four cores: the side processes each get a core
    of their own, which neither the program's threads nor the other side
    process share.  Where a physical core holds two logical ones, the
    side processes share the last physical core, so that neither slows
    the program's threads through a shared core."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return None
    last = sorted(_siblings(cores[-1]) & set(cores))
    side = last[-2:] if len(last) >= 2 else cores[-2:]
    rest = set(cores) - set(last) - set(side)
    return rest, {side[0]}, {side[1]}


def _spawn(args, root: Path, cores=None):
    pin = None if cores is None else (lambda: os.sched_setaffinity(0, cores))
    return subprocess.Popen([sys.executable, "-m", *args], cwd=str(root),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, preexec_fn=pin)


def _expect_line(proc, word: str) -> None:
    line = proc.stdout.readline().decode().strip()
    if line != word:
        raise RuntimeError(f"side process said {line!r}, not {word!r}")


def warm_up(cell: Cell, pool, device: str, work: str) -> None:
    """One call of the timed entry on the pool's first batches, into a
    folder that is then removed."""
    from barbell_tpu_torch.stages.kit import demux_using_kit

    n = min(len(pool), WARM_BATCHES * int(cell.run_options["batch_size"]))
    fifo = os.path.join(work, "warm.fastq")
    os.mkfifo(fifo)

    def feed():
        with open(fifo, "wb") as fh:
            for i in range(n):
                fh.write(traffic.record(pool, 0x7FFFFFFF, i))

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    out = os.path.join(work, "warm_out")
    demux_using_kit([fifo], kit_config(cell, out), device=device)
    t.join()
    shutil.rmtree(out)
    os.unlink(fifo)


def window(cell: Cell, seed: int, seconds: float, device: str, work: str,
           trace: bool, root: Path, prepare, plan=None):
    """Start the side processes, then ``prepare()`` (which makes the pool
    and warms up, while the feeder makes its own copy of the pool), run
    the timed call, and return (what the run measured, the pool)."""
    from barbell_tpu_torch.models import pipeline
    from barbell_tpu_torch.stages.kit import demux_using_kit

    out = os.path.join(work, "out")
    os.mkdir(out)
    names = output_names(cell)
    for name in names:
        os.mkfifo(os.path.join(out, name))
    fifo = os.path.join(work, "reads.fastq")
    os.mkfifo(fifo)
    feeder = _spawn(["benchmark.feeder", cell.name, str(seed), fifo], root,
                    plan and plan[1])
    digester = _spawn(["benchmark.digester"], root, plan and plan[2])
    try:
        pool = prepare()
        return _timed(cell, pool, seconds, device, trace, out, names, fifo, feeder,
                      digester, pipeline, demux_using_kit), pool
    finally:
        for p in (feeder, digester):
            if p.poll() is None:
                p.kill()
            p.wait()


def _timed(cell, pool, seconds, device, trace, out, names, fifo, feeder, digester,
           pipeline, demux_using_kit) -> dict:
    _expect_line(feeder, "ready")
    # the digester keeps the sample's records: the pool's, from the seed
    digester.stdin.write((json.dumps({"dir": out, "fifos": names,
                                      "sample": pool.sample.tolist()}) + "\n").encode())
    digester.stdin.flush()
    _expect_line(digester, "ready")
    pipeline.TIMINGS.clear()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # CUDA activity alone (kernels, copies and the runtime calls that
        # issue them): a CPU profile of every op would slow the host,
        # whose CPU time the per-layer metrics read in this same run
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    setup_end = time.monotonic()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t_call = time.monotonic()
    feeder.stdin.write(f"{t_call + seconds!r}\n".encode())
    feeder.stdin.flush()
    try:
        demux_using_kit([fifo], kit_config(cell, out), device=device)
    except BaseException:
        # unblock a feeder still waiting for a reader, then give up
        with contextlib.suppress(OSError):
            os.close(os.open(fifo, os.O_RDONLY | os.O_NONBLOCK))
        raise
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    return_t = time.monotonic()
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    if prof is not None:
        prof.stop()
    digester.stdin.write(b"done\n")
    digester.stdin.flush()
    dig = pickle.loads(digester.stdout.read())
    digester.wait()
    fed = json.loads(feeder.stdout.readline())
    feeder.wait()
    return {
        "setup_end": setup_end, "t_call": t_call,
        "window_s": return_t - t_call,
        "cpu_s": (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime),
        "timings": {k: list(v) for k, v in pipeline.TIMINGS.items()},
        "prof": prof, "digest": dig, "fed": fed,
    }


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        device_name: str = "", root: Path = ROOT, workers: int = 0,
        timed_hook=None) -> dict:
    """One run of ``cell``: returns the result object (and prints the
    health lines and the compared numbers on standard error).  Its key
    ``side_process_limit`` is true where the feeder or the digester was
    the limit of the window, which then measured them, not the program."""
    import torch

    everywhere = os.sched_getaffinity(0)
    plan = core_plan()
    if plan is not None:
        os.sched_setaffinity(0, plan[0])  # threads started from here inherit it

    marks = {"start_to_run": time.monotonic() - T_PROCESS}
    work = tempfile.mkdtemp(prefix="perfbench-")

    def prepare():
        pool = traffic.make_pool(cell.config, cell.traffic, seed)
        marks["pool"] = time.monotonic() - T_PROCESS
        warm_up(cell, pool, device, work)
        marks["warm_up"] = time.monotonic() - T_PROCESS
        if timed_hook is not None:
            timed_hook()
        return pool

    try:
        with contextlib.redirect_stdout(sys.stderr):
            m, pool = window(cell, seed, seconds, device, work, trace, root, prepare, plan)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        os.sched_setaffinity(0, everywhere)  # the reference's workers use every core
    setup_s = m["setup_end"] - T_PROCESS
    peak = torch.cuda.max_memory_reserved() if device != "cpu" else 0
    prof = m.pop("prof")
    tr = None
    if prof is not None:
        from benchmark.devtrace import from_profiler

        tr = from_profiler(prof)
        del prof
    import gc

    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    fed, dig = m["fed"], m["digest"]
    reads = int(fed["reads"])
    window_s = m["window_s"]
    files = dig["files"]
    j = cmp.judge(pool, cell.config, bool(cell.run_options.get("full_scan")), dig["kept"],
                  [f["order"] for f in files.values()], reads, workers)
    numbers, correct = j["numbers"], j["correct"]
    first = files.get("annotation.tsv", {}).get("first_byte_t")
    assigned, right = cmp.accuracy(pool, dig["kept"], reads)
    feeder_busy = 1 - fed["waited_s"] / max(fed["ran_s"], 1e-9)
    dig_busy = dig["busy_s"] / max(window_s, 1e-9)
    health = {
        "bytes_written": {"harness": traffic.bytes_written(), "feeder": fed["bytes_written"],
                          "digester": dig["bytes_written"]},
        "feeder_busy_share": feeder_busy, "digester_busy_share": dig_busy,
        "side_process_limit": feeder_busy > SIDE_LIMIT or dig_busy > SIDE_LIMIT,
        "host": f"{_cpu_model()} x{os.cpu_count()}",
        "cores": None if plan is None else [sorted(c) for c in plan],
        "reads_fed": reads, "passes": fed["passes"], "fed_bytes": fed["bytes"],
        "cpu_s_per_kread": m["cpu_s"] / max(reads, 1) * 1000,
        "accuracy_assigned": assigned, "accuracy_correct_of_assigned": right,
        "compared_read_instances": j["compared"], "sample_reads": len(pool.sample),
        "reference_s": j["reference_s"], "unforeseen_outputs": dig["unforeseen"],
        "setup_marks_s": dict(marks, side_processes_ready=setup_s),
        "pipe_bytes": dig.get("pipe_bytes"),
        "output_records": {n: f["records"] for n, f in files.items() if f["records"]},
        "format": {k: sum(f[k] for f in files.values())
                   for k in ("out_of_order", "unparsed", "bad_header")},
    }
    prog = files.get("pattern_per_read.tsv", {}).get("progress") or []
    health["reads_out_per_s"] = _rate_series(prog, m["t_call"], window_s)
    if tr is not None:
        health["host_runtime_calls"] = tr.runtime
    print("health " + json.dumps(health))
    if health["side_process_limit"]:
        log("benchmark: a side process was the limit of this run "
            f"(feeder busy {feeder_busy:.3f}, digester busy {dig_busy:.3f}); "
            "its rate is not a measurement of the program")
    for line in j["shown"]:
        log("mismatch: " + line)

    if trace:
        ctx = {"reads": reads, "window_s": window_s, "cpu_s": m["cpu_s"],
               "timings": m["timings"], "trace": tr,
               "first_output_s": None if first is None else first - m["t_call"]}
        metrics = {}
        for met in cell.per_layer:
            v = met.read(ctx)
            if v is not None:
                metrics[met.name] = {"value": v, "unit": met.unit}
    else:
        values = {"reads_per_s": reads / window_s, "setup_s": setup_s}
        metrics = {met.name: {"value": values[met.name], "unit": met.unit}
                   for met in cell.end_to_end}
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": device_name,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": reads, "failed": int(j["mismatched"]),
              "metrics": metrics, "device": dev,
              "side_process_limit": health["side_process_limit"]}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = window_s
        top = sorted(tr.device_s.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                               "idle_gaps": [[k, v] for k, v in tr.gaps]}
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        log(f"compared {k}: {v} (limit {lim})")
    return result


def _rate_series(progress, t0: float, window_s: float, step: float = 2.0) -> list:
    """Records a second of one output file over the window, in ``step``
    second bins, from the digester's (time, records) readings."""
    out, k, last = [], 0, 0
    bins = int(window_s // step) + 1
    for b in range(1, bins + 1):
        t = t0 + b * step
        while k < len(progress) and progress[k][0] <= t:
            last = progress[k][1]
            k += 1
        out.append(last)
    return [round((b - a) / step) for a, b in zip([0] + out, out)]


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    if a.trace:
        os.environ["BARBELL_TIMING"] = "1"  # read when the engine module loads
    _torch, name = card_check(cell.chips)
    import barbell_tpu_torch.stages.kit  # noqa: F401 - the program under test

    result = run(cell, a.seed, a.seconds, bool(a.trace), "cuda", name)
    bad = forbidden_modules()
    if bad:
        log(f"benchmark: {', '.join(bad)} loaded in the reporting process; no result")
        return 4
    if result.pop("side_process_limit"):
        log("benchmark: the feeder or the digester was the limit; no result")
        return 5
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
