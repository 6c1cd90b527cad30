"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # probe + kernel phases only
    python3 chip_smoke.py --kernels-only --package DIR
                    # the same against the barbell_tpu_torch under DIR
                    # (another checkout, for an A/B on one card)

Phases (any failure exits non-zero and prints no result line):

1. probe — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit (``nvidia-smi``), the torch and CUDA versions,
   and builds the port's kernels from ``barbell_tpu_torch/csrc`` (the
   first engine then builds the native IO library, outside the timed
   paths);
2. kernels at the ends path's shapes — every kernel and mode against
   its plain PyTorch version on the card, at the flagship shapes plus
   edge cases (IUPAC N and zero padding, empty emission ranges, rows
   with more than 8 valleys, ``w_len = 0`` lanes, left-edge and
   ``right_pos`` lanes), the Myers map mode included; then the rank and
   window kernels' edge cases at small shapes (pattern lengths 1 to 128,
   odd and short windows, ``w_len`` 0 and past the window, ``end_j =
   0``, ``right_pos`` at 1 and at W, partial blocks, both rank forms),
   and the Myers kernel's in both modes on rows crafted around its
   segment boundaries (flank lengths 1 to 128, at the wrapper's plan
   and at every segment count S);
3. the ends path — 16384 simulated SQK-RBK114-96 reads through the
   port's ``demux_using_kit`` (two-tier ends scan) in 2048-read batches;
4. the extended path — the same reads through ``kit --use-extended``
   (two barcode groups, whole-read scan): every batch must be one fused
   device call of both groups (``last_dispatch == "single-fused"``), each
   on-path kernel launched once per group per call; its assigned reads
   whose barcode differs from the simulator's truth run again on the
   scalar oracle backend, which must write the same rows (``[kit_extended]
   misassigned``);
4b. (run after 14, with the mesh steps of 7 and the kit paths'
   ``[graphs]`` of 10: run before 11 they left ``[upload]``'s profiler
   traces without their host-to-device copy records) the kit paths
   beyond the rapid kit — 16384 reads each of
   ``make_reads_kit``'s model of SQK-NBD114-96 (the construct at both
   ends) and of EXP-PBC096 (the left template's construct at the start,
   the right one's reverse complemented at the end) through
   ``demux_using_kit``, safe and ``--maximize`` (``kit_nbd``,
   ``kit_nbd_max``, ``kit_pcr``, ``kit_pcr_max``): every device call at
   the plan's tiers (safe NBD and PCR plans have no deep tier; under
   ``--maximize`` the deep tier runs at least its warm-up), EXP-PBC096's
   two groups one fused call a batch, each on-path kernel once per group
   per call, accuracy and oracle parity as below; then ``[kits]``: 256
   reads of one alias of every other registered family (KITS_READS; the
   flagship's, the two kits' and compare's SQK-RBK110-96 run elsewhere)
   through ``demux_using_kit`` (safe), each kernel launched once per
   group per call, the stage files of its first 64 reads byte-identical
   to the oracle backend's, one line a family with its plan, shapes,
   launches and accuracy (not gated);
5. two-group checks on the card — the fused dispatch against the
   per-group dispatch on the extended path's first batch, on reads with
   a mid-read fusion construct and on EXP-PBC096 reads (Ftag + rc Rtag,
   under that kit's ends plan), and against the scalar Demuxer on the
   first 64 reads of each, with each dispatch's wall time per batch;
   nibble rows (a batch with over 4096 N bytes takes them by itself;
   ``BARBELL_PACK_MODE=0``) and uploaded metadata
   (``BARBELL_META_MODE=wire``) against the default path; ``kit
   --no-stream`` against the streaming runner; ``sim`` + ``compare
   --verify`` and its per-group outcomes, each equal to the JAX
   package's on the same simulated set;
6. the whole-read paths — 16448 such reads, every 16th with a 9-20 kb
   body so that reads outrun the 8192-wide rows and become chunk rows,
   through the port's ``annotate --kit`` (whole-read scan) and ``kit
   --full-scan``.  16448 = 8 x 2048 + 64: the last batch's hit capacity
   is below 256, so it ranks with the non-split rank form;
7. the reads mesh (``[mesh]``) — ``TorchDemuxEngine(devices=["cuda:0"] *
   2)`` (and one card a shard where several are visible) on the first two
   batches of the ends, extended and whole-read paths, equal to the
   one-device engine, with each kernel launched once per shard and group;
   and the mesh's public demux steps (``sharded_demux_step``, ``_mono``
   and ``_fused``) on ``["cuda:0"] * 2``, each shard's buffer byte-equal
   to the two-shard engine's device call (whose table equals the
   one-device engine's), a replay making no ``cudaLaunchKernel`` and one
   ``cudaGraphLaunch`` a shard plus one for the hit sum;
8. record striping (``[shard]``) — ``annotate --kit --shard-rank r
   --shard-world 2`` as two processes at once on the card over the
   whole-read set, merged byte-identical to the one-process run;
9. tracing (``[profile]``) — one warm pass of the ends, extended and
   whole-read (``annotate``) paths under ``BARBELL_TIMING`` and
   ``BARBELL_PROFILE_DIR``, with CUDA graphs and then eager: phase
   report, device busy share, kernel time by name, launches a batch
   (``cudaLaunchKernel`` and ``cudaGraphLaunch`` among them), graphs
   captured and replayed, peak reserved memory, fetch against dispatch;
   the TSV equals the untraced pass's;
10. CUDA graphs (``[graphs]``) — the first three batches of the ends,
   extended and whole-read paths (and, after ``[stage_ops]``, of the
   four kit paths: run before ``[upload]`` they left its traces without
   their host-to-device copy records), and one forced overflow retry, graphs
   against the eager call: every device call's buffer byte-equal and
   every table equal on a first pass (captures), a second (no capture,
   one ``cudaGraphLaunch`` a shard a device call) and a third through
   the worker threads; dispatch s, wall ms, busy share and launch calls
   of the second pass against an eager pass, and the reserved memory
   after the first pass and with the cache full;
11. the one-blob upload (``[upload]``) — the first batch of the ends,
   extended and whole-read paths with ``mono_upload`` on (the default)
   and off: equal tables, the reference's dispatch rule (one fused call
   of both groups only on the blob), one host-to-device copy a batch on
   the blob (profiler trace) against one an array, the copies into the
   graphs' static inputs, and where the host waits for the card (sync
   debug mode);
12. row buckets (``[fine_rows]``) — the same batches with 1/8-octave row
   buckets against powers of two: equal tables, the padded rows and hit
   capacity of each call both ways, each kernel's device ms a batch both
   ways (CUDA-graph replays of the batch's captured calls); each kernel
   call of the whole-read batch with fine rows against its plain version
   on the card, timed and bounded ("fine-rows whole-read" entries);
13. ``[pack1]`` — ``BARBELL_PACK_MODE=1`` (padded 2-bit rows) against
   pack mode 2 on the first ends and whole-read batches: equal tables;
14. the compiled device functions (``[stage_ops]``) — the staged
   composites ``flank_scan``, ``flank_trace``, ``barcode_rank`` and
   their ``_reference`` variants, the six stage functions of
   ``ops/device.py`` and ``sharded_flank_step(["cuda:0"] * 2)`` on the
   card at the ends shapes (the first ends batch's rows, its first 2816
   hits), each called twice with one key: a CUDA-graph capture, then a
   replay with no ``cudaLaunchKernel`` and one ``cudaGraphLaunch`` (a
   shard); both byte-equal to ``fn.__wrapped__`` on the card and to the
   CPU route (the kernels' plain versions), the trace and the rank to
   their ``_reference`` variants; eager and replay launch calls and ms,
   capture ms and reserved MiB, beside the card's name and power limit;
15. kernels at the whole-read paths' and the extended path's shapes,
   recorded from their batches (the extended ones with the fusion
   template's flank and patterns), and the Myers kernel on the
   arguments of one full batch of the ends path, the extended path and
   ``annotate``, captured as the path passed them ("captured" entries,
   with every segment count S timed there too); every kernel call of the
   first batch of ``kit_nbd`` (rows 512 wide at m = 46, two Myers words)
   and ``kit_pcr`` (both groups: m = 59 and 60), captured as the fused
   call made them ("kit_nbd (captured)", "kit_pcr (captured)" entries).

The simulated reads and the scalar Demuxer's rows come from up to 8
spawned worker processes; the ends and whole-read sets are simulated
side by side.

Every path runs with each kernel's launch count set to 0 just before it
and read just after; every kernel of the path must have launched.  The
engines run with CUDA graphs (their default on the card) wherever a
phase does not say otherwise: a launch count counts kernels that ran,
in an eager call or in a graph's replay.
Each path must assign >= 0.99 of the reads with >= 0.99 correct against
the simulator's truth, and write stage files byte-identical to the
scalar oracle backend on its first 128 reads (the whole-read set's
include 8 chunked reads).  Kernel checks have no tolerance: integers
must be equal and Lodhi scores equal bit for bit.

Timing: a kernel's ``ms`` is the device time of one call, from ``reps``
calls captured in one CUDA graph and replayed between two CUDA events,
so host enqueue (allocation, the ctypes launch) is not in it; if
capture fails, torch.profiler's device time of ``reps`` calls, and the
phase fails if neither gives a device time.  ``timing`` names the
method; ``events_ms`` is the earlier reading (``reps`` back-to-back
wrapper calls between CUDA events, host enqueue included) and
``plain_ms`` the one call of the plain version that gives the
reference output, between CUDA events.
``--kernels-only`` adds ``sweep`` lines: every (rows, group) instance
of the rank and window kernels and every segment count S of the Myers
kernel at each path shape.
``ptxas`` is the kernel instance's registers, shared memory, stack frame
and spill bytes from the build's ``-Xptxas -v`` output.

The last three lines are a JSON object with each kernel's launches, its
largest difference from the plain version, its time, its plain
version's time, its bound (the least time the card could take for the
same work) and its ptxas line; the card's name and power limit again;
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

KIT = "SQK-RBK114-96"
N_ENDS = 16384
N_WHOLE = 16448  # 8 x 2048 + 64
LONG_EVERY = 16
BATCH = 2048
ORACLE_READS = 128
N_FUSED = 256  # reads of each two-construct input of the fused check
N_SCALAR = 64  # reads of each fused-check input held to the scalar Demuxer
N_NBATCH = 64  # reads of the N-byte batch (every fourth body base an N)
N_COMPARE = 200  # reads per simulated group of the compare check
#: the kit paths beyond the rapid kit: (kit, --maximize), 16384 reads of
#: the kit's read model (``make_reads_kit``) each
KIT_PATHS = {"kit_nbd": ("SQK-NBD114-96", False), "kit_nbd_max": ("SQK-NBD114-96", True),
             "kit_pcr": ("EXP-PBC096", False), "kit_pcr_max": ("EXP-PBC096", True)}
N_KIT = 16384
#: ``[kits]``: reads of each other registered family, and its first reads
#: held to the oracle backend
KITS_READS = 256
KITS_ORACLE_READS = 64
#: kits that run at full width elsewhere: the flagship, the kit paths'
#: and ``compare``'s (SQK-RBK110-96)
FULL_WIDTH_KITS = (KIT, "SQK-NBD114-96", "EXP-PBC096", "SQK-RBK110-96")
# compare's (assigned, correct) per group on ``sim -n 200 -r 0``, which is
# what barbell_tpu's compare on its own engine gives on the same set: the
# kit's two-tier ends scan assigns GroupV's reads by their end constructs
# and does not see the construct mid-read (docs/SEMANTICS.md)
COMPARE_EXPECTED = {"GroupI": (0, 0), "GroupII": (200, 200),
                    "GroupIII": (200, 200), "GroupIV": (0, 0),
                    "GroupV": (185, 0), "GroupVI": (0, 0)}
FLOOR = 0.99
SEED = 0
WORKERS = min(8, os.cpu_count() or 1)  # host worker processes

# Bounds: the H100 SXM's 3.35 TB/s of HBM, 67 TFLOP/s of f32 outside the
# tensor cores, and half that for int32 (64 INT32 lanes per SM beside its
# 128 FP32 lanes), per millisecond.
BYTES_PER_MS = 3.35e9
F32_PER_MS = 67e9
INT_PER_MS = 33.5e9
# Operations per DP cell (per text position for Myers), counted from the
# DP's recurrences (the kernels' inner loops); selects count as integer
# operations.  Cells are those the inputs need: rank P x m x min(W, w_len)
# per lane, the window trace and interval m x end_j, the window valley
# m x min(W, w_len, emit_hi).
MYERS_PER_WORD = 23  # csrc/myers.cu: the add-with-carry step of one word
MYERS_PER_POS = 15  # text byte, end-cost update, valley test, output
WINDOW_PER_CELL = {"valley": 9, "trace": 30, "interval": 43}  # csrc/window.cu
RANK_INT_PER_CELL = 19  # csrc/rank.cu: edit costs, moves, path selects
RANK_F32_PER_CELL = 8  # the Lodhi update: 5 multiplies, 3 adds


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def timed(phase: str):
    """Logs the phase's wall time when it ends."""
    t0 = time.perf_counter()
    yield
    log(f"phase {phase}: {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------- probe


def probe() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    from barbell_tpu_torch import _build

    _build.load()
    log(f"kernels built/loaded in {_build.build_seconds:.1f}s "
        f"({_build.library_path().name})")
    info = ptxas_info(_build.build_log)
    if not info:
        raise AssertionError("no ptxas -v output for the kernel library")
    for name, v in info.items():
        log(f"  ptxas: {name}: {v}")
    return smi


def ptxas_info(log_text: str) -> dict:
    """Per kernel (mangled name): registers, shared memory bytes, stack
    frame bytes and spill bytes, from ``-Xptxas -v`` output."""
    info, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )"
                      r"([\w$]+)", line)
        if m:
            fn = info.setdefault(m.group(1), {"registers": None, "smem": 0,
                                              "stack": None, "spill": 0})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            fn["stack"] = int(m.group(1))
            fn["spill"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            fn["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            fn["smem"] = int(sm.group(1)) if sm else 0
    return info


def _ptxas(*keys) -> dict:
    """The ptxas line of the first kernel instance whose mangled name
    holds one of ``keys`` (most specific first); raises if none does."""
    from barbell_tpu_torch import _build

    info = ptxas_info(_build.build_log)
    for key in keys:
        for name, v in info.items():
            if key in name:
                return {"kernel": name, **v}
    raise AssertionError(f"no ptxas line for {keys}")


# -------------------------------------------------------------- kernels


def _flagship_engine():
    """The ends path's shallow-tier engine: its one group plan holds the
    kernels' query constants on the card."""
    from barbell_tpu_torch.models.pipeline import TorchDemuxEngine
    from barbell_tpu_torch.stages.kit import kit_groups

    return TorchDemuxEngine(kit_groups(KIT), ends_window=(512, 512),
                            device="cuda")


def _extended_engine():
    """An engine of ``kit --use-extended``'s two groups (the RBK114
    template, then its fusion/artefact template)."""
    from barbell_tpu_torch.models.pipeline import TorchDemuxEngine
    from barbell_tpu_torch.stages.kit import kit_groups

    return TorchDemuxEngine(kit_groups(KIT, use_extended=True), device="cuda")


def _time_events(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` back-to-back calls between two CUDA
    events (host enqueue included once the calls outrun the device)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_once(fn):
    """(result, ms) of one call of ``fn`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _time_profiler(fn, reps: int) -> float:
    """Mean device ms per call over ``reps`` calls, from torch.profiler's
    device times; raises if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        us += (getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0) or 0)
    if us <= 0:
        raise AssertionError("torch.profiler reported no device time")
    return us / 1000.0 / reps


def _time(fn, reps: int):
    """(device ms per call, method): ``reps`` calls captured in one CUDA
    graph (the wrappers allocate while it is captured, not when it
    replays) and its replay timed by CUDA events; torch.profiler's
    device times if capture fails."""
    fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except Exception as exc:  # noqa: BLE001 - reported, then the profiler times it
        log(f"  CUDA graph capture failed ({type(exc).__name__}: {exc}); "
            f"timing by torch.profiler")
        torch.cuda.synchronize()
        return _time_profiler(fn, reps), "profiler"
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms, "cuda graph"


def _diff(got, want) -> float:
    """Largest absolute difference; raises unless the outputs are
    identical (float tensors compared bit for bit)."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        d = (g.double() - w.double()).abs().max().item() if g.numel() else 0.0
        worst = max(worst, d)
        if g.dtype == torch.float32:
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            same = torch.equal(g, w)
        if not same:
            n = int((g != w).sum().item())
            raise AssertionError(f"{n} entries differ (max abs diff {d})")
    return worst


def _bound(n_bytes: float, int_ops: float, f32_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and each type's operations over its peak rate."""
    t_bytes = n_bytes / BYTES_PER_MS
    t_ops = max(int_ops / INT_PER_MS, f32_ops / F32_PER_MS)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


MYERS_SRC = "barbell_tpu_torch/csrc/myers.cu"
MYERS_REP = "barbell_tpu/ops/pallas_myers.py:71"

#: each kernel wrapper the fused call reaches: (its CUDA source, the
#: Pallas site it replaces)
KERNEL_SITES = {
    "myers_topk": (MYERS_SRC, MYERS_REP + " (top-K mode, via :318)"),
    "window_valleys": ("barbell_tpu_torch/csrc/window.cu",
                       "barbell_tpu/ops/pallas_window.py:51 (MODE_VALLEY, via :357)"),
    "window_trace": ("barbell_tpu_torch/csrc/window.cu",
                     "barbell_tpu/ops/pallas_window.py:51 (MODE_TRACE, via :402)"),
    "window_interval": ("barbell_tpu_torch/csrc/window.cu",
                        "barbell_tpu/ops/pallas_window.py:51 (MODE_INTERVAL, via :434)"),
    "rank_pass1_split": ("barbell_tpu_torch/csrc/rank.cu",
                         "barbell_tpu/ops/pallas_rank.py:55 (strand-split, via :223)"),
    "rank_pass1": ("barbell_tpu_torch/csrc/rank.cu",
                   "barbell_tpu/ops/pallas_rank.py:55 (non-split, via :266)"),
}


def _myers_bound(args, out_bytes):
    """Bound of a Myers call on ``args`` (the wrapper's arguments) that
    writes ``out_bytes``: per row the columns its output needs,
    [max(0, lo - m - k - 1), min(L, hi + 2)), none when lo > hi, read once
    and scanned at MYERS_PER_WORD * W + MYERS_PER_POS operations each."""
    patw, m, rows, lo, hi, k = args[:6]
    R, L = rows.shape
    lo, hi = lo.long().cpu().numpy(), hi.long().cpu().numpy()
    span = np.minimum(L, hi + 2) - np.maximum(0, lo - m - k - 1)
    cols = int(np.where(lo <= hi, np.maximum(span, 0), 0).sum())
    ops = cols * (MYERS_PER_WORD * patw.shape[1] + MYERS_PER_POS)
    return _bound(cols + 8 * R + out_bytes, ops)


def _plant(rng, L, n_rows, pattern, copies):
    """Random base rows with noisy copies of ``pattern``, IUPAC N bytes
    and zero padding tails."""
    bases = np.array([1, 2, 4, 8], dtype=np.uint8)
    rows = bases[rng.integers(0, 4, (n_rows, L))]
    m = len(pattern)
    for r in range(n_rows):
        for pos in rng.integers(0, max(1, L - m), copies):
            seg = pattern[: min(m, L - pos)].copy()
            for e in rng.integers(0, len(seg), rng.integers(0, 4)):
                seg[e] = bases[rng.integers(0, 4)]
            rows[r, pos : pos + len(seg)] = seg
        rows[r, rng.integers(0, L, 3)] = 15
        if r % 3 == 0:
            rows[r, int(rng.integers(L // 2, L)) :] = 0
    return rows


def _rank_ptxas(rank, m, W):
    """ptxas keys of the rank kernel instance the wrapper launches at
    (m, W) (any rank kernel for a build without per-R instances)."""
    plan = getattr(rank, "plan", None)
    keys = (f"rank_kernelILi{plan(m, W)[0]}EE",) if plan else ()
    return keys + ("rank_kernel",)


def _window_ptxas(window, mode, m, W):
    """ptxas keys of the window kernel instance for ``mode`` at (m, W)."""
    plan = getattr(window, "plan", None)
    keys = (f"window_kernelILi{mode}ELi{plan(m, W)[0]}EE",) if plan else ()
    return keys + (f"window_kernelILi{mode}E",)


class KernelCheck:
    """Each kernel against its plain version on the card, at one path's
    shapes; ``entries`` collects one JSON entry per kernel and mode."""

    def __init__(self, engine, path: str, seed: int, sweep: bool = False,
                 gp=None):
        self.sweep = sweep
        self.rng = np.random.default_rng(seed)
        self.dev = torch.device("cuda")
        self.alpha = engine.alpha_scaled
        # the group whose flank and patterns the kernels run with
        (self.gp,) = engine.plans if gp is None else (gp,)
        self.path = path
        self.entries = []

    def t(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def record(self, name, source, replaces, shape, run_kernel, run_plain,
               bound, ptxas_keys, reps=20, plan=None):
        tup = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
        got = tup(run_kernel())
        torch.cuda.synchronize()
        want, plain_ms = _time_once(run_plain)
        err = _diff(got, tup(want))
        ms, method = _time(run_kernel, reps)
        events_ms = _time_events(run_kernel, reps)
        ptx = _ptxas(*ptxas_keys)
        bound_ms, bound_by = bound
        log(f"kernel {name} [{self.path}] {shape}: equal to plain (max abs "
            f"err {err}); {ms:.4f} ms by {method} ({events_ms:.4f} ms by "
            f"events) vs plain {plain_ms:.1f} ms; bound {bound_ms:.4f} ms "
            f"({bound_by}), {100 * bound_ms / ms:.1f}% of it; ptxas "
            f"{ptx['registers']} registers, {ptx['smem']} B smem, "
            f"{ptx['stack']} B stack, {ptx['spill']} B spill")
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "path": self.path, "shape": shape,
                 "max_abs_err": err, "ms": ms, "timing": method,
                 "events_ms": events_ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by, "ptxas": ptx,
                 # no single PyTorch call computes a Myers scan or these DPs
                 "library_ms": None}
        if self.sweep and plan is not None and hasattr(plan[0], "plan"):
            entry["sweep"] = self._sweep(name, *plan, run_kernel, got, reps)
        self.entries.append(entry)
        return entry

    def _sweep(self, name, module, kernel, m, run_kernel, got, reps):
        """Every (rows, group) instance the kernel has for pattern length
        ``m`` (each row count with the smallest group that covers m),
        launched through the wrapper with its ``plan`` swapped: equal
        outputs, its time (CUDA-graph method) and ptxas registers."""
        from barbell_tpu_torch import _build

        chosen, out = module.plan, []
        try:
            for R in module.ROWS:
                if -(-m // R) > 32:
                    continue
                R, G = _build.wavefront_plan(m, 0, (R,))
                module.plan = lambda _m, _W, R=R, G=G: (R, G)
                got_rg = run_kernel()
                _diff(got_rg if isinstance(got_rg, tuple) else (got_rg,), got)
                ms, _ = _time(run_kernel, reps)
                regs = _ptxas(f"{kernel}Li{R}EE")["registers"]
                log(f"  sweep {name}: R = {R}, G = {G}: equal, {ms:.4f} ms, "
                    f"{regs} registers")
                out.append({"R": R, "G": G, "ms": ms, "registers": regs})
        finally:
            module.plan = chosen
        return out

    # --- Myers interior scan, both modes
    def myers(self, R, L, copies, valleys=True):
        from barbell_tpu_torch.ops import myers, window

        gp, rng = self.gp, self.rng
        rows = self.t(_plant(rng, L, R, gp.flank, copies))
        lo = rng.integers(0, 120, R).astype(np.int32)
        hi = (L - 1 - rng.integers(0, 40, R)).astype(np.int32)
        lo[:16], hi[:16] = 300, 100  # empty emission ranges
        lo, hi = self.t(lo), self.t(hi)
        klmul = window.UNIT * (L + 2)
        args = (gp.tensors.patw, gp.m, rows, lo, hi, gp.k_units, klmul)
        self.myers_topk(args, f"rows [{R}, {L}], m = {gp.m}", self.sweep)
        cnt = myers.myers_topk(*args)[1]
        log(f"  rows {R}x{L}: {int((cnt > myers.TOPK).sum())} rows with "
            f"> 8 valleys, {int((cnt == 0).sum())} with none")
        if valleys:
            vargs = args[:-1]
            mp = myers.myers_valleys(*vargs)
            log(f"  map {R}x{L}: {int((mp < 255).sum())} valleys")
            self.record(
                "myers_valleys", MYERS_SRC, MYERS_REP + " (map mode, via :253/:270)",
                f"rows [{R}, {L}], m = {gp.m}",
                lambda: myers.myers_valleys(*vargs),
                lambda: myers.myers_valleys_plain(*vargs),
                _myers_bound(vargs, R * L),
                (f"myers_kernelILi{vargs[0].shape[1]}ELb0EE",),
            )

    def myers_topk(self, args, shape, sweep=False):
        """Record the top-K mode on ``args`` (the wrapper's arguments);
        ``sweep`` also times every segment count S of the kernel there."""
        from barbell_tpu_torch.ops import myers

        W = args[0].shape[1]
        entry = self.record(
            "myers_topk", *KERNEL_SITES["myers_topk"], shape,
            lambda: myers.myers_topk(*args),
            lambda: myers.myers_topk_plain(*args),
            _myers_bound(args, 36 * args[2].shape[0]),
            (f"myers_kernelILi{W}ELb1EE",),
        )
        if sweep and hasattr(myers, "plan"):
            entry["sweep"] = self._sweep_segments(args, entry["ptxas"]["registers"])
        return entry

    def _sweep_segments(self, args, regs, reps=20):
        """Every segment count S <= 32 of the Myers kernel on ``args``,
        launched through the wrapper with its ``plan`` swapped: equal
        outputs, its time (CUDA-graph method) and ptxas registers (one
        instance serves every S)."""
        from barbell_tpu_torch import _build
        from barbell_tpu_torch.ops import myers

        m, rows, k = args[1], args[2], args[5]
        R, L = rows.shape
        want = myers.myers_topk(*args)
        chosen, out = myers.plan, []
        log(f"  sweep myers_topk [{R}, {L}]: the plan picks (SEG, S) = "
            f"{chosen(m, k, L, R)}")
        try:
            S = 1
            while S <= min(32, L // 16):
                seg = _build.segment_size(L, S)
                myers.plan = lambda *_a, seg=seg, S=S: (seg, S)
                _diff(myers.myers_topk(*args), want)
                ms, _ = _time(lambda: myers.myers_topk(*args), reps)
                log(f"  sweep myers_topk [{R}, {L}]: S = {S}, SEG = {seg}: "
                    f"equal, {ms:.4f} ms, {regs} registers")
                out.append({"S": S, "SEG": seg, "ms": ms, "registers": regs})
                S *= 2
        finally:
            myers.plan = chosen
        return out

    # --- window valley over the boundary lanes (width m + k + 3)
    def window_valleys(self, H):
        from barbell_tpu_torch.ops import window

        gp, rng, t = self.gp, self.rng, self.t
        m, k, Wb = gp.m, gp.k_units, gp.m + gp.k_units + 3
        wins = t(_plant(rng, Wb, H, gp.flank, 1))
        w_len = np.full(H, Wb, dtype=np.int32)
        ledge = rng.integers(0, 2, H).astype(np.int32)
        rpos = np.where(rng.integers(0, 2, H) != 0, Wb, -1).astype(np.int32)
        elo = rng.integers(0, 8, H).astype(np.int32)
        ehi = (Wb - rng.integers(0, 8, H)).astype(np.int32)
        elo[:32], ehi[:32] = 50, 10
        flank = gp.tensors.flank
        U = window.UNIT
        vargs = (flank, wins, t(w_len), t(ledge), t(rpos), t(elo), t(ehi),
                 self.alpha, k * U, 512 + 2)
        cols = np.clip(np.minimum(w_len, ehi), 0, Wb).sum()
        self.record(
            "window_valleys", *KERNEL_SITES["window_valleys"],
            f"[{H} lanes, {Wb}], m = {m}",
            lambda: window.window_valleys(*vargs),
            lambda: window.window_plain(
                window.MODE_VALLEY, flank, vargs[1], vargs[5], vargs[3],
                vargs[4], vargs[6], vargs[2], self.alpha, 0, 0, k * U, 514),
            _bound(m + H * Wb + 20 * H + 36 * H,
                   cols * m * WINDOW_PER_CELL["valley"]),
            _window_ptxas(window, window.MODE_VALLEY, m, Wb),
            plan=(window, "window_kernelILi0E", m),
        )

    # --- window trace over the hit lanes (width Wf = m + k + 1)
    def window_trace(self, H):
        from barbell_tpu_torch.ops import window

        gp, rng, t = self.gp, self.rng, self.t
        m, Wf = gp.m, gp.span
        twin = _plant(rng, Wf, H, gp.flank, 1)
        end_j = rng.integers(m - 10, Wf + 1, H).astype(np.int32)
        end_j[:8] = 0
        for h in range(H):
            twin[h, end_j[h]:] = 0
        ledge = rng.integers(0, 2, H).astype(np.int32)
        rpos = np.where(rng.integers(0, 2, H) != 0, end_j, -1).astype(np.int32)
        ra, rb = gp.mask_start, gp.mask_end
        flank = gp.tensors.flank
        targs = (flank, t(twin), t(end_j), t(ledge), t(rpos), self.alpha, ra, rb)
        z = torch.zeros(H, dtype=torch.int32, device=self.dev)
        cols = np.where((end_j >= 0) & (end_j <= Wf), end_j, 0).sum()
        self.record(
            "window_trace", *KERNEL_SITES["window_trace"],
            f"[{H} lanes, {Wf}], m = {m}",
            lambda: window.window_trace(*targs),
            lambda: tuple(window.window_plain(
                window.MODE_TRACE, flank, targs[1], targs[2], targs[3],
                targs[4], z, z, self.alpha, ra, rb, 0, 0).unbind(1)),
            _bound(m + H * Wf + 12 * H + 12 * H,
                   cols * m * WINDOW_PER_CELL["trace"]),
            _window_ptxas(window, window.MODE_TRACE, m, Wf),
            plan=(window, "window_kernelILi1E", m),
        )

    def _barcode_windows(self, H):
        """Barcode windows [H, Wb = 66] holding noisy pattern copies, 16
        ``w_len = 0`` lanes, and each lane's winning pattern."""
        gp, rng = self.gp, self.rng
        Wbc = gp.barcode_window
        pats_all = gp.patterns_all
        pick = rng.integers(0, pats_all.shape[0], H)
        bwin = np.zeros((H, Wbc), dtype=np.uint8)
        b_len = rng.integers(gp.plen - 4, Wbc + 1, H).astype(np.int32)
        b_len[:16] = 0
        planted = _plant(rng, Wbc, H, pats_all[0], 0)
        for h in range(H):
            row = planted[h].copy()
            pos = int(rng.integers(0, 12))
            seg = pats_all[pick[h]][: Wbc - pos]
            row[pos : pos + len(seg)] = seg
            row[b_len[h]:] = 0
            bwin[h] = row
        return pick, bwin, b_len

    # --- window interval (winning pattern, m = 44) over the hit lanes
    def window_interval(self, H):
        from barbell_tpu_torch.ops import window

        gp, rng, t = self.gp, self.rng, self.t
        pick, bwin, b_len = self._barcode_windows(H)
        Wbc, plen = gp.barcode_window, gp.plen
        pat_top = gp.tensors.patterns_all[t(pick).long()]
        end_np = np.minimum(b_len, rng.integers(plen - 6, Wbc + 1, H)).astype(np.int32)
        end_top = t(end_np)
        bwin_t = t(bwin)
        cols = np.where((end_np >= 0) & (end_np <= Wbc), end_np, 0).sum()
        iargs = (pat_top, bwin_t, end_top, gp.rel_bar_start, gp.rel_bar_end)
        z = torch.zeros(H, dtype=torch.int32, device=self.dev)
        self.record(
            "window_interval", *KERNEL_SITES["window_interval"],
            f"[{H} lanes, {Wbc}], m = {plen}",
            lambda: window.window_interval(*iargs),
            lambda: window.window_plain(
                window.MODE_INTERVAL, pat_top, bwin_t, end_top, z, z - 1, z,
                z, window.UNIT, gp.rel_bar_start, gp.rel_bar_end, 0, 0),
            _bound(H * plen + H * Wbc + 4 * H + 24 * H,
                   cols * plen * WINDOW_PER_CELL["interval"]),
            _window_ptxas(window, window.MODE_INTERVAL, plen, Wbc),
            plan=(window, "window_kernelILi2E", plen),
        )

    # --- barcode rank, strand-split (H % 256 == 0) or non-split
    def rank(self, H, split: bool):
        from barbell_tpu_torch.ops import rank

        gp, t = self.gp, self.t
        _pick, bwin, b_len = self._barcode_windows(H)
        pats = gp.tensors.patterns_all
        Pa, m = pats.shape
        Wbc = gp.barcode_window
        bwin_t, b_len_t = t(bwin), t(b_len)
        pe = Pa // 2 if split else Pa
        W_pad = Wbc + Wbc % 2
        cells = pe * m * np.clip(b_len, 0, W_pad).sum()
        bound = _bound(Pa * m + H * Wbc + 4 * H + 8 * H * pe,
                       cells * RANK_INT_PER_CELL, cells * RANK_F32_PER_CELL)
        ptx = _rank_ptxas(rank, m, W_pad)
        if split:
            self.record(
                "rank_pass1_split", *KERNEL_SITES["rank_pass1_split"],
                f"[{H} lanes, {Wbc}] x {pe} patterns, m = {m}",
                lambda: rank.rank_pass1_split(pats, bwin_t, b_len_t, H // 2),
                lambda: rank.rank_pass1_plain(pats, bwin_t, b_len_t, split=H // 2),
                bound, ptx, plan=(rank, "rank_kernelI", m),
            )
        else:
            self.record(
                "rank_pass1", *KERNEL_SITES["rank_pass1"],
                f"[{H} lanes, {Wbc}] x {pe} patterns, m = {m}",
                lambda: rank.rank_pass1(pats, bwin_t, b_len_t),
                lambda: rank.rank_pass1_plain(pats, bwin_t, b_len_t),
                bound, ptx, reps=5,
            )


def check_ends_kernels(engine, sweep: bool = False) -> list:
    """Every kernel and mode at the ends path's flagship shapes: Myers
    rows [8192, 512] (2048 reads + their rc twins) and the deep tier's
    [1024, 1024] rows, 16384 boundary lanes, a 2816-lane hit capacity;
    ``sweep`` also times every (rows, group) instance of the rank and
    window kernels and every segment count of the Myers kernel there."""
    kc = KernelCheck(engine, "ends", SEED, sweep)
    kc.myers(8192, 512, 2)
    deep = KernelCheck(engine, "ends (deep tier)", SEED + 1, sweep)
    deep.myers(1024, 1024, 10)  # some rows carry > 8 valleys
    kc.window_valleys(16384)
    kc.window_trace(2816)
    kc.window_interval(2816)
    kc.rank(2816, split=True)
    torch.cuda.synchronize()
    return kc.entries + deep.entries


def check_edge_kernels(alpha) -> int:
    """The rank and window kernels against their plain versions at edge
    cases, exact: pattern lengths 1 to 128 (the window kernel's MAXM),
    odd windows and windows shorter than the pattern, ``w_len`` 0 and
    past the window, partial blocks, both rank forms with an odd split;
    ``end_j`` 0, 1, W and past W, ``right_pos`` at 1 and at W, left-edge
    lanes, a shared flank and per-lane patterns, lanes with more than 8
    valleys.  Returns the number of cases."""
    from barbell_tpu_torch.ops import rank, window

    rng = np.random.default_rng(SEED + 3)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def pats_of(n, m):
        p = np.array([1, 2, 4, 8], dtype=np.uint8)[rng.integers(0, 4, (n, m))]
        p[rng.integers(0, n), rng.integers(0, m)] = 15
        return p

    def lanes_len(H, W):
        w_len = rng.integers(0, W + 6, H).astype(np.int32)
        w_len[:3] = 0, W, W + 9
        return w_len

    n = most_valleys = 0
    for H, Pa, m, W, split in ((37, 10, 1, 21, 17), (37, 10, 17, 35, 0),
                               (37, 10, 17, 35, 17), (41, 192, 44, 67, 21),
                               (29, 192, 44, 66, 0), (13, 6, 44, 9, 0)):
        pats = pats_of(Pa, m)
        wins, w_len = t(_plant(rng, W, H, pats[0], 1)), t(lanes_len(H, W))
        pats = t(pats)
        if split:
            got = rank.rank_pass1_split(pats, wins, w_len, split)
        else:
            got = rank.rank_pass1(pats, wins, w_len)
        _diff(got, rank.rank_pass1_plain(pats, wins, w_len, split))
        plan = getattr(rank, "plan", lambda m, W: None)(m, W + W % 2)
        log(f"edge rank m = {m}, W = {W}, H = {H}, P = {Pa // 2 if split else Pa}, "
            f"split = {split}, (R, G) = {plan}: equal to plain")
        n += 1

    U = window.UNIT
    for mode, m, W in ((window.MODE_VALLEY, 1, 21), (window.MODE_VALLEY, 90, 40),
                       (window.MODE_VALLEY, 90, 113), (window.MODE_VALLEY, 128, 60),
                       (window.MODE_VALLEY, 128, 131), (window.MODE_TRACE, 1, 21),
                       (window.MODE_TRACE, 90, 40), (window.MODE_TRACE, 90, 111),
                       (window.MODE_TRACE, 128, 60), (window.MODE_INTERVAL, 1, 21),
                       (window.MODE_INTERVAL, 90, 40), (window.MODE_INTERVAL, 128, 60)):
        H = 45
        shared = (mode != window.MODE_INTERVAL) == (W % 2 == 1)
        pats = pats_of(1 if shared else H, m)
        wins = _plant(rng, W, H, pats[0], 2)
        wins[6] = np.resize(np.array([15, 0], dtype=np.uint8), W)  # N, pad, ...
        wins = t(wins)
        pat = t(pats[0] if shared else pats)
        ledge = rng.integers(0, 2, H).astype(np.int32)
        ledge[:2] = 1
        rpos = rng.choice([-1, 1, W, W // 2], H).astype(np.int32)
        end_j = rng.integers(0, W + 1, H).astype(np.int32)
        end_j[:4] = 0, 1, W, W + 3
        ra, rb = min(2, m - 1), max(min(2, m - 1), m - 3)
        z = torch.zeros(H, dtype=torch.int32, device=dev)
        if mode == window.MODE_VALLEY:
            w_len, elo = lanes_len(H, W), rng.integers(-1, 6, H).astype(np.int32)
            ehi = (W - rng.integers(-2, 8, H)).astype(np.int32)
            elo[5], ehi[5] = 9, 2  # empty emission range
            w_len[6], elo[6], ehi[6] = W, 0, W  # lane 6: a valley at every N
            k_scaled, klmul = (m // 3 + 1) * U, W + 2
            args = (pat, wins, t(w_len), t(ledge), t(rpos), t(elo), t(ehi),
                    alpha, k_scaled, klmul)
            got = window.window_valleys(*args)
            want = window.window_plain(mode, pat, wins, args[5], args[3], args[4],
                                       args[6], args[2], alpha, 0, 0, k_scaled, klmul)
            most_valleys = max(most_valleys, int(want[1].max()))
            extra = f", most valleys in a lane {int(want[1].max())}"
        elif mode == window.MODE_TRACE:
            args = (pat, wins, t(end_j), t(ledge), t(rpos), alpha, ra, rb)
            got = window.window_trace(*args)
            want = tuple(window.window_plain(mode, pat, wins, args[2], args[3], args[4],
                                             z, z, alpha, ra, rb, 0, 0).unbind(1))
            extra = ""
        else:
            got = window.window_interval(pat, wins, t(end_j), ra, rb)
            want = window.window_plain(mode, pat, wins, t(end_j), z, z - 1, z, z,
                                       U, ra, rb, 0, 0)
            extra = ""
        _diff(got if isinstance(got, tuple) else (got,),
              want if isinstance(want, tuple) else (want,))
        plan = getattr(window, "plan", lambda m, W: None)(m, W)
        log(f"edge window mode {mode}, m = {m}, W = {W}, H = {H}, "
            f"{'shared flank' if shared else 'per-lane patterns'}, (R, G) = "
            f"{plan}: equal to plain{extra}")
        n += 1
    if most_valleys <= window.VTOPK:
        raise AssertionError("no edge-case lane carried more than 8 valleys")
    n += check_myers_edges(rng, t)
    torch.cuda.synchronize()
    return n


def _myers_crafted(rng, pattern, L, k):
    """(rows, emit_lo, emit_hi) built around every column a that is a
    multiple of 16 (each plan's segment boundaries are among them): a
    cost-k alignment of k insertions (exactly m + k columns) ending at
    every offset a-2 .. a+2, a run of N wider than the pattern (a plateau)
    across a; a row of back-to-back copies (more than 8 valleys, several
    segments); rows with noisy copies, IUPAC N and zero padding past
    ``emit_hi``, among them an empty range, a range that ends in the
    first segment and one that starts mid-word.  An odd row count."""
    bases = np.array([1, 2, 4, 8], dtype=np.uint8)
    m, span = len(pattern), len(pattern) + k
    rows, lo, hi = [], [], []

    def add(row, a=0, b=L - 1):
        rows.append(row)
        lo.append(a)
        hi.append(b)

    for a in range(16, L, 16):
        for d in range(-2, 3):
            end = a + d
            if end - span < 0 or end > L - 1:
                continue
            text = list(pattern)
            for p in sorted(rng.integers(1, max(2, m), k), reverse=True):
                text.insert(int(p), bases[rng.integers(0, 4)])
            row = bases[rng.integers(0, 4, L)]
            row[end - span : end] = text
            add(row)
        row = bases[rng.integers(0, 4, L)]
        row[max(0, a - m - 1) : a + 2] = 15
        add(row)
    row = bases[rng.integers(0, 4, L)]
    for pos in range(1, L - m + 1, m + 3):
        row[pos : pos + m] = pattern
    add(row)
    for i in range(13 - len(rows) % 2):
        row = _plant(rng, L, 1, pattern, 2)[0]
        tec = int(rng.integers(L // 2, L + 1))
        row[tec:] = 0
        if i == 0:
            add(row, 7, 3)  # empty range
        elif i == 1:
            add(row, 0, 9)  # ends in the first segment
        elif i == 2:
            add(row, min(L - 1, int(rng.integers(L // 4, L)) | 5), L - 1)
        else:
            add(row, int(rng.integers(0, 3)), tec - 2)
    return np.stack(rows), np.array(lo, np.int32), np.array(hi, np.int32)


def check_myers_edges(rng, t) -> int:
    """The Myers kernel in both modes against its plain versions on rows
    crafted around segment boundaries (``_myers_crafted``), exact, for
    flank lengths 1 to 128 (1-4 pattern words), L = 16 and L not a
    multiple of SEG, an odd row count (never a whole block): at the
    wrapper's plan and at every segment count S, S = 1 included, forced
    through the plan.  Returns the number of cases."""
    from barbell_tpu_torch import _build
    from barbell_tpu_torch.ops import myers, window

    n = 0
    for m, L in ((1, 64), (9, 16), (9, 256), (32, 208), (33, 256), (90, 512),
                 (90, 1024), (128, 512)):
        pattern = np.array([1, 2, 4, 8], dtype=np.uint8)[rng.integers(0, 4, m)]
        if m > 4:
            pattern[rng.integers(1, m - 1)] = 15
        k = 0 if m == 1 else (20 if m == 90 else max(2, m // 5))
        rows, lo, hi = _myers_crafted(rng, pattern, L, k)
        words, _, _ = myers.pattern_words(pattern)
        args = (t(words.view(np.int32)), m, t(rows), t(lo), t(hi), k)
        klmul = window.UNIT * (L + 2)
        want_k = myers.myers_topk_plain(*args, klmul)
        want_m = myers.myers_valleys_plain(*args)
        R = rows.shape[0]
        if not hasattr(myers, "plan"):
            plans = [None]
        else:
            plans = [myers.plan(m, k, L, R)] + [
                (_build.segment_size(L, 1 << i), 1 << i)
                for i in range(6) if 1 << i <= L // 16]
        chosen = getattr(myers, "plan", None)
        try:
            for p in plans:
                if p is not None:
                    myers.plan = lambda *_a, p=p: p
                _diff(myers.myers_topk(*args, klmul), want_k)
                _diff((myers.myers_valleys(*args),), (want_m,))
        finally:
            if chosen is not None:
                myers.plan = chosen
        cnt = want_k[1]
        log(f"edge myers m = {m}, k = {k}, L = {L}, R = {R}: both modes equal "
            f"to plain at (SEG, S) = {plans}; {int((cnt > 0).sum())} rows with "
            f"valleys, most valleys in a row {int(cnt.max())}")
        n += 1
    return n


# The batch shapes as the full run records them, for --kernels-only:
# the whole-read paths' (a full 2048-read batch and the last 64-read
# one) and the extended path's (every batch full).
WHOLE_READ_BATCHES = ({"L": 4096, "R_total": 6144, "H_cap": 6144},
                      {"L": 4096, "R_total": 192, "H_cap": 192})
EXTENDED_BATCHES = ({"L": 4096, "R_total": 4096, "H_cap": 4096},)


def check_batch_kernels(engine, batches, path: str, seed: int,
                        sweep: bool = False, gp=None) -> list:
    """Every kernel at a whole-read scan's recorded batch shapes (the
    whole-read paths' or the extended path's): the largest batch's rows
    and hit capacity, and the largest split and non-split rank
    capacities among the batches; ``gp`` is the group the kernels run
    with (the engine's one group by default); ``sweep`` also times every
    instance of the rank and window kernels and every segment count of
    the Myers kernel there."""
    big = max(batches, key=lambda b: b["R_total"] * b["L"])
    kc = KernelCheck(engine, path, seed, sweep, gp)
    kc.myers(big["R_total"], big["L"], 2, valleys=False)
    kc.window_valleys(2 * big["R_total"])
    kc.window_trace(big["H_cap"])
    kc.window_interval(big["H_cap"])
    for split in (True, False):
        caps = [b["H_cap"] for b in batches if (b["H_cap"] % 256 == 0) == split]
        if caps:
            kc.rank(max(caps), split=split)
    torch.cuda.synchronize()
    return kc.entries


# ---------------------------------------------------------------- paths


class BatchRecorder:
    """Records each device call's row width, row count, hit capacity,
    group count, device, ends windows (the tier's) and the engine's
    dispatch (the engine's
    ``_dispatch``, which runs one group or, fused, every group of a batch
    on one shard) while installed."""

    def __init__(self):
        from barbell_tpu_torch.models.pipeline import TorchDemuxEngine

        self.cls = TorchDemuxEngine
        self.orig = TorchDemuxEngine._dispatch
        self.batches = []

    def __enter__(self):
        orig, batches = self.orig, self.batches

        def call(eng, gplans, batch, H_cap):
            batches.append({"L": batch.L, "R_total": batch.R_total,
                            "H_cap": H_cap, "groups": len(gplans),
                            "dispatch": eng.last_dispatch,
                            "device": str(batch.parts["host_packed"].device),
                            "ends": (eng.ends_wl, eng.ends_wr)})
            return orig(eng, gplans, batch, H_cap)

        self.cls._dispatch = call
        return self

    def __exit__(self, *exc):
        self.cls._dispatch = self.orig


def _launches_of(calls) -> dict:
    """Each on-path kernel's launches for the recorded device calls: once
    per group of each call, the rank in its split form when the call's
    hit capacity is a multiple of 256."""
    per_call = sum(b["groups"] for b in calls)
    split = sum(b["groups"] for b in calls if b["H_cap"] % 256 == 0)
    return {"myers_topk": per_call, "window_valleys": per_call,
            "window_trace": per_call, "window_interval": per_call,
            "rank_pass1_split": split, "rank_pass1": per_call - split}


class MyersCapture:
    """Keeps a copy of the arguments of the largest ``myers_topk`` call
    (one full batch's) that the fused device call makes while installed;
    the call itself goes on to the wrapper, which counts its launch.
    Calls made while a CUDA graph is captured are passed over: their
    tensors hold no data yet, and the graph's replays rewrite them (the
    eager first use of each graph runs the same call on real data)."""

    def __init__(self):
        import threading

        from barbell_tpu_torch.ops import composite

        self.mod = composite
        self.orig = composite.myers_topk
        self.lock = threading.Lock()
        self.args = None

    def __enter__(self):
        orig = self.orig

        def call(patw, m, rows, emit_lo, emit_hi, k_units, klmul):
            if torch.cuda.is_current_stream_capturing():
                return orig(patw, m, rows, emit_lo, emit_hi, k_units, klmul)
            with self.lock:
                if self.args is None or rows.numel() > self.args[2].numel():
                    self.args = (patw.clone(), m, rows.clone(), emit_lo.clone(),
                                 emit_hi.clone(), k_units, klmul)
            return orig(patw, m, rows, emit_lo, emit_hi, k_units, klmul)

        self.mod.myers_topk = call
        return self

    def __exit__(self, *exc):
        self.mod.myers_topk = self.orig


def _simulate(n, long_every, path):
    """``n`` simulated reads (``make_reads_rbk``), also written to the
    FASTQ ``path`` (runs in a worker process too)."""
    from barbell_tpu_torch.sim import make_reads_rbk, write_fastq

    reads = make_reads_rbk(n, SEED, long_every=long_every)
    write_fastq(path, reads)
    return reads


def _simulate_kit(kit, n, path):
    """``n`` reads of ``kit``'s read model (``make_reads_kit``), also
    written to the FASTQ ``path`` (runs in a worker process too)."""
    from barbell_tpu_torch.sim import make_reads_kit, write_fastq

    reads = make_reads_kit(kit, n, SEED)
    write_fastq(path, reads)
    return reads


def _kit(fq, out, backend, full_scan=False, kit=KIT, device="cuda", **config):
    from barbell_tpu_torch.stages.kit import KitRunConfig, demux_using_kit

    demux_using_kit(
        [fq],
        KitRunConfig(kit_name=kit, output_folder=out, batch_size=BATCH,
                     backend=backend, full_scan=full_scan, **config),
        device=device,
    )


def _annotate(fq, out, backend):
    """``annotate --kit`` in its default whole-read scan."""
    from barbell_tpu_torch.stages.annotate import AnnotateConfig, annotate_with_kit

    os.makedirs(out, exist_ok=True)
    annotate_with_kit([fq], os.path.join(out, "annotation.tsv"), KIT,
                      AnnotateConfig(backend=backend, batch_size=BATCH),
                      device="cuda")


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


def _accuracy(reads, anno_path):
    """bench.py's measure: a read is assigned by its first barcode (Ftag)
    annotation row."""
    truth = {rid: label for rid, _s, label in reads}
    first = {}
    with open(anno_path) as fh:
        next(fh)
        for line in fh:
            f = line.split("\t")
            if f[9] == "Ftag" and f[0] not in first:
                first[f[0]] = f[12]
    n_correct = sum(truth[rid] == label for rid, label in first.items())
    return len(first) / len(reads), n_correct / max(1, len(first))


@contextlib.contextmanager
def _quiet(d, name):
    """The stages' own console output (kit info, barcode tables,
    summaries) goes to a file beside the run, off this script's
    output."""
    with open(os.path.join(d, f"{name}.stdout"), "w") as fh, \
            contextlib.redirect_stdout(fh):
        yield


def run_path(name, fq, d, reads, wrappers, required, smi):
    """Drive one path with every launch count at 0 just before it; check
    its launches and accuracy; return (launches, batches, the arguments
    of its largest Myers call)."""
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    with BatchRecorder() as rec, MyersCapture() as cap, _quiet(d, name):
        t0 = time.perf_counter()
        PATHS[name](fq, os.path.join(d, name), "torch")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    log(f"[{name}] launches: {launches}")
    for b in rec.batches:
        log(f"[{name}] call: L {b['L']}, R_total {b['R_total']}, H_cap "
            f"{b['H_cap']} ({'split' if b['H_cap'] % 256 == 0 else 'non-split'} "
            f"rank), {b['groups']} group(s), {b['dispatch']}")
    for kname in required:
        if launches[kname] <= 0:
            raise AssertionError(f"kernel {kname} never launched in path {name}")
    assigned, correct = _accuracy(reads, os.path.join(d, name, "annotation.tsv"))
    log(f"[{name}] accuracy: assigned {assigned:.4f}, correct-of-assigned "
        f"{correct:.4f}")
    if assigned < FLOOR or correct < FLOOR:
        raise AssertionError(f"{name}: accuracy below {FLOOR}")
    log(f"[{name}] smoke figure (not a benchmark): {len(reads)} reads in "
        f"{dt:.3f}s = {len(reads) / dt:.0f} reads/s, end to end incl. FASTQ "
        f"IO, on {smi}")
    return launches, rec.batches, cap.args


def _kit_extended(fq, out, backend):
    _kit(fq, out, backend, use_extended=True)


def _kit_full(fq, out, backend):
    _kit(fq, out, backend, full_scan=True)


#: each path's run(fq, out, backend), by the path's name
PATHS = {"kit": _kit, "kit_extended": _kit_extended, "annotate": _annotate,
         "kit_full_scan": _kit_full,
         **{name: functools.partial(_kit, kit=kit, maximize=maximize)
            for name, (kit, maximize) in KIT_PATHS.items()}}


def _oracle_run(name, d):
    """Path ``name`` on the scalar oracle backend over its first
    ORACLE_READS reads (``{name}_sub.fastq``; in a worker process);
    returns its seconds."""
    with _quiet(d, f"{name}_sub_oracle"):
        t0 = time.perf_counter()
        PATHS[name](os.path.join(d, f"{name}_sub.fastq"),
                    os.path.join(d, f"{name}_sub_oracle"), "oracle")
        return time.perf_counter() - t0


def _same_files(a_dir, b_dir, what, ref="the oracle backend") -> dict:
    """The files of ``a_dir``, which must equal ``b_dir``'s (``ref``'s)
    byte for byte."""
    a, b = _files(a_dir), _files(b_dir)
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: stage files differ from {ref}'s: {sorted(a)} "
                             f"vs {sorted(b)}")
    for f in a:
        if a[f] != b[f]:
            raise AssertionError(f"{what}: {f} differs from {ref}'s")
    return a


def oracle_parity(name, reads, d, oracle_job):
    """The path's files on the first ORACLE_READS reads equal the scalar
    oracle backend's byte for byte (``oracle_job``: the oracle's run on
    them, :func:`_oracle_run`)."""
    a_dir, b_dir = os.path.join(d, f"{name}_sub_torch"), os.path.join(d, f"{name}_sub_oracle")
    with _quiet(d, f"{name}_sub"):
        PATHS[name](os.path.join(d, f"{name}_sub.fastq"), a_dir, "torch")
    t_oracle = oracle_job.result()
    a = _same_files(a_dir, b_dir, name)
    n_long = sum(len(s) > 8192 for _r, s, _l in reads[:ORACLE_READS])
    log(f"[{name}] oracle parity: {len(a)} files byte-identical on "
        f"{ORACLE_READS} reads ({n_long} longer than 8192 bases; oracle "
        f"{t_oracle:.1f}s in a worker process)")


def check_launches(name, batches, launches, n_groups):
    """A path's calls: every batch is one call of the kit's ``n_groups``
    groups (with two, one fused call: ``single-fused``), any other call
    one group's overflow retry, and each on-path kernel launched once
    per group per call."""
    full = [b for b in batches if b["groups"] == n_groups]
    if not full or (n_groups > 1 and any(b["dispatch"] != "single-fused" for b in full)):
        raise AssertionError(f"{name}: a batch was not one fused call")
    if any(b["groups"] != 1 for b in batches if b not in full):
        raise AssertionError(f"{name}: a retry call ran more than one group")
    want = _launches_of(batches)
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{name} launches {got}, want {want}")
    log(f"[{name}] {len(full)} device calls, each one "
        f"{'fused call' if n_groups > 1 else 'call'} of {n_groups} group(s), "
        f"{len(batches) - len(full)} retry call(s): every on-path kernel "
        f"launched once per group per call ({want})")


def _kits_aliases() -> list:
    """``[kits]``: one alias (the first) of each registered family that
    no full-width path runs."""
    from barbell_tpu_torch.kits.database import get_kit_info, supported_kits

    skip = {get_kit_info(k).name for k in FULL_WIDTH_KITS}
    families = {}
    for alias in supported_kits():
        family = get_kit_info(alias).name
        if family not in skip:
            families.setdefault(family, alias)
    return list(families.values())


def _kits_reference(kit, d, route):
    """``[kits]``: ``kit``'s first KITS_ORACLE_READS reads on a reference
    route (in a worker process): ``"oracle"``, the scalar oracle backend
    (a whole-read scan), or ``"cpu"``, the port's default ends scan on
    the CPU (the kernels' plain versions, which the CPU tests hold to
    the JAX package); returns its seconds."""
    torch.set_num_threads(1)
    with _quiet(d, f"kits_{kit}_sub_{route}"):
        t0 = time.perf_counter()
        _kit(os.path.join(d, f"kits_{kit}_sub.fastq"),
             os.path.join(d, f"kits_{kit}_sub_{route}"),
             "oracle" if route == "oracle" else "torch", kit=kit, device="cpu")
        return time.perf_counter() - t0


def submit_kits(d, pool) -> dict:
    """``[kits]``' reads (KITS_READS of each family's ``make_reads_kit``)
    and the reference runs of their first reads in ``pool``: {alias:
    (reads, {route: its job})}."""
    from barbell_tpu_torch.sim import make_reads_kit, write_fastq

    jobs = {}
    for kit in _kits_aliases():
        reads = make_reads_kit(kit, KITS_READS, SEED)
        write_fastq(os.path.join(d, f"kits_{kit}.fastq"), reads)
        write_fastq(os.path.join(d, f"kits_{kit}_sub.fastq"), reads[:KITS_ORACLE_READS])
        jobs[kit] = (reads, {route: pool.submit(_kits_reference, kit, d, route)
                             for route in ("oracle", "cpu")})
    return jobs


def check_kits(jobs, d, wrappers, required, smi) -> dict:
    """``[kits]``: each family's reads through ``demux_using_kit`` (safe
    presets) on the card, with every launch count at 0 just before it:
    every device call at the plan's windows (a deep tier's at least in
    its warm-up, ``warm_deep``), each kernel of
    ``required`` launched, each on-path kernel once per group per call.
    On its first KITS_ORACLE_READS reads the card's stage files are
    byte-identical to two references: the default ends scan to the same
    scan on the CPU route (the plain versions), and ``--full-scan`` to
    the oracle backend.  (The ends scan leaves out hits in a long read's
    unscanned middle, which the oracle's whole-read scan reports:
    ``docs/SEMANTICS.md`` deviation 7, which the JAX package shares,
    ``tests/test_torch_kits.py`` pins it on an SQK-MAB114-24 read.)
    Logs a line a family (plan, shapes, launches, accuracy against the
    simulated truth, not gated).  Returns the launches summed over the
    families."""
    from barbell_tpu_torch.kits.database import get_kit_info
    from barbell_tpu_torch.models.groups import GroupPlan
    from barbell_tpu_torch.stages.kit import kit_groups, kit_plan

    total = {w.__name__: 0 for w in wrappers}
    for kit, (reads, refs) in jobs.items():
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        with BatchRecorder() as rec, _quiet(d, f"kits_{kit}"):
            t0 = time.perf_counter()
            _kit(os.path.join(d, f"kits_{kit}.fastq"), os.path.join(d, f"kits_{kit}"),
                 "torch", kit=kit)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        what = f"[kits] {kit}"
        _require(launches, required, what)
        want = _launches_of(rec.batches)
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"{what}: launches {launches}, want {want}")
        plan = kit_plan(kit)
        tiers = {b["ends"] for b in rec.batches}
        if not tiers <= {tuple(plan.shallow)} | ({tuple(plan.deep)} if plan.deep else set()):
            raise AssertionError(f"{what}: calls at ends windows {sorted(tiers)}, plan {plan}")
        for name, n in launches.items():
            total[name] += n
        assigned, correct = _accuracy(reads, os.path.join(d, f"kits_{kit}", "annotation.tsv"))
        sub = os.path.join(d, f"kits_{kit}_sub.fastq")
        a_dir = os.path.join(d, f"kits_{kit}_sub_torch")
        f_dir = os.path.join(d, f"kits_{kit}_sub_full")
        with _quiet(d, f"kits_{kit}_sub"):
            _kit(sub, a_dir, "torch", kit=kit)
            _kit(sub, f_dir, "torch", full_scan=True, kit=kit)
        t_ref = {route: job.result() for route, job in refs.items()}
        files = _same_files(a_dir, os.path.join(d, f"kits_{kit}_sub_cpu"), what,
                            "the CPU route")
        full = _same_files(f_dir, os.path.join(d, f"kits_{kit}_sub_oracle"),
                           f"{what} --full-scan")
        spec = get_kit_info(kit)
        shapes = [(gp.m, gp.k_units, gp.plen, gp.barcode_window, gp.n_patterns)
                  for gp in (GroupPlan(g, "cpu") for g in kit_groups(kit))]
        calls = sorted({(b["L"], b["R_total"], b["H_cap"], b["groups"], b["ends"])
                        for b in rec.batches})
        log(f"{what} ({spec.name}, {spec.pattern_class} presets): plan {plan}; groups "
            f"(m, k, plen, Wb, P) {shapes}; calls (L, R_total, H_cap, groups, ends) "
            f"{calls}; launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}; "
            f"{len(reads)} reads in {dt:.2f}s, assigned {assigned:.4f}, "
            f"correct-of-assigned {correct:.4f} (not gated); on {KITS_ORACLE_READS} "
            f"reads {len(files)} files byte-identical to the CPU route's "
            f"({t_ref['cpu']:.1f}s) and, --full-scan, {len(full)} to the oracle "
            f"backend's ({t_ref['oracle']:.1f}s, in worker processes); {smi}")
    return total


def check_kit_path(name, plan, batches) -> None:
    """A kit path ran its plan's tiers and no other: every device call
    at the shallow windows or, with a deep tier, the deep ones (its
    warm-up, ``warm_deep``, at least)."""
    tiers = {b["ends"] for b in batches}
    want = {tuple(plan.shallow)} | ({tuple(plan.deep)} if plan.deep else set())
    if tiers != want:
        raise AssertionError(f"[{name}] device calls at ends windows {sorted(tiers)}, "
                             f"want the plan's {sorted(want)}")
    deep = sum(b["ends"] == tuple(plan.deep) for b in batches) if plan.deep else 0
    log(f"[{name}] plan {plan}: {len(batches) - deep} shallow-tier calls "
        f"{sorted({(b['L'], b['R_total'], b['H_cap']) for b in batches if b['ends'] == tuple(plan.shallow)})} "
        f"(L, R_total, H_cap), {deep} deep-tier call(s)"
        + (f" {sorted({(b['L'], b['R_total'], b['H_cap']) for b in batches if b['ends'] == tuple(plan.deep)})}"
           if deep else " (no deep tier)"))


class CallSpy:
    """Records the pack mode and metadata layout of every fused device
    call (``composite.demux_call_fused``) while installed; on the blob
    the layout is read from its spans.  Under CUDA graphs a key's first
    use calls it (eagerly, then to capture) and its replays do not."""

    def __init__(self):
        from barbell_tpu_torch.ops import composite

        self.mod = composite
        self.orig = composite.demux_call_fused
        self.calls = []

    def __enter__(self):
        orig, calls = self.orig, self.calls

        def call(groups, parts, **kw):
            names = [n for n, _off, _shape in kw["spans"]] if kw.get("spans") else parts
            calls.append((kw["pack_mode"], "desc" if "rowdesc" in names else "wire"))
            return orig(groups, parts, **kw)

        self.mod.demux_call_fused = call
        return self

    def __exit__(self, *exc):
        self.mod.demux_call_fused = self.orig


def _construct(g, i):
    """Group ``g``'s flank around its ``i``-th barcode."""
    a, b = g.bar_region
    p0 = g.pad_region[0]
    return g.flank[:a] + g.barcodes[i].seq[a - p0 : b - p0 + 1] + g.flank[b + 1 :]


def _two_construct_reads(groups, n, seed, fusion):
    """``fusion``: a standard construct at the start and a fusion
    construct mid-read (tests/test_e2e_extra.py's reads); otherwise an
    Ftag construct at the start and an rc Rtag construct at the end,
    every other read reverse complemented."""
    import random

    from barbell_tpu_torch.sim.simulate import mutate_sequence, random_sequence
    from barbell_tpu_torch.utils import dna

    rng = random.Random(seed)
    g1, g2 = groups
    ids, seqs = [], []
    for i in range(n):
        bc = rng.randrange(len(g1.barcodes))
        body1 = bytes(random_sequence(rng, rng.randrange(200, 500)))
        body2 = bytes(random_sequence(rng, rng.randrange(200, 500)))
        c2 = _construct(g2, (bc + 7) % len(g2.barcodes))
        if fusion:
            seq = _construct(g1, bc) + body1 + c2 + body2
        else:
            seq = _construct(g1, bc) + body1 + body2 + dna.reverse_complement_bytes(c2)
            if i % 2:
                seq = dna.reverse_complement_bytes(seq)
        ids.append(f"{'x' if fusion else 'p'}{i}")
        seqs.append(mutate_sequence(rng, seq, 0, 4))
    return ids, seqs


def _tables_equal(a, b, what):
    from barbell_tpu_torch.models import hittable

    if a.read_ids != b.read_ids or not np.array_equal(a.read_lens, b.read_lens):
        raise AssertionError(f"{what}: read ids or lengths differ")
    for c in hittable.COLUMNS:
        if not np.array_equal(a.cols[c], b.cols[c]):
            raise AssertionError(f"{what}: column {c} differs")


def _scalar_chunk(groups, items):
    """The scalar Demuxer's rows of each (read id, sequence) in ``items``
    (runs in a worker process)."""
    from barbell_tpu_torch.models.demux import Demuxer

    d = Demuxer(alpha=0.4)
    for g in groups:
        d.add_query_group(g)
    return [d.demux(rid, seq) for rid, seq in items]


def _scalar_rows_equal(pool, groups, table, ids, seqs, n, what):
    """The table's rows of its first ``n`` reads equal the scalar
    Demuxer's, computed in ``pool``'s worker processes (the scalar search
    takes ~0.1-0.3 s a read of a 96-barcode group)."""
    from barbell_tpu_torch.models import hittable

    items = list(zip(ids, seqs))[:n]
    size = -(-len(items) // WORKERS)
    chunks = [items[i : i + size] for i in range(0, len(items), size)]
    want = [m for part in pool.map(_scalar_chunk, [groups] * len(chunks), chunks)
            for m in part]
    rows = hittable.table_to_matches(table)
    for (rid, _seq), got, w in zip(items, rows, want):
        if got != w:
            raise AssertionError(f"{what}: read {rid} differs from the scalar Demuxer")


def _wall_ms(fn, reps=3):
    """Mean host wall ms of ``fn`` (one batch, ending in its fetch)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000 / reps


def check_fused(ends_reads, wrappers, smi, pool) -> None:
    """The fused dispatch against the per-group dispatch on three
    two-group inputs, and against the scalar Demuxer (in ``pool``) on the
    first N_SCALAR reads of each: the extended path's first batch (reads
    0-2047 of the ends set), 256 reads with a standard and a mid-read
    fusion construct (both under ``--use-extended``'s whole-read scan),
    and 256 EXP-PBC096 reads with an Ftag and an rc Rtag construct (under
    the kit's two-tier ends plan).  Prints each dispatch's wall ms per
    batch (a smoke figure)."""
    from barbell_tpu_torch.models.pipeline import TorchDemuxEngine
    from barbell_tpu_torch.models.twotier import make_ends_engine
    from barbell_tpu_torch.stages.kit import kit_groups, kit_plan

    ext = kit_groups(KIT, use_extended=True)
    pcr = kit_groups("EXP-PBC096")
    pcr_plan = kit_plan("EXP-PBC096")
    batch = ([r for r, _s, _l in ends_reads[:BATCH]],
             [s for _r, s, _l in ends_reads[:BATCH]])
    inputs = (
        ("extended batch", ext, TorchDemuxEngine(ext, device="cuda"), batch),
        ("fusion reads", ext, TorchDemuxEngine(ext, device="cuda"),
         _two_construct_reads(ext, N_FUSED, SEED + 5, fusion=True)),
        ("EXP-PBC096 reads", pcr, make_ends_engine(pcr, pcr_plan, device="cuda"),
         _two_construct_reads(pcr, N_FUSED, SEED + 6, fusion=False)),
    )
    for name, groups, eng, (ids, seqs) in inputs:
        tiers = _tiers(eng)
        for w in wrappers:
            w.launches = 0
        fused = eng.demux_batch_table(ids, seqs)
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in wrappers}
        if eng.last_dispatch != "single-fused":
            raise AssertionError(f"{name}: dispatch {eng.last_dispatch}")
        fused_ms = _wall_ms(lambda: eng.demux_batch_table(ids, seqs))
        for t in tiers:
            t.fuse_groups = False
        per_group = eng.demux_batch_table(ids, seqs)
        if eng.last_dispatch != "single":
            raise AssertionError(f"{name}: per-group dispatch {eng.last_dispatch}")
        per_group_ms = _wall_ms(lambda: eng.demux_batch_table(ids, seqs))
        _tables_equal(fused, per_group, name)
        n_scalar = min(len(ids), N_SCALAR)
        t0 = time.perf_counter()
        _scalar_rows_equal(pool, groups, fused, ids, seqs, n_scalar, name)
        log(f"[fused] {name}: {len(ids)} reads, {fused.n_rows} rows, launches "
            f"{launches}; fused table = per-group table, = scalar Demuxer on "
            f"{n_scalar} reads ({time.perf_counter() - t0:.1f}s); wall per batch "
            f"fused {fused_ms:.1f} ms, per-group {per_group_ms:.1f} ms (smoke "
            f"figure, not a benchmark; {smi})")


def _n_reads(rng, n, lo, hi):
    """``n`` SQK-RBK114-96 reads with ``lo``-``hi``-base bodies, every
    fourth body base an N (scattered Ns: a run of them would match the
    flank everywhere and send the rows to the scalar fallback); the reads
    stay under the ends plan's full cover, so the ends scan sees every
    base."""
    from barbell_tpu_torch.sim.simulate import (
        default_barcodes,
        mutate_sequence,
        rapid_adapter,
        random_sequence,
    )
    from barbell_tpu_torch.utils import dna

    bcs = default_barcodes(96)
    ids, seqs = [], []
    for i in range(n):
        body = random_sequence(rng, rng.randrange(lo, hi))
        body[::4] = b"N" * len(body[::4])
        seq = rapid_adapter(bcs[rng.randrange(96)][1]) + bytes(body)
        if i % 2:
            seq = dna.reverse_complement_bytes(seq)
        ids.append(f"n{i}")
        seqs.append(mutate_sequence(rng, seq, 0, 3))
    return ids, seqs


def check_host_forms(ends_reads, wrappers, pool) -> None:
    """Nibble rows and uploaded metadata on the card: a batch of 64 reads
    carrying over 4096 N bytes takes pack mode 0 by itself and equals
    the scalar Demuxer (in ``pool``); the first 2048 ends reads under
    BARBELL_PACK_MODE=0 and under BARBELL_META_MODE=wire give the default
    path's table.  Every engine runs the kit's two-tier ends plan."""
    import random

    from barbell_tpu_torch.models.twotier import make_ends_engine
    from barbell_tpu_torch.stages.kit import kit_groups, kit_plan

    groups, plan = kit_groups(KIT), kit_plan(KIT)
    ids, seqs = _n_reads(random.Random(SEED + 7), N_NBATCH, 300, 600)
    eng = make_ends_engine(groups, plan, device="cuda")
    with CallSpy() as spy:
        table = eng.demux_batch_table(ids, seqs)
    if not spy.calls or set(spy.calls) != {(0, "wire")}:
        raise AssertionError(f"N batch: fused calls {spy.calls}, want nibble rows")
    _scalar_rows_equal(pool, groups, table, ids, seqs, len(ids), "N batch")
    log(f"[host forms] {N_NBATCH} reads with {sum(s.count(b'N') for s in seqs)} N bytes: "
        f"calls {spy.calls} (pack mode 0, wire metadata); {table.n_rows} rows "
        f"= scalar Demuxer")

    ids = [r for r, _s, _l in ends_reads[:BATCH]]
    seqs = [s for _r, s, _l in ends_reads[:BATCH]]
    want = make_ends_engine(groups, plan, device="cuda").demux_batch_table(ids, seqs)
    for var, value, form in (("BARBELL_PACK_MODE", "0", (0, "wire")),
                             ("BARBELL_META_MODE", "wire", (2, "wire"))):
        os.environ[var] = value
        try:
            for w in wrappers:
                w.launches = 0
            with CallSpy() as spy:
                got = make_ends_engine(groups, plan, device="cuda").demux_batch_table(
                    ids, seqs)
            torch.cuda.synchronize()
        finally:
            del os.environ[var]
        if set(spy.calls) != {form}:
            raise AssertionError(f"{var}={value}: fused calls {spy.calls}")
        _tables_equal(got, want, f"{var}={value}")
        log(f"[host forms] {var}={value}: {len(ids)} ends reads, calls "
            f"{sorted(set(spy.calls))}, launches "
            f"{ {w.__name__: w.launches for w in wrappers} }; table = default "
            f"path's ({want.n_rows} rows)")


def check_staged(fq, d) -> None:
    """``kit --no-stream`` (the staged four-pass runner) writes the
    streaming runner's files byte for byte."""
    out = {}
    with _quiet(d, "staged"):
        for name, stream in (("stream", True), ("staged", False)):
            o = os.path.join(d, f"staged_{name}")
            _kit(fq, o, "torch", stream=stream,
                 failed_out=os.path.join(o, "failed.txt"))
            out[name] = _files(o)
    if out["stream"] != out["staged"]:
        diff = sorted(f for f in set(out["stream"]) | set(out["staged"])
                      if out["stream"].get(f) != out["staged"].get(f))
        raise AssertionError(f"staged runner's files differ: {diff}")
    log(f"[staged] kit --no-stream on {BATCH} ends reads: {len(out['stream'])} "
        f"files byte-identical to the streaming runner's "
        f"({sum(f.endswith('.trimmed.fastq') for f in out['stream'])} trimmed FASTQs)")


def check_compare(d, wrappers) -> None:
    """``sim -n 200 -r 0`` and ``compare --verify`` through the port's
    command line on the card, scored per group: every group's (assigned,
    correct) is COMPARE_EXPECTED's, so GroupII is fully recovered, GroupI,
    IV and VI rejected, GroupIII correct, and GroupV's reads are correct
    nowhere; the whole-read scan (``kit --full-scan``) rejects GroupV."""
    from barbell_tpu_torch import cli
    from barbell_tpu_torch.sim.compare import evaluate_group
    from barbell_tpu_torch.sim.simulate import GROUPS
    from barbell_tpu_torch.stages.kit import KitRunConfig, demux_using_kit

    sim, work = os.path.join(d, "cmp_sim"), os.path.join(d, "cmp_work")
    for w in wrappers:
        w.launches = 0
    with _quiet(d, "compare"):
        if cli.main(["sim", "-n", str(N_COMPARE), "-o", sim, "-r", "0"]) != 0:
            raise AssertionError("sim failed")
        t0 = time.perf_counter()
        if cli.main(["compare", "--sim-dir", sim, "-o", work, "--verify"]) != 0:
            raise AssertionError("compare failed")
        dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    for g in GROUPS:
        r = evaluate_group(
            g, os.path.join(sim, f"{g}.fastq"), os.path.join(sim, f"{g}_truth.txt"),
            os.path.join(work, g))
        log(f"[compare] {g}: {r.total_reads} reads, assigned {r.assigned}, "
            f"correct {r.correct}")
        if r.total_reads != N_COMPARE or (r.assigned, r.correct) != COMPARE_EXPECTED[g]:
            raise AssertionError(f"compare: {g}: {r}, want (assigned, correct) "
                                 f"{COMPARE_EXPECTED[g]}")
    full = os.path.join(d, "cmp_groupV_full")
    with _quiet(d, "compare_full"):
        demux_using_kit([os.path.join(sim, "GroupV.fastq")],
                        KitRunConfig(kit_name="SQK-RBK110-96", output_folder=full,
                                     full_scan=True), device="cuda")
    v_full = evaluate_group("GroupV", os.path.join(sim, "GroupV.fastq"),
                            os.path.join(sim, "GroupV_truth.txt"), full)
    if v_full.assigned:
        raise AssertionError(f"compare: GroupV not rejected by the whole-read scan: {v_full}")
    log(f"[compare] outcomes as expected in {dt:.1f}s (launches {launches}); "
        f"GroupV: {COMPARE_EXPECTED['GroupV'][0]} reads assigned under the ends "
        f"scan (mid-read constructs it does not scan), 0 under kit --full-scan")


def check_misassigned(reads, d, name="kit_extended") -> None:
    """The path's assigned reads whose first barcode differs from the
    simulator's truth: the oracle backend on just those reads must write
    the torch run's ``annotation.tsv`` rows for them, byte for byte (then
    the wrong barcode is the reference's own answer, not a port fault)."""
    from barbell_tpu_torch.sim import write_fastq

    truth = {rid: label for rid, _s, label in reads}
    first, rows = {}, {}
    with open(os.path.join(d, name, "annotation.tsv")) as fh:
        header = next(fh)
        for line in fh:
            f = line.split("\t")
            rows.setdefault(f[0], []).append(line)
            if f[9] == "Ftag" and f[0] not in first:
                first[f[0]] = f[12]
    bad = {rid for rid, label in first.items() if truth[rid] != label}
    if not bad:
        log(f"[{name}] misassigned: none of {len(first)} assigned reads")
        return
    sub = [r for r in reads if r[0] in bad]
    fq = os.path.join(d, f"{name}_mis.fastq")
    write_fastq(fq, sub)
    out = os.path.join(d, f"{name}_mis_oracle")
    t0 = time.perf_counter()
    with _quiet(d, f"{name}_mis"):
        PATHS[name](fq, out, "oracle")
    with open(os.path.join(out, "annotation.tsv")) as fh:
        oracle_rows = fh.read()
    torch_rows = header + "".join(line for rid, _s, _l in sub for line in rows[rid])
    desc = ", ".join(f"{rid} (truth {truth[rid]}, assigned {first[rid]})"
                     for rid, _s, _l in sub)
    verdict = ("the oracle backend writes the same rows: the reference's own "
               "answer" if oracle_rows == torch_rows else
               "the oracle backend's rows DIFFER: a port fault")
    log(f"[{name}] misassigned: {len(sub)} of {len(first)} assigned reads: "
        f"{desc}; {verdict} ({time.perf_counter() - t0:.1f}s)")
    if oracle_rows != torch_rows:
        raise AssertionError(f"{name}: misassigned reads' rows differ from the oracle's")


def check_mesh(ends_reads, whole_reads, wrappers, smi) -> None:
    """The reads mesh on the card: ``devices=["cuda:0"] * 2`` (and one
    card a shard where more than one is visible) against the one-device
    engine on the first two batches of the ends path (the kit's two-tier
    ends plan), the extended path (two groups: ``sharded-fused``) and the
    whole-read path (chunk rows): equal tables, the dispatch, each on-path
    kernel launched once per shard and group of every call (and retry),
    and each engine's wall ms a batch.  Two shards on one card are a
    correctness run: they cannot show a multi-card speed."""
    from barbell_tpu_torch.models.pipeline import TorchDemuxEngine
    from barbell_tpu_torch.models.twotier import make_ends_engine
    from barbell_tpu_torch.stages.kit import kit_groups, kit_plan

    plan = kit_plan(KIT)
    paths = (
        ("ends", lambda **kw: make_ends_engine(kit_groups(KIT), plan, **kw),
         ends_reads, "sharded"),
        ("extended", lambda **kw: TorchDemuxEngine(
            kit_groups(KIT, use_extended=True), **kw), ends_reads, "sharded-fused"),
        ("whole-read", lambda **kw: TorchDemuxEngine(kit_groups(KIT), **kw),
         whole_reads, "sharded"),
    )
    meshes = [["cuda:0"] * 2]
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        meshes.append([f"cuda:{i}" for i in range(n_cards)])
    else:
        log("[mesh] one card visible: the case of one distinct card a shard "
            "was not run")
    for name, make, reads, dispatch in paths:
        batches = [([r for r, _s, _l in reads[i : i + BATCH]],
                    [s for _r, s, _l in reads[i : i + BATCH]])
                   for i in (0, BATCH)]
        one = make(devices=["cuda:0"])
        want = [one.demux_batch_table(*b) for b in batches]
        one_ms = _wall_ms(lambda: [one.demux_batch_table(*b) for b in batches],
                          reps=2) / len(batches)
        for devices in meshes:
            eng = make(devices=devices)
            for w in wrappers:
                w.launches = 0
            with BatchRecorder() as rec:
                got = [eng.demux_batch_table(*b) for b in batches]
                torch.cuda.synchronize()
            launches = {w.__name__: w.launches for w in wrappers}
            what = f"[mesh] {name} on {devices}"
            for i, (g, w) in enumerate(zip(got, want)):
                _tables_equal(g, w, f"{what}, batch {i}")
            if eng.last_dispatch != dispatch:
                raise AssertionError(f"{what}: dispatch {eng.last_dispatch}")
            calls = [b for b in rec.batches if b["dispatch"] == dispatch]
            shards = {}
            for b in calls:
                shards[b["device"]] = shards.get(b["device"], 0) + 1
            expect = _launches_of(rec.batches)
            if {k: launches[k] for k in expect} != expect:
                raise AssertionError(f"{what}: launches {launches}, want {expect}")
            mesh_ms = _wall_ms(lambda: [eng.demux_batch_table(*b) for b in batches],
                               reps=2) / len(batches)
            per_batch = {k: v / len(batches) for k, v in expect.items() if v}
            log(f"{what}: {len(batches)} batches of {BATCH} reads, tables = "
                f"one-device engine's ({sum(t.n_rows for t in got)} rows); "
                f"{eng.last_dispatch}, {len(rec.batches)} device calls "
                f"({len(calls)} {dispatch}, by device {shards}); launches a "
                f"batch {per_batch} = once per shard and group of every call; "
                f"wall ms a batch: one device {one_ms:.1f}, mesh {mesh_ms:.1f} "
                f"(a correctness run, not a multi-card speed; {smi})")


def _engine_calls(eng, batch):
    """(table, [(group plans, the shard's uploaded batch, H_cap, its
    output buffer)]) of ``eng``'s device calls on ``batch``, run
    eagerly (``cuda_graphs`` off)."""
    calls = []
    orig = type(eng)._dispatch

    def dispatch(gplans, b, H_cap):
        launched = orig(eng, gplans, b, H_cap)
        calls.append((gplans, b, H_cap, launched.out.clone()))
        return launched

    eng.cuda_graphs = False
    eng._dispatch = dispatch
    try:
        table = eng.demux_batch_table(*batch)
        torch.cuda.synchronize()
    finally:
        del eng._dispatch  # the class's again, and no engine -> engine cycle
    return table, calls


def _demux_statics(eng, gplan, b, H_cap):
    """(group statics, call statics) of one engine call as the JAX
    package's ``demux_call`` names them."""
    from barbell_tpu_torch import PADDING

    gi, gf = eng._group_scalars(gplan, b.step)
    group = dict(gi=gi, gf=gf, m=gplan.m, k_units=gplan.k_units,
                 W_words=gplan.patw.shape[1], top_bit=(gplan.m - 1) % 32,
                 Wf=gplan.span, plen=gplan.plen, Wb=gplan.barcode_window,
                 P=gplan.n_patterns)
    call = dict(K=eng.K, H_cap=H_cap, padding=PADDING, pack_mode=b.pack_mode,
                L_rows=b.L, ends_w=eng.ends_wl, ends_wr=eng.ends_wr, halo=eng.halo,
                cat_align=eng.cat_align, S_pad=b.S_pad,
                meta_mode="desc" if "rowdesc" in b.parts else "wire",
                use_pallas=True, interpret=False)
    return group, call


#: the reads mesh the public demux steps run on
MESH_STEP_DEVICES = ["cuda:0"] * 2


def check_mesh_steps(ends_reads, pcr_reads, wrappers, smi) -> dict:
    """The mesh's public demux steps on ``["cuda:0"] * 2`` against the
    two-shard engine's own device calls on one batch: ``sharded_demux_step``
    on the flagship ends batch uploaded an array at a time (uploaded
    metadata), ``sharded_demux_step_mono`` on its blob (descriptor
    metadata), ``sharded_demux_step_fused`` on the EXP-PBC096 batch's
    blob (two groups).  The engine's tables equal the one-device
    engine's (as ``[mesh]`` holds); each step's per-shard buffers equal
    the engine's byte for byte and its hit sum theirs, on a first call
    (captures) and a replay, which makes no ``cudaLaunchKernel`` and one
    ``cudaGraphLaunch`` a shard, plus one for the shards' hit sum.
    Returns the kernels' launches in the steps' calls."""
    from barbell_tpu_torch.models import graphs
    from barbell_tpu_torch.models.pipeline import TorchDemuxEngine, _over_words
    from barbell_tpu_torch.parallel import mesh
    from barbell_tpu_torch.stages.kit import kit_groups

    devices = MESH_STEP_DEVICES
    launches = {w.__name__: 0 for w in wrappers}
    cases = (
        ("sharded_demux_step", kit_groups(KIT), dict(ends_window=(512, 512), mono_upload=False),
         ends_reads),
        ("sharded_demux_step_mono", kit_groups(KIT), dict(ends_window=(512, 512)), ends_reads),
        ("sharded_demux_step_fused", kit_groups("EXP-PBC096"), dict(ends_window=(512, 512)),
         pcr_reads),
    )
    for name, groups, kw, reads in cases:
        batch = ([r for r, _s, _l in reads[:BATCH]], [s for _r, s, _l in reads[:BATCH]])
        one = TorchDemuxEngine(groups, devices=["cuda:0"], **kw).demux_batch_table(*batch)
        eng = TorchDemuxEngine(groups, devices=devices, **kw)
        table, calls = _engine_calls(eng, batch)
        _tables_equal(table, one, f"[mesh] {name}")
        calls = [c for c in calls if len(c[0]) == len(groups)][: len(devices)]
        gplans, b0, H_cap = calls[0][:3]
        stat = [_demux_statics(eng, g, b0, H_cap) for g in gplans]
        tensors = [(g.tensors.flank, g.tensors.patw, g.tensors.patterns_all) for g in gplans]
        if name == "sharded_demux_step":
            step = mesh.sharded_demux_step(devices, **stat[0][0], **stat[0][1])
            arrays = [[c[1].parts[n] for c in calls]
                      for n in ("host_packed", "simple_idx", "meta", "exc", "row_start")]
            run = lambda: step(*tensors[0], *arrays)  # noqa: E731
        elif name == "sharded_demux_step_mono":
            step = mesh.sharded_demux_step_mono(devices, spans=b0.spans, **stat[0][0],
                                                **stat[0][1])
            run = lambda: step(*tensors[0], [c[1].blob for c in calls])  # noqa: E731
        else:
            step = mesh.sharded_demux_step_fused(
                devices, spans=b0.spans, group_statics=tuple(
                    tuple(sorted(g.items())) for g, _c in stat),
                common=tuple(sorted(stat[0][1].items())))
            run = lambda: step(tensors, [c[1].blob for c in calls])  # noqa: E731
        want_total = 0
        for gp_, b, cap, out in calls:
            off = 0
            for g in gp_:
                off += cap * eng._rec_wire(g, b.L, b.R_total)[0] + _over_words(b.R_total) + 1
                want_total += int(out[off - 1])
            if off != out.numel():
                raise AssertionError(f"[mesh] {name}: buffer of {out.numel()} words, "
                                     f"groups' layouts {off}")
        before = {w.__name__: w.launches for w in wrappers}
        replays = graphs.COMPILED.replays
        results = [run()]
        torch.cuda.synchronize()
        for w in wrappers:
            launches[w.__name__] += w.launches - before[w.__name__]
        out2, rt = _runtime_of(run)
        results.append(out2)
        n_replays = graphs.COMPILED.replays - replays
        if (rt.get("cudaLaunchKernel", 0), rt.get("cudaGraphLaunch", 0)) != (0, len(devices) + 1):
            raise AssertionError(f"[mesh] {name}: the replay made {rt}")
        for i, (outs, total) in enumerate(results):
            for d, (o, c) in enumerate(zip(outs, calls)):
                if o.dtype != c[3].dtype or not torch.equal(o, c[3]):
                    raise AssertionError(f"[mesh] {name}: call {i + 1}, shard {d}: buffer "
                                         f"differs from the engine's")
            if int(total) != want_total:
                raise AssertionError(f"[mesh] {name}: call {i + 1}: hit sum {int(total)}, "
                                     f"the engine's {want_total}")
        log(f"[mesh] {name} on {devices}: {len(groups)} group(s), {len(calls)} shards of "
            f"[L {b0.L}, R_total {b0.R_total}, H_cap {H_cap}], "
            f"{'blob' if b0.blob is not None else 'separate arrays'} "
            f"({stat[0][1]['meta_mode']} metadata); the engine's table = the one-device "
            f"engine's ({table.n_rows} rows); the step's shard buffers = the engine's calls' "
            f"byte for byte, hit sum {want_total}, on a capture and a replay; replay "
            f"{rt.get('cudaGraphLaunch', 0)} cudaGraphLaunch (a shard, and the sum), "
            f"{rt.get('cudaLaunchKernel', 0)} cudaLaunchKernel, {n_replays} compiled "
            f"replays; {smi}")
    return launches


def check_shard(fq, d, smi) -> None:
    """``annotate --kit KIT --shard-rank r --shard-world 2`` as two
    processes at once on the one card over the whole-read set; their
    shards merge to the one-process run's ``annotation.tsv`` byte for
    byte."""
    import barbell_tpu_torch
    from barbell_tpu_torch.parallel.distributed import merge_annotation_shards

    root = os.path.dirname(os.path.dirname(os.path.abspath(barbell_tpu_torch.__file__)))
    out_dir = os.path.join(d, "shard")
    os.makedirs(out_dir)
    out = os.path.join(out_dir, "annotation.tsv")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            fh = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "barbell_tpu_torch", "annotate", "-i", fq,
                 "-o", out, "--kit", KIT, "--shard-rank", str(rank),
                 "--shard-world", "2"],
                stdout=fh, stderr=subprocess.STDOUT, env=env, cwd=root), fh))
        rcs = [p.wait(timeout=600) for p, _fh in procs]
    finally:
        for p, fh in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            fh.close()
    dt = time.perf_counter() - t0
    if rcs != [0, 0]:
        tails = [Path(out_dir, f"rank{r}.log").read_text()[-2000:] for r in range(2)]
        raise AssertionError(f"[shard] ranks exited {rcs}: {tails}")
    sizes = [os.path.getsize(os.path.join(out_dir, f"annotation.shard-{r}.tsv"))
             for r in range(2)]
    merge_annotation_shards(out, 2)
    with open(out, "rb") as a, open(os.path.join(d, "annotate", "annotation.tsv"), "rb") as b:
        merged, single = a.read(), b.read()
    if merged != single:
        raise AssertionError("[shard] merged shards differ from the one-process run")
    log(f"[shard] annotate --kit {KIT} --shard-rank 0/1 --shard-world 2: two "
        f"processes at once on one card in {dt:.1f}s (process start, kernel "
        f"load and FASTQ parsing of the whole set in each); shards of {sizes} "
        f"bytes merge to the one-process annotation.tsv byte for byte "
        f"({len(merged)} bytes; {smi})")


def _trace_device_time(path):
    """(union ms of the card's kernel, copy and set intervals, {kernel
    name: (calls, ms)}, copy ms, {CUDA runtime call: (calls, host ms)})
    from a torch.profiler Chrome trace; raises if it holds no device
    event."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, kernels, copy_ms, runtime = [], {}, 0.0, {}
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        dur = float(e.get("dur", 0))
        if cat == "cuda_runtime":
            n, ms = runtime.get(e["name"], (0, 0.0))
            runtime[e["name"]] = (n + 1, ms + dur / 1000)
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts = float(e["ts"])
        spans.append((ts, ts + dur))
        if cat == "kernel":
            name = e["name"].replace("void ", "").replace("(anonymous namespace)::", "")
            name = re.split(r"[<(]", name, 1)[0]
            n, ms = kernels.get(name, (0, 0.0))
            kernels[name] = (n + 1, ms + dur / 1000)
        else:
            copy_ms += dur / 1000
    if not spans:
        raise AssertionError(f"{path}: the trace holds no device event")
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return busy / 1000, kernels, copy_ms, runtime


def _sync_points(engine, batch) -> dict:
    """{file:line: count} of the lines where one batch through ``engine``
    made the host wait for the card (torch's sync debug mode)."""
    import warnings

    torch.cuda.synchronize()
    found = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.demux_batch_table(*batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{os.path.basename(w.filename)}:{w.lineno}"
            found[where] = found.get(where, 0) + 1
    return found


def _runtime_calls(runtime, name) -> int:
    """Calls of the CUDA runtime function ``name`` in a trace's
    ``runtime`` table (versioned entry points, ``_v10000`` and the like,
    included)."""
    return sum(n for k, (n, _ms) in runtime.items() if k.split("_v")[0] == name)


@contextlib.contextmanager
def _eager_engines():
    """Every engine made inside runs its device calls eagerly
    (``cuda_graphs = False``): the engines the stages make themselves."""
    from barbell_tpu_torch.models.pipeline import TorchDemuxEngine

    orig = TorchDemuxEngine.__init__

    def init(self, *args, **kw):
        orig(self, *args, **kw)
        self.cuda_graphs = False

    TorchDemuxEngine.__init__ = init
    try:
        yield
    finally:
        TorchDemuxEngine.__init__ = orig


@contextlib.contextmanager
def _graph_caches():
    """The graph caches of the engines made inside (their capture and
    replay counts)."""
    from barbell_tpu_torch.models import graphs

    made, orig = [], graphs.GraphCache.__init__

    def init(self, *args, **kw):
        orig(self, *args, **kw)
        made.append(self)

    graphs.GraphCache.__init__ = init
    try:
        yield made
    finally:
        graphs.GraphCache.__init__ = orig


def check_profile(fq_ends, fq_whole, d, wrappers, smi, batches) -> None:
    """One warm pass each of the ends (``kit``), extended (``kit
    --use-extended``) and whole-read (``annotate --kit``) paths under
    ``BARBELL_TIMING`` and ``BARBELL_PROFILE_DIR``, with CUDA graphs (the
    default) and then eager: the trace is written and the TSV equals the
    untraced pass's; prints the phase report, the device busy share (the
    union of the trace's kernel and copy intervals over the pass's wall
    time, under the profiler), the kernel time by name, the launches a
    batch (port kernels, ``cudaLaunchKernel``, ``cudaGraphLaunch``), the
    graphs captured and replayed, the peak reserved device memory, the
    fetch against the dispatch and the
    host time in CUDA runtime calls; then where one ends and one
    whole-read batch (``batches``) make the host wait for the card."""
    from torch.profiler import ProfilerActivity, profile

    from barbell_tpu_torch import timing
    from barbell_tpu_torch.models import pipeline
    from barbell_tpu_torch.models.pipeline import TorchDemuxEngine
    from barbell_tpu_torch.models.twotier import make_ends_engine
    from barbell_tpu_torch.stages.kit import kit_groups, kit_plan

    # the profiler's first start (CUPTI's) takes seconds: outside the passes
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    log(f"[profile] profiler warm-up {time.perf_counter() - t0:.1f}s")
    timing.ENABLED = True
    try:
        for (name, fq, n_reads), mode in (
                (p, m) for p in (("kit", fq_ends, N_ENDS),
                                 ("kit_extended", fq_ends, N_ENDS),
                                 ("annotate", fq_whole, N_WHOLE))
                for m in ("graphs", "eager")):
            tag = f"{name} ({mode})"
            pdir = os.path.join(d, f"profile_{name}_{mode}")
            out = os.path.join(d, f"{name}_profiled_{mode}")
            pipeline.TIMINGS.clear()
            for w in wrappers:
                w.launches = 0
            os.environ["BARBELL_PROFILE_DIR"] = pdir
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                with _quiet(d, f"{name}_profiled_{mode}"), _graph_caches() as caches, \
                        (_eager_engines() if mode == "eager" else contextlib.nullcontext()):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    PATHS[name](fq, out, "torch")
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1000
            finally:
                del os.environ["BARBELL_PROFILE_DIR"]
            launches = {w.__name__: w.launches for w in wrappers}
            traces = sorted(Path(pdir).glob("*.trace.json"))
            if len(traces) != 1:
                raise AssertionError(f"[profile] {tag}: traces {traces}")
            with open(os.path.join(out, "annotation.tsv"), "rb") as a, \
                    open(os.path.join(d, name, "annotation.tsv"), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"[profile] {tag}: TSV differs from "
                                         f"the untraced pass's")
            busy_ms, kernels, copy_ms, runtime = _trace_device_time(traces[0])
            n_batches = -(-n_reads // BATCH)
            t = pipeline.TIMINGS
            disp, fetch = t["demux_call.dispatch"], t["demux_call.fetch"]
            top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
            log(f"[profile] {tag}: {n_reads} reads, {n_batches} batches, wall "
                f"{wall_ms:.1f} ms under the profiler; trace "
                f"{traces[0].name} ({traces[0].stat().st_size} bytes); TSV = "
                f"untraced pass's; {smi}")
            log(f"[profile] {tag}: phases (seconds summed over "
                f"{pipeline.DEFAULT_PIPELINE_DEPTH} worker threads):\n"
                f"{pipeline.timing_report()}")
            log(f"[profile] {tag}: device busy {busy_ms:.2f} ms of {wall_ms:.1f} "
                f"= {100 * busy_ms / wall_ms:.2f}% (kernels "
                f"{sum(ms for _n, ms in kernels.values()):.2f} ms in "
                f"{sum(n for n, _ms in kernels.values())} launches, copies and "
                f"sets {copy_ms:.2f} ms)")
            log(f"[profile] {tag}: kernel time by name (calls, ms): "
                + "; ".join(f"{k} ({n}, {ms:.3f})" for k, (n, ms) in top))
            log(f"[profile] {tag}: a batch: port kernel launches "
                f"{ {k: round(v / n_batches, 2) for k, v in launches.items() if v} }, "
                f"cudaLaunchKernel {_runtime_calls(runtime, 'cudaLaunchKernel') / n_batches:.2f}, "
                f"cudaGraphLaunch {_runtime_calls(runtime, 'cudaGraphLaunch') / n_batches:.2f}; "
                f"graphs captured {sum(c.captures for c in caches)}, replayed "
                f"{sum(c.replays for c in caches)} in the pass; peak reserved memory "
                f"{torch.cuda.max_memory_reserved() / 2**20:.0f} MiB")
            log(f"[profile] {tag}: demux_call.fetch {fetch[0] * 1000:.1f} ms "
                f"(n={fetch[1]}) against demux_call.dispatch {disp[0] * 1000:.1f} "
                f"ms (n={disp[1]}): {fetch[0] / max(disp[0], 1e-9):.2f}x")
            top_rt = sorted(runtime.items(), key=lambda kv: -kv[1][1])[:6]
            log(f"[profile] {tag}: host time in CUDA runtime calls (calls, "
                f"ms, summed over threads): "
                + "; ".join(f"{k} ({n}, {ms:.1f})" for k, (n, ms) in top_rt))
    finally:
        timing.ENABLED = False
        pipeline.TIMINGS.clear()
    for name, eng, batch in (
            ("ends", make_ends_engine(kit_groups(KIT), kit_plan(KIT), device="cuda"),
             batches[0]),
            ("whole-read", TorchDemuxEngine(kit_groups(KIT), device="cuda"), batches[1])):
        eng.demux_batch_table(*batch)
        log(f"[profile] one {name} batch: the host waits for the card at "
            f"{_sync_points(eng, batch)} (file:line: times)")


# ------------------------------------------------------------ graphs


#: batches of each path the [graphs] phase runs
N_GRAPH_BATCHES = 3


def _tiers(eng):
    """The engines a (two-tier) engine runs on."""
    return [getattr(eng, t) for t in ("shallow", "deep") if hasattr(eng, t)] or [eng]


def _recorded_pass(eng, batches, threads: bool = False):
    """(fetched buffers by batch, tables) of one pass over ``batches``:
    each of the engine's device calls' host copies, in call order within
    the batch; on ``threads`` through ``engine_map_batches`` (the
    pipeline's worker threads), else one batch after another."""
    import threading

    from barbell_tpu_torch.models.pipeline import engine_map_batches

    local, bufs = threading.local(), {}
    for t in _tiers(eng):
        def fetch(launched, _orig=t._fetch):
            out = _orig(launched)
            bufs[local.batch].append(out.copy())
            return out

        t._fetch = fetch
    run = eng.demux_batch_table

    def batch_table(ids, seqs):
        local.batch = ids[0]
        bufs[ids[0]] = []
        return run(ids, seqs)

    try:
        if threads:
            tables = [tb for _i, _s, tb in engine_map_batches(
                types.SimpleNamespace(demux_batch_table=batch_table), iter(batches))]
        else:
            tables = [batch_table(*b) for b in batches]
        torch.cuda.synchronize()
    finally:
        for t in _tiers(eng):
            del t._fetch  # the class's again, and no engine -> engine cycle
    return [bufs[ids[0]] for ids, _s in batches], tables


def _profiled_pass(eng, batches) -> dict:
    """One pass over ``batches`` (one after another) under torch.profiler
    and the phase timers: wall ms, the card's busy ms, kernels traced,
    ``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls, dispatch s, and
    the device calls made (:class:`BatchRecorder`)."""
    from torch.profiler import ProfilerActivity, profile

    from barbell_tpu_torch import timing
    from barbell_tpu_torch.models import pipeline

    pipeline.TIMINGS.clear()
    timing.ENABLED = True
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                BatchRecorder() as rec:
            t0 = time.perf_counter()
            for b in batches:
                eng.demux_batch_table(*b)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000
        dispatch_s = pipeline.TIMINGS["demux_call.dispatch"][0]
    finally:
        timing.ENABLED = False
        pipeline.TIMINGS.clear()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        busy_ms, kernels, _copy_ms, runtime = _trace_device_time(path)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "dispatch_s": dispatch_s,
            "kernels": sum(n for n, _ms in kernels.values()),
            "launch_kernel": _runtime_calls(runtime, "cudaLaunchKernel"),
            "graph_launch": _runtime_calls(runtime, "cudaGraphLaunch"),
            "calls": len(rec.batches), "caps": [b["H_cap"] for b in rec.batches]}


def check_graphs(ends_reads, whole_reads, smi, kit_reads=None) -> None:
    """CUDA graphs against the eager call on the first N_GRAPH_BATCHES
    batches of the ends, extended and whole-read paths, or, given
    ``kit_reads`` (each kit's reads), of the four kit paths, and on the ends
    path's first batch with its hit capacity forced to BATCH / 8 = 256
    (the call overflows, and its retry runs at a capacity of its own, a
    key of its own): every fetched device-call buffer byte-equal (to the
    eager engine's first pass on the first pass, to a later eager pass
    on the later ones: an overflow raises both engines' sticky hit
    capacity, so the NBD kit's batches retry only on a first pass) and
    every table equal, on a first pass (which captures), a second (which captures
    nothing and replays one graph a shard a device call,
    ``cudaGraphLaunch`` counted in a profiler trace) and a third through
    the pipeline's worker threads; the second pass's dispatch s, wall
    ms, busy share and launch calls against an eager pass's, and the
    reserved device memory with the cache full."""
    import gc

    from barbell_tpu_torch.models import pipeline
    from barbell_tpu_torch.models.twotier import make_ends_engine
    from barbell_tpu_torch.stages.kit import kit_groups, kit_plan

    if kit_reads is None:
        reads_of = {"ends": ends_reads, "extended": ends_reads, "whole-read": whole_reads}
        cases = [(name, make, reads_of[name], N_GRAPH_BATCHES, False)
                 for name, make, _b in _first_batches(ends_reads, whole_reads)]
        cases.append(("ends, forced retry", cases[0][1], ends_reads, 1, True))
    else:
        cases = [(name, functools.partial(
                      lambda kit, maximize, **kw: make_ends_engine(
                          kit_groups(kit), kit_plan(kit, maximize), device="cuda", **kw),
                      kit, maximize), kit_reads[kit], N_GRAPH_BATCHES, False)
                 for name, (kit, maximize) in KIT_PATHS.items()]
    for name, make, reads, n, force in cases:
        batches = [([r for r, _s, _l in reads[i : i + BATCH]],
                    [s for _r, s, _l in reads[i : i + BATCH]])
                   for i in range(0, n * BATCH, BATCH)]

        def build(graphs):
            eng = make()
            eng.cuda_graphs = graphs
            if force:
                eng_t = _tiers(eng)[0]
                eng_t._h_cap = lambda B, plan, R: BATCH // 8
            return eng

        eager = build(False)
        want, want_tables = _recorded_pass(eager, batches)
        if force and not any(len(b) == 2 for b in want):
            raise AssertionError(f"[graphs] {name}: no call overflowed the forced capacity")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        eng = build(True)
        caches = [t._graphs for t in _tiers(eng)]
        caps = lambda: sum(c.captures for c in caches)  # noqa: E731
        c0 = caps()
        passes = [_recorded_pass(eng, batches)]
        c1 = caps()
        # what stays reserved past the allocator's free cache: the graphs'
        # pools and static inputs and outputs
        torch.cuda.empty_cache()
        one_mib = (torch.cuda.memory_reserved() - base) / 2**20
        eager_stats = _profiled_pass(eager, batches)
        # an overflow's retry raises an engine's sticky hit capacity, so
        # its later passes start there: they are held to a later eager pass
        want_next, _tables = _recorded_pass(eager, batches)
        graph_stats = _profiled_pass(eng, batches)
        c2 = caps()
        passes.append(_recorded_pass(eng, batches))
        passes.append(_recorded_pass(eng, batches, threads=True))
        c3 = caps()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        full_mib = (torch.cuda.memory_reserved() - base) / 2**20
        for i, (got, tables) in enumerate(passes):
            for b, (g, w) in enumerate(zip(got, want if i == 0 else want_next)):
                if len(g) != len(w) or any(
                        x.dtype != y.dtype or not np.array_equal(x, y) for x, y in zip(g, w)):
                    raise AssertionError(f"[graphs] {name}: pass {i + 1}, batch {b}: "
                                         f"fused outputs differ from the eager call's")
            for b, (g, w) in enumerate(zip(tables, want_tables)):
                _tables_equal(g, w, f"[graphs] {name}: pass {i + 1}, batch {b}")
        if c1 - c0 <= 0 or c2 != c1:
            raise AssertionError(f"[graphs] {name}: captures pass 1 {c1 - c0}, while "
                                 f"profiled {c2 - c1}, want > 0 and 0")
        if (graph_stats["graph_launch"], eager_stats["graph_launch"]) != (graph_stats["calls"], 0):
            raise AssertionError(f"[graphs] {name}: cudaGraphLaunch {graph_stats['graph_launch']} "
                                 f"for {graph_stats['calls']} device calls (eager "
                                 f"{eager_stats['graph_launch']})")
        instances = sum(c.instances(k) for c in caches for k in c.keys())
        n_keys = sum(len(c.keys()) for c in caches)
        del eng, caches, passes
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        freed_mib = (torch.cuda.memory_reserved() - base) / 2**20
        n_bufs = sum(len(w) for w in want)
        per = lambda st, k: st[k] / len(batches)  # noqa: E731
        log(f"[graphs] {name}: {len(batches)} batch(es) of {BATCH} reads, "
            f"{n_bufs} device-call buffers byte-equal to the eager call's on passes 1-3 "
            f"(3: {pipeline.DEFAULT_PIPELINE_DEPTH} worker threads), tables equal; "
            f"captures pass 1 "
            f"{c1 - c0}, pass 2 {c2 - c1}, pass 3 {c3 - c2}; pass 2: "
            f"cudaGraphLaunch {graph_stats['graph_launch']} for {graph_stats['calls']} "
            f"device calls (one a shard a call), a batch cudaLaunchKernel graphs "
            f"{per(graph_stats, 'launch_kernel'):.1f} / eager "
            f"{per(eager_stats, 'launch_kernel'):.1f}, kernels traced graphs "
            f"{graph_stats['kernels']} / eager {eager_stats['kernels']}; dispatch s "
            f"graphs {graph_stats['dispatch_s']:.4f} / eager {eager_stats['dispatch_s']:.4f}; "
            f"wall ms graphs {graph_stats['wall_ms']:.1f} / eager "
            f"{eager_stats['wall_ms']:.1f}; busy graphs "
            f"{100 * graph_stats['busy_ms'] / graph_stats['wall_ms']:.2f}% / eager "
            f"{100 * eager_stats['busy_ms'] / eager_stats['wall_ms']:.2f}% (one thread, "
            f"under the profiler); reserved memory +{one_mib:.0f} MiB after pass 1 "
            f"(one instance a key), +{full_mib:.0f} MiB with the cache full after "
            f"pass 3 ({instances} instance(s) of {n_keys} key(s)), +{freed_mib:.0f} MiB "
            f"once the engine is dropped ({smi})")
        if force:
            log(f"[graphs] {name}: the device calls' hit capacities "
                f"{graph_stats['caps']}: the forced {BATCH // 8}, then the retry's own")


# ------------------------------------------- upload, row buckets, stages


class KernelCalls:
    """Copies of the arguments of every kernel call the device calls
    make while installed, in order; the calls go on to the wrappers,
    which count their launches.  Calls inside a CUDA-graph capture are
    passed over, as :class:`MyersCapture` does."""

    def __init__(self):
        import threading

        from barbell_tpu_torch.ops import composite

        self.mod = composite
        self.orig = {n: getattr(composite, n) for n in KERNEL_SITES}
        self.lock = threading.Lock()
        self.calls = []

    def __enter__(self):
        for name, fn in self.orig.items():
            def call(*args, _name=name, _fn=fn):
                if torch.cuda.is_current_stream_capturing():
                    return _fn(*args)
                copy = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args)
                with self.lock:
                    self.calls.append((_name, copy))
                return _fn(*args)

            setattr(self.mod, name, call)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def _wrapper(name):
    from barbell_tpu_torch.ops import myers, rank, window

    return getattr({"myers_topk": myers, "rank_pass1": rank,
                    "rank_pass1_split": rank}.get(name, window), name)


def _plain_of(name, args):
    """The plain version's output for one captured call of ``name``, on
    the call's own (card) tensors."""
    from barbell_tpu_torch.ops import myers, rank, window

    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    if name == "myers_topk":
        return myers.myers_topk_plain(*args)
    if name == "window_valleys":
        pat, win, wl, le, rp, elo, ehi, alpha, k, klmul = args
        return window.window_plain(window.MODE_VALLEY, pat, win, i32(elo), i32(le),
                                   i32(rp), i32(ehi), i32(wl), alpha, 0, 0, k, klmul)
    if name == "window_trace":
        pat, win, ej, le, rp, alpha, ra, rb = args
        z = torch.zeros_like(ej, dtype=torch.int32)
        return tuple(window.window_plain(window.MODE_TRACE, pat, win, i32(ej), i32(le),
                                         i32(rp), z, z, alpha, ra, rb, 0, 0).unbind(1))
    if name == "window_interval":
        pats, win, ej, ia, ib = args
        z = torch.zeros_like(ej, dtype=torch.int32)
        return window.window_plain(window.MODE_INTERVAL, pats, win, i32(ej), z, z - 1,
                                   z, z, window.UNIT, ia, ib, 0, 0)
    return rank.rank_pass1_plain(*args[:3], args[3] if len(args) > 3 else 0)


def _captured_bound(name, args):
    """(bound_ms, bound_by) of one captured call, from its inputs (the
    cells its output needs, as the kernel phases count them)."""
    if name == "myers_topk":
        return _myers_bound(args, 36 * args[2].shape[0])
    pat, win, c = args[:3]
    H, W = win.shape
    m = pat.shape[-1]
    if name == "window_valleys":
        cols = int(torch.clamp(torch.minimum(c, args[6]), 0, W).sum())
        return _bound(m + H * W + 56 * H, cols * m * WINDOW_PER_CELL["valley"])
    if name in ("window_trace", "window_interval"):
        cols = int(torch.where((c >= 0) & (c <= W), c, 0).sum())
        if name == "window_trace":
            return _bound(m + H * W + 24 * H, cols * m * WINDOW_PER_CELL["trace"])
        return _bound(H * m + H * W + 28 * H, cols * m * WINDOW_PER_CELL["interval"])
    Pa = pat.shape[0]
    pe = Pa // 2 if name == "rank_pass1_split" else Pa
    cells = pe * m * int(c.clamp(0, W + W % 2).sum())
    return _bound(Pa * m + H * W + 4 * H + 8 * H * pe, cells * RANK_INT_PER_CELL,
                  cells * RANK_F32_PER_CELL)


def _batch_kernel_ms(calls, reps=10):
    """{kernel: device ms} of one batch's captured calls, each call's
    time from a CUDA-graph replay (:func:`_time`), summed by kernel."""
    out = {}
    for name, args in calls:
        fn = _wrapper(name)
        ms, _method = _time(lambda: fn(*args), reps)
        out[name] = out.get(name, 0.0) + ms
    return out


def _first_batches(ends_reads, whole_reads):
    """(path, engine factory, first batch, dispatch of the reference
    rule with the blob) of the ends, extended and whole-read paths."""
    from barbell_tpu_torch.models.pipeline import TorchDemuxEngine
    from barbell_tpu_torch.models.twotier import make_ends_engine
    from barbell_tpu_torch.stages.kit import kit_groups, kit_plan

    def batch(reads):
        return ([r for r, _s, _l in reads[:BATCH]], [s for _r, s, _l in reads[:BATCH]])

    return (
        ("ends", lambda **kw: make_ends_engine(kit_groups(KIT), kit_plan(KIT), device="cuda",
                                               **kw), batch(ends_reads)),
        ("extended", lambda **kw: TorchDemuxEngine(kit_groups(KIT, use_extended=True),
                                                   device="cuda", **kw), batch(ends_reads)),
        ("whole-read", lambda **kw: TorchDemuxEngine(kit_groups(KIT), device="cuda", **kw),
         batch(whole_reads)),
    )


def _h2d_issued_mode():
    """A dispatch mode that counts the copies torch issues: each
    ``_to_copy`` / ``copy_`` that reads a host tensor and writes one on
    the card (``n``), and each ``copy_`` from the card to the card
    (``d2d``: the copy of an upload into a CUDA graph's static input)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    copies = {torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default}

    class H2DIssued(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0
            self.d2d = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in copies:
                ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
                outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
                if (any(t.device.type == "cpu" for t in ins)
                        and any(t.device.type == "cuda" for t in outs)):
                    self.n += 1
                elif (func == torch.ops.aten.copy_.default
                      and all(t.device.type == "cuda" for t in ins)):
                    self.d2d += 1
            return out

    return H2DIssued()


def _h2d_copies(fn, tries: int = 3) -> tuple:
    """Host-to-device copies during one ``fn()``, counted twice: the ones
    torch issued (:func:`_h2d_issued_mode`) and the ``HtoD`` copy events
    the card ran (a torch.profiler trace); and the device-to-device
    copies torch issued with ``copy_`` and the ``DtoD`` events the card
    ran (the latter include copies inside a replayed graph).  A trace
    that holds no kernel and no device copy of the batch has lost its
    device records (CUPTI drops a session's records now and then), and
    so has one that holds no copy of a kind (``HtoD``, ``DtoD``) that
    torch issued: the run is made again, up to ``tries`` runs, and then
    the check fails.
    Returns (issued, ran, kernels traced, DtoD issued, DtoD ran)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with _h2d_issued_mode() as issued:
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        copies = [e.get("name", "") for e in events if e.get("cat") == "gpu_memcpy"]
        d2d = sum("DtoD" in c for c in copies)
        ran = sum("HtoD" in c for c in copies)
        if (kernels or d2d) and (ran or not issued.n) and (d2d or not issued.d2d):
            return issued.n, ran, kernels, issued.d2d, d2d
    seen = {}
    for e in events:
        if e.get("cat") != "kernel" and ("emcpy" in e.get("name", "")
                                         or e.get("cat", "").startswith("gpu")):
            k = (e.get("cat"), e.get("name"))
            seen[k] = seen.get(k, 0) + 1
    raise AssertionError(f"the profiler lost the batch's kernels or copies in {tries} "
                         f"runs: issued {issued.n} HtoD, {issued.d2d} DtoD; the last "
                         f"trace held {kernels} kernels and {seen}")


def check_upload(ends_reads, whole_reads, wrappers, smi) -> dict:
    """The one-blob upload against separate uploads on the first batch of
    the ends, extended and whole-read paths: equal tables, the
    reference's dispatch rule (the fused call only on the blob), the
    host-to-device copies a batch (profiler) and where the host waits
    for the card (sync debug mode).  Returns the launches of the blob
    runs."""
    for w in wrappers:
        w.launches = 0
    blob_launches = {}
    for name, make, batch in _first_batches(ends_reads, whole_reads):
        res = {}
        for mono in (True, False):
            eng = make(mono_upload=mono)
            tiers = _tiers(eng)
            before = {w.__name__: w.launches for w in wrappers}
            table = eng.demux_batch_table(*batch)
            torch.cuda.synchronize()
            if mono:
                for w in wrappers:
                    blob_launches[w.__name__] = (blob_launches.get(w.__name__, 0)
                                                 + w.launches - before[w.__name__])
            groups = len(tiers[0].plans)
            want = "single-fused" if mono and groups > 1 else "single"
            if eng.last_dispatch != want:
                raise AssertionError(f"[upload] {name}: dispatch {eng.last_dispatch}, "
                                     f"the reference's rule gives {want}")
            copies = _h2d_copies(lambda: eng.demux_batch_table(*batch))
            waits = _sync_points(eng, batch)
            ms = _wall_ms(lambda: eng.demux_batch_table(*batch))
            res[mono] = (table, eng.last_dispatch, copies, waits, ms)
        _tables_equal(res[True][0], res[False][0], f"[upload] {name}")
        (_t, d1, c1, w1, ms1), (_t2, d0, c0, w0, ms0) = res[True], res[False]
        if c1[:2] != (1, 1):
            raise AssertionError(f"[upload] {name}: host-to-device copies a batch on "
                                 f"the blob issued {c1[0]}, ran {c1[1]} ({c1[2]} kernels "
                                 f"traced), want 1 and 1")
        # under CUDA graphs each device call copies its upload into its
        # graph's static inputs: the blob once (one call of every
        # group), or each array once a group's call
        if (c1[3], c0[3]) != (1, c0[0] * groups):
            raise AssertionError(f"[upload] {name}: copies into static inputs a batch "
                                 f"blob {c1[3]}, separate {c0[3]}, want 1 and "
                                 f"{c0[0] * groups}")
        log(f"[upload] {name}: {len(batch[0])} reads, tables equal ({res[True][0].n_rows} "
            f"rows); dispatch blob {d1}, separate {d0}; host-to-device copies a batch "
            f"(issued, ran on the card) blob {c1[:2]}, separate {c0[:2]}; device-to-device "
            f"copies into the graphs' static inputs (issued; DtoD ran, graph copies "
            f"included) blob {c1[3]} ({c1[4]}), separate {c0[3]} ({c0[4]}); kernels traced "
            f"blob {c1[2]}, separate {c0[2]}; the host waits for the card at blob "
            f"{sum(w1.values())} {w1}, separate {sum(w0.values())} {w0}; wall ms a batch "
            f"blob {ms1:.1f}, separate {ms0:.1f} (smoke figure; {smi})")
    return blob_launches


def check_fine_rows(ends_reads, whole_reads, wrappers, smi, engine) -> tuple:
    """The first batches of the three paths with 1/8-octave row buckets
    against powers of two: equal tables, the padded rows and hit
    capacity a call both ways, each kernel's device ms a batch both ways
    (CUDA-graph replays of the batch's captured calls); the whole-read
    batch's fine-row calls each checked against its plain version on the
    card, timed and bounded (kernel entries).  Returns (the fine runs'
    launches by path, kernel entries)."""
    launches, entries = {}, []
    for name, make, batch in _first_batches(ends_reads, whole_reads):
        res = {}
        for fine in (False, True):
            eng = make(fine_rows=fine)
            for w in wrappers:
                w.launches = 0
            with BatchRecorder() as rec, KernelCalls() as cap:
                table = eng.demux_batch_table(*batch)
                torch.cuda.synchronize()
            if fine:
                launches[name] = {w.__name__: w.launches for w in wrappers}
            res[fine] = (table, rec.batches, cap.calls, _batch_kernel_ms(cap.calls))
        _tables_equal(res[True][0], res[False][0], f"[fine_rows] {name}")
        shapes = {f: [(b["R_total"], b["H_cap"]) for b in res[f][1]] for f in (False, True)}
        fmt = lambda d: ", ".join(f"{k} {v:.4f}" for k, v in sorted(d.items()))  # noqa: E731
        log(f"[fine_rows] {name}: tables equal ({res[True][0].n_rows} rows); (R_total, "
            f"H_cap) a call pow2 {shapes[False]}, fine {shapes[True]}; launches "
            f"{launches[name]}; kernel ms a batch pow2 {{{fmt(res[False][3])}}} = "
            f"{sum(res[False][3].values()):.4f}, fine {{{fmt(res[True][3])}}} = "
            f"{sum(res[True][3].values()):.4f} ({smi})")
        if name == "whole-read":
            entries += _captured_entries(engine, "fine-rows whole-read", SEED + 6,
                                         res[True][2], "captured, fine rows")
    return launches, entries


def _captured_entries(engine, path, seed, calls, what="captured") -> list:
    """Each captured kernel call (:class:`KernelCalls`) against its plain
    version on its own card tensors, timed (CUDA-graph replay) and
    bounded from its inputs: one kernel entry a call."""
    from barbell_tpu_torch.ops import rank, window

    kc = KernelCheck(engine, path, seed)
    for kname, args in calls:
        src, rep = KERNEL_SITES[kname]
        if kname == "myers_topk":
            ptx = (f"myers_kernelILi{args[0].shape[1]}ELb1EE",)
            shape = (f"rows [{args[2].shape[0]}, {args[2].shape[1]}], m = {args[1]}, "
                     f"{args[0].shape[1]} words")
        elif kname.startswith("rank"):
            H, W = args[1].shape
            ptx = _rank_ptxas(rank, args[0].shape[1], W + W % 2)
            shape = (f"[{H} lanes, {W}] x {args[0].shape[0]} patterns, "
                     f"m = {args[0].shape[1]}")
        else:
            mode = {"window_valleys": window.MODE_VALLEY,
                    "window_trace": window.MODE_TRACE}.get(kname, window.MODE_INTERVAL)
            H, W = args[1].shape
            ptx = _window_ptxas(window, mode, args[0].shape[-1], W)
            shape = f"[{H} lanes, {W}], m = {args[0].shape[-1]}"
        fn = _wrapper(kname)
        kc.record(kname, src, rep, f"{shape} ({what})",
                  lambda fn=fn, a=args: fn(*a), lambda n=kname, a=args: _plain_of(n, a),
                  _captured_bound(kname, args), ptx, reps=5)
    return kc.entries


def check_kit_kernels(engine, kit, reads, path) -> list:
    """Every kernel call of the first batch of ``kit``'s ends path
    (safe plan, eager), captured as the fused call made it, against its
    plain version on the card, timed and bounded (``path (captured)``
    entries): the Myers, window and rank instances of that kit's flank
    and barcode shapes."""
    from barbell_tpu_torch.models.twotier import make_ends_engine
    from barbell_tpu_torch.stages.kit import kit_groups, kit_plan

    eng = make_ends_engine(kit_groups(kit), kit_plan(kit), device="cuda")
    eng.cuda_graphs = False
    with KernelCalls() as cap:
        eng.demux_batch_table([r for r, _s, _l in reads[:BATCH]],
                              [s for _r, s, _l in reads[:BATCH]])
        torch.cuda.synchronize()
    return _captured_entries(engine, f"{path} (captured)", SEED + 7, cap.calls)


def check_pack1(ends_reads, whole_reads, wrappers) -> dict:
    """``BARBELL_PACK_MODE=1`` (padded 2-bit rows, uploaded metadata)
    against the default pack mode 2 on the first ends and whole-read
    batches: equal tables.  Returns the launches of the mode-1 runs."""
    launches = {w.__name__: 0 for w in wrappers}
    for name, make, batch in _first_batches(ends_reads, whole_reads):
        if name == "extended":
            continue
        want = make().demux_batch_table(*batch)
        os.environ["BARBELL_PACK_MODE"] = "1"
        try:
            before = {w.__name__: w.launches for w in wrappers}
            with CallSpy() as spy:
                got = make().demux_batch_table(*batch)
            torch.cuda.synchronize()
        finally:
            del os.environ["BARBELL_PACK_MODE"]
        for w in wrappers:
            launches[w.__name__] += w.launches - before[w.__name__]
        if set(spy.calls) != {(1, "wire")}:
            raise AssertionError(f"[pack1] {name}: fused calls {spy.calls}")
        _tables_equal(got, want, f"[pack1] {name}")
        log(f"[pack1] {name}: BARBELL_PACK_MODE=1, calls {sorted(set(spy.calls))}: "
            f"table = pack mode 2's ({want.n_rows} rows)")
    return launches


#: hit lanes of a full ends-path batch (its H_cap)
H_ENDS = 2816


def _require(launches, names, what):
    """Raises unless each kernel in ``names`` launched in the run."""
    missing = [n for n in names if launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels {missing} never launched")


def _leaves(out) -> list:
    """The tensors of a compiled function's output, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in (out or ()) for t in _leaves(o)]


@contextlib.contextmanager
def _as_written():
    """Compiled functions called inside run as written, as they do inside
    another compiled call: ``fn.__wrapped__`` with its nested compiled
    calls eager too."""
    from barbell_tpu_torch.models import graphs

    graphs._inline.depth = getattr(graphs._inline, "depth", 0) + 1
    try:
        yield
    finally:
        graphs._inline.depth -= 1


def _runtime_of(fn) -> tuple:
    """(result, {CUDA runtime call: count}) of one call of ``fn`` under
    torch.profiler (host-side API calls; no device record needed)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    calls = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and e.get("ph") == "X":
            name = e["name"].split("_v")[0]
            calls[name] = calls.get(name, 0) + 1
    return out, calls


def _wall_ms_per_call(fn, reps: int) -> float:
    """Host ms per call of ``fn`` over ``reps`` calls, the device drained
    before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000 / reps


def check_stage_ops(ends_reads, wrappers, smi) -> dict:
    """The compiled device functions on the card at the ends shapes (the
    first ends batch's shallow-tier rows, nibble-packed): the staged
    composites ``flank_scan`` over its rows and rc twins, ``flank_trace``
    over its hits, ``barcode_rank`` over each hit's mask region widened
    by the padding, their ``_reference`` variants, the six stage
    functions of ``ops/device.py`` at the shapes the references give
    them, and ``sharded_flank_step(["cuda:0"] * 2)`` over the scan rows.
    Each compiled function is called twice with one key: a capture, then
    a replay, which must make no ``cudaLaunchKernel`` and one
    ``cudaGraphLaunch`` (one a shard for the flank step; the shards'
    count sum is outside the graphs); both results, ``fn.__wrapped__``
    on the card and the CPU route (the kernels' plain versions) are
    byte-equal, and the traces and ranks equal their references where
    the lane is valid.  Prints, for each, the eager call's
    ``cudaLaunchKernel`` calls and ms, the replay's ``cudaGraphLaunch``
    calls and ms, the capture ms and the reserved MiB, beside the card.
    Returns the kernels' launches in the card calls."""
    from barbell_tpu_torch import PADDING
    from barbell_tpu_torch.models import graphs
    from barbell_tpu_torch.models.pipeline import TorchDemuxEngine
    from barbell_tpu_torch.ops import composite as comp
    from barbell_tpu_torch.ops import device as dev_ops
    from barbell_tpu_torch.ops.oracle import COST_SCALE
    from barbell_tpu_torch.parallel import mesh
    from barbell_tpu_torch.stages.kit import kit_groups

    eng = TorchDemuxEngine(kit_groups(KIT), ends_window=(512, 512), device="cuda")
    gp = eng.plans[0]
    lens = np.array([len(s) for _r, s, _l in ends_reads[:BATCH]], dtype=np.int64)
    seqs = [s for _r, s, _l in ends_reads[:BATCH]]
    L = eng._choose_L(lens)
    step = L - PADDING - eng.halo
    plan = eng._plan(lens, L, step)
    R_host, S_pad = plan.R_host, plan.F
    mat = eng._materialize(plan, seqs, lens, L, R_host, S_pad, force_nibble=True)
    meta = mat.meta
    m, k, K = gp.m, gp.k_units, eng.K
    dev, cpu = eng.device, torch.device("cpu")
    tsc, tec = meta[:, comp.M_TSC], meta[:, comp.M_TEC]
    ts, te = meta[:, comp.M_TSTART] != 0, meta[:, comp.M_TEND] != 0
    lo, hi = meta[:, comp.M_LO], meta[:, comp.M_HI]
    cols = dict(start_col=np.where(ts, tsc, -1), end_col=np.where(te, tec, L + 2),
                lo=lo, hi=hi, emit_lo=np.where(ts, tsc + m + k + 2, lo),
                emit_hi=np.where(te, np.minimum(hi, tec - 2), hi))

    def on(d, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)

    launches = {w.__name__: 0 for w in wrappers}
    capture_ms = []
    cache = graphs.COMPILED
    capture = cache._capture

    def timed_capture(fn, inputs, device):
        t0 = time.perf_counter()
        out = capture(fn, inputs, device)
        torch.cuda.synchronize()
        capture_ms.append((time.perf_counter() - t0) * 1000)
        return out

    cache._capture = timed_capture
    cache.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mib = 2.0 ** 20
    reserved0 = torch.cuda.memory_reserved() / mib
    names = []

    def run(what, fn, card, host, kw, graph_launches=1, ref=None, valid=None):
        """Capture, replay, eager and CPU route of ``fn`` (card and host
        argument lists; one key, so the first call captures one graph and
        a second call replays it ``graph_launches`` times, each launch
        beyond the first a shard's and one more kernel, the shards'
        sum); returns the card result."""
        before = {w.__name__: w.launches for w in wrappers}
        n_caps = len(capture_ms)
        first = fn(*card, **kw)
        torch.cuda.synchronize()
        used = {w.__name__: w.launches - before[w.__name__] for w in wrappers
                if w.launches > before[w.__name__]}
        for n, c in used.items():
            launches[n] += c
        if len(capture_ms) != n_caps + 1:
            raise AssertionError(f"[stage_ops] {what}: {len(capture_ms) - n_caps} "
                                 f"captures on the first call, want 1")
        cap_ms = sum(capture_ms[n_caps:])
        reserved = torch.cuda.memory_reserved() / mib
        replays = cache.replays
        second, rt = _runtime_of(lambda: fn(*card, **kw))
        if (rt.get("cudaLaunchKernel", 0) != graph_launches - 1
                or rt.get("cudaGraphLaunch", 0) != graph_launches
                or cache.replays - replays != graph_launches):
            raise AssertionError(f"[stage_ops] {what}: the replay made {rt}, "
                                 f"{cache.replays - replays} replays")
        with _as_written():
            eager, rt_eager = _runtime_of(lambda: fn(*card, **kw))
            eager_ms = _wall_ms_per_call(lambda: fn(*card, **kw), 3)
        replay_ms = _wall_ms_per_call(lambda: fn(*card, **kw), 10)
        t0 = time.perf_counter()
        want = fn(*host, **kw)
        t_cpu = time.perf_counter() - t0
        got = [t.cpu() for t in _leaves(first)]
        for other, name in ((second, "replay"), (eager, "__wrapped__"),
                            (want, "CPU route")):
            try:
                _diff(got, [t.cpu() for t in _leaves(other)])
            except AssertionError as exc:
                raise AssertionError(f"[stage_ops] {what}: capture vs {name}: {exc}")
        extra = ""
        if ref is not None:
            _diff((first[valid],), (ref[valid],))
            extra = f"; = its _reference on {int(valid.sum())} valid lanes"
        log(f"[stage_ops] {what}: capture = replay = __wrapped__ = CPU route "
            f"({t_cpu:.1f}s on the CPU){extra}; launches {used}")
        log(f"[stage_ops] {what}: eager {rt_eager.get('cudaLaunchKernel', 0)} "
            f"cudaLaunchKernel, {eager_ms:.3f} ms a call; replay "
            f"{rt.get('cudaGraphLaunch', 0)} cudaGraphLaunch, "
            f"{rt.get('cudaLaunchKernel', 0)} cudaLaunchKernel, {replay_ms:.3f} ms a "
            f"call; capture {cap_ms:.1f} ms; reserved {reserved:.0f} MiB "
            f"(+{reserved - reserved0:.0f} since the phase began); {smi}")
        names.append(what.split(" ")[0])
        return first

    alpha = eng.alpha_scaled
    args = {d: [gp.tensors.flank.to(d), gp.tensors.patw.to(d), on(d, mat.host_packed),
                on(d, mat.simple_idx[:S_pad]), *(on(d, cols[c]) for c in cols), alpha]
            for d in (dev, cpu)}
    scan = run(f"flank_scan rows [{R_host} + {S_pad} rc twins, {L}] (nibble-packed), "
               f"K = {K}", comp.flank_scan, args[dev], args[cpu],
               dict(K=K, m=m, k_units=k))
    rows = scan.rows
    rows_on = {dev: rows, cpu: rows.cpu()}
    pos, cost, valid, _count = (x.cpu().numpy()
                                for x in comp.unpack_flank_scan(scan.packed, K))
    # the first hits, as many as a full ends batch's lanes
    hrow, slot = (a[:H_ENDS] for a in np.nonzero(valid))
    hcol = pos[hrow, slot]
    Wf = gp.span
    s_col = np.maximum(tsc[hrow], hcol - Wf)
    end_j = (hcol - s_col).astype(np.int32)
    ledge = (ts[hrow] & (s_col == tsc[hrow])).astype(np.int32)
    rpos = np.where(te[hrow] & (hcol == tec[hrow]), end_j, -1).astype(np.int32)
    hv = np.ones(len(hrow), dtype=bool)
    tr_np = (hrow.astype(np.int32), s_col.astype(np.int32), ledge, rpos, end_j, hv)
    ra, rb = gp.mask_start, gp.mask_end
    tr_args = {d: [gp.tensors.flank.to(d), rows_on[d], *(on(d, a) for a in tr_np),
                   ra, rb, alpha] for d in (dev, cpu)}
    fkw = dict(m=m, W=Wf)
    tr_ref = run(f"flank_trace_reference [{len(hrow)} lanes, {Wf}]",
                 comp.flank_trace_reference, tr_args[dev], tr_args[cpu], fkw)
    tr = run(f"flank_trace [{len(hrow)} lanes, {Wf}]", comp.flank_trace, tr_args[dev],
             tr_args[cpu], fkw, ref=tr_ref, valid=torch.from_numpy(hv).to(dev))
    tr = tr.cpu().numpy()
    Wb = gp.barcode_window
    has = tr[:, 3] != 0
    b_start = np.maximum(0, s_col + tr[:, 1] - PADDING).astype(np.int32)
    b_len = np.where(has, np.minimum(Wb, tr[:, 2] - tr[:, 1] + 1 + 2 * PADDING), 0)
    b_len = b_len.astype(np.int32)
    P = gp.n_patterns
    pats = gp.tensors.patterns_all[:P]
    scal = (gp.k1_scaled, gp.rel_bar_start, gp.rel_bar_end,
            float(np.float32(gp.perfect)), float(np.float32(eng.min_score)),
            float(np.float32(eng.min_score_diff)))
    br_np = (hrow.astype(np.int32), b_start, b_len, has)
    br_args = {d: [pats.to(d), rows_on[d], *(on(d, a) for a in br_np), *scal]
               for d in (dev, cpu)}
    bkw = dict(m=gp.plen, W=Wb)
    br_ref = run(f"barcode_rank_reference [{len(hrow)} lanes, {Wb}] x {P} patterns",
                 comp.barcode_rank_reference, br_args[dev], br_args[cpu], bkw)
    br = run(f"barcode_rank [{len(hrow)} lanes, {Wb}] x {P} patterns", comp.barcode_rank,
             br_args[dev], br_args[cpu], bkw, ref=br_ref,
             valid=torch.from_numpy(has).to(dev))
    log(f"[stage_ops] barcode_rank: {int(br[:, 1].sum())} of {int(has.sum())} lanes with "
        f"a region accepted")

    # the stage functions at the shapes barcode_rank_reference gives them
    H = len(hrow)
    wins = {d: comp._masked_windows(rows_on[d], on(d, br_np[0]), on(d, b_start),
                                    on(d, b_len), Wb) for d in (dev, cpu)}
    no_edge = {d: torch.zeros(H, dtype=torch.bool, device=d) for d in (dev, cpu)}
    no_right = {d: torch.full((H,), -1, dtype=torch.int32, device=d) for d in (dev, cpu)}
    dp_args = {d: [pats.to(d), wins[d], no_edge[d], no_right[d], COST_SCALE]
               for d in (dev, cpu)}
    bdp = run(f"window_dp [{H} lanes, {Wb}] x {P} patterns, m = {gp.plen}",
              dev_ops.window_dp, dp_args[dev], dp_args[cpu], {})
    best_args = {d: [bdp.ends.to(d), on(d, b_len)] for d in (dev, cpu)}
    best = run(f"best_valley_per_pattern [{H}, {P}, {Wb + 1}]",
               dev_ops.best_valley_per_pattern, best_args[dev], best_args[cpu], {})
    in_k1 = best.cost <= gp.k1_scaled
    cand = ((in_k1.sum(dim=1) <= 1)[:, None] | in_k1) & torch.from_numpy(has).to(dev)[:, None]
    tb_args = {d: [bdp.moves.to(d), best.pos.to(d), cand.to(d), 0, -1, scal[1], scal[2]]
               for d in (dev, cpu)}
    run(f"traceback_reduce [{gp.plen}, {H}, {P}, {Wb + 1}] moves",
        dev_ops.traceback_reduce, tb_args[dev], tb_args[cpu], dict(m=gp.plen, W=Wb))
    sum_args = {d: [pats[None].to(d), wins[d], no_edge[d], no_right[d], COST_SCALE, 0, -1,
                    scal[1], scal[2]] for d in (dev, cpu)}
    run(f"window_dp_summary [{H} lanes, {Wb}] x {P} patterns, with_lodhi",
        dev_ops.window_dp_summary, sum_args[dev], sum_args[cpu], dict(with_lodhi=True))

    # the flank stages over the scan rows, alone and as the mesh's step
    R = rows.shape[0]
    row_cols = [cols[c] for c in ("start_col", "end_col", "lo", "hi")]
    fe_args = {d: [gp.tensors.flank.to(d), rows_on[d], *(on(d, a) for a in row_cols[:2]),
                   alpha] for d in (dev, cpu)}
    ends = run(f"flank_ends rows [{R}, {L}], m = {m}", dev_ops.flank_ends,
               fe_args[dev], fe_args[cpu], {})
    k_scaled = k * COST_SCALE
    fh_args = {d: [ends.to(d), *(on(d, a) for a in row_cols[2:]), k_scaled]
               for d in (dev, cpu)}
    run(f"find_hits [{R}, {L + 1}], K = {K}", dev_ops.find_hits, fh_args[dev],
        fh_args[cpu], dict(K=K))
    devices = [dev] * 2
    step = mesh.sharded_flank_step(devices, K=K)
    step_cpu = mesh.sharded_flank_step([cpu] * 2, K=K)
    st_args = {d: [gp.tensors.flank.to(d), *mesh.shard_rows([d] * 2, rows_on[d].cpu(),
                                                             *row_cols),
                   k_scaled, alpha] for d in (dev, cpu)}

    def flank_step(*a):
        hits, found = (step if a[1][0].is_cuda else step_cpu)(*a)
        return tuple(hits) + (found,)

    flank_step.__name__ = "sharded_flank_step"
    run(f"sharded_flank_step(['cuda:0'] * 2) rows 2 x [{R // 2}, {L}]", flank_step,
        st_args[dev], st_args[cpu], {}, graph_launches=2)
    cache.clear()
    cache._capture = capture
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[stage_ops] {len(names)} compiled functions, each captured once and "
        f"replayed; reserved {torch.cuda.memory_reserved() / mib:.0f} MiB after dropping "
        f"the cache, {torch.cuda.memory_allocated() / mib:.0f} MiB of it the phase's live "
        f"results (was {reserved0:.0f} MiB when the phase began)")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="run the probe and the kernel phases only (the "
                         "whole-read shapes as a full run records them), "
                         "and time every rank and window instance and "
                         "every Myers segment count at each path shape")
    ap.add_argument("--package", metavar="DIR",
                    help="import barbell_tpu_torch from DIR (another checkout)")
    opts = ap.parse_args()
    if opts.package:
        sys.path.insert(0, os.path.abspath(opts.package))
    t_start = time.perf_counter()
    smi = probe()
    from barbell_tpu_torch.ops import myers, rank, window
    from barbell_tpu_torch.sim import make_reads_kit, make_reads_rbk, write_fastq
    from barbell_tpu_torch.stages.kit import kit_groups, kit_plan

    t0 = time.perf_counter()
    engine = _flagship_engine()
    log(f"engine set up in {time.perf_counter() - t0:.1f}s (builds the native "
        f"IO library on first use)")
    with timed("ends kernels"):
        kernels = check_ends_kernels(engine, sweep=opts.kernels_only)
    t0 = time.perf_counter()
    n_edge = check_edge_kernels(engine.alpha_scaled)
    log(f"{n_edge} edge cases equal to their plain versions in "
        f"{time.perf_counter() - t0:.1f}s")
    if opts.kernels_only:
        kernels += check_batch_kernels(engine, WHOLE_READ_BATCHES, "whole-read",
                                       SEED + 2, sweep=True)
        kernels += check_batch_kernels(engine, EXTENDED_BATCHES, "extended",
                                       SEED + 3, sweep=True,
                                       gp=_extended_engine().plans[1])
        print(json.dumps({"kernels": kernels}))
        print(smi)
        return 0

    wrappers = [myers.myers_topk, myers.myers_valleys, window.window_valleys,
                window.window_trace, window.window_interval,
                rank.rank_pass1_split, rank.rank_pass1]
    on_path = ["myers_topk", "window_valleys", "window_trace",
               "window_interval", "rank_pass1_split"]
    by_path = {}
    whole_batches = []
    captured = {}
    spawn = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d, \
            ProcessPoolExecutor(WORKERS, mp_context=spawn) as pool:
        # the oracle backend's runs of each path's first reads go to the
        # worker processes alongside the simulation (the first reads of
        # a set do not depend on its size)
        t0 = time.perf_counter()
        kits = sorted({kit for kit, _maximize in KIT_PATHS.values()})
        sub_reads = {"ends": make_reads_rbk(ORACLE_READS, SEED),
                     "whole": make_reads_rbk(ORACLE_READS, SEED,
                                             long_every=LONG_EVERY),
                     **{kit: make_reads_kit(kit, ORACLE_READS, SEED) for kit in kits}}
        set_of = {"kit": "ends", "kit_extended": "ends", "annotate": "whole",
                  "kit_full_scan": "whole",
                  **{name: kit for name, (kit, _m) in KIT_PATHS.items()}}
        oracle_jobs = {}
        for name in PATHS:
            write_fastq(os.path.join(d, f"{name}_sub.fastq"), sub_reads[set_of[name]])
            oracle_jobs[name] = pool.submit(_oracle_run, name, d)
        fq_ends = os.path.join(d, "ends.fastq")
        fq_whole = os.path.join(d, "whole.fastq")
        fq_kit = {kit: os.path.join(d, f"{kit}.fastq") for kit in kits}
        ends_job = pool.submit(_simulate, N_ENDS, 0, fq_ends)
        kit_jobs = {kit: pool.submit(_simulate_kit, kit, N_KIT, fq_kit[kit]) for kit in kits}
        kits_jobs = submit_kits(d, pool)
        whole_reads = _simulate(N_WHOLE, LONG_EVERY, fq_whole)
        ends_reads = ends_job.result()
        kit_reads = {kit: job.result() for kit, job in kit_jobs.items()}
        for key, reads in (("ends", ends_reads), ("whole", whole_reads), *kit_reads.items()):
            if reads[:ORACLE_READS] != sub_reads[key]:
                raise AssertionError(f"the {key} set's first reads differ")
        n_long = sum(len(s) > 8192 for _r, s, _l in whole_reads)
        log(f"simulated {len(ends_reads)} + {len(whole_reads)} + "
            f"{' + '.join(str(len(r)) for r in kit_reads.values())} reads "
            f"({n_long} longer than 8192 bases; {', '.join(kits)}) in "
            f"{time.perf_counter() - t0:.1f}s")

        with timed("kit path"):
            by_path["kit"], _, captured["ends (captured)"] = run_path(
                "kit", fq_ends, d, ends_reads, wrappers, on_path, smi)
            oracle_parity("kit", ends_reads, d, oracle_jobs["kit"])
        with timed("kit_extended path"):
            by_path["kit_extended"], ext_batches, captured["extended (captured)"] = \
                run_path("kit_extended", fq_ends, d, ends_reads, wrappers,
                         on_path, smi)
            check_launches("kit_extended", ext_batches, by_path["kit_extended"], 2)
            oracle_parity("kit_extended", ends_reads, d, oracle_jobs["kit_extended"])
            check_misassigned(ends_reads, d)
        with timed("fused"):
            check_fused(ends_reads, wrappers, smi, pool)
        with timed("host forms"):
            check_host_forms(ends_reads, wrappers, pool)
        fq_batch = os.path.join(d, "ends_batch.fastq")
        write_fastq(fq_batch, ends_reads[:BATCH])
        with timed("staged"):
            check_staged(fq_batch, d)
        with timed("compare"):
            check_compare(d, wrappers)
        for name in ("annotate", "kit_full_scan"):
            with timed(f"{name} path"):
                by_path[name], batches, args = run_path(
                    name, fq_whole, d, whole_reads, wrappers,
                    on_path + ["rank_pass1"], smi)
                if name == "annotate":
                    captured["whole-read (captured)"] = args
                whole_batches += batches
                oracle_parity(name, whole_reads, d, oracle_jobs[name])
        with timed("mesh"):
            check_mesh(ends_reads, whole_reads, wrappers, smi)
        with timed("shard"):
            check_shard(fq_whole, d, smi)
        with timed("profile"):
            check_profile(fq_ends, fq_whole, d, wrappers, smi, [
                ([r for r, _s, _l in reads[:BATCH]], [s for _r, s, _l in reads[:BATCH]])
                for reads in (ends_reads, whole_reads)])
        with timed("graphs"):
            check_graphs(ends_reads, whole_reads, smi)
        with timed("upload"):
            by_path["upload"] = check_upload(ends_reads, whole_reads, wrappers, smi)
            _require(by_path["upload"], on_path, "[upload]")
        with timed("fine_rows"):
            fine, entries = check_fine_rows(ends_reads, whole_reads, wrappers, smi, engine)
            for name, got in fine.items():
                _require(got, on_path[:4], f"[fine_rows] {name}")
                _require({"rank": got["rank_pass1_split"] + got["rank_pass1"]},
                         ["rank"], f"[fine_rows] {name}")
            by_path["fine_rows (whole-read)"] = fine["whole-read"]
            kernels += entries
        with timed("pack1"):
            by_path["pack1"] = check_pack1(ends_reads, whole_reads, wrappers)
            _require(by_path["pack1"], on_path, "[pack1]")
        with timed("stage_ops"):
            by_path["stage_ops"] = check_stage_ops(ends_reads, wrappers, smi)
            _require(by_path["stage_ops"], on_path[:4] + ["rank_pass1"], "[stage_ops]")
        # the phases of the kits beyond the rapid kit come last: run
        # before [upload], they left its profiler traces without their
        # host-to-device copy records
        for name, (kit, maximize) in KIT_PATHS.items():
            with timed(f"{name} path"):
                by_path[name], batches, _args = run_path(
                    name, fq_kit[kit], d, kit_reads[kit], wrappers, on_path, smi)
                check_launches(name, batches, by_path[name], len(kit_groups(kit)))
                check_kit_path(name, kit_plan(kit, maximize), batches)
                oracle_parity(name, kit_reads[kit], d, oracle_jobs[name])
        with timed("kits"):
            by_path["kits"] = check_kits(kits_jobs, d, wrappers, on_path, smi)
        with timed("mesh steps"):
            by_path["mesh steps"] = check_mesh_steps(ends_reads, kit_reads["EXP-PBC096"],
                                                     wrappers, smi)
            _require(by_path["mesh steps"], on_path, "[mesh] steps")
        with timed("graphs (kit paths)"):
            check_graphs(ends_reads, whole_reads, smi, kit_reads)

    with timed("whole-read kernels"):
        kernels += check_batch_kernels(engine, whole_batches, "whole-read", SEED + 2)
    with timed("extended kernels"):
        kernels += check_batch_kernels(engine, ext_batches, "extended", SEED + 3,
                                       gp=_extended_engine().plans[1])
    with timed("kit kernels"):
        for name in ("kit_nbd", "kit_pcr"):
            kit = KIT_PATHS[name][0]
            kernels += check_kit_kernels(engine, kit, kit_reads[kit], name)
    with timed("captured Myers"):
        for path, args in captured.items():
            R, L = args[2].shape
            kc = KernelCheck(engine, path, SEED + 4)
            kc.myers_topk(args, f"rows [{R}, {L}], m = {args[1]}, captured",
                          sweep=True)["inputs"] = "captured"
            kernels += kc.entries
    path_runs = {"ends": ("kit",), "whole-read": ("annotate", "kit_full_scan"),
                 "extended": ("kit_extended",),
                 "fine-rows whole-read": ("fine_rows (whole-read)",),
                 "kit_nbd": ("kit_nbd", "kit_nbd_max"),
                 "kit_pcr": ("kit_pcr", "kit_pcr_max")}
    for entry in kernels:
        n = entry["name"]
        entry["launches_by_path"] = {p: c[n] for p, c in by_path.items()}
        runs = path_runs[entry["path"].split(" (")[0]]
        entry["launches"] = sum(by_path[r][n] for r in runs)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
