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
   on-path kernel launched once per group per call;
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
7. kernels at the whole-read paths' and the extended path's shapes,
   recorded from their batches (the extended ones with the fusion
   template's flank and patterns), and the Myers kernel on the
   arguments of one full batch of the ends path, the extended path and
   ``annotate``, captured as the path passed them ("captured" entries,
   with every segment count S timed there too).

The simulated reads and the scalar Demuxer's rows come from up to 8
spawned worker processes; the ends and whole-read sets are simulated
side by side.

Every path runs with each kernel's launch count set to 0 just before it
and read just after; every kernel of the path must have launched.
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
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
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
            "myers_topk", MYERS_SRC, MYERS_REP + " (top-K mode, via :318)", shape,
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
            "window_valleys", "barbell_tpu_torch/csrc/window.cu",
            "barbell_tpu/ops/pallas_window.py:51 (MODE_VALLEY, via :357)",
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
            "window_trace", "barbell_tpu_torch/csrc/window.cu",
            "barbell_tpu/ops/pallas_window.py:51 (MODE_TRACE, via :402)",
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
            "window_interval", "barbell_tpu_torch/csrc/window.cu",
            "barbell_tpu/ops/pallas_window.py:51 (MODE_INTERVAL, via :434)",
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
        src, rep = "barbell_tpu_torch/csrc/rank.cu", "barbell_tpu/ops/pallas_rank.py:55"
        if split:
            self.record(
                "rank_pass1_split", src, rep + " (strand-split, via :223)",
                f"[{H} lanes, {Wbc}] x {pe} patterns, m = {m}",
                lambda: rank.rank_pass1_split(pats, bwin_t, b_len_t, H // 2),
                lambda: rank.rank_pass1_plain(pats, bwin_t, b_len_t, split=H // 2),
                bound, ptx, plan=(rank, "rank_kernelI", m),
            )
        else:
            self.record(
                "rank_pass1", src, rep + " (non-split, via :266)",
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
    group count and the engine's dispatch (the engine's ``_call``, which
    runs one group or, fused, every group of a batch) while installed."""

    def __init__(self):
        from barbell_tpu_torch.models.pipeline import TorchDemuxEngine

        self.cls = TorchDemuxEngine
        self.orig = TorchDemuxEngine._call
        self.batches = []

    def __enter__(self):
        orig, batches = self.orig, self.batches

        def call(eng, gplans, batch, H_cap):
            batches.append({"L": batch.L, "R_total": batch.R_total,
                            "H_cap": H_cap, "groups": len(gplans),
                            "dispatch": eng.last_dispatch})
            return orig(eng, gplans, batch, H_cap)

        self.cls._call = call
        return self

    def __exit__(self, *exc):
        self.cls._call = self.orig


class MyersCapture:
    """Keeps a copy of the arguments of the largest ``myers_topk`` call
    (one full batch's) that the fused device call makes while installed;
    the call itself goes on to the wrapper, which counts its launch."""

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


def _kit(fq, out, backend, full_scan=False, **config):
    from barbell_tpu_torch.stages.kit import KitRunConfig, demux_using_kit

    demux_using_kit(
        [fq],
        KitRunConfig(kit_name=KIT, output_folder=out, batch_size=BATCH,
                     backend=backend, full_scan=full_scan, **config),
        device="cuda",
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
         "kit_full_scan": _kit_full}


def _oracle_run(name, d):
    """Path ``name`` on the scalar oracle backend over its first
    ORACLE_READS reads (``{name}_sub.fastq``; in a worker process);
    returns its seconds."""
    with _quiet(d, f"{name}_sub_oracle"):
        t0 = time.perf_counter()
        PATHS[name](os.path.join(d, f"{name}_sub.fastq"),
                    os.path.join(d, f"{name}_sub_oracle"), "oracle")
        return time.perf_counter() - t0


def oracle_parity(name, reads, d, oracle_job):
    """The path's files on the first ORACLE_READS reads equal the scalar
    oracle backend's byte for byte (``oracle_job``: the oracle's run on
    them, :func:`_oracle_run`)."""
    a_dir, b_dir = os.path.join(d, f"{name}_sub_torch"), os.path.join(d, f"{name}_sub_oracle")
    with _quiet(d, f"{name}_sub"):
        PATHS[name](os.path.join(d, f"{name}_sub.fastq"), a_dir, "torch")
    t_oracle = oracle_job.result()
    a, b = _files(a_dir), _files(b_dir)
    if sorted(a) != sorted(b):
        raise AssertionError(f"{name}: stage files differ: {sorted(a)} vs {sorted(b)}")
    for f in a:
        if a[f] != b[f]:
            raise AssertionError(f"{name}: {f} differs from the oracle backend")
    n_long = sum(len(s) > 8192 for _r, s, _l in reads[:ORACLE_READS])
    log(f"[{name}] oracle parity: {len(a)} files byte-identical on "
        f"{ORACLE_READS} reads ({n_long} longer than 8192 bases; oracle "
        f"{t_oracle:.1f}s in a worker process)")


def check_extended_launches(batches, launches):
    """The extended path's calls: every batch is one fused call of both
    groups (``single-fused``), any other call is one group's overflow
    retry, and each on-path kernel launched once per group per call."""
    fused = [b for b in batches if b["groups"] == 2]
    if not fused or any(b["dispatch"] != "single-fused" for b in fused):
        raise AssertionError("kit_extended: a batch was not one fused call")
    if any(b["groups"] != 1 for b in batches if b not in fused):
        raise AssertionError("kit_extended: a retry call ran more than one group")
    per_call = sum(b["groups"] for b in batches)
    split = sum(b["groups"] for b in batches if b["H_cap"] % 256 == 0)
    want = {"myers_topk": per_call, "window_valleys": per_call,
            "window_trace": per_call, "window_interval": per_call,
            "rank_pass1_split": split, "rank_pass1": per_call - split}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"kit_extended launches {got}, want {want}")
    log(f"[kit_extended] {len(fused)} batches, each one fused call of 2 "
        f"groups, {len(batches) - len(fused)} retry call(s): every on-path "
        f"kernel launched 2 x per batch plus retries ({want})")


class CallSpy:
    """Records the pack mode and metadata layout of every fused device
    call (``composite.demux_call_fused``) while installed."""

    def __init__(self):
        from barbell_tpu_torch.ops import composite

        self.mod = composite
        self.orig = composite.demux_call_fused
        self.calls = []

    def __enter__(self):
        orig, calls = self.orig, self.calls

        def call(groups, parts, **kw):
            calls.append((kw["pack_mode"], "desc" if "rowdesc" in parts else "wire"))
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
        tiers = [getattr(eng, t) for t in ("shallow", "deep") if hasattr(eng, t)] or [eng]
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
    from barbell_tpu_torch.sim import make_reads_rbk, write_fastq

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
        sub_reads = {"ends": make_reads_rbk(ORACLE_READS, SEED),
                     "whole": make_reads_rbk(ORACLE_READS, SEED,
                                             long_every=LONG_EVERY)}
        oracle_jobs = {}
        for name in PATHS:
            key = "ends" if name in ("kit", "kit_extended") else "whole"
            write_fastq(os.path.join(d, f"{name}_sub.fastq"), sub_reads[key])
            oracle_jobs[name] = pool.submit(_oracle_run, name, d)
        fq_ends = os.path.join(d, "ends.fastq")
        fq_whole = os.path.join(d, "whole.fastq")
        ends_job = pool.submit(_simulate, N_ENDS, 0, fq_ends)
        whole_reads = _simulate(N_WHOLE, LONG_EVERY, fq_whole)
        ends_reads = ends_job.result()
        for key, reads in (("ends", ends_reads), ("whole", whole_reads)):
            if reads[:ORACLE_READS] != sub_reads[key]:
                raise AssertionError(f"the {key} set's first reads differ")
        n_long = sum(len(s) > 8192 for _r, s, _l in whole_reads)
        log(f"simulated {len(ends_reads)} + {len(whole_reads)} reads "
            f"({n_long} longer than 8192 bases) in "
            f"{time.perf_counter() - t0:.1f}s")

        with timed("kit path"):
            by_path["kit"], _, captured["ends (captured)"] = run_path(
                "kit", fq_ends, d, ends_reads, wrappers, on_path, smi)
            oracle_parity("kit", ends_reads, d, oracle_jobs["kit"])
        with timed("kit_extended path"):
            by_path["kit_extended"], ext_batches, captured["extended (captured)"] = \
                run_path("kit_extended", fq_ends, d, ends_reads, wrappers,
                         on_path, smi)
            check_extended_launches(ext_batches, by_path["kit_extended"])
            oracle_parity("kit_extended", ends_reads, d, oracle_jobs["kit_extended"])
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

    with timed("whole-read kernels"):
        kernels += check_batch_kernels(engine, whole_batches, "whole-read", SEED + 2)
    with timed("extended kernels"):
        kernels += check_batch_kernels(engine, ext_batches, "extended", SEED + 3,
                                       gp=_extended_engine().plans[1])
    with timed("captured Myers"):
        for path, args in captured.items():
            R, L = args[2].shape
            kc = KernelCheck(engine, path, SEED + 4)
            kc.myers_topk(args, f"rows [{R}, {L}], m = {args[1]}, captured",
                          sweep=True)["inputs"] = "captured"
            kernels += kc.entries
    path_runs = {"ends": ("kit",), "whole-read": ("annotate", "kit_full_scan"),
                 "extended": ("kit_extended",)}
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
