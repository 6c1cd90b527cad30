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
   0``, ``right_pos`` at 1 and at W, partial blocks, both rank forms);
3. the ends path — 16384 simulated SQK-RBK114-96 reads through the
   port's ``demux_using_kit`` (two-tier ends scan) in 2048-read batches;
4. the whole-read paths — 16448 such reads, every 16th with a 9-20 kb
   body so that reads outrun the 8192-wide rows and become chunk rows,
   through the port's ``annotate --kit`` (whole-read scan) and ``kit
   --full-scan``.  16448 = 8 x 2048 + 64: the last batch's hit capacity
   is below 256, so it ranks with the non-split rank form;
5. kernels at the whole-read paths' shapes, recorded from their batches.

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
``plain_ms`` one call of the plain version between CUDA events.
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
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

KIT = "SQK-RBK114-96"
N_ENDS = 16384
N_WHOLE = 16448  # 8 x 2048 + 64
LONG_EVERY = 16
BATCH = 2048
ORACLE_READS = 128
FLOOR = 0.99
SEED = 0

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

    def __init__(self, engine, path: str, seed: int, sweep: bool = False):
        self.sweep = sweep
        self.rng = np.random.default_rng(seed)
        self.dev = torch.device("cuda")
        self.alpha = engine.alpha_scaled
        (self.gp,) = engine.plans
        self.path = path
        self.entries = []

    def t(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def record(self, name, source, replaces, shape, run_kernel, run_plain,
               bound, ptxas_keys, reps=20, plan=None):
        tup = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
        got = tup(run_kernel())
        torch.cuda.synchronize()
        want = tup(run_plain())
        torch.cuda.synchronize()
        err = _diff(got, want)
        ms, method = _time(run_kernel, reps)
        events_ms = _time_events(run_kernel, reps)
        plain_ms = _time_events(run_plain, 1)
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
        W = gp.tensors.patw.shape[1]
        ops = R * L * (MYERS_PER_WORD * W + MYERS_PER_POS)
        shape = f"rows [{R}, {L}], m = {gp.m}"
        src, rep = "barbell_tpu_torch/csrc/myers.cu", "barbell_tpu/ops/pallas_myers.py:71"
        args = (gp.tensors.patw, gp.m, rows, lo, hi, gp.k_units, klmul)
        self.record(
            "myers_topk", src, rep + " (top-K mode, via :318)", shape,
            lambda: myers.myers_topk(*args),
            lambda: myers.myers_topk_plain(*args),
            _bound(R * L + 8 * R + 36 * R, ops),
            (f"myers_kernelILi{W}ELb1EE",),
        )
        cnt = myers.myers_topk(*args)[1]
        log(f"  rows {R}x{L}: {int((cnt > myers.TOPK).sum())} rows with "
            f"> 8 valleys, {int((cnt == 0).sum())} with none")
        if valleys:
            vargs = (gp.tensors.patw, gp.m, rows, lo, hi, gp.k_units)
            mp = myers.myers_valleys(*vargs)
            log(f"  map {R}x{L}: {int((mp < 255).sum())} valleys")
            self.record(
                "myers_valleys", src, rep + " (map mode, via :253/:270)", shape,
                lambda: myers.myers_valleys(*vargs),
                lambda: myers.myers_valleys_plain(*vargs),
                _bound(2 * R * L + 8 * R, ops),
                (f"myers_kernelILi{W}ELb0EE",),
            )

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
    window kernels there."""
    kc = KernelCheck(engine, "ends", SEED, sweep)
    kc.myers(8192, 512, 2)
    deep = KernelCheck(engine, "ends (deep tier)", SEED + 1)
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
    torch.cuda.synchronize()
    return n


# The whole-read paths' batch shapes as the full run records them (a
# full 2048-read batch and the last 64-read one), for --kernels-only.
WHOLE_READ_BATCHES = ({"L": 4096, "R_total": 6144, "H_cap": 6144},
                      {"L": 4096, "R_total": 192, "H_cap": 192})


def check_whole_read_kernels(engine, batches) -> list:
    """Every kernel at the whole-read paths' recorded shapes: the largest
    batch's rows and hit capacity, and the non-split batch's."""
    big = max(batches, key=lambda b: b["R_total"] * b["L"])
    ns = [b for b in batches if b["H_cap"] % 256]
    kc = KernelCheck(engine, "whole-read", SEED + 2)
    kc.myers(big["R_total"], big["L"], 2, valleys=False)
    kc.window_valleys(2 * big["R_total"])
    kc.window_trace(big["H_cap"])
    kc.window_interval(big["H_cap"])
    kc.rank(max(b["H_cap"] for b in batches if b["H_cap"] % 256 == 0), split=True)
    kc.rank(max(b["H_cap"] for b in ns), split=False)
    torch.cuda.synchronize()
    return kc.entries


# ---------------------------------------------------------------- paths


class BatchRecorder:
    """Records each device call's row width, row count and hit capacity
    (the engine's ``_call``) while installed."""

    def __init__(self):
        from barbell_tpu_torch.models.pipeline import TorchDemuxEngine

        self.cls = TorchDemuxEngine
        self.orig = TorchDemuxEngine._call
        self.batches = []

    def __enter__(self):
        orig, batches = self.orig, self.batches

        def call(eng, gplan, dev_in, L, step, H_cap, S_pad):
            batches.append({"L": L, "R_total": dev_in[1].shape[0] + S_pad,
                            "H_cap": H_cap})
            return orig(eng, gplan, dev_in, L, step, H_cap, S_pad)

        self.cls._call = call
        return self

    def __exit__(self, *exc):
        self.cls._call = self.orig


def _kit(fq, out, backend, full_scan=False):
    from barbell_tpu_torch.stages.kit import KitRunConfig, demux_using_kit

    demux_using_kit(
        [fq],
        KitRunConfig(kit_name=KIT, output_folder=out, batch_size=BATCH,
                     backend=backend, full_scan=full_scan),
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


def run_path(name, run, fq, d, reads, wrappers, required, smi):
    """Drive one path with every launch count at 0 just before it; check
    its launches and accuracy; return (launches, batches)."""
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    with BatchRecorder() as rec, _quiet(d, name):
        t0 = time.perf_counter()
        run(fq, os.path.join(d, name), "torch")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    log(f"[{name}] launches: {launches}")
    for b in rec.batches:
        log(f"[{name}] batch: L {b['L']}, R_total {b['R_total']}, H_cap "
            f"{b['H_cap']} ({'split' if b['H_cap'] % 256 == 0 else 'non-split'} rank)")
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
    return launches, rec.batches


def oracle_parity(name, run, reads, d):
    """The path's files on the first ORACLE_READS reads equal the scalar
    oracle backend's byte for byte."""
    from barbell_tpu_torch.sim import write_fastq

    sub = os.path.join(d, f"{name}_sub.fastq")
    write_fastq(sub, reads[:ORACLE_READS])
    a_dir, b_dir = os.path.join(d, f"{name}_sub_torch"), os.path.join(d, f"{name}_sub_oracle")
    with _quiet(d, f"{name}_sub"):
        run(sub, a_dir, "torch")
        t0 = time.perf_counter()
        run(sub, b_dir, "oracle")
        t_oracle = time.perf_counter() - t0
    a, b = _files(a_dir), _files(b_dir)
    if sorted(a) != sorted(b):
        raise AssertionError(f"{name}: stage files differ: {sorted(a)} vs {sorted(b)}")
    for f in a:
        if a[f] != b[f]:
            raise AssertionError(f"{name}: {f} differs from the oracle backend")
    n_long = sum(len(s) > 8192 for _r, s, _l in reads[:ORACLE_READS])
    log(f"[{name}] oracle parity: {len(a)} files byte-identical on "
        f"{ORACLE_READS} reads ({n_long} longer than 8192 bases; oracle "
        f"{t_oracle:.1f}s)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="run the probe and the kernel phases only (the "
                         "whole-read shapes as a full run records them), "
                         "and time every rank and window instance at the "
                         "ends shapes")
    ap.add_argument("--package", metavar="DIR",
                    help="import barbell_tpu_torch from DIR (another checkout)")
    opts = ap.parse_args()
    if opts.package:
        sys.path.insert(0, os.path.abspath(opts.package))
    smi = probe()
    from barbell_tpu_torch.ops import myers, rank, window
    from barbell_tpu_torch.sim import make_reads_rbk, write_fastq

    t0 = time.perf_counter()
    engine = _flagship_engine()
    log(f"engine set up in {time.perf_counter() - t0:.1f}s (builds the native "
        f"IO library on first use)")
    kernels = check_ends_kernels(engine, sweep=opts.kernels_only)
    t0 = time.perf_counter()
    n_edge = check_edge_kernels(engine.alpha_scaled)
    log(f"{n_edge} edge cases equal to their plain versions in "
        f"{time.perf_counter() - t0:.1f}s")
    if opts.kernels_only:
        kernels += check_whole_read_kernels(engine, WHOLE_READ_BATCHES)
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        t0 = time.perf_counter()
        ends_reads = make_reads_rbk(N_ENDS, SEED)
        whole_reads = make_reads_rbk(N_WHOLE, SEED, long_every=LONG_EVERY)
        fq_ends = os.path.join(d, "ends.fastq")
        fq_whole = os.path.join(d, "whole.fastq")
        write_fastq(fq_ends, ends_reads)
        write_fastq(fq_whole, whole_reads)
        n_long = sum(len(s) > 8192 for _r, s, _l in whole_reads)
        log(f"simulated {len(ends_reads)} + {len(whole_reads)} reads "
            f"({n_long} longer than 8192 bases) in "
            f"{time.perf_counter() - t0:.1f}s")

        by_path["kit"], _ = run_path(
            "kit", _kit, fq_ends, d, ends_reads, wrappers, on_path, smi)
        oracle_parity("kit", _kit, ends_reads, d)

        def kit_full(fq, out, backend):
            _kit(fq, out, backend, full_scan=True)

        for name, run in (("annotate", _annotate), ("kit_full_scan", kit_full)):
            by_path[name], batches = run_path(
                name, run, fq_whole, d, whole_reads, wrappers,
                on_path + ["rank_pass1"], smi)
            whole_batches += batches
            oracle_parity(name, run, whole_reads, d)

    kernels += check_whole_read_kernels(engine, whole_batches)
    for entry in kernels:
        n = entry["name"]
        entry["launches_by_path"] = {p: c[n] for p, c in by_path.items()}
        if entry["path"].startswith("ends"):
            entry["launches"] = by_path["kit"][n]
        elif entry["path"] == "whole-read":
            entry["launches"] = by_path["annotate"][n] + by_path["kit_full_scan"][n]
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
