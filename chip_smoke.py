"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. probe — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit (``nvidia-smi``), the torch and CUDA versions,
   and builds the port's kernels from ``barbell_tpu_torch/csrc`` (the
   first engine then builds the native IO library, outside the timed
   slice);
2. kernels — every kernel of the flagship path against its plain
   PyTorch version on the card, at the flagship shapes plus edge cases
   (IUPAC N and zero padding, empty emission ranges, rows with more than
   8 valleys, ``w_len = 0`` lanes, left-edge and ``right_pos`` lanes,
   the non-split rank form).  Tolerance: none — integers must be equal
   and Lodhi scores equal bit for bit;
3. slice — 16384 simulated SQK-RBK114-96 reads through the port's
   ``demux_using_kit`` in 2048-read batches: every kernel's launch
   count must be > 0, assigned and correct-of-assigned >= 0.99 against
   the simulator's truth, and the stage files byte-identical to the
   scalar oracle backend on the first 128 reads.

The last three lines are a JSON object with each kernel's launches in
the slice, its largest difference from the plain version and both
times; the card's name and power limit again; and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

KIT = "SQK-RBK114-96"
N_READS = 16384
BATCH = 2048
ORACLE_READS = 128
FLOOR = 0.99
SEED = 0


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
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    return smi


# -------------------------------------------------------------- kernels


def _flagship_engine():
    """The slice's shallow-tier engine: its one group plan holds the
    kernels' query constants on the card."""
    from barbell_tpu_torch.models.pipeline import TorchDemuxEngine
    from barbell_tpu_torch.stages.kit import kit_groups

    return TorchDemuxEngine(kit_groups(KIT), ends_window=(512, 512),
                            device="cuda")


def _time(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def check_kernels(engine) -> list:
    """Every kernel against its plain version at the flagship shapes."""
    from barbell_tpu_torch.ops import myers, rank, window

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    UNIT = window.UNIT
    alpha = engine.alpha_scaled
    (gp,) = engine.plans
    m, k = gp.m, gp.k_units
    flank = gp.tensors.flank
    patw = gp.tensors.patw
    results = []

    def record(name, source, replaces, run_kernel, run_plain, reps=20):
        tup = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
        got = tup(run_kernel())
        torch.cuda.synchronize()
        want = tup(run_plain())
        torch.cuda.synchronize()
        err = _diff(got, want)
        ms = _time(run_kernel, reps)
        plain_ms = _time(run_plain, 1)
        log(f"kernel {name}: equal to plain (max abs err {err}); "
            f"{ms:.3f} ms vs plain {plain_ms:.1f} ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms}

    # --- Myers interior scan: shallow rows [8192, 512]; deep rows
    # [1024, 1024] where some rows carry 10 flank copies (> 8 valleys)
    for R, L, copies in ((8192, 512, 2), (1024, 1024, 10)):
        rows = t(_plant(rng, L, R, gp.flank, copies))
        lo = rng.integers(0, 120, R).astype(np.int32)
        hi = (L - 1 - rng.integers(0, 40, R)).astype(np.int32)
        lo[:16], hi[:16] = 300, 100  # empty emission ranges
        lo, hi = t(lo), t(hi)
        klmul = UNIT * (L + 2)
        args = (patw, m, rows, lo, hi, k, klmul)
        entry = record(
            "myers_topk", "barbell_tpu_torch/csrc/myers.cu",
            "barbell_tpu/ops/pallas_myers.py:71",
            lambda: myers.myers_topk(*args),
            lambda: myers.myers_topk_plain(*args),
        )
        cnt = myers.myers_topk(*args)[1]
        log(f"  rows {R}x{L}: {int((cnt > myers.TOPK).sum())} rows with > 8 "
            f"valleys, {int((cnt == 0).sum())} with none")
        if R == 8192:
            results.append(entry)

    # --- window valley: 2R = 16384 boundary lanes of width m + k + 3
    H, Wb = 16384, m + k + 3
    wins = t(_plant(rng, Wb, H, gp.flank, 1))
    w_len = np.full(H, Wb, dtype=np.int32)
    ledge = rng.integers(0, 2, H).astype(np.int32)
    rpos = np.where(rng.integers(0, 2, H) != 0, Wb, -1).astype(np.int32)
    elo = rng.integers(0, 8, H).astype(np.int32)
    ehi = (Wb - rng.integers(0, 8, H)).astype(np.int32)
    elo[:32], ehi[:32] = 50, 10
    vargs = (flank, wins, t(w_len), t(ledge), t(rpos), t(elo), t(ehi),
             alpha, k * UNIT, 512 + 2)
    results.append(record(
        "window_valleys", "barbell_tpu_torch/csrc/window.cu",
        "barbell_tpu/ops/pallas_window.py:51",
        lambda: window.window_valleys(*vargs),
        lambda: window.window_plain(
            window.MODE_VALLEY, flank, vargs[1], vargs[5], vargs[3], vargs[4],
            vargs[6], vargs[2], alpha, 0, 0, k * UNIT, 514),
    ))

    # --- window trace: ~2816 hit lanes over Wf = m + k + 1 columns
    H, Wf = 2816, gp.span
    twin = _plant(rng, Wf, H, gp.flank, 1)
    end_j = rng.integers(m - 10, Wf + 1, H).astype(np.int32)
    end_j[:8] = 0
    for h in range(H):
        twin[h, end_j[h]:] = 0
    ledge = rng.integers(0, 2, H).astype(np.int32)
    rpos = np.where(rng.integers(0, 2, H) != 0, end_j, -1).astype(np.int32)
    ra, rb = gp.mask_start, gp.mask_end
    targs = (flank, t(twin), t(end_j), t(ledge), t(rpos), alpha, ra, rb)
    z = torch.zeros(H, dtype=torch.int32, device=dev)
    results.append(record(
        "window_trace", "barbell_tpu_torch/csrc/window.cu",
        "barbell_tpu/ops/pallas_window.py:51",
        lambda: torch.stack(window.window_trace(*targs), dim=1),
        lambda: window.window_plain(
            window.MODE_TRACE, flank, targs[1], targs[2], targs[3], targs[4],
            z, z, alpha, ra, rb, 0, 0),
    ))

    # --- barcode windows shared by interval and rank: [2816, Wb = 66]
    Wbc = gp.barcode_window
    pats_all = gp.tensors.patterns_all
    pick = rng.integers(0, pats_all.shape[0], H)
    bwin = np.zeros((H, Wbc), dtype=np.uint8)
    b_len = rng.integers(gp.plen - 4, Wbc + 1, H).astype(np.int32)
    b_len[:16] = 0  # w_len = 0 lanes
    planted = _plant(rng, Wbc, H, gp.patterns_all[0], 0)
    for h in range(H):
        row = planted[h].copy()
        pos = int(rng.integers(0, 12))
        seg = gp.patterns_all[pick[h]][: Wbc - pos]
        row[pos : pos + len(seg)] = seg
        row[b_len[h]:] = 0
        bwin[h] = row
    bwin_t, b_len_t = t(bwin), t(b_len)
    pat_top = pats_all[t(pick).long()]
    end_top = t(np.minimum(b_len, rng.integers(gp.plen - 6, Wbc + 1, H)).astype(np.int32))
    iargs = (pat_top, bwin_t, end_top, gp.rel_bar_start, gp.rel_bar_end)
    results.append(record(
        "window_interval", "barbell_tpu_torch/csrc/window.cu",
        "barbell_tpu/ops/pallas_window.py:51",
        lambda: window.window_interval(*iargs),
        lambda: window.window_plain(
            window.MODE_INTERVAL, pat_top, bwin_t, end_top, z, z - 1, z, z,
            UNIT, gp.rel_bar_start, gp.rel_bar_end, 0, 0),
    ))

    # --- rank, strand-split (the slice's form) and non-split (H % 256 != 0)
    results.append(record(
        "rank_pass1", "barbell_tpu_torch/csrc/rank.cu",
        "barbell_tpu/ops/pallas_rank.py:55",
        lambda: rank.rank_pass1(pats_all, bwin_t, b_len_t, split=H // 2),
        lambda: rank.rank_pass1_plain(pats_all, bwin_t, b_len_t, split=H // 2),
    ))
    Hn = 1000
    record(
        "rank_pass1 (non-split)", "barbell_tpu_torch/csrc/rank.cu",
        "barbell_tpu/ops/pallas_rank.py:55",
        lambda: rank.rank_pass1(pats_all, bwin_t[:Hn], b_len_t[:Hn]),
        lambda: rank.rank_pass1_plain(pats_all, bwin_t[:Hn], b_len_t[:Hn]),
        reps=5,
    )
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------- slice


def _run_kit(fq, out, backend):
    from barbell_tpu_torch.stages.kit import KitRunConfig, demux_using_kit

    demux_using_kit(
        [fq],
        KitRunConfig(kit_name=KIT, output_folder=out, batch_size=BATCH,
                     backend=backend),
        device="cuda",
    )


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


def run_slice(wrappers, smi: str) -> dict:
    from barbell_tpu_torch.sim import make_reads_rbk, write_fastq

    t0 = time.perf_counter()
    reads = make_reads_rbk(N_READS, SEED)
    log(f"simulated {len(reads)} reads in {time.perf_counter() - t0:.1f}s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        fq = os.path.join(d, "reads.fastq")
        write_fastq(fq, reads)

        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _run_kit(fq, os.path.join(d, "out"), "torch")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        log(f"slice launches: {launches}")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"kernel {name} never launched in the slice")

        # bench.py's measure: a read is assigned by its first barcode
        # (Ftag) annotation row
        truth = {rid: label for rid, _s, label in reads}
        first = {}
        with open(os.path.join(d, "out", "annotation.tsv")) as fh:
            next(fh)
            for line in fh:
                f = line.split("\t")
                if f[9] == "Ftag" and f[0] not in first:
                    first[f[0]] = f[12]
        n_correct = sum(truth[rid] == label for rid, label in first.items())
        assigned = len(first) / len(reads)
        correct = n_correct / max(1, len(first))
        log(f"slice accuracy: assigned {assigned:.4f}, correct-of-assigned "
            f"{correct:.4f}")
        if assigned < FLOOR or correct < FLOOR:
            raise AssertionError(f"accuracy below {FLOOR}")
        log(f"slice smoke figure (not a benchmark): {len(reads)} reads in "
            f"{dt:.2f}s = {len(reads) / dt:.0f} reads/s, end to end incl. "
            f"FASTQ IO, on {smi}")

        sub = os.path.join(d, "sub.fastq")
        write_fastq(sub, reads[:ORACLE_READS])
        _run_kit(sub, os.path.join(d, "sub_torch"), "torch")
        _run_kit(sub, os.path.join(d, "sub_oracle"), "oracle")
        a, b = _files(os.path.join(d, "sub_torch")), _files(os.path.join(d, "sub_oracle"))
        if sorted(a) != sorted(b):
            raise AssertionError(f"stage files differ: {sorted(a)} vs {sorted(b)}")
        for name in a:
            if a[name] != b[name]:
                raise AssertionError(f"{name} differs from the oracle backend")
        log(f"oracle parity: {len(a)} stage files byte-identical on "
            f"{ORACLE_READS} reads ({', '.join(sorted(a))})")
    return launches


def main() -> int:
    smi = probe()
    from barbell_tpu_torch.ops import myers, rank, window

    t0 = time.perf_counter()
    engine = _flagship_engine()
    log(f"engine set up in {time.perf_counter() - t0:.1f}s (builds the native "
        f"IO library on first use)")
    kernels = check_kernels(engine)
    wrappers = [myers.myers_topk, window.window_valleys, window.window_trace,
                window.window_interval, rank.rank_pass1]
    launches = run_slice(wrappers, smi)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
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
