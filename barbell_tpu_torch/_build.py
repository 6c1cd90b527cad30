"""Build and load the port's hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one
process per source, all started together, and links the objects into
one shared library with a plain C interface, which :func:`load` opens
with ``ctypes``.  The library's file name carries a hash of the sources and
flags, so an edited kernel never loads a stale build; the build goes to
a private temporary name and is renamed into place, so concurrent
processes never open a half-written file.  A lock makes the build
happen once per process: the engine's constructor calls :func:`load`,
so the worker threads of ``engine_map_batches`` never race ``nvcc``.
The compiler's output (``-Xptxas -v``: registers, shared memory, stack
frame and spills of every kernel) is kept beside the library and read
back into :data:`build_log` whenever the library loads.

Any build or load failure raises; there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # the Lodhi update must not contract into FMAs (bit-identical f32)
    "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
#: compiler output of the library's build (read back from beside a
#: finished library) and the seconds the build and load took
build_log = ""
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # rows, patw, emit_lo, emit_hi, keys, cnt, R, L, W, top_bit, m, k,
    # klmul, seg, S, stream
    "bb_myers_topk": [_P] * 6 + [_I] * 9 + [_P],
    # rows, patw, emit_lo, emit_hi, map, R, L, W, top_bit, m, k, seg, S,
    # stream
    "bb_myers_valleys": [_P] * 5 + [_I] * 8 + [_P],
    # mode, pat, pat_stride, win, c0, ledge, rpos, ehi, wlen, out,
    # out_cnt, H, m, W, unit, alpha, ra, rb, k_scaled, klmul, rows, group,
    # stream
    "bb_window": [_I, _P, ctypes.c_longlong] + [_P] * 8 + [_I] * 11 + [_P],
    # pats, win, wlen, key, lodhi, H, P, m, W, split, unit, rows, group,
    # stream
    "bb_rank": [_P] * 5 + [_I] * 8 + [_P],
}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from barbell_tpu_torch/csrc at first use"
        )
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libbarbell_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd, what: str) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {what} ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    return res.stdout + res.stderr


def _build(so: Path) -> str:
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{f.stem}.o" for f in cu]
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        with ThreadPoolExecutor(max_workers=len(cu)) as pool:
            logs = list(pool.map(
                lambda fo: _run([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(fo[1]),
                                 str(fo[0])], fo[0].name),
                zip(cu, objs),
            ))
        logs.append(_run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", str(tmp), *map(str, objs)], "link"))
        os.replace(tmp, so)
    finally:
        for f in (tmp, *objs):
            if f.exists():
                f.unlink()
    return "".join(logs)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises on any failure."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            so = library_path()
            log = so.with_suffix(".log")
            if not so.exists():
                log.write_text(_build(so))
            build_log = log.read_text() if log.exists() else ""
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            build_seconds = time.perf_counter() - t0
            _lib = lib
        return _lib


def wavefront_plan(m: int, W: int, rows) -> tuple:
    """(R, G) for a wavefront kernel over a pattern of ``m`` rows and a
    window of ``W`` columns: R pattern rows a thread (one of ``rows``, the
    kernel's template instances) and a power-of-two group of G <= 32
    threads, the pair with the fewest thread-cell slots
    G * R * (W + (m - 1) // R), which counts the padding rows and the ramp
    until the thread holding row m reaches column W; ties go to the
    smaller R (fewer registers).  Raises if no instance covers m."""
    best = None
    for R in rows:
        G = 1 << max(0, -(-m // R) - 1).bit_length()
        if G > 32:
            continue
        cost = G * R * (W + (m - 1) // R)
        if best is None or cost < best[0]:
            best = (cost, R, G)
    if best is None:
        raise ValueError(f"pattern length {m} needs more than 32 x {max(rows)} rows")
    return best[1], best[2]


#: threads whose instruction slots take as long as one thread's dependent
#: step: a Myers segment's time is its chain times (its launch's threads
#: + SEGMENT_FILL) (132 SMs x 6 warps; chip_smoke.py's segment sweep)
SEGMENT_FILL = 132 * 6 * 32


def myers_warmup(m: int, k: int) -> int:
    """Columns a Myers segment scans before the first position it
    decides (``warmup_cols`` in ``csrc/myers.cu``, whose header gives the
    argument): an alignment of cost <= k spans at most m + k columns."""
    return m + k


def segment_size(L: int, S: int) -> int:
    """SEG for S segments of an L-column row: ceil(L / S) rounded up to
    16 (at least 16), so every segment starts on a 16-byte word."""
    return max(16, (-(-L // S) + 15) // 16 * 16)


def segment_plan(m: int, k: int, L: int, R: int) -> tuple:
    """(SEG, S) for the Myers kernel over ``R`` rows of ``L`` columns:
    S segments of SEG columns a row (S a power of two <= 32, and
    <= L / 16 past 1; SEG = :func:`segment_size`), the S with the least
    chain * (R * S + SEGMENT_FILL), where the chain is the longest
    segment's columns, min(L, SEG + warm-up): each step of the chain
    waits for its own latency and for the instruction slots of the launch's
    other threads.  Ties go to the smaller S."""
    if L < 0 or L % 16:
        raise ValueError(f"Myers rows need L % 16 == 0, got L = {L}")
    best = None
    S = 1
    while S == 1 or S <= min(32, L // 16):
        seg = segment_size(L, S)
        chain = L if S == 1 else min(L, seg + myers_warmup(m, k))
        cost = chain * (R * S + SEGMENT_FILL)
        if best is None or cost < best[0]:
            best = (cost, seg, S)
        S *= 2
    return best[1], best[2]


def ptr(t, name: str, dtype, device, shape) -> int:
    """``t.data_ptr()`` after checking what the kernel assumes of it."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def check(err: int, name: str) -> None:
    """Raise when a kernel entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


_recording = threading.local()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (wrappers run on worker threads);
    inside :func:`recording_launches` on this thread, note the launch
    instead: a CUDA-graph capture runs no kernel, its replays do."""
    rec = getattr(_recording, "wrappers", None)
    if rec is not None:
        rec.append(wrapper)
        return
    with _count_lock:
        wrapper.launches += 1


@contextlib.contextmanager
def recording_launches():
    """The wrappers whose kernels this thread enqueues inside, in order,
    noted and not counted (:func:`count_replay` counts them each time
    the captured graph runs)."""
    prev = getattr(_recording, "wrappers", None)
    _recording.wrappers = rec = []
    try:
        yield rec
    finally:
        _recording.wrappers = prev


def count_replay(wrappers) -> None:
    """Count one launch on each wrapper of a captured graph that ran."""
    with _count_lock:
        for w in wrappers:
            w.launches += 1
