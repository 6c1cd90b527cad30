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
    # klmul, stream
    "bb_myers_topk": [_P] * 6 + [_I] * 7 + [_P],
    # rows, patw, emit_lo, emit_hi, map, R, L, W, top_bit, m, k, stream
    "bb_myers_valleys": [_P] * 5 + [_I] * 6 + [_P],
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


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (wrappers run on worker threads)."""
    with _count_lock:
        wrapper.launches += 1
