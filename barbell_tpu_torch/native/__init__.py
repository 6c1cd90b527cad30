"""Native IO extension loader (ctypes; builds lazily with g++ if needed).

Two libraries, each built on first use: ``libbarbell_io.so`` (plain C:
the FASTQ reader and writers, 2-bit encoders, Myers helpers) and the
library that builds Python objects (``fastq_batch.cpp``, against the
interpreter's own headers, loaded through ``ctypes.PyDLL``): the FASTQ
batch reader and the kit runner's filter tail and trim of a batch.
Both share ``fastq_reader.h``.

Falls back cleanly when no compiler/zlib (or no Python headers) is
available — the pure-Python readers in :mod:`barbell_tpu.utils.fastx`
remain the portable path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastq_io.cpp")
_HEADER = os.path.join(_HERE, "fastq_reader.h")
_BUILD = os.path.join(os.path.dirname(_HERE), "build")
_SO = os.path.join(_BUILD, "libbarbell_io.so")
_PY_SRC = os.path.join(_HERE, "fastq_batch.cpp")
# the interpreter's ABI in the name: a library built for one Python is
# never loaded by another
_PY_SO = os.path.join(
    _BUILD, f"libbarbell_fastq_batch.{sysconfig.get_config_var('SOABI') or 'py'}.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_pylib: Optional[ctypes.PyDLL] = None
_py_tried = False


def _build(src: str, so: str, flags=()) -> bool:
    # Build to a private temp path and os.rename into place: concurrent
    # processes (per-rank shards, parallel test workers) may race the
    # build, and linking straight onto the live path could hand a torn
    # .so to a concurrent CDLL (or SIGBUS a process that already
    # mmapped the old inode — rename keeps the old inode alive).
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.build.{os.getpid()}"
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-pthread",
        "-std=c++17",
        *flags,
        src,
        "-o",
        tmp,
        "-lz",
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _built(src: str, so: str, flags=()) -> bool:
    """Whether ``so`` is there and newer than ``src`` and the shared
    header, building it if not."""
    try:
        newest = max(os.path.getmtime(p) for p in (src, _HEADER) if os.path.exists(p))
        stale = not os.path.exists(so) or os.path.getmtime(so) < newest
    except (OSError, ValueError):
        stale = not os.path.exists(so)
    return not stale or _build(src, so, flags)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if
    unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _built(_SRC, _SO):
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.bbio_reader_open.restype = ctypes.c_void_p
        lib.bbio_reader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
        ]
        lib.bbio_reader_close.argtypes = [ctypes.c_void_p]
        lib.bbio_reader_next_batch.restype = ctypes.c_long
        lib.bbio_reader_next_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.bbio_writer_open.restype = ctypes.c_void_p
        lib.bbio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.bbio_writer_write.restype = ctypes.c_int
        lib.bbio_writer_write.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        lib.bbio_writer_write_raw.restype = ctypes.c_int
        lib.bbio_writer_write_raw.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        lib.bbio_writer_close.restype = ctypes.c_int
        lib.bbio_writer_close.argtypes = [ctypes.c_void_p]
        lib.bbio_encode_pack2_cat.restype = ctypes.c_long
        lib.bbio_encode_pack2_cat.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_long),  # per-row byte starts
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_long,
        ]
        lib.bbio_encode_pack2_chunks.restype = ctypes.c_long
        lib.bbio_encode_pack2_chunks.argtypes = [
            ctypes.c_char_p,  # concatenated long-read raw bytes
            ctypes.POINTER(ctypes.c_long),  # per-read offsets
            ctypes.POINTER(ctypes.c_int),  # per-read lengths
            ctypes.c_int,  # n chunk rows
            ctypes.POINTER(ctypes.c_int),  # row -> local read index
            ctypes.POINTER(ctypes.c_long),  # row span offset (own strand)
            ctypes.POINTER(ctypes.c_int),  # row span length
            ctypes.c_char_p,  # row is-rc flags (u8)
            ctypes.POINTER(ctypes.c_long),  # row output byte starts
            ctypes.POINTER(ctypes.c_long),  # row flat bases (row * L)
            ctypes.c_char_p,  # fwd 2-bit code LUT
            ctypes.c_char_p,  # fwd mask LUT
            ctypes.c_char_p,  # rc 2-bit code LUT
            ctypes.c_char_p,  # rc mask LUT
            ctypes.c_char_p,  # out buffer
            ctypes.POINTER(ctypes.c_int),  # exceptions out
            ctypes.c_long,  # incoming exception count
            ctypes.c_long,  # exception capacity
        ]
        lib.bbio_encode_pack2_rows.restype = ctypes.c_long
        lib.bbio_encode_pack2_rows.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_char_p,  # 2-bit code LUT
            ctypes.c_char_p,  # mask LUT
            ctypes.c_char_p,  # out [n, L/4]
            ctypes.POINTER(ctypes.c_int),  # exceptions out
            ctypes.c_long,  # exception capacity
        ]
        lib.bbio_myers_valleys.restype = ctypes.c_long
        lib.bbio_myers_valleys.argtypes = [
            ctypes.c_char_p,  # raw text bytes
            ctypes.c_int,  # n
            ctypes.c_char_p,  # 256-entry byte -> mask LUT
            ctypes.c_char_p,  # pattern masks
            ctypes.c_int,  # m
            ctypes.c_int,  # k
            ctypes.POINTER(ctypes.c_int),  # valley positions out
            ctypes.c_int,  # capacity
        ]
        lib.bbio_myers_anchor.restype = ctypes.c_long
        lib.bbio_myers_anchor.argtypes = [
            ctypes.c_char_p,  # concatenated raw seq bytes
            ctypes.POINTER(ctypes.c_long),  # per-read offsets
            ctypes.POINTER(ctypes.c_int),  # per-read lengths
            ctypes.c_int,  # n reads
            ctypes.c_char_p,  # 256-entry byte -> mask LUT
            ctypes.c_char_p,  # flank masks
            ctypes.c_int,  # m_flank
            ctypes.c_int,  # k_flank
            ctypes.c_char_p,  # barcode masks [n_bars, m_bar]
            ctypes.c_int,  # n_bars
            ctypes.c_int,  # m_bar
            ctypes.c_int,  # k_bar
            ctypes.c_int,  # window
            ctypes.c_int,  # n_threads
        ]
        lib.bbio_encode_pack_rows.restype = None
        lib.bbio_encode_pack_rows.argtypes = [
            ctypes.c_char_p,  # concatenated seq bytes
            ctypes.POINTER(ctypes.c_long),  # per-read offsets
            ctypes.POINTER(ctypes.c_int),  # per-read lengths
            ctypes.c_int,  # n reads
            ctypes.c_int,  # L (row width, even)
            ctypes.c_char_p,  # 256-entry encode LUT
            ctypes.c_char_p,  # out buffer [n, L/2]
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def get_pylib() -> Optional[ctypes.PyDLL]:
    """The library that builds Python objects: the FASTQ batch reader
    (``bbfq_open`` / ``bbfq_next`` / ``bbfq_close``) and the kit
    runner's run closer (``bbkt_close_runs``), building it on first use;
    None where it cannot be built (no compiler, zlib or Python
    headers)."""
    global _pylib, _py_tried
    if _pylib is not None or _py_tried:
        return _pylib
    with _lock:
        if _pylib is not None or _py_tried:
            return _pylib
        _py_tried = True
        include = sysconfig.get_paths().get("include") or ""
        if not os.path.exists(os.path.join(include, "Python.h")):
            return None
        if not _built(_PY_SRC, _PY_SO, ["-fvisibility-inlines-hidden", f"-I{include}"]):
            return None
        try:
            lib = ctypes.PyDLL(_PY_SO)
        except OSError:
            return None
        lib.bbfq_open.restype = ctypes.c_void_p
        lib.bbfq_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
        lib.bbfq_next.restype = ctypes.py_object
        lib.bbfq_next.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.bbfq_close.restype = None
        lib.bbfq_close.argtypes = [ctypes.c_void_p]
        lib.bbkt_close_runs.restype = ctypes.py_object
        lib.bbkt_close_runs.argtypes = [
            *[ctypes.py_object] * 8,  # ids descs seqs quals slabels lines cutrows names
            ctypes.c_void_p,  # int64 [8, n] columns
            ctypes.c_long,  # n reads
            ctypes.py_object,  # the open run's id, or None
            ctypes.c_long,  # its records
            ctypes.c_long,  # the early-flush count
        ]
        _pylib = lib
        return _pylib
