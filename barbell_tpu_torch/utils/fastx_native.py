"""Native-backed FASTQ batch reader / per-label writers.

Wraps :mod:`barbell_tpu.native` (C++ + zlib) behind the same record
tuples as the pure-Python readers.  ``iter_fastq_batches_auto`` picks
the native path when the extension is available.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, List, Sequence, Tuple

from ..native import get_lib
from .fastx import iter_fastq_batches, validate_fastq_paths

_DATA_CAP = 32 * 1024 * 1024


def native_available() -> bool:
    return get_lib() is not None


def iter_fastq_batches_native(
    paths: Sequence[str], batch_size: int
) -> Iterator[List[Tuple[str, bytes, bytes]]]:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    validate_fastq_paths(paths)

    c_paths = (ctypes.c_char_p * len(paths))(
        *[p.encode() for p in paths]
    )
    handle = lib.bbio_reader_open(c_paths, len(paths))
    if not handle:
        raise OSError("failed to open FASTQ collection")
    data = ctypes.create_string_buffer(_DATA_CAP)
    offs = (ctypes.c_long * (4 * batch_size))()
    try:
        while True:
            n = lib.bbio_reader_next_batch(
                handle, batch_size, data, _DATA_CAP, offs
            )
            if n == 0:
                return
            if n == -1:
                raise ValueError("malformed FASTQ input")
            if n == -2:
                raise ValueError("FASTQ record larger than native IO buffer")
            # copy only the used prefix — .raw copies the whole 32MB cap
            raw = ctypes.string_at(data, offs[4 * (n - 1) + 3])
            batch = []
            for i in range(n):
                h_off, s_off, q_off, q_end = offs[4 * i : 4 * i + 4]
                header = raw[h_off : s_off - 1].decode("ascii")
                seq = raw[s_off : q_off - 1]
                qual = raw[q_off:q_end]
                batch.append((header, seq, qual))
            yield batch
    finally:
        lib.bbio_reader_close(handle)


def iter_fastq_batches_auto(
    paths: Sequence[str], batch_size: int
) -> Iterator[List[Tuple[str, bytes, bytes]]]:
    if native_available():
        return iter_fastq_batches_native(paths, batch_size)
    return iter_fastq_batches(paths, batch_size)


class NativeFastqWriter:
    """One output FASTQ (optionally gzip) via the native extension.

    Records buffer host-side and flush as ~256KB raw blocks: one ctypes
    call per block instead of a 6-argument marshalled call per record
    (the per-call overhead dominated trim's write path at ~14us/record
    on the 1-core bench host)."""

    _FLUSH_AT = 1 << 18

    def __init__(self, path: str, gzip_level: int = 0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._buf = bytearray()
        self._h = lib.bbio_writer_open(path.encode(), gzip_level)
        if not self._h:
            raise OSError(f"Failed to create output file '{path}'")

    def write_record(self, header: bytes, seq: bytes, qual: bytes) -> None:
        # one C-level format + append instead of seven bytearray
        # appends (~3us/record on the 1-core bench host, and the trim
        # path writes one call per output record)
        b = self._buf
        b += b"@%b\n%b\n+\n%b\n" % (header, seq, qual)
        if len(b) >= self._FLUSH_AT:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            rc = self._lib.bbio_writer_write_raw(
                self._h, bytes(self._buf), len(self._buf)
            )
            if rc != 0:
                # keep the buffer: a caller may retry after the error
                raise OSError("native FASTQ write failed")
            self._buf.clear()

    def close(self) -> None:
        if self._h:
            try:
                self.flush()
            finally:
                # always release the handle (for gzip this writes the
                # trailer); a failed flush must not leak the FILE*
                self._lib.bbio_writer_close(self._h)
                self._h = None
