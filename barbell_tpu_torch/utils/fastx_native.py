"""Native-backed FASTQ batch readers / per-label writers.

Wraps :mod:`barbell_tpu_torch.native` (C++ + zlib) behind the pure-Python
readers.  ``iter_fastq_batches_auto`` yields :class:`FastqBatch`es (the
four lists the kit runner keeps), from one native call a batch where
the library that builds Python objects is available, else from the
record tuples of the plain native reader or of the pure-Python one.
:class:`ReadAhead` makes those calls on a reader thread, a batch or two
ahead of the thread that takes them.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import queue
import threading
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

from .. import timing
from ..native import get_lib, get_pylib
from .fastx import iter_fastq_batches, split_fastq_header, validate_fastq_paths

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


class FastqBatch:
    """One batch of FASTQ records as four lists: read ids and
    descriptions (``split_fastq_header`` of each header) as ``str``,
    sequences and qualities as ``bytes``.  A slice of a batch is a
    batch."""

    __slots__ = ("ids", "descs", "seqs", "quals")

    def __init__(self, ids: List[str], descs: List[str], seqs: List[bytes],
                 quals: List[bytes]):
        self.ids, self.descs, self.seqs, self.quals = ids, descs, seqs, quals

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, key: slice) -> "FastqBatch":
        return FastqBatch(self.ids[key], self.descs[key], self.seqs[key],
                          self.quals[key])

    @classmethod
    def from_records(cls, batch: Sequence[Tuple[str, bytes, bytes]]) -> "FastqBatch":
        ids, descs = [], []
        for h, _s, _q in batch:
            rid, desc = split_fastq_header(h)
            ids.append(rid)
            descs.append(desc)
        return cls(ids, descs, [s for _h, s, _q in batch], [q for _h, _s, q in batch])


def iter_fastq_batches_split(paths: Sequence[str], batch_size: int) -> Iterator[FastqBatch]:
    """One native call a batch (``bbfq_next``): the scan and the header
    split without the interpreter lock, then the four lists made
    straight from the reader's buffer.  No cap on a batch's bytes."""
    lib = get_pylib()
    if lib is None:
        raise RuntimeError("native FASTQ batch library unavailable")
    validate_fastq_paths(paths)
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.bbfq_open(c_paths, len(paths))
    if not handle:
        raise OSError("failed to open FASTQ collection")
    try:
        while True:
            lists = lib.bbfq_next(handle, batch_size)
            if lists is None:
                return
            yield FastqBatch(*lists)
    finally:
        lib.bbfq_close(handle)


def iter_fastq_batches_auto(paths: Sequence[str], batch_size: int) -> Iterator[FastqBatch]:
    if get_pylib() is not None:
        return iter_fastq_batches_split(paths, batch_size)
    records = iter_fastq_batches_native if native_available() else iter_fastq_batches
    return (FastqBatch.from_records(b) for b in records(paths, batch_size))


#: batches the reader thread holds ready beyond the one it is reading
READ_AHEAD = 2


def _read_into(batches: Iterator, q: queue.Queue, stop: threading.Event) -> None:
    """The reader thread: each batch of ``batches`` (span
    ``reader.read``) into ``q``, then None; an exception is put in the
    batch's place.  Stops before its next read once ``stop`` is set, and
    closes ``batches`` when it ends."""
    try:
        for serial in itertools.count():
            if stop.is_set():
                return
            with timing.span("reader.read", serial):
                batch = next(batches, None)
            q.put(batch)
            if batch is None:
                return
    except BaseException as exc:  # raised again where the batch is taken
        q.put(exc)
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()


class ReadAhead:
    """Reads ``batches`` on a thread of its own, up to :data:`READ_AHEAD`
    batches ahead of :meth:`take`.  An error in the reader is raised by
    the :meth:`take` that asks for its batch, after the earlier batches;
    :meth:`close` stops the thread and closes ``batches`` (the native
    handle) at any point."""

    def __init__(self, batches: Iterable):
        self._q: queue.Queue = queue.Queue(READ_AHEAD)
        self._stop = threading.Event()
        self._done = False
        # takes that found their item waiting, added to the counter
        # reader.ready at close: one lock of the recorder a run, not a batch
        self._ready = 0
        self._thread = threading.Thread(
            target=_read_into, args=(iter(batches), self._q, self._stop),
            name="fastq-reader", daemon=True)
        self._thread.start()

    def take(self) -> Optional[FastqBatch]:
        """The next batch; None at the end of input."""
        if self._done:
            return None
        if timing.ENABLED and self._q.qsize():
            self._ready += 1
        item = self._q.get()
        if item is None or isinstance(item, BaseException):
            self._done = True
            if item is not None:
                raise item
        return item

    def close(self) -> None:
        """Stops the reader (a put it is blocked in returns once the
        queue is drained), waits for it, and counts ``reader.ready``."""
        self._stop.set()
        while self._thread.is_alive():
            with contextlib.suppress(queue.Empty):
                while True:
                    self._q.get_nowait()
            self._thread.join(0.01)
        if self._ready:
            timing.count("reader.ready", self._ready)
            self._ready = 0


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

    def write_block(self, block: bytes) -> None:
        """Whole FASTQ records (the kit runner's block of a batch for
        this file), buffered as records are: the file gets the same
        ~256KB writes either way."""
        b = self._buf
        b += block
        if len(b) >= self._FLUSH_AT:
            self.flush()

    def flush(self) -> None:
        b = self._buf
        if b:
            view = (ctypes.c_char * len(b)).from_buffer(b)  # the buffer, not a copy
            rc = self._lib.bbio_writer_write_raw(self._h, view, len(b))
            del view  # the buffer may change size again
            if rc != 0:
                # keep the buffer: a caller may retry after the error
                raise OSError("native FASTQ write failed")
            b.clear()

    def close(self) -> None:
        if self._h:
            try:
                self.flush()
            finally:
                # always release the handle (for gzip this writes the
                # trailer); a failed flush must not leak the FILE*
                self._lib.bbio_writer_close(self._h)
                self._h = None
