"""Digester process: reads every output pipe of the timed call and keeps
only what the comparison needs.

    python -m benchmark.digester

Standard input first carries one JSON line: ``{"dir": <output folder>,
"fifos": [names], "sample": [pool indices]}``.  It opens every pipe for
reading (so the writer's ``open`` never waits), prints ``ready``, and
then polls.  Per file it counts records and bytes, checks that read ids
arrive in feed order, and keeps the whole records of the sampled pool
reads.  A ``done`` line on standard input means the call has returned:
it drains the pipes, reads any regular file the call wrote instead (an
output the harness did not foresee), deletes it, and writes a pickle of
its findings to standard output.
"""

from __future__ import annotations

import fcntl
import json
import os
import pickle
import select
import stat
import sys
import time

import numpy as np

from benchmark.reference.records import TSV_HEADER
from benchmark.traffic import bytes_written

F_SETPIPE_SZ = 1031
PIPE_BYTES = 1 << 20
READ_BYTES = 1 << 20
F_GETPIPE_SZ = 1032
#: how long data gathers between polls: each pipe then yields one larger
#: read instead of many small ones (the writers flush a few KiB at a
#: time, and there is a pipe per sample); the pipes hold far more
GATHER_S = 0.01
PARSE_BYTES = 1 << 18


_HEX = np.full(256, -1, dtype=np.int64)
_HEX[np.frombuffer(b"0123456789abcdef", dtype=np.uint8)] = np.arange(16)
#: a read id begins "pppppppp-iiii-iiii": the pass, then the pool index
_DIGITS = np.array([0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 14, 15, 16, 17])
_WEIGHTS = 16 ** np.arange(15, -1, -1, dtype=np.int64)


def _ids_at(arr: np.ndarray, starts: np.ndarray):
    """(pass << 32 | pool index, well formed) of the read ids at
    ``starts`` of ``arr``."""
    if len(arr) < 18:
        return np.zeros(len(starts), dtype=np.int64), np.zeros(len(starts), dtype=bool)
    rows = np.lib.stride_tricks.as_strided(arr, (len(arr) - 17, 18), (1, 1))
    g = rows[np.minimum(starts, len(arr) - 18)]
    d = _HEX[g[:, _DIGITS]]
    ok = ((d >= 0).all(axis=1) & (g[:, 8] == 45) & (g[:, 13] == 45)
          & (starts + 18 <= len(arr)))
    return (np.maximum(d, 0) * _WEIGHTS).sum(axis=1), ok


class Stream:
    """One output file's reader: TSV lines, or 4-line FASTQ records.

    Every record is counted and its read id checked for form and feed
    order with NumPy over the whole chunk; only the records of sampled
    reads are cut out and kept."""

    def __init__(self, name: str, sample: np.ndarray, kept: dict):
        self.name = name
        self.fastq = name.endswith(".fastq")
        self.sample = sample  # sorted pool indices
        self.kept = kept
        self.carry = b""
        self.pending: list = []
        self.pending_bytes = 0
        self.records = 0
        self.bytes = 0
        self.bad_header = 0
        self.unparsed = 0
        self.out_of_order = 0
        self.last = -1
        self.first_byte_t = None
        self.started = False
        self.progress: list = []  # (time, records before this parse)
        self.order: list = []  # (pass, pool index) of each kept record, as they came

    def feed(self, data: bytes) -> None:
        """Takes ``data`` as it came; parses once ``PARSE_BYTES`` have
        gathered, so that NumPy's cost a call is paid on large pieces."""
        if not data:
            return
        if self.first_byte_t is None:
            self.first_byte_t = time.monotonic()
        self.bytes += len(data)
        self.pending.append(data)
        self.pending_bytes += len(data)
        if self.pending_bytes >= PARSE_BYTES:
            self.parse()

    def parse(self) -> None:
        if not self.pending:
            return
        self.progress.append((time.monotonic(), self.records))
        buf = b"".join([self.carry, *self.pending])
        self.pending, self.pending_bytes = [], 0
        arr = np.frombuffer(buf, dtype=np.uint8)
        nl = np.flatnonzero(arr == 10)
        per = 4 if self.fastq else 1
        full = len(nl) // per
        if full == 0:
            self.carry = buf
            return
        end = int(nl[full * per - 1]) + 1
        self.carry = buf[end:]
        nl = nl[:full * per]
        starts = np.concatenate([[0], nl[per - 1:-1:per] + 1]).astype(np.int64)
        ends = nl[per - 1::per]
        if self.fastq:
            l0, l1, l2 = nl[0::4], nl[1::4], nl[2::4]
            bad = ((arr[starts] != ord("@")) | (arr[l1 + 1] != ord("+")) | (l2 != l1 + 2)
                   | (l1 - l0 != ends - l2))
            self.unparsed += int(bad.sum())
            starts, ends = starts[~bad], ends[~bad]
        else:
            if not self.started and buf.startswith(b"read_id\t"):
                # the annotation files' header: once, first, exact
                if buf[:ends[0]].decode("ascii", "replace") != TSV_HEADER:
                    self.bad_header += 1
                starts, ends = starts[1:], ends[1:]
            head = arr[starts] == ord("r")  # no read id starts so
            self.bad_header += int(head.sum())
            starts, ends = starts[~head], ends[~head]
        self.started = True
        self._ids(buf, arr, starts, ends, 1 if self.fastq else 0)

    def _ids(self, buf, arr, starts, ends, at: int) -> None:
        """Counts the records at ``starts`` (read id ``at`` bytes in),
        checks their ids' form and order, keeps the sampled ones."""
        self.records += len(starts)
        if not len(starts):
            return
        full, ok = _ids_at(arr, starts + at)
        self.unparsed += int((~ok).sum())
        i = full & 0xFFFFFFFF
        key = full[ok]
        if len(key):
            self.out_of_order += int((np.diff(np.concatenate([[self.last], key])) < 0).sum())
            self.last = int(key[-1])
        at_ = np.minimum(np.searchsorted(self.sample, i), len(self.sample) - 1)
        hit = ok & (self.sample[at_] == i) if len(self.sample) else np.zeros_like(ok)
        for a, b, kk in zip(starts[hit].tolist(), ends[hit].tolist(), full[hit].tolist()):
            pp, ii = kk >> 32, kk & 0xFFFFFFFF
            self.kept.setdefault((self.name, pp, ii), []).append(
                buf[a:b].decode("ascii", "replace"))
            self.order.append((pp, ii))

    def finish(self) -> None:
        self.parse()
        if self.carry:
            self.unparsed += 1  # a partial line or record at the end

    def summary(self) -> dict:
        return {"records": self.records, "bytes": self.bytes, "bad_header": self.bad_header,
                "unparsed": self.unparsed, "out_of_order": self.out_of_order,
                "first_byte_t": self.first_byte_t, "progress": self.progress,
                "order": self.order}


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    out_dir = spec["dir"]
    sample = np.unique(np.asarray(spec["sample"], dtype=np.int64))
    kept: dict = {}
    streams = {}
    fds = {}
    pipe_bytes = PIPE_BYTES
    for name in spec["fifos"]:
        fd = os.open(os.path.join(out_dir, name), os.O_RDONLY | os.O_NONBLOCK)
        try:  # fewer, larger transfers; the kernel's default is 64 KiB
            fcntl.fcntl(fd, F_SETPIPE_SZ, PIPE_BYTES)
        except OSError:
            pass
        pipe_bytes = min(pipe_bytes, fcntl.fcntl(fd, F_GETPIPE_SZ))
        fds[fd] = streams[name] = Stream(name, sample, kept)
    print("ready", flush=True)

    poller = select.poll()
    for fd in fds:
        poller.register(fd, select.POLLIN)
    ctl = sys.stdin.fileno()
    poller.register(ctl, select.POLLIN)
    busy = 0.0
    done = False
    # one buffer for every read: a fresh 1 MiB object a read costs more
    # than the copy of what it holds
    room = bytearray(READ_BYTES)
    view = memoryview(room)
    while not done:
        events = poller.poll()
        t = time.monotonic()
        for fd, ev in events:
            if fd == ctl:
                done = True
                continue
            try:
                n = os.readv(fd, [room])
            except BlockingIOError:
                continue
            if n:
                fds[fd].feed(bytes(view[:n]))
            else:  # the writer closed it
                poller.unregister(fd)
        done_t = time.monotonic()
        busy += done_t - t
        # let data gather: a few large reads cost less than many small
        # ones, and the pipes hold far more than arrives meanwhile
        if done_t - t < GATHER_S:
            time.sleep(GATHER_S - (done_t - t))
    # the call has returned: every writer is closed, so each pipe reads
    # to its end
    for fd, st in fds.items():
        while True:
            try:
                data = os.read(fd, 1 << 20)
            except BlockingIOError:
                break
            if not data:
                break
            st.feed(data)
        os.close(fd)
    unforeseen = []
    for name in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, name)
        if name in streams or not stat.S_ISREG(os.lstat(path).st_mode):
            continue
        unforeseen.append(name)
        st = streams[name] = Stream(name, sample, kept)
        with open(path, "rb") as fh:
            while True:
                data = fh.read(1 << 20)
                if not data:
                    break
                st.feed(data)
        os.unlink(path)
    for st in streams.values():
        st.finish()
    result = {"files": {n: s.summary() for n, s in streams.items()}, "kept": kept,
              "busy_s": busy, "unforeseen": unforeseen,
              "bytes_written": bytes_written(), "pipe_bytes": pipe_bytes}
    sys.stdout.buffer.write(pickle.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
