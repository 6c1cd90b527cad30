"""Feeder process: writes a cell's read pool into the input pipe, pass
after pass with fresh read ids, until its deadline, then closes the pipe.

    python -m benchmark.feeder <cell json> <seed> <fifo>

It makes the pool from the seed itself (the same pool as the harness's),
prints ``ready`` when it has, then reads one line from standard input:
the deadline as a ``time.monotonic()`` value, which the harness sends
when the timed call starts.  The pipe applies back-pressure, so the loop
is closed.  It prints one JSON line at the end: reads and bytes written,
whole passes, and the seconds spent waiting in ``open``/``write`` (the
pipe full, or no reader yet) against the seconds it ran.
"""

from __future__ import annotations

import fcntl
import json
import os
import sys
import time

from benchmark import traffic
from benchmark.cells import load_cell

CHUNK = 1 << 20
F_SETPIPE_SZ = 1031


def _chunks(pool, pass_no: int):
    """(bytes, records) pieces of about ``CHUNK`` bytes of one pass."""
    head = b"@%08x" % pass_no
    buf, n, size = [], 0, 0
    for rec in pool.records:
        buf.append(head)
        buf.append(rec)
        n += 1
        size += len(rec) + 9
        if size >= CHUNK:
            yield b"".join(buf), n
            buf, n, size = [], 0, 0
    if buf:
        yield b"".join(buf), n


def main() -> int:
    cell_name, seed, fifo = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    cell = load_cell(cell_name)
    pool = traffic.make_pool(cell.config, cell.traffic, seed)
    print("ready", flush=True)
    deadline = float(sys.stdin.readline())
    t0 = time.monotonic()
    waited = 0.0
    fd = os.open(fifo, os.O_WRONLY)
    waited += time.monotonic() - t0
    try:
        fcntl.fcntl(fd, F_SETPIPE_SZ, CHUNK)
    except OSError:
        pass  # a smaller pipe only means more writes
    reads = nbytes = passes = 0
    try:
        while time.monotonic() < deadline:
            for data, n in _chunks(pool, passes):
                if time.monotonic() >= deadline:
                    break
                view = memoryview(data)
                while view:
                    t = time.monotonic()
                    k = os.write(fd, view)
                    waited += time.monotonic() - t
                    view = view[k:]
                reads += n
                nbytes += len(data)
            else:
                passes += 1
    finally:
        os.close(fd)
    ran = time.monotonic() - t0
    print(json.dumps({"reads": reads, "bytes": nbytes, "passes": passes,
                      "waited_s": waited, "ran_s": ran,
                      "bytes_written": traffic.bytes_written()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
