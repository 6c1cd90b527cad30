"""The kit runner's FASTQ batches (``barbell_tpu_torch/utils/fastx_native.py``)
on the CPU:

* one native call a batch (``bbfq_next``) gives the four lists that
  ``split_fastq_header`` makes of today's ``(header, seq, qual)`` tuples:
  every ASCII whitespace byte as the separator, CRLF and blank lines,
  plain, gzip and multi-member gzip files, several files and a named
  pipe, batch sizes 1, 2 and 2048; the errors of today's reader; the
  fallbacks give the same lists;
* the reader thread (:class:`ReadAhead`): an error reaches the taker
  after the earlier batches, closing early leaves no thread and no open
  handle, ``reader.read`` / ``reader.ready`` are recorded; the same
  through the streaming ``kit`` runner;
* the benchmark's ``reader.ready_share`` reads its counter."""

import contextlib
import gzip
import importlib.util
import io
import os
import random
import threading
import time

import pytest

from barbell_tpu_torch import native, timing
from barbell_tpu_torch.utils import fastx_native as fn
from barbell_tpu_torch.utils.fastx import split_fastq_header

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_native = pytest.mark.skipif(
    native.get_lib() is None or native.get_pylib() is None,
    reason="native IO libraries unavailable (no g++, zlib or Python headers)")

#: every ASCII byte for which str.isspace() is true but the newline,
#: which ends the header line
SPACES = [0x09, 0x0B, 0x0C, 0x0D, 0x1C, 0x1D, 0x1E, 0x1F, 0x20]


def _record(header: str, seq: str, eol: str = "\n") -> str:
    return f"@{header}{eol}{seq}{eol}+{eol}{'I' * len(seq)}{eol}"


def _random_reads(n: int, seed: int, headers=None) -> str:
    rng = random.Random(seed)
    out = []
    for i in range(n):
        seq = "".join(rng.choice("ACGTN") for _ in range(rng.randrange(1, 300)))
        header = headers[i % len(headers)].format(i=i) if headers else f"r{i} ch={i % 7}"
        out.append(_record(header, seq))
    return "".join(out)


def _write(path, text: str, how: str = "plain") -> str:
    data = text.encode("ascii", "surrogateescape") if isinstance(text, str) else text
    if how == "gzip":
        data = gzip.compress(data)
    elif how == "multi-member gzip":
        half = len(data) // 2
        data = gzip.compress(data[:half]) + gzip.compress(data[half:])
    with open(path, "wb") as fh:
        fh.write(data)
    return str(path)


def _split(batch):
    """Four lists of one batch of today's tuples."""
    ids = [split_fastq_header(h)[0] for h, _s, _q in batch]
    descs = [split_fastq_header(h)[1] for h, _s, _q in batch]
    return ids, descs, [s for _h, s, _q in batch], [q for _h, _s, q in batch]


def _today(paths, batch_size):
    """Today's batches: the native reader's (header, seq, qual) tuples,
    each header split by ``split_fastq_header``, as four lists."""
    return [_split(b) for b in fn.iter_fastq_batches_native(paths, batch_size)]


def _lists(batches):
    return [(b.ids, b.descs, b.seqs, b.quals) for b in batches]


def _taken(batches):
    """The batches up to an error, and the error (or None)."""
    got = []
    try:
        for b in batches:
            got.append(b)
    except Exception as exc:  # noqa: BLE001 - compared below
        return got, exc
    return got, None


def _open_fds_on(path) -> int:
    real = os.path.realpath(path)
    n = 0
    for fd in os.listdir("/proc/self/fd"):
        with contextlib.suppress(OSError):
            n += os.readlink(f"/proc/self/fd/{fd}") == real
    return n


def _reader_threads():
    return [t for t in threading.enumerate() if t.name == "fastq-reader" and t.is_alive()]


@needs_native
@pytest.mark.parametrize("header", [
    *(f"read{chr(c)}desc {chr(c)}x" for c in SPACES),
    "read\t\t  \tch=1\tstart=2", "read     runid=x  ch=1 ", "read",
    "read   \t", "read\x1f", "", "\x1c lead", "read\x0bdesc\x1cmore  ",
], ids=lambda h: repr(h))
@pytest.mark.parametrize("batch_size", [1, 2, 2048])
def test_header_split_is_split_fastq_headers(tmp_path, header, batch_size):
    text = _random_reads(5, 1, [header + "{i}", header, "n{i}" + header])
    path = _write(tmp_path / "r.fastq", text)
    got = _lists(fn.iter_fastq_batches_auto([path], batch_size))
    assert got == _today([path], batch_size)
    ids, descs, seqs, quals = (sum((list(b[k]) for b in got), []) for k in range(4))
    assert (ids[1], descs[1]) == split_fastq_header(header)
    assert all(type(x) is str for x in ids + descs)
    assert all(type(x) is bytes for x in seqs + quals)


@needs_native
@pytest.mark.parametrize("how", ["plain", "gzip", "multi-member gzip", "several files",
                                 "named pipe", "crlf and blank lines"])
@pytest.mark.parametrize("batch_size", [1, 2, 2048])
def test_sources_give_todays_lists(tmp_path, how, batch_size):
    text = _random_reads(37, 2)
    if how == "several files":
        paths = [_write(tmp_path / "a.fastq", _random_reads(5, 3)),
                 _write(tmp_path / "b.fastq.gz", _random_reads(6, 4), "gzip"),
                 # the last record without its newline, then the next file
                 _write(tmp_path / "c.fastq", text.rstrip("\n")),
                 _write(tmp_path / "d.fastq", _random_reads(3, 5))]
    elif how == "crlf and blank lines":
        crlf = "\n\r\n" + text.replace("\n", "\r\n").replace("\r\n@", "\r\n\n\r\n@")
        paths = [_write(tmp_path / "r.fastq", crlf + "\n\n")]
    elif how == "named pipe":
        paths = [str(tmp_path / "fifo")]
        os.mkfifo(paths[0])
    else:
        paths = [_write(tmp_path / "r.fastq", text, how)]

    def read_all(read):
        feeder = None
        if how == "named pipe":
            feeder = threading.Thread(target=_write, args=(paths[0], text))
            feeder.start()
        try:
            return read(paths, batch_size)
        finally:
            if feeder is not None:
                feeder.join(30)
                assert not feeder.is_alive()

    got = read_all(lambda p, b: _lists(fn.iter_fastq_batches_auto(p, b)))
    assert got == read_all(_today)
    assert sum(len(b[0]) for b in got) >= 37


@needs_native
def test_a_batch_past_the_old_data_cap_is_one_batch(tmp_path):
    """Three records of 12 MB each (sequence and quality): today's 32 MB
    buffer splits them over two batches, the one-call batch holds all
    three."""
    seq = "ACGT" * (6 << 18)  # 6 MiB
    path = _write(tmp_path / "big.fastq", "".join(_record(f"r{i} x", seq) for i in range(3)))
    (batch,) = list(fn.iter_fastq_batches_auto([path], 2048))
    assert batch.ids == ["r0", "r1", "r2"] and batch.descs == ["x"] * 3
    assert all(s == seq.encode() for s in batch.seqs)
    assert len(_today([path], 2048)) == 2


@needs_native
@pytest.mark.parametrize("case", ["non-ascii header", "no @", "no +", "lengths differ",
                                  "truncated record", "text before a record"])
@pytest.mark.parametrize("batch_size", [1, 2, 2048])
def test_errors_are_todays(tmp_path, case, batch_size):
    good = _random_reads(5, 6)
    bad = {
        "non-ascii header": _record("réad x", "ACGT"),
        "no @": "r9\nACGT\n+\nIIII\n",
        "no +": "@r9\nACGT\n-\nIIII\n",
        "lengths differ": "@r9\nACGT\n+\nIII\n",
        "truncated record": "@r9\nACGT\n",
        "text before a record": "junk\n" + _record("r9", "AC"),
    }[case]
    path = _write(tmp_path / "r.fastq", (good + bad + good).encode("utf-8"))
    got, err = _taken(fn.iter_fastq_batches_auto([path], batch_size))
    want, want_err = _taken(fn.iter_fastq_batches_native([path], batch_size))
    assert type(err) is type(want_err) and str(err) == str(want_err)
    if case == "non-ascii header":
        assert isinstance(err, UnicodeDecodeError)
        with pytest.raises(UnicodeDecodeError) as exc:
            "réad x".encode("utf-8").decode("ascii")
        assert str(err) == str(exc.value)
    else:
        assert isinstance(err, ValueError) and str(err) == "malformed FASTQ input"
    assert _lists(got) == [_split(b) for b in want]


@pytest.mark.parametrize("missing", ["batch library", "both native libraries"])
@pytest.mark.parametrize("batch_size", [1, 2, 2048])
def test_fallback_gives_the_same_lists(tmp_path, monkeypatch, missing, batch_size):
    path = _write(tmp_path / "r.fastq",
                  _random_reads(23, 7, ["{i}\x1fa", "{i}\tb  c", "{i}", "{i}   "]))
    want = _lists(fn.iter_fastq_batches_auto([path], batch_size))
    monkeypatch.setattr(fn, "get_pylib", lambda: None)
    if missing == "both native libraries":
        monkeypatch.setattr(fn, "get_lib", lambda: None)
    got = list(fn.iter_fastq_batches_auto([path], batch_size))
    assert all(isinstance(b, fn.FastqBatch) for b in got)
    assert _lists(got) == want
    assert sum(len(b) for b in got) == 23


def test_a_slice_of_a_batch_is_a_batch():
    b = fn.FastqBatch(["a", "b", "c"], ["", "x", ""], [b"A", b"C", b"G"], [b"I", b"J", b"K"])
    half = b[: len(b) // 2]
    assert isinstance(half, fn.FastqBatch) and len(half) == 1
    assert (half.ids, half.descs, half.seqs, half.quals) == (["a"], [""], [b"A"], [b"I"])


# --- the reader thread ---------------------------------------------------


def _wait_ready(ra, timeout=10.0):
    """Until the reader thread has a batch waiting (or has ended)."""
    end = time.monotonic() + timeout
    while not ra._q.qsize() and time.monotonic() < end:
        time.sleep(0.002)


@needs_native
def test_reader_error_reaches_the_taker_after_the_earlier_batches(tmp_path):
    text = _random_reads(4, 8) + "@r4\nACGT\n+\nIII\n" + _random_reads(4, 9)
    path = _write(tmp_path / "r.fastq", text)
    ra = fn.ReadAhead(fn.iter_fastq_batches_auto([path], 2))
    written = []
    try:
        for _ in range(2):
            _wait_ready(ra)  # the reader is ahead: the error is read already
            written.extend(ra.take().ids)
        with pytest.raises(ValueError, match="^malformed FASTQ input$"):
            ra.take()
        assert written == ["r0", "r1", "r2", "r3"]
        assert ra.take() is None
    finally:
        ra.close()
    assert not _reader_threads() and _open_fds_on(path) == 0


@needs_native
@pytest.mark.parametrize("source", ["file", "named pipe"])
def test_closing_early_leaves_no_thread_and_no_handle(tmp_path, source):
    text = _random_reads(400, 10)
    if source == "file":
        path = _write(tmp_path / "r.fastq", text)
        feeder = None
    else:
        path = str(tmp_path / "fifo")
        os.mkfifo(path)

        def feed():
            with contextlib.suppress(BrokenPipeError):
                _write(path, text)

        feeder = threading.Thread(target=feed)
        feeder.start()
    ra = fn.ReadAhead(fn.iter_fastq_batches_auto([path], 8))
    assert len(ra.take()) == 8
    _wait_ready(ra)
    ra.close()
    assert not _reader_threads()
    assert _open_fds_on(path) == 0
    if feeder is not None:
        feeder.join(10)
        assert not feeder.is_alive()


@needs_native
def test_reader_spans_and_counter(tmp_path, monkeypatch):
    monkeypatch.setattr(timing, "ENABLED", True)
    timing.TIMINGS.clear()
    try:
        path = _write(tmp_path / "r.fastq", _random_reads(6, 11))
        ra = fn.ReadAhead(fn.iter_fastq_batches_auto([path], 2))
        n = 0
        while True:
            _wait_ready(ra)
            b = ra.take()
            if b is None:
                break
            n += 1
        ra.close()
        t = {k: list(v) for k, v in timing.TIMINGS.items()}
    finally:
        timing.TIMINGS.clear()
    assert n == 3
    wall, calls, cpu = t["reader.read"]
    assert calls == 4 and wall >= 0 and cpu >= 0  # three batches and the end
    assert t["reader.ready"] == [0.0, 4]


def test_many_readers_under_a_short_switch_interval(tmp_path):
    """Eight readers at once, more than the cores a test worker has, the
    interpreter switching threads every microsecond: each taker gets its
    file's batches whole and in order, then every thread ends."""
    import sys

    paths = [_write(tmp_path / f"r{k}.fastq", _random_reads(50, 20 + k)) for k in range(8)]
    want = [_lists(fn.iter_fastq_batches_auto([p], 3)) for p in paths]
    got = [[] for _ in paths]

    def take_all(k):
        ra = fn.ReadAhead(fn.iter_fastq_batches_auto([paths[k]], 3))
        try:
            while (b := ra.take()) is not None:
                got[k].append((b.ids, b.descs, b.seqs, b.quals))
        finally:
            ra.close()

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        takers = [threading.Thread(target=take_all, args=(k,)) for k in range(8)]
        for t in takers:
            t.start()
        for t in takers:
            t.join(60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in takers)
    assert got == want
    assert not _reader_threads()


def test_flag_off_records_no_reader_spans(tmp_path, monkeypatch):
    monkeypatch.setattr(timing, "ENABLED", False)
    timing.TIMINGS.clear()
    path = _write(tmp_path / "r.fastq", _random_reads(6, 12))
    ra = fn.ReadAhead(fn.iter_fastq_batches_auto([path], 2))
    while ra.take() is not None:
        pass
    ra.close()
    assert timing.TIMINGS == {}


# --- through the streaming kit runner ------------------------------------


def _kit_reads(path, n, bad_at=None):
    from barbell_tpu_torch.sim.simulate import default_barcodes, rapid_adapter, random_sequence

    rng = random.Random(13)
    bars = default_barcodes(6)
    with open(path, "w") as fh:
        for i in range(n):
            s = (rapid_adapter(bars[i % 6][1]) + bytes(random_sequence(rng, 300))).decode()
            q = "I" * (len(s) - (i == bad_at))
            fh.write(f"@k{i} ch={i}\n{s}\n+\n{q}\n")
    return str(path)


def _kit(path, out, **kw):
    from barbell_tpu_torch.stages.kit import KitRunConfig, demux_using_kit

    os.makedirs(out, exist_ok=True)
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        demux_using_kit([path], KitRunConfig(kit_name="SQK-RBK114-96", output_folder=str(out),
                                             batch_size=2, **kw), device="cpu")


def test_kit_records_the_reader_and_keeps_runner_parse(tmp_path, monkeypatch):
    """Under ``BARBELL_TIMING=1`` the streaming runner takes each batch
    as ``runner.parse`` (three batches and the end: four), the reader
    thread times each native call as ``reader.read``, and ``reader.ready``
    counts no more takes than there were."""
    monkeypatch.setattr(timing, "ENABLED", True)
    timing.TIMINGS.clear()
    try:
        _kit(_kit_reads(tmp_path / "r.fastq", 6), tmp_path / "out")
        t = {k: list(v) for k, v in timing.TIMINGS.items()}
    finally:
        timing.TIMINGS.clear()
    assert t["runner.parse"][1] == 4 and t["reader.read"][1] == 4
    assert 0 <= t.get("reader.ready", [0.0, 0])[1] <= 4
    assert not _reader_threads()
    rows = (tmp_path / "out" / "annotation.tsv").read_text().splitlines()[1:]
    assert {r.split("\t")[0] for r in rows} == {f"k{i}" for i in range(6)}


def test_kit_raises_the_readers_error_after_the_earlier_batches(tmp_path, monkeypatch):
    """A malformed record in the fourth batch: with one batch in flight
    the runner has written batches one and two when it asks for the
    fourth, and raises today's error; no reader thread, no open input."""
    from barbell_tpu_torch.models import pipeline

    monkeypatch.setattr(pipeline, "DEFAULT_PIPELINE_DEPTH", 1)
    path = _kit_reads(tmp_path / "r.fastq", 10, bad_at=7)
    with pytest.raises(ValueError, match="^malformed FASTQ input$"):
        _kit(path, tmp_path / "out")
    rows = (tmp_path / "out" / "annotation.tsv").read_text().splitlines()[1:]
    assert {r.split("\t")[0] for r in rows} == {"k0", "k1", "k2", "k3"}
    assert not _reader_threads() and _open_fds_on(path) == 0


def test_kit_exit_downstream_stops_the_reader(tmp_path, monkeypatch):
    """An exception downstream of the reader (the engine's map here)
    closes the runner's batches: the reader thread stops and the input
    is closed."""
    from barbell_tpu_torch.models import pipeline

    def broken(engine, batches, *a, **k):
        next(iter(batches))
        raise RuntimeError("downstream")
        yield  # noqa: unreachable - makes this a generator

    monkeypatch.setattr(pipeline, "engine_map_batches", broken)
    path = _kit_reads(tmp_path / "r.fastq", 40)
    with pytest.raises(RuntimeError, match="downstream"):
        _kit(path, tmp_path / "out")
    assert not _reader_threads() and _open_fds_on(path) == 0


# --- the benchmark's metric ------------------------------------------------


def _metric():
    path = os.path.join(REPO, "benchmark", "metrics", "reader.ready_share.py")
    spec = importlib.util.spec_from_file_location("fastq_batches_ready_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("timings,want", [
    ({"reader.read": [0.5, 8, 0.4], "reader.ready": [0.0, 6]}, 75.0),
    ({"reader.read": [0.5, 8, 0.4]}, 0.0),
    ({}, None),  # an untimed run
    ({"runner.parse": [0.25, 3, 0.2], "encode": [0.4, 2]}, None),  # the parent's spans
])
def test_ready_share_reads_its_counter(timings, want):
    got = _metric()({"reads": 2000, "window_s": 4.0, "timings": timings})
    assert got == (None if want is None else pytest.approx(want))
