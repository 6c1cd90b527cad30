"""The port's cache of captured device calls
(``barbell_tpu_torch/models/graphs.py``), the counterpart of the JAX
engine's ``jax.jit`` cache, on the CPU:

* capture safety: the fused call makes no host sync, reads no tensor on
  the host and takes no shape from data (what a CUDA-graph capture
  cannot hold), on every path it serves; the kernels' plain versions
  are exempt, since on the card the kernels stand in their place;
* the cache key splits a run of batches exactly where the JAX engine's
  static arguments (``_group_statics`` / ``_fused_statics`` and the
  blob's spans) do, with both engines' device calls stubbed out;
* the cache's semantics through a CPU stand-in for the capture that
  reruns the eager call on the instance's static buffers: the eager
  outputs, the pool bound under threads, eviction, launch counts, and a
  failed capture or replay raising.

The CUDA capture itself runs only on the card (``chip_smoke.py``
``[graphs]``)."""

import gc
import threading
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs
jax = pytest.importorskip("jax")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from barbell_tpu.models.pipeline import JaxDemuxEngine  # noqa: E402
from barbell_tpu_torch import _build  # noqa: E402
from barbell_tpu_torch.models.graphs import GraphCache  # noqa: E402
from barbell_tpu_torch.models.pipeline import TorchDemuxEngine  # noqa: E402
from barbell_tpu_torch.models.twotier import EndsPlan, TwoTierDemuxEngine  # noqa: E402
from barbell_tpu_torch.ops import composite as tcomp  # noqa: E402

from test_torch_upload import JAX, PORT, _groups, _reads, _tables_equal  # noqa: E402

#: the kernel wrappers the fused call reaches (their plain versions on
#: the CPU)
KERNELS = ("myers_topk", "window_valleys", "window_trace", "window_interval",
           "rank_pass1_split", "rank_pass1")


def _tensors(out):
    return [out] if isinstance(out, torch.Tensor) else [
        t for t in out if isinstance(t, torch.Tensor)]


class _Rerun:
    """CPU stand-in for a captured graph: its output (a tensor, or a
    tuple holding tensors) is allocated once and each replay reruns the
    call on the same static inputs into it, with the wrappers' launch
    counts held back as a graph's replay holds them (the cache counts
    them)."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, inputs
        self.output = fn(inputs)

    def replay(self):
        with _build.recording_launches():
            new = self.fn(self.inputs)
        for static, t in zip(_tensors(self.output), _tensors(new)):
            static.copy_(t)


def _standin(fn, inputs, device):
    r = _Rerun(fn, inputs)
    return r, r.output


def _graph_engine(engine, capture=_standin, per_key=8, max_keys=16):
    """``engine`` with graphs on through a cache of ``capture``."""
    engine._graphs = GraphCache(per_key=per_key, max_keys=max_keys, capture=capture)
    engine.cuda_graphs = True
    return engine


# ------------------------------------------------------------ capture safety


#: Tensor methods that read a tensor on the host; ``tolist`` dispatches
#: no op at all and ``numpy`` only ``aten.detach``, so the dispatch mode
#: alone cannot see them
HOST_READS = ("tolist", "numpy", "item", "__int__", "__float__", "__bool__",
              "__index__")


class _NoSync(TorchDispatchMode):
    """Raises on an op that makes the host wait for the device or takes
    an output shape from data, and on a host read of a tensor
    (``HOST_READS``, patched onto ``torch.Tensor`` while the mode is
    on), outside the exempt kernel calls."""

    NAMES = ("_local_scalar_dense", "nonzero", "masked_select", "bincount",
             "is_nonzero", "equal", "allclose")

    def __init__(self):
        super().__init__()
        self.exempt = 0
        self.ops = 0
        self._saved = []

    def _guard(self, name, orig):
        def read(t, *args, **kwargs):
            if not self.exempt:
                raise AssertionError(f"host read Tensor.{name} in a captured call")
            return orig(t, *args, **kwargs)

        return read

    def __enter__(self):
        saved = {n: torch.Tensor.__dict__.get(n) for n in HOST_READS}
        self._saved.append(saved)
        for n in HOST_READS:
            setattr(torch.Tensor, n, self._guard(n, getattr(torch.Tensor, n)))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for n, orig in self._saved.pop().items():
                if orig is None:
                    delattr(torch.Tensor, n)
                else:
                    setattr(torch.Tensor, n, orig)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.exempt:
            self.ops += 1
            name = func._schema.name.split("::")[1]
            base = name.rstrip("_")
            bad = (base in self.NAMES or base.startswith(("unique", "_unique"))
                   or (base == "repeat_interleave" and func._overloadname == "Tensor"
                       and kwargs.get("output_size") is None))
            if base in ("index", "index_put"):
                bad = bad or any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                                 for i in args[1] if i is not None)
            if bad:
                raise AssertionError(f"capture-unsafe op {func} in a captured call")
        return func(*args, **kwargs)


def _no_sync_calls(monkeypatch):
    """Runs every fused call under :class:`_NoSync` (the kernel wrappers
    exempt); returns the list of calls' H_cap."""
    calls = []
    mode = _NoSync()
    fused = tcomp.demux_call_fused

    def call(groups, parts, **kw):
        calls.append(kw["H_cap"])
        with mode:
            return fused(groups, parts, **kw)

    for name in KERNELS:
        def kernel(*args, _fn=getattr(tcomp, name)):
            mode.exempt += 1
            try:
                return _fn(*args)
            finally:
                mode.exempt -= 1

        monkeypatch.setattr(tcomp, name, kernel)
    monkeypatch.setattr(tcomp, "demux_call_fused", call)
    return calls, mode


#: path: (engine keyword arguments, environment, two groups, reads)
SAFETY_PATHS = {
    "ends": (dict(ends_window=(128, 128)), {}, False, dict(long_at=(1, 4))),
    "whole-read": ({}, {}, False, dict(long_at=(1, 4))),
    "two-group": ({}, {}, True, dict(long_at=(2,))),
    "pack0": ({}, {"BARBELL_PACK_MODE": "0"}, False, dict(long_at=(2,))),
    "pack1": ({}, {"BARBELL_PACK_MODE": "1"}, False, dict(long_at=(2,), iupac_at=(0,))),
    "wire": (dict(meta_mode="wire"), {}, False, dict(long_at=(2,), iupac_at=(3,))),
    "retry": ({}, {}, False, {}),
}


@pytest.mark.parametrize("path", list(SAFETY_PATHS))
def test_fused_call_is_capture_safe(monkeypatch, path):
    """The fused call on each path: no host sync, no shape from data;
    ``retry`` starts every batch at 2 hit lanes, so the call runs again
    at the overflow retry's capacity."""
    kw, env, two, reads = SAFETY_PATHS[path]
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    engine = TorchDemuxEngine(_groups(PORT, two), device="cpu", max_row_len=256, **kw)
    if path == "retry":
        monkeypatch.setattr(engine, "_h_cap", lambda B, plan, R: 2)
    calls, mode = _no_sync_calls(monkeypatch)
    engine.demux_batch_table(*_reads(6, 3, **reads))
    assert calls and mode.ops > 100
    if path == "retry":
        assert len(calls) == 2 and calls[1] > calls[0] == 2, calls


# ------------------------------------------------------------ key vs JAX


class _Stub:
    """Stands in for both engines' device calls: records each call's key
    and returns a zero hit buffer (no hits) whose total lane overflows
    the capacity on the first call after :meth:`overflow`."""

    def __init__(self):
        self.keys = []
        self._overflow = False

    def overflow(self):
        self._overflow = True

    def out(self, key, H_cap):
        self.keys.append(key)
        buf = np.zeros(H_cap * tcomp.REC_COLS + 4096 + 1, dtype=np.int32)
        if self._overflow:
            buf[-1] = H_cap + 1
            self._overflow = False
        return buf


def _stub_port(engine, stub):
    class Cache:
        def run(self, key, fn, inputs):
            return torch.from_numpy(stub.out(key, dict(key[2])["H_cap"])), None

    engine._graphs = Cache()
    engine.cuda_graphs = True


def _stub_jax(engine, stub):
    def group(gplan, dev_in, pack_mode, L, step, H_cap, extra=None):
        st = engine._group_statics(gplan, pack_mode, L, step, H_cap, extra)
        return stub.out(("mono", dev_in[2]) + tuple(sorted(st.items())), H_cap)

    def fused(dev_in, pack_mode, L, step, H_cap, extra=None):
        gs, common = engine._fused_statics(pack_mode, L, step, H_cap, extra)
        return stub.out(("fused", dev_in[2], gs, common), H_cap)

    engine._dispatch_group = group
    engine._dispatch_all_groups = fused


def _partition(keys):
    """Each call's index of first occurrence of its key."""
    first = {}
    return [first.setdefault(k, i) for i, k in enumerate(keys)]


@pytest.mark.parametrize("two", [False, True], ids=["one-group", "two-group"])
def test_key_splits_batches_as_jax_statics(two):
    """A run of batches (two row buckets, then, on the one-group kit, a
    forced overflow retry whose capacity sticks): the port's key changes
    at exactly the calls where the JAX engine's key of static arguments
    and spans changes."""
    stubs = {}
    for pkg, eng_cls, stub_fn in ((PORT, TorchDemuxEngine, _stub_port),
                                  (JAX, JaxDemuxEngine, _stub_jax)):
        kw = dict(device="cpu") if pkg is PORT else dict(devices=jax.devices()[:1])
        engine = eng_cls(_groups(pkg, two), max_row_len=256, **kw)
        stub = stubs[pkg is PORT] = _Stub()
        stub_fn(engine, stub)
        runs = [(6, 1), (7, 2), (12, 3)]
        if not two:
            runs += [(6, 4, "overflow"), (6, 5), (12, 6)]
        for n, seed, *over in runs:
            if over:
                stub.overflow()
            engine.demux_batch_table(*_reads(n, seed, hi=150))
    port, ref = stubs[True].keys, stubs[False].keys
    assert len(port) == len(ref)
    assert _partition(port) == _partition(ref)
    assert len(set(port)) == (2 if two else 4), _partition(port)


# ------------------------------------------------------------ semantics


def test_cached_engine_matches_eager():
    """Batches through the cache (two of one key, then one of another)
    give the eager call's fetched buffers bit for bit and its tables;
    one capture a key, replays after."""
    batches = [_reads(6, 1, hi=150), _reads(5, 2, hi=150), _reads(12, 3, hi=150)]
    fetched = {}
    tables = {}
    for graphs in (True, False):
        engine = TorchDemuxEngine(_groups(PORT), device="cpu", max_row_len=256)
        if graphs:
            graphs_engine = _graph_engine(engine)
        got = fetched[graphs] = []
        fetch = engine._fetch

        def record(launched, _fetch=fetch, _got=got):
            out = _fetch(launched)
            _got.append(out.copy())
            return out

        engine._fetch = record
        tables[graphs] = [engine.demux_batch_table(*b) for b in batches]
    assert len(fetched[True]) == len(fetched[False]) == len(batches)
    for a, b in zip(fetched[True], fetched[False]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tables[True], tables[False]):
        _tables_equal(a, b)
    assert (graphs_engine._graphs.captures, graphs_engine._graphs.replays) == (2, 1)


def test_cache_counts_captures_and_replays():
    """The first use of a key captures, later uses replay; a fake kernel
    wrapper counts one launch a call either way (the eager first use
    counts as it runs, a replay counts what its capture launched)."""

    def wrapper():
        pass

    wrapper.launches = 0

    def fn(inp):
        _build.count_launch(wrapper)
        return inp["x"] * 2

    cache = GraphCache(per_key=2, capture=_standin)
    for i in range(4):
        x = torch.full((3,), float(i))
        out, inst = cache.run("k", fn, {"x": x})
        assert torch.equal(out, 2 * x)
        cache.release(inst)
    assert (cache.captures, cache.replays, wrapper.launches) == (1, 3, 4)
    assert cache.instances("k") == 1


@pytest.mark.parametrize("threads", [8, 12])
def test_pool_holds_at_most_per_key_instances(threads):
    """``threads`` workers hammer one key of a pool of 8: each gets its
    own inputs' result while it holds its instance, and the key never
    holds more than 8 instances (more workers than that wait)."""
    cache = GraphCache(per_key=8, capture=_standin)
    held, peak, errors = [0], [0], []
    lock = threading.Lock()

    def fn(inp):
        time.sleep(0.001)
        return inp["x"] + 1

    def work(t):
        try:
            for i in range(15):
                x = torch.full((4,), float(1000 * t + i))
                out, inst = cache.run("k", fn, {"x": x})
                with lock:
                    held[0] += 1
                    peak[0] = max(peak[0], held[0])
                time.sleep(0.001)
                assert torch.equal(out, x + 1)
                assert cache.instances("k") <= 8
                with lock:
                    held[0] -= 1
                cache.release(inst)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    assert not errors, errors[0]
    assert peak[0] <= 8 and 1 <= cache.instances("k") <= 8
    assert cache.captures == cache.instances("k")
    assert cache.captures + cache.replays == 15 * threads


def test_one_capture_of_a_key_at_a_time():
    """Eight threads reaching a fresh key together: the key is captured
    once at a time, and the threads take its instances back as they are
    handed in, so the key ends with fewer instances than threads."""
    lock = threading.Lock()
    live, peak = [0], [0]

    def slow_capture(fn, inputs, device):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.05)
        with lock:
            live[0] -= 1
        return _standin(fn, inputs, device)

    cache = GraphCache(per_key=8, capture=slow_capture)
    start = threading.Barrier(8)
    errors = []

    def work(t):
        try:
            start.wait()
            for i in range(5):
                x = torch.full((2,), float(10 * t + i))
                out, inst = cache.run("k", lambda inp: inp["x"] * 2, {"x": x})
                assert torch.equal(out, 2 * x)
                cache.release(inst)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    pool = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    assert not errors, errors[0]
    assert peak[0] == 1
    assert cache.captures == cache.instances("k") < 8
    assert cache.captures + cache.replays == 40


def test_eviction_frees_the_least_recent_key():
    """Past ``max_keys`` the least recently used key goes, and its
    instances with it; an instance checked out when its key goes is
    dropped when handed back."""
    cache = GraphCache(per_key=2, max_keys=2, capture=_standin)

    def fn(inp):
        return inp["x"] * 3

    x = {"x": torch.ones(2)}
    _out, a = cache.run("a", fn, x)
    cache.release(a)
    dead_a = weakref.ref(a.output)
    _out, b = cache.run("b", fn, x)  # held across the eviction
    dead_b = weakref.ref(b.output)
    del a
    _out, a2 = cache.run("a", fn, x)  # "a" is the newest again
    cache.release(a2)
    _out, c = cache.run("c", fn, x)  # evicts "b"
    cache.release(c)
    assert cache.keys() == ["a", "c"] and cache.instances("b") == 0
    cache.release(b)
    del b, _out
    gc.collect()
    assert dead_b() is None
    assert dead_a() is not None  # "a" survived: its instance is pooled
    _out, d = cache.run("d", fn, x)  # evicts "a"
    cache.release(d)
    del a2, _out
    gc.collect()
    assert dead_a() is None and cache.keys() == ["c", "d"]


def test_failed_capture_raises_and_never_runs_eagerly():
    """A capture that fails raises out of the engine's batch (no eager
    fallback hides it) and leaves no instance; a replay that fails
    raises too."""

    def broken(fn, inputs, device):
        raise RuntimeError("capture failed")

    engine = _graph_engine(TorchDemuxEngine(_groups(PORT), device="cpu",
                                            max_row_len=256), capture=broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        engine.demux_batch_table(*_reads(6, 1))
    assert engine._graphs.captures == 0 and not any(
        engine._graphs.instances(k) for k in engine._graphs.keys())

    class BadReplay(_Rerun):
        def replay(self):
            raise RuntimeError("replay failed")

    def capture(fn, inputs, device):
        r = BadReplay(fn, inputs)
        return r, r.output

    cache = GraphCache(per_key=1, capture=capture)
    _out, inst = cache.run("k", lambda inp: inp["x"] + 1, {"x": torch.ones(2)})
    cache.release(inst)
    with pytest.raises(RuntimeError, match="replay failed"):
        cache.run("k", lambda inp: inp["x"] + 1, {"x": torch.ones(2)})
    assert cache.instances("k") == 0


def test_cuda_graphs_switch():
    """Graphs are off on a CPU engine (the call runs eagerly) and the
    two-tier engine's switch sets both tiers."""
    assert TorchDemuxEngine(_groups(PORT), device="cpu").cuda_graphs is False
    tt = TwoTierDemuxEngine(_groups(PORT), EndsPlan((128, 128), (256, 128), 40),
                            device="cpu", max_row_len=256)
    assert tt.cuda_graphs is False
    tt.cuda_graphs = True
    assert tt.shallow.cuda_graphs and tt.deep.cuda_graphs


def test_dropped_engine_frees_its_graphs_without_the_collector():
    """Nothing of the cache is in a reference cycle: dropping the engine
    frees its graphs at once, with the cyclic collector off (a graph the
    collector freed inside another thread's capture would invalidate
    that capture)."""
    engine = _graph_engine(TorchDemuxEngine(_groups(PORT), device="cpu",
                                            max_row_len=256))
    engine.demux_batch_table(*_reads(4, 1, hi=150))
    (key,) = engine._graphs.keys()
    inst = engine._graphs._entries[key].idle[0]
    dead = weakref.ref(inst.output)
    del inst
    enabled = gc.isenabled()
    gc.disable()
    try:
        del engine
        assert dead() is None
    finally:
        if enabled:
            gc.enable()
