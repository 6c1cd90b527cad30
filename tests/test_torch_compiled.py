"""``compiled`` (``barbell_tpu_torch/models/graphs.py``), the port's
``jax.jit``, on the CPU, for every device function ``barbell_tpu`` jits
outside the engine: the five staged composites, the six stage functions
of ``ops/device.py`` and the mesh's flank step.

On the CPU a compiled function runs as written; these tests send its
calls through the cache path instead (a fresh cache whose capture is
``test_torch_graphs.py``'s stand-in, ``_Rerun``, run under the strict
capture-safety checker ``_NoSync`` with the kernel wrappers exempt):

* what a capture records makes no host sync, no host read of a tensor
  and takes no shape from data, and the checker catches each kind of
  host read (it would have caught ``flank_ends``' old ``pattern.tolist()``);
* a key's first call captures and a second call with other inputs
  replays; both equal the eager function (``fn.__wrapped__``) and the
  JAX package on the same inputs, and the first result is unchanged by
  the second call (results own their memory);
* the keys split a run of calls where JAX's jit cache does
  (``_cache_size()``), except for the scalars a port kernel takes by
  value as a launch argument, which JAX traces and a graph bakes in:
  ``alpha_scaled`` of ``flank_scan`` (the window valley kernel),
  ``alpha_scaled`` / ``region_a`` / ``region_b`` of ``flank_trace`` (the
  window trace kernel) and ``iv_a`` / ``iv_b`` of ``barcode_rank`` (the
  window interval kernel): a new value of one of them is a new key;
* a failed capture raises, and nothing runs eagerly in its place.

The CUDA capture itself runs only on the card (``chip_smoke.py``
``[stage_ops]``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test worker: the workers share the CPUs
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu.ops import composite as jcomp  # noqa: E402
from barbell_tpu.ops import device as jdev  # noqa: E402
from barbell_tpu.ops.oracle import scale_k  # noqa: E402
from barbell_tpu.ops.pallas_myers import pattern_words  # noqa: E402
from barbell_tpu.parallel.mesh import make_mesh  # noqa: E402
from barbell_tpu.parallel.mesh import shard_rows as jax_shard_rows  # noqa: E402
from barbell_tpu.parallel.mesh import sharded_flank_step as jax_flank_step  # noqa: E402
from barbell_tpu_torch.models import graphs  # noqa: E402
from barbell_tpu_torch.models.graphs import GraphCache, compiled  # noqa: E402
from barbell_tpu_torch.ops import composite as comp  # noqa: E402
from barbell_tpu_torch.ops import device as dev  # noqa: E402
from barbell_tpu_torch.parallel import mesh as pmesh  # noqa: E402

from test_torch_graphs import HOST_READS, KERNELS, _NoSync, _Rerun  # noqa: E402
from test_torch_stage_ops import (ALPHA, BASES, _dp_case, _eq, _flank_rows,  # noqa: E402
                                  _flank_scan_vs_jax, _group, _noisy, _rank_case,
                                  _t, _trace_case)

K_HITS = 4


def _first_device(tensors):
    return next(iter(tensors)).device


@pytest.fixture
def through_cache(monkeypatch):
    """Compiled calls on CPU tensors go through a fresh cache whose
    capture reruns the call (``_Rerun``) under the strict checker, the
    kernel wrappers exempt; returns (cache, checker, eager), ``eager(fn,
    ...)`` running ``fn.__wrapped__`` as on the CPU (its nested compiled
    calls as written, not through the cache)."""
    mode = _NoSync()
    as_written = graphs._graph_device
    for name in KERNELS:
        def kernel(*args, _fn=getattr(comp, name), **kw):
            mode.exempt += 1
            try:
                return _fn(*args, **kw)
            finally:
                mode.exempt -= 1

        monkeypatch.setattr(comp, name, kernel)

    def capture(fn, inputs, device):
        with mode:
            r = _Rerun(fn, inputs)
        return r, r.output

    def eager(fn, *args, **kw):
        with monkeypatch.context() as mp:
            mp.setattr(graphs, "_graph_device", as_written)
            return fn.__wrapped__(*args, **kw)

    cache = GraphCache(per_key=1, capture=capture)
    monkeypatch.setattr(graphs, "COMPILED", cache)
    monkeypatch.setattr(graphs, "_graph_device", _first_device)
    return cache, mode, eager


def _same(got, want, what):
    """Equal outputs (integers equal, floats bit for bit), field by
    field for a NamedTuple."""
    if hasattr(got, "_fields"):
        for f in got._fields:
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), (what, f)
            if g is not None:
                _same(g, w, f"{what}.{f}")
    else:
        _eq(got, want, what)


def _copy(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return None if out is None else type(out)(*map(_copy, out))


# ------------------------------------------------------------------ the calls
#
# Each case gives, for a seed, (port args, port kwargs, JAX output thunk)
# at small shapes; seeds 0 and 1 share a key.


def _ends_case(seed, B=8, L=160):
    rng = np.random.default_rng(seed)
    g, _ = _group()
    flank = np.asarray(g.flank_masks, dtype=np.uint8)
    rows = BASES[rng.integers(0, 4, (B, L))]
    for b in range(B):
        seg = _noisy(rng, flank, int(rng.integers(0, 12)))[: L - 20]
        p = int(rng.integers(0, L - len(seg)))
        rows[b, p : p + len(seg)] = seg
        rows[b, int(rng.integers(100, L + 1)):] = 0
    rows[2, 7] = 15
    start = rng.choice([-1, 0, 3], B).astype(np.int32)
    end = rng.integers(90, L + 3, B).astype(np.int32)
    lo = rng.integers(0, 30, B).astype(np.int32)
    hi = rng.integers(90, L + 1, B).astype(np.int32)
    return g, flank, rows, start, end, lo, hi


def flank_ends_call(seed, B=8):
    _g, flank, rows, start, end, _lo, _hi = _ends_case(seed, B)
    arrays = (flank, rows, start, end)
    return ([_t(a) for a in arrays] + [ALPHA], {},
            lambda: jdev.flank_ends(*map(jnp.asarray, arrays), jnp.int32(ALPHA)))


def find_hits_call(seed, K=K_HITS):
    g, flank, rows, start, end, lo, hi = _ends_case(seed)
    ends = dev.flank_ends.__wrapped__(_t(flank), _t(rows), _t(start), _t(end), ALPHA)
    k = scale_k(g.k_cutoff) - 100 * seed
    return ([ends, _t(lo), _t(hi), k], {"K": K},
            lambda: jdev.find_hits(jnp.asarray(ends.numpy()), jnp.asarray(lo),
                                   jnp.asarray(hi), jnp.int32(k), K))


def window_dp_call(seed, H=9):
    _rng, pats, wins, ledge, rpos, _w = _dp_case(seed, H)
    arrays = (pats, wins, ledge, rpos)
    return ([_t(a) for a in arrays] + [ALPHA], {},
            lambda: jdev.window_dp(*map(jnp.asarray, arrays), jnp.int32(ALPHA)))


def traceback_reduce_call(seed, H=None):
    rng, pats, wins, ledge, rpos, _w = _dp_case(seed)
    if H is not None:
        wins, ledge, rpos = wins[:H], ledge[:H], rpos[:H]
    H, W = wins.shape
    P, m = pats.shape
    moves = dev.window_dp.__wrapped__(_t(pats), _t(wins), _t(ledge), _t(rpos), ALPHA).moves
    end_j = rng.integers(0, W + 1, (H, P)).astype(np.int32)
    valid = rng.integers(0, 4, (H, P)) != 0
    scal = (2 + seed, m - 3, 3, m - 2 - seed)
    return ([moves, _t(end_j), _t(valid), *scal], {"m": m, "W": W},
            lambda: jdev.traceback_reduce(jnp.asarray(moves.numpy()), jnp.asarray(end_j),
                                          jnp.asarray(valid), *map(jnp.int32, scal),
                                          m=m, W=W))


SUMMARY_FLAGS = dict(with_lodhi=True, with_region=True, with_interval=True,
                     with_start=True)


def window_dp_summary_call(seed, flags=SUMMARY_FLAGS):
    _rng, pats, wins, ledge, rpos, _w = _dp_case(2 + seed)
    m = pats.shape[1]
    arrays = (pats[None], wins, ledge, rpos)
    scal = (ALPHA, 2, m - 3 - seed, 3 + seed, m - 2)
    return ([_t(a) for a in arrays] + list(scal), dict(flags),
            lambda: jdev.window_dp_summary(*map(jnp.asarray, arrays),
                                           *map(jnp.int32, scal), **flags))


def best_valley_per_pattern_call(seed, H=9):
    _rng, pats, wins, ledge, rpos, w_len = _dp_case(seed, H)
    ends = dev.window_dp.__wrapped__(_t(pats), _t(wins), _t(ledge), _t(rpos), ALPHA).ends
    return ([ends, _t(w_len)], {},
            lambda: jdev.best_valley_per_pattern(jnp.asarray(ends.numpy()),
                                                 jnp.asarray(w_len)))


def flank_scan_call(seed, alpha=ALPHA):
    g, flank, rows, tsc, tec, emit_lo, emit_hi = _flank_rows(seed)
    S = rows.shape[0]
    m, k = len(flank), int(g.k_cutoff)
    packed = jcomp.pack_rows_np(rows)
    sidx = np.arange(S, dtype=np.int32)
    words, W_words, top_bit = pattern_words(flank)
    cols = (tsc, tec, tsc, tec, emit_lo, emit_hi)
    statics = dict(K=16, m=m, k_units=k)

    def want():
        return jcomp.flank_scan(
            jnp.asarray(flank), jnp.asarray(words), jnp.asarray(packed),
            jnp.asarray(sidx), *map(jnp.asarray, cols), jnp.int32(alpha),
            use_pallas=False, interpret=False, W_words=W_words, top_bit=top_bit,
            **statics)

    want.tec = tec
    return ([_t(flank), _t(words.view(np.int32)), _t(packed), _t(sidx),
             *map(_t, cols), alpha], statics, want)


def _trace_call(jfn, seed, region_shift=0, H=12):
    args, fm, Wf, _hvalid = _trace_case(seed, H)
    ra, rb = args[8] + region_shift, args[9]
    return ([_t(a) for a in args[:8]] + [ra, rb, ALPHA], {"m": fm, "W": Wf},
            lambda: jfn(*map(jnp.asarray, args[:8]), jnp.int32(ra), jnp.int32(rb),
                        jnp.int32(ALPHA), m=fm, W=Wf))


def _rank_call(jfn, seed, iv_shift=0, **case):
    jargs, pargs, m, W, hvalid = _rank_case(seed, **case)
    pargs = list(pargs)
    pargs[7] += iv_shift
    jargs = list(jargs)
    jargs[7] = jnp.int32(pargs[7])
    want = lambda: jfn(*jargs, m=m, W=W)  # noqa: E731
    want.hvalid = hvalid
    return pargs, {"m": m, "W": W}, want


def _wide_rank_call(seed):
    pargs, kw, _want = _rank_call(None, 5 + seed, H=6, n_pat=2, extra=260 - 44)
    return pargs, kw, None


#: name: (compiled function, call builder); the wide rank takes the
#: W > 255 branch (the summary DP), held to JAX by test_torch_stage_ops
CASES = {
    "flank_ends": (dev.flank_ends, flank_ends_call),
    "find_hits": (dev.find_hits, find_hits_call),
    "window_dp": (dev.window_dp, window_dp_call),
    "traceback_reduce": (dev.traceback_reduce, traceback_reduce_call),
    "window_dp_summary": (dev.window_dp_summary, window_dp_summary_call),
    "best_valley_per_pattern": (dev.best_valley_per_pattern, best_valley_per_pattern_call),
    "flank_scan": (comp.flank_scan, flank_scan_call),
    "flank_trace": (comp.flank_trace, lambda s: _trace_call(jcomp.flank_trace, s)),
    "flank_trace_reference": (comp.flank_trace_reference,
                              lambda s: _trace_call(jcomp.flank_trace_reference, s)),
    "barcode_rank": (comp.barcode_rank, lambda s: _rank_call(jcomp.barcode_rank, s)),
    "barcode_rank_reference": (comp.barcode_rank_reference,
                               lambda s: _rank_call(jcomp.barcode_rank_reference, s)),
    "barcode_rank_wide": (comp.barcode_rank, _wide_rank_call),
}


def _vs_jax(name, got, want):
    """``got`` against the JAX output ``want()``: the flank scan up to
    the read-end key the jnp path lacks, the rank on valid lanes (as
    test_torch_stage_ops holds them)."""
    if name == "flank_scan":
        _flank_scan_vs_jax(got, want(), want.tec, 16)
    elif name == "barcode_rank":
        _same(got[_t(want.hvalid)], np.asarray(want())[want.hvalid], name)
    else:
        _same(got, want(), f"{name} vs JAX")


@pytest.mark.parametrize("name", list(CASES))
def test_compiled_call_captures_replays_and_matches(through_cache, name):
    """Seed 0 captures (under the strict checker), seed 1 replays; each
    equals the eager function and JAX, and seed 0's result survives the
    replay."""
    cache, mode, eager = through_cache
    fn, build = CASES[name]
    calls = [build(seed) for seed in (0, 1)]
    first = fn(*calls[0][0], **calls[0][1])
    kept = _copy(first)
    second = fn(*calls[1][0], **calls[1][1])
    assert (cache.captures, cache.replays, len(cache.keys())) == (1, 1, 1)
    assert mode.ops > 10
    _same(first, kept, f"{name}: first result after the replay")
    for got, (args, kw, want) in zip((first, second), calls):
        _same(got, eager(fn, *args, **kw), f"{name} vs eager")
        if want is not None:
            _vs_jax(name, got, want)


def _mesh_case(seed, B=8, L=160):
    g, flank, rows, start, end, lo, hi = _ends_case(seed, B, L)
    return flank, rows, start, end, lo, hi, scale_k(g.k_cutoff)


def test_sharded_flank_step_is_one_compiled_call_a_shard(through_cache):
    """``sharded_flank_step(["cpu"] * 2)``: each shard is one compiled
    call of one key (one capture, then replays) under the strict checker;
    two steps equal the eager shard bodies and JAX's step on one device."""
    cache, mode, eager = through_cache
    step = pmesh.sharded_flank_step(["cpu"] * 2, K=K_HITS)
    jstep = jax_flank_step(make_mesh(jax.devices()[:1]), K=K_HITS)
    for seed in (0, 1):
        flank, *cols, k = _mesh_case(seed)
        hits, found = step(_t(flank), *pmesh.shard_rows(["cpu"] * 2, *cols), k, ALPHA)
        want, want_found = jstep(jnp.asarray(flank), *jax_shard_rows(
            make_mesh(jax.devices()[:1]), *cols), np.int32(k), np.int32(ALPHA))
        for f in dev.Hits._fields:
            _eq(torch.cat([getattr(h, f) for h in hits]), getattr(want, f), f)
        assert int(found) == int(want_found) > 0
        for d, h in enumerate(hits):
            blk = [c[d * 4 : d * 4 + 4] for c in cols]
            want_h, _n = eager(pmesh._flank_shard, _t(flank), *map(_t, blk), k, ALPHA,
                               K=K_HITS)
            _same(h, want_h, "shard vs eager")
    # one key, as JAX's step is one cache entry
    assert (cache.captures, cache.replays, len(cache.keys())) == (1, 3, 1)
    assert jstep._cache_size() == 1
    assert mode.ops > 10


# ---------------------------------------------------------------- the checker


@pytest.mark.parametrize("read", HOST_READS)
def test_checker_catches_host_reads(read):
    """Each host read of a tensor raises under the checker, the
    ``pattern.tolist()`` loop ``flank_ends`` had among them; the same
    reads pass inside an exempt kernel call."""
    t = torch.tensor([3], dtype=torch.int32)
    reads = {"tolist": lambda: t.tolist(), "numpy": lambda: t.numpy(),
             "item": lambda: t.item(), "__int__": lambda: int(t),
             "__float__": lambda: float(t), "__bool__": lambda: bool(t),
             "__index__": lambda: [0, 1, 2, 3][t]}
    mode = _NoSync()
    with mode, pytest.raises(AssertionError, match="host read|capture-unsafe"):
        reads[read]()
    with mode:
        mode.exempt += 1
        reads[read]()
        mode.exempt -= 1
    assert reads[read]() is not None  # restored once the mode is off


def test_checker_would_catch_the_old_flank_ends(through_cache):
    """``flank_ends`` as it was (a loop over ``pattern.tolist()``) fails
    the capture; the compiled one passes (``test_compiled_call...``)."""

    @compiled()
    def old_flank_ends(pattern, text, start_col, end_col, alpha_scaled):
        out = torch.zeros(text.shape, dtype=torch.int32)
        for pat_i in pattern.tolist():
            out = out + ((text.to(torch.int32) & pat_i) != 0).to(torch.int32)
        return out

    args, _kw, _want = flank_ends_call(0)
    with pytest.raises(AssertionError, match="Tensor.tolist"):
        old_flank_ends(*args)
    cache = through_cache[0]
    assert cache.captures == 0 and not any(cache.instances(k) for k in cache.keys())


# ------------------------------------------------------------- key vs JAX


#: name: (the calls, JAX's cache entries after them, the keys the port
#: makes beyond those: its by-value scalars' new values)
KEY_RUNS = {
    # no statics: a shape change is a key, alpha is traced
    "flank_ends": ([lambda: flank_ends_call(0), lambda: flank_ends_call(1),
                    lambda: flank_ends_call(0, B=6)], 2, 0),
    "window_dp": ([lambda: window_dp_call(0), lambda: window_dp_call(1),
                   lambda: window_dp_call(0, H=6)], 2, 0),
    "best_valley_per_pattern": ([lambda: best_valley_per_pattern_call(0),
                                 lambda: best_valley_per_pattern_call(1),
                                 lambda: best_valley_per_pattern_call(0, H=6)], 2, 0),
    # a static (K) change; k_scaled is traced
    "find_hits": ([lambda: find_hits_call(0), lambda: find_hits_call(1),
                   lambda: find_hits_call(0, K=8)], 2, 0),
    # region and interval bounds are traced; a shape change is a key
    "traceback_reduce": ([lambda: traceback_reduce_call(0), lambda: traceback_reduce_call(1),
                          lambda: traceback_reduce_call(0, H=6)], 2, 0),
    # the flags are static; the bounds and alpha traced
    "window_dp_summary": ([lambda: window_dp_summary_call(0), lambda: window_dp_summary_call(1),
                           lambda: window_dp_summary_call(0, dict(with_lodhi=True))], 2, 0),
    # alpha is a window valley kernel launch argument
    "flank_scan": ([lambda: flank_scan_call(0), lambda: flank_scan_call(1),
                    lambda: flank_scan_call(0, alpha=ALPHA + 100)], 1, 1),
    # region_a is a window trace kernel launch argument
    "flank_trace": ([lambda s=s, r=r: _trace_call(jcomp.flank_trace, s, r, H=6)
                     for s, r in ((0, 0), (1, 0), (0, 1))], 1, 1),
    # the same bounds are traced by the reference (no kernel)
    "flank_trace_reference": ([lambda s=s, r=r: _trace_call(jcomp.flank_trace_reference,
                                                            s, r, H=6)
                               for s, r in ((0, 0), (1, 0), (0, 1))], 1, 0),
    # iv_a is a window interval kernel launch argument; the rest traced
    "barcode_rank": ([lambda s=s, v=v: _rank_call(jcomp.barcode_rank, s, v, H=6, n_pat=4)
                      for s, v in ((0, 0), (1, 0), (0, 1))], 1, 1),
    # the reference traces them all
    "barcode_rank_reference": ([lambda s=s, v=v: _rank_call(jcomp.barcode_rank_reference,
                                                            s, v, H=6, n_pat=4)
                                for s, v in ((0, 0), (1, 0), (0, 1))], 1, 0),
}

#: the jitted JAX function of each run
JAX_FNS = {"flank_ends": jdev.flank_ends, "window_dp": jdev.window_dp,
           "best_valley_per_pattern": jdev.best_valley_per_pattern,
           "barcode_rank_reference": jcomp.barcode_rank_reference,
           "find_hits": jdev.find_hits, "traceback_reduce": jdev.traceback_reduce,
           "window_dp_summary": jdev.window_dp_summary, "flank_scan": jcomp.flank_scan,
           "flank_trace": jcomp.flank_trace,
           "flank_trace_reference": jcomp.flank_trace_reference,
           "barcode_rank": jcomp.barcode_rank}


@pytest.mark.parametrize("name", list(KEY_RUNS))
def test_keys_split_calls_as_jax_cache(through_cache, name):
    """The same calls through the JAX function and the port: the port's
    keys are JAX's new cache entries plus one a new value of a scalar a
    port kernel takes by value."""
    cache = through_cache[0]
    fn = CASES[name][0]
    jfn = JAX_FNS[name]
    runs, entries, extra = KEY_RUNS[name]
    jfn.clear_cache()  # this worker's earlier calls
    for make in runs:
        args, kw, want = make()
        want()
        fn(*args, **kw)
    assert jfn._cache_size() == entries
    assert len(cache.keys()) == entries + extra, cache.keys()


# ------------------------------------------------------------ failures


def test_failed_capture_raises_and_never_runs_eagerly(monkeypatch):
    """A capture that fails raises out of the compiled call and leaves no
    instance; the eager function is not run in its place."""

    def broken(fn, inputs, device):
        raise RuntimeError("capture failed")

    cache = GraphCache(per_key=1, capture=broken)
    monkeypatch.setattr(graphs, "COMPILED", cache)
    monkeypatch.setattr(graphs, "_graph_device", _first_device)
    args, kw, _want = find_hits_call(0)
    with pytest.raises(RuntimeError, match="capture failed"):
        dev.find_hits(*args, **kw)
    assert cache.captures == 0 and not any(cache.instances(k) for k in cache.keys())


def test_cpu_tensors_run_as_written():
    """Without a card a compiled function is its eager self: no key, the
    same result as ``__wrapped__``."""
    args, kw, _want = window_dp_call(0)
    keys = len(graphs.COMPILED.keys())
    _same(dev.window_dp(*args, **kw), dev.window_dp.__wrapped__(*args, **kw), "cpu")
    assert len(graphs.COMPILED.keys()) == keys
    assert dev.window_dp.__wrapped__.__name__ == "window_dp"
