"""Captured device calls: the counterpart of ``jax.jit``'s cache of
compiled calls.

The JAX engine never runs its fused call op by op:
``demux_call_fused`` is a ``jax.jit`` function keyed by its static
arguments, and the engine keeps the compiled sharded steps keyed by
``("fused", spans, group_statics, common)``
(``barbell_tpu/models/pipeline.py`` ``_dispatch_all_groups_sharded``),
so each batch is one launch of a program compiled once for its shape
bucket.  On CUDA the counterpart of that executable is a captured CUDA
graph.  :class:`GraphCache` keeps, for each key, a pool of
:class:`Instance` objects, each one graph with its own static inputs,
static output and memory pool:

* :meth:`GraphCache.run` checks an instance out, copies the batch's
  inputs into its static inputs on the current stream and replays the
  graph there; the caller reads the output and then hands the instance
  back with :meth:`GraphCache.release` (the engine does so after its
  fetch has copied the output to the host);
* an instance's first use runs the eager call once on its static
  inputs (that output serves the batch, and it loads every kernel
  before any capture), then captures the same call on a non-blocking
  side stream under a lock per device, in ``thread_local`` capture
  mode so that the other worker threads go on uploading, fetching and
  replaying meanwhile;
* a key holds at most ``per_key`` instances (the threads that can hold
  one at once) and makes one at a time: a thread that finds every
  instance of its key checked out makes another only when none is
  being made and the key is below ``per_key``, and otherwise waits
  until one comes back or the one being made is done.  An instance is
  out only from its dispatch to its
  fetch, so a key grows to the instances its threads really hold at
  once, not one per thread: a fresh engine's first batches on eight
  threads wait for the first capture instead of making eight;
* the keys form an LRU of at most ``max_keys``; the least recently used
  key's instances are dropped (their graphs and memory pools freed) as
  ``jit``'s cache evicts.

A capture or replay that fails raises: nothing falls back to the eager
call.  Under ``BARBELL_TIMING=1`` a capture (its eager call and the
capture) is the span ``graph.capture`` and each replay adds one to the
counter ``graph.replay`` (:mod:`~barbell_tpu_torch.timing`), across
every cache; :attr:`GraphCache.captures` / ``.replays`` count one
cache's.  Launch counts stay counts of kernels that ran: the eager first
use counts as it runs, a capture notes its launches
(:func:`~barbell_tpu_torch._build.recording_launches`) and each replay
counts them.

:func:`compiled` is the counterpart of ``functools.partial(jax.jit,
static_argnames=...)`` for the port's other device functions (the
staged composites, the stage functions of
:mod:`~barbell_tpu_torch.ops.device`, the mesh's flank step): on CUDA
tensors each call is a replay of one graph a key, taken from one
module-level :class:`GraphCache`.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import inspect
import itertools
import numbers
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from .. import _build, timing

#: keys the cache holds before it drops the least recently used
MAX_KEYS = 16

Inputs = Dict[str, torch.Tensor]


_serials = itertools.count()


class _Entry:
    __slots__ = ("idle", "total", "capturing", "serial")

    def __init__(self):
        self.idle: List["Instance"] = []
        self.total = 0  # instances of the key, idle or checked out
        self.capturing = False  # an instance of the key is being made
        self.serial = next(_serials)


class Instance:
    """One captured call: its static ``inputs`` (the tensors the graph
    reads), its static ``output`` (what each replay writes: a tensor, or
    a tuple holding tensors), the
    ``graph`` (anything with ``replay()``), the kernel wrappers its
    capture launched (counted again at each replay) and the key and
    serial of the pool it belongs to.  It holds no reference to the
    pool: nothing of the cache is in a reference cycle, so a graph is
    freed when its last reference goes and never by the cyclic garbage
    collector, which could run inside another capture."""

    __slots__ = ("inputs", "output", "graph", "launches", "key", "serial")

    def __init__(self, key: Hashable, serial: int, inputs: Inputs):
        self.key, self.serial, self.inputs = key, serial, inputs
        self.output: Optional[torch.Tensor] = None
        self.graph = None
        self.launches: List = []


_side_streams: Dict[torch.device, torch.cuda.Stream] = {}
_capture_locks: Dict[torch.device, threading.Lock] = {}
_streams_lock = threading.Lock()
_gc_paused = [0, False]  # captures under way, whether gc was enabled


@contextlib.contextmanager
def _gc_paused_for_capture():
    """No cyclic garbage collection while any capture runs: a collection
    triggered inside the capturing thread could free some other CUDA
    graph, and destroying a graph there invalidates the capture."""
    with _streams_lock:
        if _gc_paused[0] == 0:
            _gc_paused[1] = gc.isenabled()
            gc.disable()
        _gc_paused[0] += 1
    try:
        yield
    finally:
        with _streams_lock:
            _gc_paused[0] -= 1
            if _gc_paused[0] == 0 and _gc_paused[1]:
                gc.enable()


def _capture_lock_and_stream(device: torch.device):
    with _streams_lock:
        if device not in _capture_locks:
            _capture_locks[device] = threading.Lock()
            # torch's pool streams are created cudaStreamNonBlocking: no
            # implicit order with the legacy stream the workers use
            _side_streams[device] = torch.cuda.Stream(device)
        return _capture_locks[device], _side_streams[device]


def capture_cuda(fn: Callable[[Inputs], torch.Tensor], inputs: Inputs,
                 device: torch.device):
    """(graph, output) of ``fn(inputs)`` captured as one CUDA graph in
    its own memory pool, on ``device``'s side stream, one capture at a
    time per device.  ``thread_local`` mode forbids unsafe calls in
    this thread only, so the engine's other threads keep running."""
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
    lock, stream = _capture_lock_and_stream(device)
    graph = torch.cuda.CUDAGraph()
    with lock, _gc_paused_for_capture(), torch.cuda.device(device), \
            torch.cuda.stream(stream):
        graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                            capture_error_mode="thread_local")
        try:
            out = fn(inputs)
        except BaseException:
            # end the capture so the stream leaves capture mode; the
            # call's own error is the one that propagates
            try:
                graph.capture_end()
            except RuntimeError:
                pass
            raise
        graph.capture_end()
    return graph, out


class GraphCache:
    """Per-key pools of captured calls (see the module doc).
    ``capture(fn, inputs, device) -> (graph, output)`` makes an
    instance's graph (default :func:`capture_cuda`; the CPU tests inject
    a stand-in that reruns ``fn`` on the static inputs)."""

    def __init__(self, per_key: int, max_keys: int = MAX_KEYS,
                 capture=capture_cuda):
        if per_key < 1 or max_keys < 1:
            raise ValueError(f"per_key {per_key} and max_keys {max_keys} must be >= 1")
        self.per_key = per_key
        self.max_keys = max_keys
        self._capture = capture
        self._cond = threading.Condition()
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        #: captures made and replays run since the cache was made
        self.captures = 0
        self.replays = 0

    def run(self, key: Hashable, fn: Callable[[Inputs], torch.Tensor],
            inputs: Inputs) -> Tuple[torch.Tensor, Instance]:
        """(output, instance) of ``fn(inputs)`` through an instance of
        ``key``, which must determine everything ``fn`` does but the
        values of ``inputs``; hand the instance back with
        :meth:`release` once the output has been read."""
        with self._cond:
            while True:
                entry = self._entries.get(key)
                if entry is None:
                    entry = self._entries[key] = _Entry()
                    while len(self._entries) > self.max_keys:
                        self._entries.popitem(last=False)
                self._entries.move_to_end(key)
                if entry.idle:
                    inst = entry.idle.pop()
                    break
                if entry.total < self.per_key and not entry.capturing:
                    entry.total += 1
                    entry.capturing = True
                    inst = None
                    break
                self._cond.wait()
        if inst is not None:
            try:
                for name, t in inst.inputs.items():
                    t.copy_(inputs[name])
                inst.graph.replay()
            except BaseException:
                self._drop(entry)
                raise
            _build.count_replay(inst.launches)
            timing.count("graph.replay")
            with self._cond:
                self.replays += 1
            return inst.output, inst
        try:
            device = next(iter(inputs.values())).device
            inst = Instance(key, entry.serial, {n: torch.empty_like(t).copy_(t)
                                                for n, t in inputs.items()})
            with timing.span("graph.capture"):
                out = fn(inst.inputs)
                with _build.recording_launches() as launches:
                    inst.graph, inst.output = self._capture(fn, inst.inputs, device)
            inst.launches = launches
        except BaseException:
            self._drop(entry, captured=True)
            raise
        with self._cond:
            entry.capturing = False
            self.captures += 1
            self._cond.notify_all()
        return out, inst

    def _drop(self, entry: _Entry, captured: bool = False) -> None:
        """Forget a checked-out instance whose capture (``captured``) or
        replay failed."""
        with self._cond:
            entry.total -= 1
            if captured:
                entry.capturing = False
            self._cond.notify_all()

    def release(self, inst: Instance) -> None:
        """Return a checked-out instance to its key's pool; one of an
        evicted key is dropped, and its graph and pool with it."""
        with self._cond:
            entry = self._entries.get(inst.key)
            if entry is not None and entry.serial == inst.serial:
                entry.idle.append(inst)
            self._cond.notify_all()

    def instances(self, key: Hashable) -> int:
        """Instances of ``key``, idle or checked out (0 once evicted)."""
        with self._cond:
            entry = self._entries.get(key)
            return 0 if entry is None else entry.total

    def keys(self) -> list:
        """The cached keys, least recently used first."""
        with self._cond:
            return list(self._entries)

    def clear(self) -> None:
        """Drop every key (an instance checked out now is dropped when
        handed back), and with the last references their graphs and
        memory pools."""
        with self._cond:
            self._entries.clear()
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# compiled: jax.jit for the port's device functions
# ---------------------------------------------------------------------------

#: the cache of every :func:`compiled` function: one graph a key (calls
#: of one key take turns), the least recently used of MAX_KEYS keys
#: dropped
COMPILED = GraphCache(per_key=1)

_inline = threading.local()  # depth of compiled bodies running on this thread


def _scalar_dtype(x) -> Optional[torch.dtype]:
    """The dtype JAX traces a Python or numpy scalar as (32-bit), or
    None for anything else."""
    if isinstance(x, (bool, np.bool_)):
        return torch.bool
    if isinstance(x, numbers.Integral):
        return torch.int32
    if isinstance(x, numbers.Real):
        return torch.float32
    return None


def _graph_device(tensors) -> Optional[torch.device]:
    """The CUDA device of the first tensor on one, else None (the call
    runs eagerly, as on the CPU)."""
    for t in tensors:
        if t.device.type == "cuda":
            return t.device
    return None


def _flatten(out, leaves: list):
    """The structure of ``out`` (a tensor, None, or a tuple or NamedTuple
    of those) with its tensors appended to ``leaves``, made contiguous
    inside the call (so that a replay's copies of them are memcpys, not
    kernels)."""
    if isinstance(out, torch.Tensor):
        leaves.append(out.contiguous())
        return len(leaves) - 1
    if out is None:
        return None
    if isinstance(out, tuple):
        return (type(out), tuple(_flatten(o, leaves) for o in out))
    raise TypeError(f"compiled: cannot return {type(out).__name__}")


def _unflatten(spec, leaves):
    """:func:`_flatten`'s ``out`` again, with ``leaves`` for its tensors."""
    if spec is None:
        return None
    if isinstance(spec, int):
        return leaves[spec]
    cls, parts = spec
    items = [_unflatten(p, leaves) for p in parts]
    return cls(*items) if hasattr(cls, "_fields") else cls(items)


def _tensor_tree(value):
    """(structure, tensors) of a tuple or list holding tensors (nested,
    as :func:`_flatten` gives them), or None for anything else."""
    if not isinstance(value, (tuple, list)) or not value:
        return None
    leaves: list = []
    try:
        spec = _flatten(tuple(value), leaves)
    except TypeError:
        return None
    return (spec, leaves) if leaves else None


def compiled(static_argnames=(), by_value=()):
    """Decorator: the port's ``functools.partial(jax.jit,
    static_argnames=static_argnames)``.

    On CPU tensors, inside another compiled call (JAX inlines a nested
    jit) and inside a stream capture the function runs as written.
    Otherwise the call's key is the function, the values of ``static_argnames``, the values of the
    ``by_value`` scalars (those a kernel takes as a launch argument,
    which a graph bakes in; JAX traces them) and each tensor argument's
    shape, dtype and device; every other Python or numpy scalar becomes
    a 0-d tensor on the device (int32, float32 or bool, as JAX traces
    it), so one graph serves every value.  A tuple or list of tensors
    (nested) is an argument as JAX takes a pytree: each tensor an input,
    its structure and shapes part of the key.  A key's first call runs the
    function eagerly and captures it (:meth:`GraphCache.run`); later
    calls copy their tensors into the graph's static inputs and replay
    it on the current stream.  The result is a tensor, or a tuple or
    NamedTuple of tensors and None, that the call owns: a
    device-to-device copy of the graph's outputs, as a jitted call
    returns new arrays.  Calls of one key are ordered on one stream of
    the device.  A failed capture or replay raises.  ``fn.__wrapped__``
    is the function as written."""
    static_argnames, by_value = tuple(static_argnames), tuple(by_value)

    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            arguments = bound.arguments
            trees = {name: tree for name, value in arguments.items()
                     if name not in static_argnames
                     and (tree := _tensor_tree(value)) is not None}
            device = _graph_device(
                [a for a in arguments.values() if isinstance(a, torch.Tensor)]
                + [t for _spec, leaves in trees.values() for t in leaves])
            if (device is None or getattr(_inline, "depth", 0)
                    or (device.type == "cuda" and torch.cuda.is_current_stream_capturing())):
                return fn(*args, **kwargs)
            fixed: Dict[str, Any] = {}
            inputs: Dict[str, torch.Tensor] = {}
            tree_specs: Dict[str, tuple] = {}
            key: List[Hashable] = [fn]
            for name, value in arguments.items():
                if name in static_argnames:
                    fixed[name] = value
                    key.append((name, value))
                elif name in by_value:
                    if isinstance(value, (torch.Tensor, np.generic)):
                        value = value.item()  # a launch argument: read on the host
                    fixed[name] = value
                    key.append((name, value))
                elif isinstance(value, torch.Tensor):
                    inputs[name] = value.to(device)
                    key.append((name, tuple(value.shape), value.dtype, device))
                elif name in trees:
                    spec, leaves = trees[name]
                    tree_specs[name] = (spec, len(leaves))
                    for i, t in enumerate(leaves):
                        inputs[f"{name}.{i}"] = t.to(device)
                    key.append((name, spec, tuple((tuple(t.shape), t.dtype)
                                                  for t in leaves), device))
                elif _scalar_dtype(value) is not None:
                    dtype = _scalar_dtype(value)
                    staged = torch.tensor(value, dtype=dtype)
                    if device.type == "cuda":  # an asynchronous copy, no wait
                        staged = staged.pin_memory()
                    inputs[name] = staged.to(device, non_blocking=True)
                    key.append((name, (), dtype, device))
                elif value is None:
                    fixed[name] = None
                    key.append((name, None))
                else:
                    raise TypeError(f"{fn.__name__}: argument {name} of type "
                                    f"{type(value).__name__} is neither a tensor "
                                    f"nor a scalar; name it static")

            def body(inp):
                args = {n: t for n, t in inp.items() if n in arguments}
                for name, (spec, n) in tree_specs.items():
                    args[name] = _unflatten(spec, [inp[f"{name}.{i}"] for i in range(n)])
                _inline.depth = getattr(_inline, "depth", 0) + 1
                try:
                    out = fn(**fixed, **args)
                finally:
                    _inline.depth -= 1
                leaves: list = []
                return (_flatten(out, leaves), *leaves)

            ctx = torch.cuda.device(device) if device.type == "cuda" \
                else contextlib.nullcontext()
            with ctx:
                out, inst = COMPILED.run(tuple(key), body, inputs)
                try:
                    leaves = [t.clone() for t in out[1:]]
                finally:
                    COMPILED.release(inst)
            return _unflatten(out[0], leaves)

        return call

    return wrap
