"""The reads mesh: the devices a batch is sharded over.

Counterpart of :mod:`barbell_tpu.parallel.mesh`.  Demultiplexing is
independent per read, so the mesh has one axis, ``reads``: each batch's
reads split into one row block per device (a read's rows stay on one
device, since chunk rows gather barcode windows from their sibling
rows), every device holds a copy of the query tensors, and each
device's hit records come back with its rows.  No collective carries
demux data, so the mesh is a list of devices, each running its block's
fused call on its own current stream
(:meth:`~barbell_tpu_torch.models.pipeline.TorchDemuxEngine.demux_batch_table`).
:func:`sharded_flank_step` is the mesh form of the plain flank stages,
and :func:`sharded_demux_step`, :func:`sharded_demux_step_fused` and
:func:`sharded_demux_step_mono` that of the fused demux call
(:func:`~barbell_tpu_torch.ops.composite.demux_call_fused`, the engine's
device call), each with the one reduction demultiplexing has: a hit or
row count summed over the shards on the first device.  Each shard's
call is one :func:`~barbell_tpu_torch.models.graphs.compiled` call (on
the card a CUDA-graph replay) on the shard's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..models.graphs import compiled
from ..ops import composite as comp
from ..ops import device as dev_ops

READS_AXIS = "reads"

#: ``barbell_tpu.ops.composite.demux_call``'s keyword defaults, for the
#: statics a caller leaves out
DEMUX_DEFAULTS = dict(pack_mode=0, L_rows=0, ends_w=0, ends_wr=0, halo=0,
                      meta_mode="wire", S_pad=0, cat_align=128)
#: the statics of one group (the rest are the call's)
GROUP_STATICS = ("gi", "gf", "m", "k_units", "W_words", "top_bit", "Wf",
                 "plen", "Wb", "P")
#: statics the reference's kernels take that the port has no use for
IGNORED_STATICS = ("use_pallas", "interpret")


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The reads mesh as a device list: ``devices`` as given (entries
    may repeat, e.g. ``["cpu"] * 2``), else every visible card."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; name the "
                               "devices (e.g. ['cpu'] * 2) to run elsewhere")
    return resolve_devices(None, devices)


def resolve_devices(device, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The engine's reads mesh: ``devices`` as given (entries may repeat,
    e.g. ``["cpu"] * 2`` or ``["cuda:0"] * 2``), else ``[device]``,
    except that ``"cuda"`` without an index means every visible card."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("devices must name at least one device")
        return out
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def shard_rows(devices: Sequence, *arrays):
    """Each array's leading axis split into ``len(devices)`` equal row
    blocks, block d on ``devices[d]``: a tuple (one entry an array) of
    per-device tensor lists.  The row count must divide evenly."""
    devs = [torch.device(d) for d in devices]
    out = []
    for arr in arrays:
        t = torch.as_tensor(arr)
        if t.shape[0] % len(devs):
            raise ValueError(f"{t.shape[0]} rows do not split over {len(devs)} devices")
        out.append([blk.to(d) for blk, d in zip(t.chunk(len(devs)), devs)])
    return tuple(out)


@compiled(static_argnames=("K",))
def _flank_shard(pattern, rows, start_col, end_col, lo, hi, k_scaled,
                 alpha_scaled, K: int):
    """One shard's flank step: its ``Hits`` and its rows with a hit."""
    ends = dev_ops.flank_ends(pattern, rows, start_col, end_col, alpha_scaled)
    h = dev_ops.find_hits(ends, lo, hi, k_scaled, K)
    return h, h.valid.any(dim=1).sum(dtype=torch.int32)


def sharded_flank_step(devices: Sequence, K: int = 16):
    """The sharded flank step over ``devices``: ``step(pattern, rows,
    start_col, end_col, lo, hi, k_scaled, alpha_scaled)`` with the row
    arrays as :func:`shard_rows` gives them runs
    :func:`~barbell_tpu_torch.ops.device.flank_ends` and
    :func:`~barbell_tpu_torch.ops.device.find_hits` on each device's
    rows (one compiled call a shard: on the card a graph replay) and
    returns (per-device ``Hits``, the rows with a hit summed over the
    shards, on the first device).  Hits stay with their rows."""
    devs = [torch.device(d) for d in devices]

    def step(pattern, rows, start_col, end_col, lo, hi, k_scaled, alpha_scaled):
        hits, found = [], []
        for d, r, s, e, a, b in zip(devs, rows, start_col, end_col, lo, hi):
            h, n = _flank_shard(pattern.to(d), r, s, e, a, b, k_scaled,
                                alpha_scaled, K=K)
            hits.append(h)
            found.append(n)
        total = found[0]
        for n in found[1:]:
            total = total + n.to(devs[0])
        return hits, total

    return step


def _split_statics(statics: dict):
    """(group statics, call statics) as sorted item tuples from
    ``demux_call``'s keyword arguments as the JAX package names them;
    ``W_words`` and ``top_bit`` must agree with ``m`` (the port derives
    them from it); ``meta_mode`` (which names the arrays, not the call),
    ``use_pallas`` and ``interpret`` are left out."""
    st = {**DEMUX_DEFAULTS, **statics}
    unknown = set(st) - set(DEMUX_DEFAULTS) - set(GROUP_STATICS) - set(IGNORED_STATICS) \
        - {"K", "H_cap", "padding"}
    if unknown:
        raise TypeError(f"unknown demux statics {sorted(unknown)}")
    words = {"W_words": -(-st["m"] // 32), "top_bit": (st["m"] - 1) % 32}
    bad = {k: st[k] for k in words if k in st and st[k] != words[k]}
    if bad:
        raise ValueError(f"{bad} do not fit a flank of m = {st['m']} ({words})")
    group = tuple(sorted((k, st[k]) for k in GROUP_STATICS
                         if k in st and k not in words))
    call = tuple(sorted((k, v) for k, v in st.items()
                        if k not in GROUP_STATICS and k not in IGNORED_STATICS
                        and k != "meta_mode"))
    return group, call


def _parts_names(meta_mode: str):
    """The names :func:`~barbell_tpu_torch.ops.composite.batch_rows`
    reads, in the order of ``demux_call``'s positional arrays
    (``host_packed, simple_idx, meta, exc, row_start``); with descriptor
    metadata ``simple_idx`` carries the chunk rows' table and ``meta``
    the row descriptors, and ``row_start`` is not read."""
    if meta_mode == "desc":
        return ("host_packed", "chunk_meta", "rowdesc", "exc", None)
    if meta_mode == "wire":
        return ("host_packed", "simple_idx", "meta", "exc", "row_start")
    raise ValueError(f"meta_mode must be 'wire' or 'desc', got {meta_mode!r}")


@compiled(static_argnames=("groups", "call", "names", "spans"))
def _demux_shard(group_tensors, arrays, groups, call, names, spans):
    """One shard's fused demux call: the groups (``groups``: each one's
    static items, ``group_tensors``: its flank, pattern words and
    pattern stack) over the shard's ``arrays`` (named by ``names``, or
    one blob laid out by ``spans``).  Returns (the groups' flat buffers
    concatenated in group order, their hit totals summed)."""
    gargs = [comp.GroupArgs(*t, **dict(g)) for t, g in zip(group_tensors, groups)]
    parts = arrays[0] if spans is not None else {
        n: a for n, a in zip(names, arrays) if n is not None}
    outs = comp.demux_call_groups(gargs, parts, spans=spans, **dict(call))
    total = torch.stack([o[-1] for o in outs]).sum(dtype=torch.int32)
    return (torch.cat(outs) if len(outs) > 1 else outs[0]), total


@compiled()
def _sum_counts(counts):
    """The shards' counts (0-d tensors on one device) summed: one more
    compiled call, so that a step's replay launches no kernel of its
    own."""
    return torch.stack(list(counts)).sum(dtype=torch.int32)


def _demux_step(devices, groups, call, names, spans):
    """``step(group_tensors, shards)``: :func:`_demux_shard` on each
    shard's arrays on its device, then the hit totals summed on the
    first device."""
    devs = [torch.device(d) for d in devices]

    def step(group_tensors, shards):
        outs, found = [], []
        for d, arrays in zip(devs, shards):
            gt = tuple(tuple(t.to(d) for t in g) for g in group_tensors)
            out, n = _demux_shard(gt, tuple(arrays), groups=groups, call=call,
                                  names=names, spans=spans)
            outs.append(out)
            found.append(n)
        if len(found) == 1:
            return outs, found[0]
        return outs, _sum_counts(tuple(n.to(devs[0]) for n in found))

    return step


def sharded_demux_step(devices: Sequence, **statics):
    """The fused demux step over ``devices``: ``step(flank, patw,
    patterns_all, host_packed, simple_idx, meta, exc, row_start)``, the
    five row arrays as :func:`shard_rows` gives them (per-device lists;
    row indices, exception positions and row starts shard-local), runs
    one group's :func:`~barbell_tpu_torch.ops.composite.demux_call_fused`
    on each shard (one compiled call a shard: on the card a graph
    replay) and returns (the shards' flat buffers, in shard order, the
    hit totals summed over the shards on the first device).
    ``statics`` are ``barbell_tpu.ops.composite.demux_call``'s keyword
    arguments (``gi, gf, K, m, k_units, W_words, top_bit, Wf, plen, Wb,
    P, H_cap, padding``, and ``pack_mode``, ``L_rows``, ``ends_w``,
    ``ends_wr``, ``halo``, ``meta_mode``, ``S_pad``, ``cat_align`` with
    its defaults); ``use_pallas`` and ``interpret`` are accepted and
    ignored.  ``H_cap`` is each shard's hit-lane capacity."""
    group, call = _split_statics(statics)
    names = _parts_names(statics.get("meta_mode", DEMUX_DEFAULTS["meta_mode"]))
    inner = _demux_step(devices, (group,), call, names, None)

    def step(flank, patw, patterns_all, host_packed, simple_idx, meta, exc, row_start):
        return inner(((flank, patw, patterns_all),),
                     list(zip(host_packed, simple_idx, meta, exc, row_start)))

    return step


def sharded_demux_step_fused(devices: Sequence, *, spans, group_statics, common):
    """Every group's fused demux in one call a shard on the shards'
    blobs: ``step(group_args, blobs)`` with ``group_args`` a (flank,
    patw, patterns_all) tuple a group and ``blobs`` each shard's uint8
    blob (laid out by ``spans``, the same on every shard) returns (each
    shard's groups' flat buffers concatenated in plan order, in shard
    order; the hit totals of every group summed over the shards, on the
    first device).  ``group_statics`` (a tuple of each group's static
    items) and ``common`` (the shared ones) are the JAX package's
    ``demux_call_fused`` statics."""
    groups, calls = zip(*(_split_statics({**dict(common), **dict(g)})
                          for g in group_statics))
    if len(set(calls)) != 1:
        raise ValueError("group_statics may not override the common statics")
    inner = _demux_step(devices, groups, calls[0], None, tuple(spans))

    def step(group_args, blobs):
        return inner(tuple(tuple(g) for g in group_args),
                     [(b.reshape(-1),) for b in blobs])

    return step


def sharded_demux_step_mono(devices: Sequence, *, spans, **statics):
    """:func:`sharded_demux_step` with each shard's arrays riding one
    uint8 blob laid out by ``spans`` (the same on every shard):
    ``step(flank, patw, patterns_all, blobs)``."""
    group, call = _split_statics(statics)
    inner = _demux_step(devices, (group,), call, None, tuple(spans))

    def step(flank, patw, patterns_all, blobs):
        return inner(((flank, patw, patterns_all),), [(b.reshape(-1),) for b in blobs])

    return step
