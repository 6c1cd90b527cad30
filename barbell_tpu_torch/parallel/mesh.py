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
with the one reduction demultiplexing has: the count of rows with a hit,
summed over the shards on the first device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..models.graphs import compiled
from ..ops import device as dev_ops

READS_AXIS = "reads"


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
