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
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

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
