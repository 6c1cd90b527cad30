"""Multi-host execution: per-host record striping + deterministic merge.

Counterpart of :mod:`barbell_tpu.parallel.distributed`.  Reads are
independent, so a multi-host demux is input sharding plus a final
deterministic merge:

* every host processes its own stripe of the input (records with
  ``stream_index % world == rank``) through the normal single-host
  pipeline, writing its own stage output (``annotation.shard-{r}.tsv``)
  plus a ``.idx`` sidecar of ``stream_index\tn_rows`` per processed read;
* the merge interleaves shard rows back into the original stream order
  using the sidecars, so the merged ``annotation.tsv`` is byte-identical
  to a single-host run: each read's rows stay contiguous, and the
  downstream stages (filter/inspect/trim on the merged file) see exactly
  the single-host input.

:func:`initialize` joins a ``torch.distributed`` process group (gloo)
when a coordinator address is given or ``BARBELL_COORDINATOR`` is set;
otherwise everything runs as rank 0 of 1.  No collective carries demux
data: the group only names each process's rank.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the process group if configured; returns (rank, world).

    ``coordinator_address`` (default ``BARBELL_COORDINATOR``) is the
    ``host:port`` of rank 0; ``num_processes`` and ``process_id`` default
    to ``WORLD_SIZE`` and ``RANK``.  The group uses gloo: NCCL refuses two
    ranks on one card, and no collective carries demux data."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "BARBELL_COORDINATOR"
    )
    if coordinator_address is None:
        return 0, 1
    if not dist.is_initialized():
        dist.init_process_group(
            backend="gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes if num_processes is not None
                           else os.environ["WORLD_SIZE"]),
            rank=int(process_id if process_id is not None
                     else os.environ["RANK"]),
        )
    return dist.get_rank(), dist.get_world_size()


def shard_output_path(base: str, rank: int, world: int) -> str:
    if world <= 1:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}.shard-{rank}{ext}"


def merge_annotation_shards(base: str, world: int, delete: bool = True) -> None:
    """Merge per-host annotation shards into ``base``.  Run on rank 0
    after a barrier.

    When every shard has a ``.idx`` sidecar (written by sharded
    annotate runs), rows interleave by original stream index and the
    result is byte-identical to a single-host run.  Record striping
    assigns index %% world == rank, so the global order is a strict
    round-robin over shards — no heap needed; the sidecar's per-read
    row count keeps zero-row reads from desynchronizing the copy.
    Without sidecars (e.g. hand-built shards) the merge degrades to
    rank-order concatenation, which keeps rows contiguous per read but
    reorders reads across hosts."""
    if world <= 1:
        return
    from ..models.records import TSV_COLUMNS

    header = "\t".join(TSV_COLUMNS)
    shards = [shard_output_path(base, rank, world) for rank in range(world)]
    sidecars = [s + ".idx" for s in shards]
    missing = [s for s in shards if not os.path.exists(s)]
    if missing:
        # A missing shard means a rank never finished — merging the
        # survivors (and deleting them) would silently lose that rank's
        # reads.  Fail loudly; re-run the missing rank first.
        raise FileNotFoundError(
            f"Cannot merge: shard output(s) missing: {missing} "
            f"(world={world}; did every rank complete?)"
        )
    have_idx = [os.path.exists(i) for i in sidecars]
    if any(have_idx) and not all(have_idx):
        raise FileNotFoundError(
            "Cannot merge: some shards have .idx sidecars and some do "
            "not — a sharded annotate run writes one per rank, so a "
            "missing sidecar means an incomplete rank: "
            f"{[i for i, ok in zip(sidecars, have_idx) if not ok]}"
        )
    interleave = all(have_idx)

    with open(base, "w") as out:
        if interleave:
            readers = []
            idx_iters = []
            try:
                for shard in shards:
                    fh = open(shard)
                    first = fh.readline()
                    if first and first.rstrip("\n") != header:
                        raise ValueError(f"Bad shard header in {shard}")
                    readers.append(fh)
                for side in sidecars:
                    idx_iters.append(open(side))
                # Header is lazy like AnnotationWriter's: an all-empty
                # merge must stay a 0-byte file, byte-identical to a
                # zero-row single-host run.
                wrote_header = False
                live = [True] * world
                rank = 0
                while any(live):
                    if live[rank]:
                        line = idx_iters[rank].readline()
                        if not line:
                            live[rank] = False
                        else:
                            _si, n_rows = line.split("\t")
                            for _ in range(int(n_rows)):
                                if not wrote_header:
                                    out.write(header + "\n")
                                    wrote_header = True
                                row = readers[rank].readline()
                                if not row:
                                    # sidecar promises more rows than
                                    # the shard holds = truncated shard
                                    raise ValueError(
                                        f"Shard {shards[rank]} is "
                                        "truncated (fewer rows than its "
                                        ".idx sidecar records)"
                                    )
                                out.write(row)
                    rank = (rank + 1) % world
            finally:
                for fh in readers + idx_iters:
                    fh.close()
        else:
            wrote_header = False
            for shard in shards:
                with open(shard) as fh:
                    first = fh.readline()
                    if not first:
                        continue
                    if first.rstrip("\n") != header:
                        raise ValueError(f"Bad shard header in {shard}")
                    if not wrote_header:
                        out.write(first)
                        wrote_header = True
                    for line in fh:
                        out.write(line)
    if delete:
        for path in shards + sidecars:
            if os.path.exists(path):
                os.remove(path)


def write_completion_marker(out_dir: str, stage: str, rank: int) -> None:
    """Per-shard completion marker — the restart/checkpoint contract for
    multi-host streaming (a stage re-run skips shards whose marker
    exists)."""
    os.makedirs(os.path.join(out_dir, ".markers"), exist_ok=True)
    with open(os.path.join(out_dir, ".markers", f"{stage}.{rank}.done"), "w") as fh:
        fh.write("done\n")


def has_completion_marker(out_dir: str, stage: str, rank: int) -> bool:
    return os.path.exists(os.path.join(out_dir, ".markers", f"{stage}.{rank}.done"))
