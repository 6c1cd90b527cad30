"""Two-tier ends scan: shallow end windows for every read, a deep-left
rescan for the few reads whose near-boundary hits could chain deeper.

Counterpart of :mod:`barbell_tpu.models.twotier` on
:class:`~barbell_tpu_torch.models.pipeline.TorchDemuxEngine`.
Contract (docs/SEMANTICS.md deviation 7): triggered reads get exactly
the deep-window row set, untriggered reads the shallow-window row set.
Under ``BARBELL_TIMING=1`` the counter ``rescue.reads`` counts the
reads the deep tier rescued (:mod:`~barbell_tpu_torch.timing`).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .. import PADDING, timing
from . import hittable
from .hittable import HitTable
from .pipeline import TorchDemuxEngine, _pow2_at_least
from .records import BarbellMatch


@dataclass(frozen=True)
class EndsPlan:
    """Preset-derived per-side / per-tier ends-scan windows.

    ``shallow`` is the (prefix, suffix) window pair every read is
    scanned with; ``deep`` (optional) the rescan pair for triggered
    reads (suffix side never deepens: ``@prev_left`` after ``@right``
    is unbounded and forces a full scan instead); ``trigger_margin``
    the read-coordinate distance from the shallow prefix width within
    which a visible flank end triggers the rescan."""

    shallow: Tuple[int, int]
    deep: Optional[Tuple[int, int]] = None
    trigger_margin: int = 0


def make_ends_engine(groups, plan: Optional[EndsPlan], **engine_kwargs):
    """Engine for an ends plan: plain whole-read scan (plan None), plain
    ends engine (no deep tier), or the two-tier engine."""
    if plan is None:
        return TorchDemuxEngine(groups, **engine_kwargs)
    if plan.deep:
        return TwoTierDemuxEngine(groups, plan, **engine_kwargs)
    return TorchDemuxEngine(groups, ends_window=plan.shallow, **engine_kwargs)


class TwoTierDemuxEngine:
    """Shallow-scan + deep-rescue wrapper around two
    :class:`TorchDemuxEngine` instances, with the same ``demux_batch`` /
    ``demux_batch_table`` interface (drivable by ``engine_map_batches``)
    and the same keyword arguments, passed to both tiers, except that the
    deep tier always pads rows to powers of two (``fine_rows=False``).
    Rescue batches pad with deterministic dummy reads to a fixed row
    bucket, as the JAX engine does, so both engines see the same
    batches."""

    #: minimum padded host-row count of a rescue batch (buckets to 64)
    _RESCUE_ROWS = 48

    def __init__(self, groups, plan: EndsPlan, **engine_kwargs):
        if not plan.deep:
            raise ValueError("TwoTierDemuxEngine needs a plan with a deep tier")
        self.plan = plan
        self.shallow = TorchDemuxEngine(
            groups, ends_window=plan.shallow, **engine_kwargs
        )
        # the rescue batches' row bucket stays pinned
        deep_kwargs = dict(engine_kwargs, fine_rows=False)
        self.deep = TorchDemuxEngine(groups, ends_window=plan.deep, **deep_kwargs)
        self.groups = self.shallow.groups
        self.devices = self.shallow.devices
        self.labels = self.shallow.labels
        self.halo = self.shallow.halo
        W1l, W1r = plan.shallow
        #: reads fully covered by the shallow overlap need no rescue
        self._cover1 = W1l + W1r - self.shallow.halo - PADDING - 1
        #: trigger: a visible left-region flank end past this depth
        self._thresh = W1l - plan.trigger_margin
        self._w1l = W1l
        #: rescued-read count of the last batch
        self.last_rescued = 0
        self._L_deep = min(
            _pow2_at_least(max(plan.deep), lo=256), self.deep.max_row_len
        )
        # deterministic hit-free pad read, long enough to take the
        # ends-row path in the deep engine (pins L and the row bucket)
        rng = random.Random(0xBA5BE11)
        self._dummy = bytes(
            rng.choice(b"ACGT") for _ in range(self._L_deep + 64)
        )

    @property
    def last_dispatch(self) -> Optional[str]:
        """The shallow tier's dispatch of the last batch (see
        :attr:`TorchDemuxEngine.last_dispatch`)."""
        return self.shallow.last_dispatch

    @property
    def cuda_graphs(self) -> bool:
        """Both tiers replay captured CUDA graphs (see
        :attr:`TorchDemuxEngine.cuda_graphs`); setting it sets both."""
        return self.shallow.cuda_graphs

    @cuda_graphs.setter
    def cuda_graphs(self, on: bool) -> None:
        self.shallow.cuda_graphs = self.deep.cuda_graphs = bool(on)

    def demux_batch(
        self, read_ids: List[str], seqs: List[bytes]
    ) -> List[List[BarbellMatch]]:
        """Per-read ``BarbellMatch`` lists (the object API)."""
        return hittable.table_to_matches(self.demux_batch_table(read_ids, seqs))

    def demux_batch_table(
        self, read_ids: List[str], seqs: List[bytes]
    ) -> HitTable:
        t = self.shallow.demux_batch_table(read_ids, seqs)
        self.last_rescued = 0
        c = t.cols
        if c["reads"].shape[0] == 0:
            return t
        # Trigger: a hit in the LEFT claim region whose flank end could
        # chain a successor past the shallow claims.
        eligible = t.read_lens[c["reads"]] > self._cover1
        trig = eligible & (c["ref"] > self._thresh) & (c["ref"] < self._w1l)
        if not bool(trig.any()):
            return t
        rescue = np.unique(c["reads"][trig])
        self.last_rescued = int(rescue.size)
        timing.count("rescue.reads", self.last_rescued)
        td = self._deep_call(
            [read_ids[int(i)] for i in rescue],
            [seqs[int(i)] for i in rescue],
        )
        dcols = dict(td.cols)
        dcols["reads"] = rescue[td.cols["reads"]]
        keep = ~np.isin(c["reads"], rescue)
        cols = {
            k: np.concatenate([c[k][keep], dcols[k]]) for k in hittable.COLUMNS
        }
        # a read's rows are entirely shallow or entirely deep, so the
        # stable read sort keeps each side's internal order
        order = np.argsort(cols["reads"], kind="stable")
        cols = {k: v[order] for k, v in cols.items()}
        return HitTable(
            read_ids=t.read_ids, read_lens=t.read_lens, cols=cols,
            labels=t.labels,
        )

    def _deep_call(self, ids: List[str], seqs: List) -> HitTable:
        """Deep-window scan of the rescued reads, padded with dummy reads
        to the pinned row bucket; dummy rows are stripped."""
        rows = sum(1 if len(s) <= self._L_deep else 2 for s in seqs)
        n_dummy = max(1, -(-(self._RESCUE_ROWS - rows) // 2))
        all_ids = list(ids) + [f"__pad{i}" for i in range(n_dummy)]
        all_seqs = list(seqs) + [self._dummy] * n_dummy
        td = self.deep.demux_batch_table(all_ids, all_seqs)
        keep = td.cols["reads"] < len(ids)
        cols = {k: v[keep] for k, v in td.cols.items()}
        return HitTable(
            read_ids=td.read_ids[: len(ids)],
            read_lens=td.read_lens[: len(ids)],
            cols=cols,
            labels=td.labels,
        )

    def warm_deep(self) -> None:
        """Run the deep tier once (one rescue-sized call of a dummy read)
        so its first real trigger mid-stream pays no first-call costs:
        with ``cuda_graphs`` that call captures the rescue key's graph."""
        self._deep_call(["__warm"], [self._dummy])
