"""Engine factory of the annotate stage.

Counterpart of the engine selection in :mod:`barbell_tpu.stages.annotate`
with the backends ``torch`` (the batched device pipeline; ``device``
says where it runs) and ``oracle`` (the scalar NumPy engine).  There is
no automatic fallback from one to the other.  The ``annotate``
subcommand itself (whole-read scan) is not ported.
"""

from __future__ import annotations

from typing import Sequence

from barbell_tpu.models.barcodes import BarcodeGroup
from barbell_tpu.models.twotier import EndsPlan
from barbell_tpu.stages.annotate import AnnotateConfig, _OracleEngine

from ..models.pipeline import TorchDemuxEngine
from ..models.twotier import make_ends_engine

BACKENDS = ("torch", "oracle")


def _torch_engine(groups: Sequence[BarcodeGroup], config: AnnotateConfig, device):
    """Device engine for the config: plain ends scan, or the two-tier
    shallow+rescue engine when ``ends_window`` is an
    :class:`~barbell_tpu.models.twotier.EndsPlan` with a deep tier."""
    kw = dict(
        alpha=config.alpha,
        min_score=config.min_score,
        min_score_diff=config.min_score_diff,
        device=device,
    )
    ew = config.ends_window
    if isinstance(ew, EndsPlan):
        return make_ends_engine(list(groups), ew, **kw)
    return TorchDemuxEngine(list(groups), ends_window=ew, **kw)


def make_engine(groups: Sequence[BarcodeGroup], config: AnnotateConfig,
                device="cuda"):
    if config.backend == "torch":
        return _torch_engine(groups, config, device)
    if config.backend == "oracle":
        return _OracleEngine(groups, config)
    raise ValueError(
        f"Unknown backend {config.backend!r}; choose one of {', '.join(BACKENDS)}"
    )
