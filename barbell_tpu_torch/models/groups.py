"""Per-group query constants: the port's "weights".

Counterpart of ``barbell_tpu.models.pipeline._GroupPlan``: the host-side
constants of one barcode group (flank, thresholds, windows, hit-table
codes) plus its device tensors — the flank masks, the Myers pattern
words and the [fwd; rc] barcode pattern stack — held as buffers of a
small ``nn.Module`` so ``.to(device)`` moves them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import PADDING
from ..ops import oracle
from ..ops.lodhi import perfect_score
from ..ops.myers import pattern_words
from . import hittable
from .barcodes import BarcodeGroup
from .demux import BARCODE_K_FRAC
from .records import Strand


class GroupTensors(nn.Module):
    """Device-resident query constants of one group."""

    def __init__(self, flank: np.ndarray, patw: np.ndarray,
                 patterns_all: np.ndarray):
        super().__init__()
        self.register_buffer(
            "flank", torch.from_numpy(np.ascontiguousarray(flank, dtype=np.uint8))
        )
        # uint32 Myers words travel as their int32 bit pattern
        self.register_buffer(
            "patw",
            torch.from_numpy(
                np.ascontiguousarray(patw, dtype=np.uint32).view(np.int32)
            ),
        )
        self.register_buffer(
            "patterns_all",
            torch.from_numpy(np.ascontiguousarray(patterns_all, dtype=np.uint8)),
        )


def group_tensors_from_numpy(flank, patw, patterns_all, device) -> GroupTensors:
    """Numpy query constants as the port's tensors on ``device``."""
    return GroupTensors(flank, patw, patterns_all).to(device)


class GroupPlan:
    """Per-group constants (host numbers + device tensors)."""

    def __init__(self, group: BarcodeGroup, device):
        if group.k_cutoff is None:
            raise ValueError("BarcodeGroup needs a flank threshold before demuxing")
        self.group = group
        self.flank = np.asarray(group.flank_masks, dtype=np.uint8)
        self.m = len(self.flank)
        self.k_units = int(group.k_cutoff)
        self.span = oracle.flank_window_span(self.m, self.k_units)
        self.plen = group.pattern_len
        self.k1_scaled = oracle.scale_k(int(self.plen * BARCODE_K_FRAC))
        self.mask_start, self.mask_end = group.bar_region
        pad_start, _ = group.pad_region
        self.rel_bar_start = self.mask_start - pad_start
        self.rel_bar_end = self.mask_end - pad_start
        mask_len = self.mask_end - self.mask_start + 1
        self.barcode_window = mask_len + self.k_units + 2 * PADDING + 2
        self.patw = pattern_words(self.flank)[0]
        self.perfect = perfect_score(group.pad_region[1] - group.pad_region[0])
        self.patterns: Dict[Strand, np.ndarray] = {
            Strand.Fwd: np.asarray(group.patterns_fwd, dtype=np.uint8),
            Strand.Rc: np.asarray(group.patterns_rc, dtype=np.uint8),
        }
        self.n_patterns = self.patterns[Strand.Fwd].shape[0]
        self.patterns_all = np.concatenate(
            [self.patterns[Strand.Fwd], self.patterns[Strand.Rc]], axis=0
        )
        # hit-table constants (vectorized assembly)
        self.bar_mtype_codes = np.array(
            [hittable.MTYPE_CODE[b.match_type] for b in group.barcodes],
            dtype=np.int64,
        )
        self.flank_code = hittable.MTYPE_CODE[
            group.barcodes[0].match_type.as_flank()
        ]
        self.flank_cost_len = len(group.barcodes[0].seq)
        self.label_base = 0  # set by the engine (global label vocabulary)
        self.tensors = group_tensors_from_numpy(
            self.flank, self.patw, self.patterns_all, device
        )
