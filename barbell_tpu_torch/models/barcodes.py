"""Query compilation: barcode groups, flank extraction, device tensors.

A *barcode group* is a set of equal-length query constructs sharing a
common prefix/suffix (the flanks).  We extract the longest common
prefix and suffix, mask the variable (barcode) region with ``N``, and
slice out each per-barcode sequence with +-PADDING bases of anchoring
context.  Mirrors the reference semantics
(`src/annotate/barcodes.rs:105-197`), but the group is compiled into
dense device-ready mask tensors up front (flank mask vector + a
[num_barcodes, pattern_len] matrix per strand).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import PADDING
from ..kits.database import KitSpec, expand_template, get_kit_info
from ..utils import dna
from .records import BarcodeType


@dataclass
class Barcode:
    seq: bytes  # padded barcode construct slice (uppercase ASCII)
    label: str
    match_type: BarcodeType

    def __post_init__(self):
        if not dna.is_valid_iupac(self.seq):
            raise ValueError("Sequence contains character not supported by IUPAC")


@dataclass
class BarcodeGroup:
    flank: bytes  # prefix + N*mask + suffix
    flank_prefix: bytes
    flank_suffix: bytes
    bar_region: Tuple[int, int]  # (start, end) INCLUSIVE end, within flank
    pad_region: Tuple[int, int]  # padded barcode slice within construct
    barcodes: List[Barcode]
    barcode_type: BarcodeType
    k_cutoff: Optional[int] = None

    # Compiled device tensors (filled by _compile).
    flank_masks: np.ndarray = field(default=None, repr=False)
    patterns_fwd: np.ndarray = field(default=None, repr=False)  # [N, plen] u8
    patterns_rc: np.ndarray = field(default=None, repr=False)  # [N, plen] u8

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @staticmethod
    def from_seqs(
        query_seqs: Sequence[bytes],
        query_labels: Sequence[str],
        barcode_type: BarcodeType,
    ) -> "BarcodeGroup":
        if not query_seqs:
            raise ValueError("No query sequences provided (empty input?)")
        if len(query_seqs) == 1:
            raise ValueError(
                "Groups need at least two queries; add a second query with the "
                "same flanks and a different barcode"
            )
        lengths = {len(s) for s in query_seqs}
        if len(lengths) != 1:
            raise ValueError("All sequences per group must be equally long")

        prefix = _longest_common_prefix(query_seqs)
        suffix = _longest_common_suffix(query_seqs)
        seq_len = len(query_seqs[0])
        prefix_len, suffix_len = len(prefix), len(suffix)

        if prefix_len + suffix_len >= seq_len:
            raise ValueError(
                "No barcode region found; input must be unique sequences of "
                "<prefix><barcode><suffix>"
            )
        mask_size = seq_len - prefix_len - suffix_len
        if prefix_len == 0 and suffix_len == 0:
            raise ValueError("No shared prefix or suffix found; cannot anchor the search")
        if prefix_len == 0 or suffix_len == 0:
            # stderr, like from_kit's notice — stdout stays clean for
            # bench/pipe consumers (one-JSON-line contract)
            print(
                "Your input only has a flank on one side; that works but both "
                "a left and right flank anchor barcodes better",
                file=sys.stderr,
            )

        flank = prefix + b"N" * mask_size + suffix

        pad_start = max(0, prefix_len - PADDING)
        pad_end = prefix_len + mask_size + PADDING

        barcodes = []
        for seq, label in zip(query_seqs, query_labels):
            end = min(pad_end, len(seq))
            barcodes.append(Barcode(bytes(seq[pad_start:end]), label, barcode_type))

        group = BarcodeGroup(
            flank=flank,
            flank_prefix=prefix,
            flank_suffix=suffix,
            bar_region=(prefix_len, prefix_len + mask_size - 1),
            pad_region=(pad_start, pad_end),
            barcodes=barcodes,
            barcode_type=barcode_type,
        )
        group._compile()
        return group

    @staticmethod
    def from_fasta(fasta_path: str, barcode_type: BarcodeType) -> "BarcodeGroup":
        from ..utils.fastx import read_fasta

        seqs, labels = [], []
        for name, seq in read_fasta(fasta_path):
            labels.append(name)
            seqs.append(dna.upper_bytes(seq))
        return BarcodeGroup.from_seqs(seqs, labels, barcode_type)

    @staticmethod
    def from_kit(kit: str, use_extended: bool = False) -> List["BarcodeGroup"]:
        spec: KitSpec = get_kit_info(kit)
        groups = []
        for tmpl in spec.templates:
            if tmpl.extended and not use_extended:
                # Reference prints this notice (barcodes.rs:260); stderr
                # here so stdout stays clean for bench/pipe consumers.
                print(f"Skipping extended template {kit}", file=sys.stderr)
                continue
            labels, seqs = expand_template(tmpl)
            seq_bytes = [s.encode("ascii") for s in seqs]
            for s in seq_bytes:
                if not dna.is_valid_iupac(s):
                    raise ValueError("Expanded template contained non-IUPAC characters")
            btype = BarcodeType.Ftag if tmpl.side == "left" else BarcodeType.Rtag
            groups.append(BarcodeGroup.from_seqs(seq_bytes, labels, btype))
        return groups

    # ------------------------------------------------------------------

    def _compile(self) -> None:
        self.flank_masks = dna.encode(self.flank)
        fwd = np.stack([dna.encode(b.seq) for b in self.barcodes])
        rc = np.stack(
            [dna.encode(dna.reverse_complement_bytes(b.seq)) for b in self.barcodes]
        )
        self.patterns_fwd = fwd
        self.patterns_rc = rc

    def patterns_for_strand(self, strand) -> np.ndarray:
        from .records import Strand

        return self.patterns_fwd if strand is Strand.Fwd else self.patterns_rc

    def set_flank_threshold(self, flank_threshold: int) -> None:
        self.k_cutoff = flank_threshold

    def get_effective_len(self) -> int:
        """Combined flank length (prefix + suffix) — drives the auto-k."""
        return len(self.flank_prefix) + len(self.flank_suffix)

    @property
    def pattern_len(self) -> int:
        return len(self.barcodes[0].seq)

    def display(self, n: int = 5) -> None:
        mask_start, mask_end = self.bar_region
        mask_size = mask_end - mask_start + 1
        print(
            self.flank_prefix.decode() + "-" * mask_size + self.flank_suffix.decode()
        )
        pad_start, _ = self.pad_region
        bar_start, bar_end = self.bar_region
        left_len = len(self.flank_prefix)
        for barcode in self.barcodes[:n]:
            length = len(barcode.seq)
            start_pos = min(max(0, bar_start - pad_start), length)
            end_pos = min(max(0, bar_end + 1 - pad_start), length)
            end_pos = max(end_pos, start_pos)
            label_text = f"{barcode.label}: "
            pad_spaces = max(0, left_len - len(label_text))
            pad_str = " " * pad_spaces if pad_spaces else " "
            print(f"{label_text}{pad_str}{barcode.seq[start_pos:end_pos].decode()}")
        if len(self.barcodes) > 2:
            print(f"...+{len(self.barcodes) - 2} more")


def _longest_common_prefix(seqs: Sequence[bytes]) -> bytes:
    if not seqs:
        return b""
    first = seqs[0]
    common = len(first)
    for seq in seqs[1:]:
        i = 0
        while i < common and i < len(seq) and first[i] == seq[i]:
            i += 1
        common = i
        if common == 0:
            return b""
    return bytes(first[:common])


def _longest_common_suffix(seqs: Sequence[bytes]) -> bytes:
    if not seqs:
        return b""
    first = seqs[0]
    common = len(first)
    for seq in seqs[1:]:
        i = 0
        while i < common and i < len(seq) and first[len(first) - 1 - i] == seq[len(seq) - 1 - i]:
            i += 1
        common = i
        if common == 0:
            return b""
    return bytes(first[len(first) - common :])
