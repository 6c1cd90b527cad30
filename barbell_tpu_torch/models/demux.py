"""Per-read demultiplexing: flank search -> barcode rescoring -> select.

This is the *reference* (NumPy oracle) implementation of the demux
algorithm — exact but scalar.  The batched TPU pipeline in
:mod:`barbell_tpu.models.pipeline` reproduces these results on padded
read tensors and is tested against this module.

Algorithm per read (mirrors reference `src/annotate/searcher.rs:430-490`):

1. For each barcode group: search the flank (prefix+N-mask+suffix) over
   the whole read, both strands, overhang cost ``alpha`` at read ends,
   edit threshold ``k`` (explicit or the paper formula on the combined
   flank length).
2. For each flank match: map the mask region through the alignment to
   read coordinates, pad +-PADDING, and search all per-barcode padded
   patterns (strand-matched set) in the window with
   ``k = floor(0.4 * pattern_len)``; keep the best hit per pattern;
   if <= 1 patterns matched, retry with ``k = pattern_len``.
3. Score each candidate's alignment with the Lodhi kernel, normalize by
   the group's perfect score, stable-sort descending; accept the top iff
   ``top >= min_score`` and (if a runner-up exists)
   ``top - second >= min_score_diff``; otherwise emit a flank-only row.
4. Collapse overlapping matches across groups at 0.8 overlap.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import PADDING
from ..ops import oracle
from ..ops.lodhi import lodhi_from_ops, perfect_score
from ..utils import dna
from .barcodes import BarcodeGroup
from .collapse import collapse_overlapping_matches
from .records import BarbellMatch, BarcodeType, Strand, rel_dist_to_end

# Fraction of the padded barcode pattern length used as the candidate
# search threshold (reference `src/annotate/searcher.rs:458-460`).
BARCODE_K_FRAC = 0.4
COLLAPSE_OVERLAP = 0.8


class Demuxer:
    """Scalar demultiplexer over compiled barcode groups."""

    def __init__(
        self,
        alpha: float,
        verbose: bool = False,
        min_score: float = 0.2,
        min_score_diff: float = 0.1,
    ):
        self.alpha = float(alpha)
        if not 0.0 <= self.alpha <= 1.0:
            # overhang bases costing more than a unit edit (alpha > 1)
            # break the device kernels' boundary-window assumption; the
            # reference's sassy overhang model is fractional too
            raise ValueError(f"alpha must be in [0, 1], got {self.alpha}")
        self.verbose = verbose
        self.min_score = float(min_score)
        self.min_score_diff = float(min_score_diff)
        self.groups: List[BarcodeGroup] = []
        self.perfect_scores: List[float] = []

    def add_query_group(self, group: BarcodeGroup) -> "Demuxer":
        pad_start, pad_end = group.pad_region
        self.perfect_scores.append(perfect_score(pad_end - pad_start))
        self.groups.append(group)
        return self

    # ------------------------------------------------------------------

    def demux(self, read_id: str, seq) -> List[BarbellMatch]:
        text = dna.encode(seq)
        n = len(text)
        if n == 0:
            return []
        text_rc = dna.reverse_complement_masks(text)

        results: List[BarbellMatch] = []
        for group_i, group in enumerate(self.groups):
            flank_k = group.k_cutoff or 0
            flank_matches = self._flank_matches(group, text, text_rc, flank_k)
            for fm in flank_matches:
                self._process_flank_match(
                    results, read_id, text, n, group, group_i, fm
                )
        return collapse_overlapping_matches(results, COLLAPSE_OVERLAP)

    # ------------------------------------------------------------------

    def _flank_matches(self, group, text, text_rc, flank_k):
        fwd = self._flank_search_one_strand(group, text, flank_k, Strand.Fwd)
        rc = self._flank_search_one_strand(group, text_rc, flank_k, Strand.Rc)
        return fwd + rc

    def _flank_search_one_strand(self, group, text, flank_k, strand):
        """Valley matches with windowed tracebacks (canonical convention:
        the traceback runs on the (m+k+1)-wide window ending at the
        match end, exactly as the device pipeline computes it)."""
        flank = group.flank_masks
        m = len(flank)
        n = len(text)
        C_full = oracle.dp_table(flank, text, self.alpha)
        ends = oracle.end_costs(C_full)
        span = oracle.flank_window_span(m, int(flank_k))
        out = []
        for j in oracle.find_valleys(ends, oracle.scale_k(flank_k)):
            s = max(0, j - span)
            window = text[s:j]
            w_len = j - s
            left_edge = s == 0
            right_pos = w_len if j == n else -1
            C = oracle.window_table(flank, window, left_edge, right_pos, self.alpha)
            start_w, path, ops = oracle.window_traceback(
                C, flank, window, w_len, left_edge, right_pos, self.alpha
            )
            path = path.copy()
            if len(path):
                path[:, 1] += s  # window -> strand-space coordinates
            out.append(
                oracle.Alignment(
                    text_start=s + start_w,
                    text_end=j,
                    cost=int(ends[j]),
                    strand=strand,
                    path=path,
                    ops=ops,
                )
            )
        return out

    def _fwd_span(self, fm: oracle.Alignment, n: int):
        if fm.strand is Strand.Fwd:
            return fm.text_start, fm.text_end
        return oracle.rc_span_to_fwd(fm.text_start, fm.text_end, n)

    def _process_flank_match(
        self,
        results: List[BarbellMatch],
        read_id: str,
        text: np.ndarray,
        n: int,
        group: BarcodeGroup,
        group_i: int,
        fm: oracle.Alignment,
    ) -> None:
        mask_start, mask_end = group.bar_region
        region = oracle.matching_region(fm, mask_start, mask_end, n=n)
        if region is None:
            return  # no room for a barcode
        region_start = max(0, region[0] - PADDING)
        region_end = min(region[1] + PADDING, n)
        if region_end <= region_start:
            return
        window = text[region_start:region_end]

        patterns = group.patterns_for_strand(fm.strand)
        plen = group.pattern_len
        k1 = int(plen * BARCODE_K_FRAC)

        best = oracle.best_match_per_pattern(patterns, window, k1)
        matched = sum(1 for b in best if b is not None)
        if matched <= 1 and k1 < plen:
            best = oracle.best_match_per_pattern(patterns, window, plen)

        candidates = [(b, idx) for idx, b in enumerate(best) if b is not None]
        for aln, _ in candidates:
            aln.strand = fm.strand

        if not candidates:
            self._push_flank_only(results, read_id, n, group, fm)
            return

        perfect = self.perfect_scores[group_i]
        scored = []
        for aln, idx in candidates:
            s = lodhi_from_ops(aln.ops)
            s_norm = s / perfect if perfect > 0.0 else 0.0
            scored.append((s_norm, s, aln, idx))
        # Stable sort, descending normalized score (ties keep index order).
        scored.sort(key=lambda t: -t[0])

        pad_start, _ = group.pad_region
        bar_start_abs, bar_end_abs = group.bar_region
        rel_bar_start = bar_start_abs - pad_start
        rel_bar_end = bar_end_abs - pad_start

        top = scored[0]
        mapped = oracle.map_pattern_interval(top[2], rel_bar_start, rel_bar_end)
        if mapped is None:
            raise RuntimeError("No barcode match region found; unusual")
        (bar_s, bar_e), (read_bar_s, read_bar_e), bar_cost = mapped

        top_norm = top[0]
        is_valid = top_norm >= self.min_score
        if len(scored) > 1:
            is_valid = is_valid and (top_norm - scored[1][0]) >= self.min_score_diff

        flank_start_fwd, flank_end_fwd = self._fwd_span(fm, n)

        if is_valid:
            top_barcode = group.barcodes[top[3]]
            results.append(
                BarbellMatch(
                    read_id=read_id,
                    read_len=n,
                    rel_dist_to_end=rel_dist_to_end(flank_start_fwd, n),
                    read_start_bar=region_start + read_bar_s,
                    read_end_bar=region_start + read_bar_e,
                    read_start_flank=flank_start_fwd,
                    read_end_flank=flank_end_fwd,
                    bar_start=region_start + bar_s,
                    bar_end=region_start + bar_e,
                    match_type=top_barcode.match_type,
                    flank_cost=fm.cost_int,
                    barcode_cost=int(bar_cost),
                    label=top_barcode.label,
                    strand=fm.strand,
                    cuts=None,
                )
            )
        else:
            self._push_flank_only(results, read_id, n, group, fm)

    def _push_flank_only(
        self,
        results: List[BarbellMatch],
        read_id: str,
        n: int,
        group: BarcodeGroup,
        fm: oracle.Alignment,
    ) -> None:
        flank_start_fwd, flank_end_fwd = self._fwd_span(fm, n)
        results.append(
            BarbellMatch(
                read_id=read_id,
                read_len=n,
                rel_dist_to_end=rel_dist_to_end(flank_start_fwd, n),
                read_start_bar=flank_start_fwd,
                read_end_bar=flank_end_fwd,
                read_start_flank=flank_start_fwd,
                read_end_flank=flank_end_fwd,
                bar_start=0,
                bar_end=0,
                match_type=group.barcodes[0].match_type.as_flank(),
                flank_cost=fm.cost_int,
                barcode_cost=len(group.barcodes[0].seq),
                label="flank",
                strand=fm.strand,
                cuts=None,
            )
        )
