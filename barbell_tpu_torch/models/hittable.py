"""Columnar per-batch hit tables: the annotate hot path without
per-hit Python objects.

The batched engine's packed device records used to be assembled into
one ``BarbellMatch`` dataclass per hit; on the 1-core bench host that
object churn (construction, object-based overlap collapse, per-field
``str()`` serialization) was the GIL-bound ceiling on pipeline depth
(~18-46ms per 2048-read batch).  A :class:`HitTable` keeps the batch's
hits as numpy columns end to end: vectorized field math, a single-pass
index collapse over plain ints, and TSV serialization from column
lists.  ``table_to_matches`` materializes the exact same
``BarbellMatch`` rows for callers that need objects (filter/trim, the
row-identity tests).

Semantics are pinned by the object path: every transform here mirrors
:func:`barbell_tpu.models.collapse.collapse_overlapping_matches`
(reference ``src/annotate/interval.rs:4-79``) and
:meth:`BarbellMatch.to_tsv_row` exactly, enforced by
``tests/test_hittable.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .records import BarbellMatch, BarcodeType, Strand, rel_dist_to_end

# match_type wire codes (column ``mtype``)
MTYPES = (BarcodeType.Ftag, BarcodeType.Rtag, BarcodeType.Fflank, BarcodeType.Rflank)
MTYPE_CODE = {t: i for i, t in enumerate(MTYPES)}
MTYPE_STR = tuple(t.value for t in MTYPES)
_TAG_CODES = (MTYPE_CODE[BarcodeType.Ftag], MTYPE_CODE[BarcodeType.Rtag])
STRAND_STR = (Strand.Fwd.value, Strand.Rc.value)
_STRANDS = (Strand.Fwd, Strand.Rc)

#: column names, all int arrays of one length (one entry per hit row)
COLUMNS = (
    "reads",      # batch read index (rows grouped by read, ascending)
    "rel",        # rel_dist_to_end(read_start_flank)
    "rsb", "reb",  # read_start_bar / read_end_bar
    "rsf", "ref",  # read_start_flank / read_end_flank
    "bs", "be",    # bar_start / bar_end
    "mtype",      # MTYPES code
    "fcost", "bcost",
    "label",      # index into HitTable.labels
    "strand",     # 0=Fwd 1=Rc
)


@dataclass
class HitTable:
    """One batch's annotation rows, columnar.

    ``cols`` holds the :data:`COLUMNS` arrays; rows are grouped by
    ``reads`` ascending and, within a read, in the engine's output
    order (ascending flank start after overlap collapse — identical to
    the object path)."""

    read_ids: List[str]
    read_lens: np.ndarray  # int64 [B]
    cols: Dict[str, np.ndarray]
    labels: Sequence[str]  # label vocabulary (``label`` column indexes it)

    @property
    def n_rows(self) -> int:
        return int(self.cols["reads"].shape[0])

    def rows_per_read(self) -> np.ndarray:
        return np.bincount(
            self.cols["reads"], minlength=len(self.read_ids)
        ).astype(np.int64)


def empty_table(read_ids: List[str], read_lens: np.ndarray, labels) -> HitTable:
    return HitTable(
        read_ids=read_ids,
        read_lens=np.asarray(read_lens, dtype=np.int64),
        cols={c: np.zeros(0, dtype=np.int64) for c in COLUMNS},
        labels=labels,
    )


def rel_dist_vec(pos: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Vectorized :func:`barbell_tpu.models.records.rel_dist_to_end`."""
    pos = pos.astype(np.int64)
    n = n.astype(np.int64)
    left = np.where(pos <= 0, 1, pos)
    right = np.where(pos == n, -1, pos - n)
    return np.where(pos <= n // 2, left, right)


def collapse_candidate_rows(
    reads: np.ndarray,
    rsf: np.ndarray,
    ref_: np.ndarray,
    threshold: float,
) -> Optional[np.ndarray]:
    """Row-index mask of reads that can form a non-singleton overlap
    group, or None when no read can (every row survives).

    The scalar collapse extends a group only while CONSECUTIVE rows
    keep joining (it breaks at the first non-joining row), so if no
    consecutive same-read pair overlaps by >= threshold of the shorter
    flank, every group is a singleton — checked here as one vector op
    instead of a per-hit Python loop (the common case: RBK reads carry
    one hit, NBD reads one per end, far apart)."""
    n = reads.shape[0]
    if n < 2:
        return None
    same = reads[1:] == reads[:-1]
    ov = np.minimum(ref_[1:], ref_[:-1]) - np.maximum(rsf[1:], rsf[:-1])
    shorter = np.minimum(ref_[1:] - rsf[1:], ref_[:-1] - rsf[:-1])
    pair_hits = same & (ov > 0) & (ov >= threshold * shorter)
    if not pair_hits.any():
        return None
    hot_reads = np.unique(reads[:-1][pair_hits])
    return np.isin(reads, hot_reads)


def collapse_keep_indices(
    reads: List[int],
    rsf: List[int],
    ref_: List[int],
    mtype: List[int],
    fcost: List[int],
    bcost: List[int],
    threshold: float,
) -> List[int]:
    """Surviving row indices under the overlap collapse, given rows
    sorted by (read, read_start_flank) with stable insertion order.

    Mirrors ``collapse_overlapping_matches`` exactly: transitive
    overlap grouping (a row joins the current group if it overlaps ANY
    member by >= threshold of the shorter flank), then per group the
    stable-minimum of the object path's sort key — barcode rows
    (Ftag/Rtag) before flank-only rows, then (barcode_cost, flank_cost)
    ascending, flank-only ties broken by longer flank."""
    keep: List[int] = []
    N = len(reads)
    i = 0
    while i < N:
        r = reads[i]
        # open a new overlap group with row i
        spans = [(rsf[i], ref_[i])]
        best_i = i
        is_tag = mtype[i] <= 1
        best_key = (
            (1, bcost[i], fcost[i], 0)
            if is_tag
            else (2, 0, 0, rsf[i] - ref_[i])
        )
        i += 1
        while i < N and reads[i] == r:
            s, e = rsf[i], ref_[i]
            hit = False
            for gs, ge in spans:
                start = s if s > gs else gs
                end = e if e < ge else ge
                if end <= start:
                    continue
                ml = e - s
                gl = ge - gs
                if gl < ml:
                    ml = gl
                if (end - start) / ml >= threshold:
                    hit = True
                    break
            if not hit:
                break
            spans.append((s, e))
            is_tag = mtype[i] <= 1
            key = (
                (1, bcost[i], fcost[i], 0)
                if is_tag
                else (2, 0, 0, s - e)
            )
            if key < best_key:
                best_key = key
                best_i = i
            i += 1
        keep.append(best_i)
    return keep


def emit_tsv_lines(table: HitTable) -> List[str]:
    """TSV rows (no trailing newline), byte-identical to
    ``BarbellMatch.to_tsv_row`` for engine output (cuts always empty)."""
    c = table.cols
    n = table.n_rows
    if n == 0:
        return []
    ids = table.read_ids
    lens_l = table.read_lens.tolist()
    labels = table.labels
    reads_l = c["reads"].tolist()
    out = []
    for read, rel, rsb, reb, rsf, ref_, bs, be, mt, fc, bc, lab, st in zip(
        reads_l,
        c["rel"].tolist(),
        c["rsb"].tolist(),
        c["reb"].tolist(),
        c["rsf"].tolist(),
        c["ref"].tolist(),
        c["bs"].tolist(),
        c["be"].tolist(),
        c["mtype"].tolist(),
        c["fcost"].tolist(),
        c["bcost"].tolist(),
        c["label"].tolist(),
        c["strand"].tolist(),
    ):
        out.append(
            f"{ids[read]}\t{lens_l[read]}\t{rel}\t{rsb}\t{reb}\t{rsf}\t"
            f"{ref_}\t{bs}\t{be}\t{MTYPE_STR[mt]}\t{fc}\t{bc}\t"
            f"{labels[lab]}\t{STRAND_STR[st]}\t"
        )
    return out


def table_to_matches(table: HitTable) -> List[List[BarbellMatch]]:
    """Materialize per-read ``BarbellMatch`` lists (the object API)."""
    B = len(table.read_ids)
    out: List[List[BarbellMatch]] = [[] for _ in range(B)]
    c = table.cols
    if table.n_rows == 0:
        return out
    ids = table.read_ids
    lens_l = table.read_lens.tolist()
    labels = table.labels
    for read, rel, rsb, reb, rsf, ref_, bs, be, mt, fc, bc, lab, st in zip(
        c["reads"].tolist(),
        c["rel"].tolist(),
        c["rsb"].tolist(),
        c["reb"].tolist(),
        c["rsf"].tolist(),
        c["ref"].tolist(),
        c["bs"].tolist(),
        c["be"].tolist(),
        c["mtype"].tolist(),
        c["fcost"].tolist(),
        c["bcost"].tolist(),
        c["label"].tolist(),
        c["strand"].tolist(),
    ):
        out[read].append(
            BarbellMatch(
                read_id=ids[read],
                read_len=lens_l[read],
                rel_dist_to_end=rel,
                read_start_bar=rsb,
                read_end_bar=reb,
                read_start_flank=rsf,
                read_end_flank=ref_,
                bar_start=bs,
                bar_end=be,
                match_type=MTYPES[mt],
                flank_cost=fc,
                barcode_cost=bc,
                label=labels[lab],
                strand=_STRANDS[st],
                cuts=None,
            )
        )
    return out


def matches_to_columns(
    ridx: int,
    matches: List[BarbellMatch],
    label_index: Dict[str, int],
) -> Optional[Dict[str, np.ndarray]]:
    """Column arrays for one read's object rows (the scalar-fallback
    splice).  Returns None when a label is outside the vocabulary
    (caller keeps that read on the object path)."""
    n = len(matches)
    cols = {c: np.zeros(n, dtype=np.int64) for c in COLUMNS}
    for i, m in enumerate(matches):
        lab = label_index.get(m.label)
        if lab is None or m.cuts:
            return None
        cols["reads"][i] = ridx
        cols["rel"][i] = m.rel_dist_to_end
        cols["rsb"][i] = m.read_start_bar
        cols["reb"][i] = m.read_end_bar
        cols["rsf"][i] = m.read_start_flank
        cols["ref"][i] = m.read_end_flank
        cols["bs"][i] = m.bar_start
        cols["be"][i] = m.bar_end
        cols["mtype"][i] = MTYPE_CODE[m.match_type]
        cols["fcost"][i] = m.flank_cost
        cols["bcost"][i] = m.barcode_cost
        cols["label"][i] = lab
        cols["strand"][i] = 0 if m.strand is Strand.Fwd else 1
    return cols
