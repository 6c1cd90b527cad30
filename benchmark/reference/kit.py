"""The plain reference of one ``kit`` run: what each output file holds for
one read.

Built only from a configuration file (the kit's frozen construct
templates, its preset patterns and options) and the read itself.  Per
read: the flank search over each strand of the whole read, the end-window
restriction of the default ends scan (barbell_tpu_torch's documented
semantics, docs/SEMANTICS.md deviation 7: a flank match whose end lies in
the unscanned middle of a long read is not annotated; reads whose left
window holds a match near its edge are scanned again with the deep left
window), the barcode ranking of each flank match, the overlap collapse,
then inspect, filter and trim as barbell's kit command runs them
(`src/annotate/searcher.rs:430-490`, `src/annotate/interval.rs:4-79`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from . import pattern as pat
from . import search
from .records import FTAG, FWD, RC, RTAG, Row, as_flank, rel_dist_to_end

PADDING = 10  # bases around a barcode window (`src/lib.rs:10`)
BARCODE_K_FRAC = 0.4
COLLAPSE_OVERLAP = 0.8
BUCKET = 250
ID = "\x00"  # stands for the read id in the expected lines


def edit_cut_off(length: int) -> int:
    """Flank edit threshold (`src/annotate/edit_model.rs:1-11`)."""
    return max(0, math.ceil(0.5100 * length - 1.7312 * math.sqrt(length)))


@dataclass
class Group:
    flank: np.ndarray  # masks of prefix + N * barcode + suffix
    bar_region: Tuple[int, int]  # inclusive, within the flank
    pad_region: Tuple[int, int]
    labels: List[str]
    pats_fwd: np.ndarray  # [P, plen] masks
    pats_rc: np.ndarray
    match_type: str
    k: int
    perfect: float


def _common(seqs: List[str], rev: bool) -> int:
    n = 0
    first = seqs[0][::-1] if rev else seqs[0]
    while n < len(first) and all((s[::-1] if rev else s)[n] == first[n] for s in seqs):
        n += 1
    return n


def make_group(constructs: Dict[str, str], side: str) -> Group:
    labels = list(constructs)
    seqs = [constructs[lab] for lab in labels]
    pre, suf = _common(seqs, False), _common(seqs, True)
    n = len(seqs[0])
    mask = n - pre - suf
    flank = seqs[0][:pre] + "N" * mask + seqs[0][n - suf:]
    ps, pe = max(0, pre - PADDING), pre + mask + PADDING
    padded = [s[ps:min(pe, len(s))].encode() for s in seqs]
    return Group(
        flank=search.encode(flank.encode()),
        bar_region=(pre, pre + mask - 1),
        pad_region=(ps, pe),
        labels=labels,
        pats_fwd=np.stack([search.encode(p) for p in padded]),
        pats_rc=np.stack([search.encode(search.revcomp(p)) for p in padded]),
        match_type=FTAG if side == "left" else RTAG,
        k=edit_cut_off(pre + suf),
        perfect=search.perfect_score(pe - ps),
    )


def _pow2(x: int, lo: int = 256) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def ends_plan(patterns, groups: List[Group]):
    """The two-tier ends plan the preset patterns bound: ((W1, W1), deep
    (W2, W1) or None, trigger margin), or None (whole-read scan)."""
    ext = max(len(g.flank) + g.k for g in groups)
    halo = max(search.flank_span(len(g.flank), g.k) for g in groups) + PADDING + 2
    first = right = deep = chain_hi = 0
    for p in patterns:
        prev = None
        for el in p:
            if el.relative_to == "left":
                prev = el.range[1] + ext
                first = max(first, prev)
            elif el.relative_to == "prev_left":
                if prev is None:
                    return None
                chain_hi = max(chain_hi, el.range[1])
                prev = prev + el.range[1] + ext
            elif el.relative_to == "right":
                right = max(right, el.range[1] + ext)
                prev = None
                continue
            else:
                return None
            deep = max(deep, prev)

    def w(depth):
        return -(-(depth + halo + 1) // 128) * 128

    W1, W2 = w(max(first, right)), w(deep)
    if max(W1, W2) > 8192:
        return None
    if W2 > W1:
        return (W1, W1), (W2, W1), chain_hi + halo + 1
    return (W1, W1), None, 0


class KitReference:
    """Expected output lines of one read of a configuration."""

    def __init__(self, config: dict, full_scan: bool, precision: str = "float32"):
        opts = config["kit_options"]
        self.alpha = float(opts["alpha"])
        self.min_score = float(opts["min_score"])
        self.min_score_diff = float(opts["min_score_diff"])
        self.precision = precision
        self.groups = [make_group(t["constructs"], t["side"]) for t in config["templates"]]
        self.patterns = [pat.parse(p) for p in config["patterns"]]
        self.halo = max(search.flank_span(len(g.flank), g.k) for g in self.groups) + PADDING + 2
        self.plan = None if full_scan else ends_plan(self.patterns, self.groups)

    # -- annotation ------------------------------------------------------

    def _claimed(self, j: int, n: int, rc: bool, window) -> bool:
        """Whether an end position ``j`` (strand coordinates) lies in the
        claims of an ends scan with windows ``window`` = (W_l, W_r).  Reads
        no longer than the row width are scanned whole (every read of the
        traffic is longer than the plan's windows, so the row width is
        the windows' power of two)."""
        if window is None:
            return True
        wl, wr = window
        if n <= max(_pow2(max(wl, wr)), max(wl, wr)):
            return True
        first, last = (wr, wl) if rc else (wl, wr)
        return j <= first - 1 - PADDING or j >= max(n - last + self.halo + 1, first - PADDING)

    def _demux(self, rid: str, seq: bytes, window) -> List[Row]:
        text = search.encode(seq)
        n = len(text)
        if n == 0:
            return []
        text_rc = search.rc_masks(text)
        rows: List[Row] = []
        for g in self.groups:
            for rc, t in ((False, text), (True, text_rc)):
                for start, end, cost, path, _ops in search.flank_search(g.flank, t, g.k, self.alpha, self.precision):
                    if self._claimed(end, n, rc, window):
                        self._barcode(rows, rid, text, n, g, rc, start, end, cost, path)
        return _collapse(rows)

    def _barcode(self, rows, rid, text, n, g: Group, rc, start, end, cost, path):
        fs, fe = (n - end, n - start) if rc else (start, end)
        strand = RC if rc else FWD
        region = search.matching_region(path, rc, g.bar_region[0], g.bar_region[1], n)
        if region is None:
            return
        rs, re_ = max(0, region[0] - PADDING), min(region[1] + PADDING, n)
        if re_ <= rs:
            return

        def flank_only():
            rows.append(Row(rid, n, rel_dist_to_end(fs, n), fs, fe, fs, fe, 0, 0,
                            as_flank(g.match_type), search.cost_int(cost),
                            g.pats_fwd.shape[1], "flank", strand))

        cand, _c, _e, _s, lodhi, paths = search.barcode_search(
            g.pats_rc if rc else g.pats_fwd, text[rs:re_], BARCODE_K_FRAC, self.precision)
        top, ok = search.select(cand, lodhi, g.perfect, self.min_score,
                                self.min_score_diff, self.precision)
        if top is None or not ok:
            flank_only()
            return
        tpath, tops = paths[top]
        b0, b1 = g.bar_region[0] - g.pad_region[0], g.bar_region[1] - g.pad_region[0]
        mapped = search.pattern_interval(tpath, tops, b0, b1)
        if mapped is None:
            raise RuntimeError("no barcode region in the top alignment")
        (bs, be), (tbs, tbe), bcost = mapped
        rows.append(Row(rid, n, rel_dist_to_end(fs, n), rs + tbs, rs + tbe, fs, fe,
                        rs + bs, rs + be, g.match_type, search.cost_int(cost), bcost,
                        g.labels[top], strand))

    def annotate(self, rid: str, seq: bytes) -> List[Row]:
        if self.plan is None:
            return self._demux(rid, seq, None)
        shallow, deep, margin = self.plan
        rows = self._demux(rid, seq, shallow)
        if deep is None:
            return rows
        cover = shallow[0] + shallow[1] - self.halo - PADDING - 1
        lo = shallow[0] - margin
        if len(seq) > cover and any(lo < r.read_end_flank < shallow[0] for r in rows):
            return self._demux(rid, seq, deep)
        return rows

    # -- the whole kit run of one read ------------------------------------

    def expected(self, seq: bytes, qual: bytes, desc: str) -> Dict[str, List[str]]:
        """{output file: [its records for this read]} with ``ID`` in place
        of the read id; FASTQ records as whole 4-line strings."""
        rows = self.annotate(ID, seq)
        if not rows:
            return {}
        out = {"annotation.tsv": [r.tsv() for r in rows],
               "pattern_per_read.tsv": [f"{ID}\t{pat.structure(rows, BUCKET)}"]}
        if not pat.filter_pass(rows, self.patterns):
            return out
        out["filtered.tsv"] = [r.tsv() for r in rows]
        for s, q, label, suffix in pat.trim(seq, qual, rows):
            head = f"{ID}{suffix} {desc}" if desc else f"{ID}{suffix}"
            out.setdefault(f"{label}.trimmed.fastq", []).append(
                f"@{head}\n{s.decode()}\n+\n{q.decode()}")
        return out


def _collapse(rows: List[Row]) -> List[Row]:
    if len(rows) <= 1:
        return rows
    ordered = sorted(rows, key=lambda r: r.read_start_flank)

    def overlap(a, b):
        s, e = max(a.read_start_flank, b.read_start_flank), min(a.read_end_flank, b.read_end_flank)
        if e <= s:
            return False
        return (e - s) / min(a.read_end_flank - a.read_start_flank,
                             b.read_end_flank - b.read_start_flank) >= COLLAPSE_OVERLAP

    def key(r):
        if r.match_type in (FTAG, RTAG):
            return (1, r.barcode_cost, r.flank_cost, 0)
        return (2, 0, 0, -(r.read_end_flank - r.read_start_flank))

    groups, cur = [], [ordered[0]]
    for r in ordered[1:]:
        if any(overlap(g, r) for g in cur):
            cur.append(r)
        else:
            groups.append(cur)
            cur = [r]
    groups.append(cur)
    return [sorted(g, key=key)[0] for g in groups]
