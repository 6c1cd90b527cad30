"""Batched demux engine on one CUDA device (or the CPU).

Counterpart of :class:`barbell_tpu.models.pipeline.JaxDemuxEngine` for
the ends-only scan (``ends_window`` set), single device.  Per batch the
host plans rows with numpy and the native encoder — simple reads whole,
long reads as prefix/suffix end windows, all as concatenated 2-bit codes
with an exception list for non-ACGT bytes and a 4-byte/row descriptor —
uploads them, and runs ONE fused device call per group
(:func:`barbell_tpu_torch.ops.composite.demux_call`).  The packed hit
records come back and :meth:`TorchDemuxEngine._finish_table` turns them
into a :class:`~barbell_tpu.models.hittable.HitTable` whose rows equal
the JAX engine's (enforced by tests).

Not ported here (each raises with a pointer to ROADMAP.md): the whole-
read / chunked full scan, the nibble pack mode used when the native IO
library is missing or a batch carries more than 4096 non-ACGT bytes,
and multi-device meshes.
"""

from __future__ import annotations

import ctypes
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from barbell_tpu import PADDING
from barbell_tpu.models import hittable
from barbell_tpu.models.barcodes import BarcodeGroup
from barbell_tpu.models.demux import COLLAPSE_OVERLAP, Demuxer
from barbell_tpu.models.hittable import HitTable
from barbell_tpu.native import get_lib
from barbell_tpu.ops import oracle
from barbell_tpu.utils import dna

from .. import _build
from ..ops import composite as comp
from .groups import GroupPlan

MAX_ROW_LEN = 8192
MAX_HITS_PER_ROW = 16  # K for valley compaction
_EXC_CAP = 4096  # non-ACGT bytes per batch the 2-bit encoding carries
_CAT_BUCKET = 128 * 1024  # concatenated-code buffer size floor
#: batches in flight in engine_map_batches
PIPELINE_DEPTH = 8

_NOT_PORTED = "not ported yet (see ROADMAP.md, 'Off the slice')"


def engine_map_batches(engine, batches):
    """Run ``engine.demux_batch_table`` over an iterator of (ids, seqs)
    batches with PIPELINE_DEPTH batches in flight on worker threads;
    yields (ids, seqs, table) in order.  Host planning of one batch
    overlaps another batch's device work (kernels and copies release
    the GIL)."""
    depth = PIPELINE_DEPTH
    fn = engine.demux_batch_table
    with ThreadPoolExecutor(max_workers=depth) as pool:
        inflight = deque()
        for ids, seqs in batches:
            inflight.append((ids, seqs, pool.submit(fn, ids, seqs)))
            while len(inflight) > depth:
                bids, bseqs, fut = inflight.popleft()
                yield bids, bseqs, fut.result()
        while inflight:
            bids, bseqs, fut = inflight.popleft()
            yield bids, bseqs, fut.result()


def _pow2_at_least(x: int, lo: int = 8) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


def _retry_cap(total: int, h_cap: int) -> int:
    """Overflow-retry hit capacity: the measured total + 12.5% slack at a
    256-granule (strand-split rank lanes), strictly above the failed cap."""
    return max(-(-(total + total // 8) // 256) * 256, h_cap + 256)


def _over_words(R: int) -> int:
    """int32 words of demux_call's packed overflow bitmask for R rows."""
    return (R + 31) // 32


def _over_rows(words: np.ndarray, R: int) -> np.ndarray:
    """Row indices flagged in the packed overflow bitmask."""
    bits = np.unpackbits(
        np.ascontiguousarray(words, dtype="<i4").view(np.uint8),
        bitorder="little",
    )[:R]
    return np.nonzero(bits)[0]


class _Plan:
    """Host-row plan of one batch: ``[0, S)`` simple forward reads,
    ``[S, F = S + 2E)`` prefix/suffix row pairs of the E long reads."""

    __slots__ = ("simple_reads", "ends_reads", "S", "E", "F")


class _Mat:
    """One batch's materialized host arrays (see _materialize)."""

    __slots__ = ("host_packed", "exc", "meta", "row_read", "rowdesc")


class TorchDemuxEngine:
    """Ends-scan demux engine; ``device`` is where the fused call runs
    (``"cuda"`` launches the hand-written kernels, ``"cpu"`` runs their
    plain PyTorch versions)."""

    def __init__(
        self,
        groups: Sequence[BarcodeGroup],
        alpha: float = 0.4,
        min_score: float = 0.2,
        min_score_diff: float = 0.1,
        ends_window=None,  # int (symmetric) | (W_left, W_right)
        device="cuda",
    ):
        self.device = torch.device(device)
        # build what the batches need once, here, and not inside the
        # first batch: the kernels and the native 2-bit encoder
        if self.device.type == "cuda":
            _build.load()
        if get_lib() is None:
            raise NotImplementedError(
                f"the native IO library is unavailable (needs g++ and zlib); "
                f"the nibble pack mode that would replace it is {_NOT_PORTED}"
            )
        self.groups = list(groups)
        self.alpha = float(alpha)
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {self.alpha}")
        self.alpha_scaled = oracle.scale_alpha(alpha)
        self.min_score = float(min_score)
        self.min_score_diff = float(min_score_diff)
        self.max_row_len = MAX_ROW_LEN
        self.K = MAX_HITS_PER_ROW
        self.plans = [GroupPlan(g, self.device) for g in self.groups]
        self.halo = max(p.span for p in self.plans) + PADDING + 2
        self._fallback: Optional[Demuxer] = None
        # Sticky hit-record capacity: the first overflow raises it for
        # every later batch (one retry instead of one per batch).
        self._h_cap_hint = 0

        # Global label vocabulary: every group's barcode labels in plan
        # order, then the shared "flank" sentinel.
        self.labels: List[str] = []
        for p in self.plans:
            p.label_base = len(self.labels)
            self.labels.extend(b.label for b in p.group.barcodes)
        self.flank_label = len(self.labels)
        self.labels.append("flank")
        self._label_index = {lab: i for i, lab in enumerate(self.labels)}

        # Valley keys (cost_scaled*(L+2)+col) must stay below the 2**30
        # sentinel: long flanks shrink the row width until keys fit.
        max_k_scaled = max(p.k_units for p in self.plans) * oracle.COST_SCALE
        while (
            self.max_row_len > 256
            and max_k_scaled * (self.max_row_len + 2) + self.max_row_len >= 2**30
        ):
            self.max_row_len //= 2
        if max_k_scaled * (self.max_row_len + 2) + self.max_row_len >= 2**30:
            raise ValueError(
                f"flank threshold too large for valley keys: k_scaled="
                f"{max_k_scaled} needs rows shorter than 256"
            )
        if self.max_row_len <= self.halo + PADDING + 2:
            raise ValueError(
                f"row width {self.max_row_len} cannot hold the flank halo "
                f"{self.halo}"
            )

        # Ends-only scan: reads longer than max(W, L) ship only their
        # first W_l / last W_r bases as two forward rows (rc twins built
        # on the device).  The claim ranges tile at C = max(n-W_r+halo+1,
        # W_l-PADDING), so reads up to W_l+W_r-halo-PADDING-1 are covered
        # completely and only longer reads skip their middle.
        if not ends_window:
            raise NotImplementedError(f"the whole-read scan is {_NOT_PORTED}")
        if isinstance(ends_window, (tuple, list)):
            wl, wr = int(ends_window[0]), int(ends_window[1])
        else:
            wl = wr = int(ends_window)
        for W in (wl, wr):
            if W <= self.halo + PADDING + 2:
                raise ValueError(
                    f"ends window {W} must exceed halo+padding "
                    f"({self.halo + PADDING + 2})"
                )
            if W > self.max_row_len:
                raise ValueError(
                    f"ends window {W} needs rows of W <= max_row_len "
                    f"({self.max_row_len})"
                )
        self.ends_wl, self.ends_wr = wl, wr
        #: max per-side width: row-width / ends-cut decisions use it
        self.ends_window = max(wl, wr)

    # ------------------------------------------------------------------

    def _scalar_fallback(self) -> Demuxer:
        if self._fallback is None:
            d = Demuxer(
                alpha=self.alpha,
                min_score=self.min_score,
                min_score_diff=self.min_score_diff,
            )
            for g in self.groups:
                d.add_query_group(g)
            self._fallback = d
        return self._fallback

    def demux_batch_table(
        self, read_ids: List[str], seqs: List[bytes]
    ) -> HitTable:
        """One batch's annotation rows as a columnar :class:`HitTable`."""
        B = len(seqs)
        seq_bytes = [
            s if type(s) is bytes else dna.seq_to_bytes(s).tobytes()
            for s in seqs
        ]
        lens = np.array([len(s) for s in seq_bytes], dtype=np.int64)
        if B == 0 or lens.max(initial=0) == 0:
            return hittable.empty_table(read_ids, lens, self.labels)
        if int(lens.max()) >= 1 << 29:
            raise NotImplementedError(
                f"reads of 2**29 bases or more need the wire-metadata mode, "
                f"which is {_NOT_PORTED}"
            )

        L = self._choose_L(lens)
        plan = self._plan(lens, L)
        R_host_pad = _pow2_at_least(max(plan.F, 1), 8)
        S_pad = R_host_pad
        R_total_pad = R_host_pad + S_pad
        # flat row indexing is int32: split oversized batches
        if R_total_pad * L >= 2**31:
            if B == 1:
                return self._table_from_fallback(read_ids, seqs, lens)
            half = B // 2
            return self._concat_tables(
                self.demux_batch_table(read_ids[:half], seqs[:half]),
                self.demux_batch_table(read_ids[half:], seqs[half:]),
            )

        mat = self._materialize(plan, seq_bytes, lens, L, R_host_pad, S_pad)
        exc = mat.exc
        # entries fill the exception list in order: a sentinel at index
        # 64 means <= 64 real entries, so upload only that prefix
        if exc.shape[0] > 64 and exc[64, 0] == R_host_pad * L:
            exc = exc[:64]
        dev = self.device
        dev_in = (
            torch.from_numpy(mat.host_packed).to(dev),
            torch.from_numpy(mat.rowdesc).to(dev),
            torch.from_numpy(np.ascontiguousarray(exc)).to(dev),
        )

        packets: List[tuple] = []  # (GroupPlan, packet dict) in plan order
        overflow_reads: set = set()
        H_cap = self._h_cap(B)
        for gplan in self.plans:
            out_np = self._call(gplan, dev_in, L, H_cap, S_pad)
            cap = H_cap
            wcols, wbits = self._rec_wire(gplan, L, R_total_pad)
            nw = _over_words(R_total_pad)
            rec = self._unpack_rec(out_np, cap, wbits)
            over = out_np[cap * wcols : cap * wcols + nw]
            total = int(out_np[-1])
            if total > cap:
                # Hit-dense batch: one retry at a larger capacity (sticky —
                # later batches start there), then whole-batch fallback.
                cap = _retry_cap(total, H_cap)
                self._h_cap_hint = max(self._h_cap_hint, cap)
                out_np = self._call(gplan, dev_in, L, cap, S_pad)
                rec = self._unpack_rec(out_np, cap, wbits)
                over = out_np[cap * wcols : cap * wcols + nw]
                total = int(out_np[-1])
                if total > cap:
                    overflow_reads.update(range(B))
                    continue
            for r in _over_rows(over, R_total_pad):
                if mat.row_read[r] >= 0:
                    overflow_reads.add(int(mat.row_read[r]))
            pkt = self._gather_packet(rec, mat.row_read, mat.meta)
            if pkt is not None:
                packets.append((gplan, pkt))

        return self._finish_table(read_ids, seqs, lens, packets, overflow_reads)

    # ------------------------------------------------------------------

    def _choose_L(self, lens: np.ndarray) -> int:
        """Ends mode: L = pow2(min(lmax, W)) — reads <= L ship whole
        (they are their own ends), longer reads become two W-wide end
        rows that each fill a whole row."""
        lmax = int(lens.max())
        eff = min(max(lmax, self.halo + PADDING + 3), self.ends_window)
        return min(_pow2_at_least(eff, lo=256), self.max_row_len)

    def _plan(self, lens, L: int) -> _Plan:
        """Simple reads first, then the prefix/suffix row pairs of reads
        longer than max(L, W).  Every read of length <= W fits a row
        (``_choose_L`` makes L >= min(lmax, W)), so ends mode never
        needs the chunk rows of the full scan."""
        plan = _Plan()
        ends_cut = max(L, self.ends_window)
        simple_reads: List[int] = []
        ends_reads: List[int] = []
        for ridx in range(len(lens)):
            n = lens[ridx]
            if n == 0:
                continue
            if n > ends_cut:
                ends_reads.append(ridx)
            elif n > L:
                raise RuntimeError(
                    f"read of {n} bases needs chunk rows (L={L}); chunked "
                    f"rows are {_NOT_PORTED}"
                )
            else:
                simple_reads.append(ridx)
        plan.simple_reads = simple_reads
        plan.ends_reads = ends_reads
        plan.S = len(simple_reads)
        plan.E = len(ends_reads)
        plan.F = plan.S + 2 * plan.E
        return plan

    def _materialize(
        self, plan, seq_bytes, lens, L: int, R_host_pad: int, S_pad: int
    ) -> _Mat:
        """The batch's host arrays: packed rows, exceptions, the row
        descriptors the device derives metadata from, and the same
        metadata on the host (the packet assembly reads it)."""
        R_total_pad = R_host_pad + S_pad
        host_packed, exc = self._pack_host_rows(seq_bytes, plan, R_host_pad, L)

        meta = np.zeros((R_total_pad, comp.META_COLS), dtype=np.int32)
        meta[:, comp.M_HI] = -1
        row_read = np.full(R_total_pad, -1, dtype=np.int64)
        rowdesc = np.zeros(R_host_pad, dtype=np.int32)

        # Simple reads fill rows [0, S) (fwd) and [R_host_pad,
        # R_host_pad + S) (their rc twins).
        S, E, F = plan.S, plan.E, plan.F
        if S:
            sr = np.asarray(plan.simple_reads, dtype=np.int64)
            ns = np.asarray(lens, dtype=np.int64)[sr].astype(np.int32)
            idx = np.arange(S, dtype=np.int32)
            fwd = meta[:S]
            fwd[:, comp.M_TEC] = ns
            fwd[:, comp.M_TSTART] = 1
            fwd[:, comp.M_TEND] = 1
            fwd[:, comp.M_HI] = ns
            fwd[:, comp.M_N] = ns
            fwd[:, comp.M_FSIMPLE] = idx
            fwd[:, comp.M_NCHUNKS] = 1
            rc = meta[R_host_pad : R_host_pad + S]
            rc[:, comp.M_TSC] = L - ns
            rc[:, comp.M_TEC] = L
            rc[:, comp.M_TSTART] = 1
            rc[:, comp.M_TEND] = 1
            rc[:, comp.M_LO] = L - ns
            rc[:, comp.M_HI] = L
            rc[:, comp.M_N] = ns
            rc[:, comp.M_ISRC] = 1
            rc[:, comp.M_FSIMPLE] = idx
            rc[:, comp.M_NCHUNKS] = 1
            row_read[:S] = sr
            row_read[R_host_pad : R_host_pad + S] = sr
            rowdesc[:S] = ns << 2  # tag 0

        # Ends rows [S, F): interleaved prefix/suffix pairs, plus their
        # on-device rc twins.  The flip of the forward PREFIX is the
        # rc-coordinate SUFFIX window (and vice versa); both cover rows
        # are the forward pair (baserow = prefix row).  Claim partition:
        # the prefix claims end positions [0, W_l-1-PADDING], the suffix
        # [C, n] with C = max(n-W_r+halo+1, W_l-PADDING).  Must stay in
        # lockstep with composite._derive_meta.
        if E:
            W_l, W_r = self.ends_wl, self.ends_wr
            er = np.asarray(plan.ends_reads, dtype=np.int64)
            ne = np.asarray(lens, dtype=np.int64)[er].astype(np.int32)
            suf_lo = np.maximum(self.halo + 1, W_l + W_r - PADDING - ne)
            rows_p = (S + 2 * np.arange(E, dtype=np.int64)).astype(np.int32)
            blk = np.zeros((2 * E, comp.META_COLS), dtype=np.int32)
            pre, suf = blk[0::2], blk[1::2]
            for half in (pre, suf):
                half[:, comp.M_N] = ne
                half[:, comp.M_FSIMPLE] = -1
                half[:, comp.M_BASEROW] = rows_p
                half[:, comp.M_NCHUNKS] = 2
                half[:, comp.M_ENDS] = 1
            pre[:, comp.M_TEC] = W_l
            pre[:, comp.M_TSTART] = 1
            pre[:, comp.M_HI] = W_l - 1 - PADDING
            suf[:, comp.M_TEC] = W_r
            suf[:, comp.M_TEND] = 1
            suf[:, comp.M_LO] = suf_lo
            suf[:, comp.M_HI] = W_r
            suf[:, comp.M_OFF] = ne - W_r
            meta[S:F] = blk

            tb = np.zeros((2 * E, comp.META_COLS), dtype=np.int32)
            tpre, tsuf = tb[0::2], tb[1::2]  # flips of fwd prefix/suffix
            for half in (tpre, tsuf):
                half[:, comp.M_TEC] = L
                half[:, comp.M_N] = ne
                half[:, comp.M_ISRC] = 1
                half[:, comp.M_FSIMPLE] = -1
                half[:, comp.M_BASEROW] = rows_p
                half[:, comp.M_NCHUNKS] = 2
                half[:, comp.M_ENDS] = 1
            tpre[:, comp.M_TSC] = L - W_l
            tpre[:, comp.M_TEND] = 1  # rc suffix window
            tpre[:, comp.M_LO] = (L - W_l) + suf_lo
            tpre[:, comp.M_HI] = L
            tpre[:, comp.M_OFF] = ne - W_l
            tsuf[:, comp.M_TSC] = L - W_r
            tsuf[:, comp.M_TSTART] = 1  # rc prefix window
            tsuf[:, comp.M_LO] = L - W_r
            tsuf[:, comp.M_HI] = L - 1 - PADDING
            meta[R_host_pad + S : R_host_pad + F] = tb

            er2 = np.repeat(er, 2)
            row_read[S:F] = er2
            row_read[R_host_pad + S : R_host_pad + F] = er2
            rowdesc[S:F:2] = (ne << 2) | 1
            rowdesc[S + 1 : F : 2] = (ne << 2) | 2

        mat = _Mat()
        mat.host_packed = host_packed
        mat.exc = exc
        mat.meta = meta
        mat.row_read = row_read
        mat.rowdesc = rowdesc
        return mat

    def _entry_blob(self, seq_bytes, plan):
        """Blob + per-entry (offs, lens) covering host rows [0, F):
        simple reads whole, then each ends read's prefix/suffix window
        slices — entry order == host row order, so the native encoder's
        exception positions (entry * L + col) land on the right rows."""
        S, E, F = plan.S, plan.E, plan.F
        W_l, W_r = self.ends_wl, self.ends_wr
        ls = np.zeros(F, dtype=np.int32)
        if S:
            ls[:S] = np.fromiter(
                (len(seq_bytes[r]) for r in plan.simple_reads),
                dtype=np.int32, count=S,
            )
        if E:
            ls[S:F:2] = W_l
            ls[S + 1 : F : 2] = W_r
        offs = np.zeros(F, dtype=np.int64)
        if F > 1:
            np.cumsum(ls[:-1], dtype=np.int64, out=offs[1:])
        parts = [seq_bytes[r] for r in plan.simple_reads]
        for r in plan.ends_reads:
            s = seq_bytes[r]
            parts.append(s[:W_l])
            parts.append(s[len(s) - W_r :])
        return b"".join(parts), offs, ls

    def _pack_host_rows(self, seq_bytes, plan, R_host_pad: int, L: int):
        """-> (flat codes, exceptions): concatenated 2-bit base codes,
        rows back to back at CAT_ALIGN-byte starts (the device re-derives
        the starts with the same formula), encoded natively straight from
        the raw read bytes; N/IUPAC/junk bytes ride an exception list of
        (flat_pos, mask) pairs whose sentinel position (one past the
        padded rows) the device drops."""
        F = plan.F
        lib = get_lib()  # loaded by the constructor
        nb = np.zeros(R_host_pad, dtype=np.int64)
        blob, offs, ls = self._entry_blob(seq_bytes, plan)
        nb[:F] = (ls.astype(np.int64) + 3) // 4
        A = comp.CAT_ALIGN
        stride = (nb + (A - 1)) // A * A
        starts = np.zeros(R_host_pad, dtype=np.int64)
        np.cumsum(stride[:-1], out=starts[1:])
        # >= L/4 bytes of slack past the last row: every device-side row
        # read spans a full L/4 bytes
        total = int(starts[-1] + nb[-1]) + L
        t_pad = max(_CAT_BUCKET, _pow2_at_least(total, 8))
        flat = np.zeros(t_pad, dtype=np.uint8)
        exc = np.zeros((_EXC_CAP, 2), dtype=np.int32)
        exc[:, 0] = R_host_pad * L
        total_exc = lib.bbio_encode_pack2_cat(
            blob,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            ls.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            F,
            L,
            dna.CODE2_LUT.tobytes(),
            dna.ENCODE_LUT.tobytes(),
            flat.ctypes.data_as(ctypes.c_char_p),
            exc.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            _EXC_CAP,
        )
        if total_exc > _EXC_CAP:
            raise NotImplementedError(
                f"batch carries {total_exc} non-ACGT bytes (> {_EXC_CAP}); "
                f"the nibble pack mode for such batches is {_NOT_PORTED}"
            )
        return flat, exc

    def _h_cap(self, B: int) -> int:
        """Initial hit-lane capacity: raw hit density is per read in ends
        mode (~1.1/read for single-end kits), so lanes start at 1.25/read
        at a 256-granule (strand-split rank lanes); the sticky hint holds
        the capacity an overflow retry measured."""
        lanes = B + B // 4 + 16
        return max(-(-lanes // 256) * 256, self._h_cap_hint)

    def _group_scalars(self, gplan: GroupPlan):
        gi = (
            int(self.alpha_scaled),
            int(gplan.mask_start),
            int(gplan.mask_end),
            int(gplan.k1_scaled),
            int(gplan.rel_bar_start),
            int(gplan.rel_bar_end),
        )
        gf = (
            float(np.float32(gplan.perfect)),
            float(np.float32(self.min_score)),
            float(np.float32(self.min_score_diff)),
        )
        return gi, gf

    def _rec_wire(self, gplan: GroupPlan, L: int, R_total_pad: int):
        """(wire_cols, wbits) of the hit-record layout — must agree with
        demux_call's rec_wire_spec on the same shapes."""
        wbits = comp.rec_wire_spec(
            L, R_total_pad, gplan.k_units, gplan.n_patterns, gplan.plen,
            gplan.barcode_window,
        )
        if wbits is None:
            return comp.REC_COLS, None
        return comp.REC_WIRE_COLS, wbits

    @staticmethod
    def _unpack_rec(out_np, cap, wbits):
        if wbits is None:
            return out_np[: cap * comp.REC_COLS].reshape(cap, comp.REC_COLS)
        return comp.unpack_rec_np(out_np, cap, wbits)

    def _call(self, gplan: GroupPlan, dev_in, L: int, H_cap: int,
              S_pad: int) -> np.ndarray:
        """One fused device call; returns its packed output on the host."""
        gi, gf = self._group_scalars(gplan)
        t = gplan.tensors
        out = comp.demux_call(
            t.flank, t.patw, t.patterns_all, *dev_in,
            gi=gi, gf=gf, K=self.K, m=gplan.m, k_units=gplan.k_units,
            Wf=gplan.span, plen=gplan.plen, Wb=gplan.barcode_window,
            P=gplan.n_patterns, H_cap=H_cap, padding=PADDING, L_rows=L,
            ends_w=self.ends_wl, ends_wr=self.ends_wr, halo=self.halo,
            S_pad=S_pad,
        )
        return out.cpu().numpy()

    @staticmethod
    def _gather_packet(rec, row_read, meta):
        """Raw hit arrays from one fused call's packed records, in the
        scalar engine's order: per read, fwd hits then rc hits, each by
        ascending end position.  Returns None when the call produced no
        hits."""
        lanes = np.nonzero(rec[:, comp.REC_HAS] == 1)[0]
        if lanes.size == 0:
            return None
        rows = rec[lanes, comp.REC_ROW]
        reads = row_read[rows]
        isrc = meta[rows, comp.M_ISRC]
        end_abs = (
            meta[rows, comp.M_OFF] + rec[lanes, comp.REC_COL] - meta[rows, comp.M_TSC]
        )
        order = np.lexsort((end_abs, isrc, reads))
        return dict(
            reads=reads[order],
            isrc=isrc[order].astype(np.int64),
            end=end_abs[order].astype(np.int64),
            rec=rec[lanes][order],
        )

    def _packet_columns(self, gplan: GroupPlan, pkt, lens):
        """Vectorized BarbellMatch field math for one packet."""
        rec = pkt["rec"]
        reads = pkt["reads"]
        isrc = pkt["isrc"]
        end = pkt["end"]
        n = lens[reads]
        fst = rec[:, comp.REC_FSTEXT].astype(np.int64)
        rc = isrc == 1
        fs = np.where(rc, n - end, fst)
        fe = np.where(rc, n - fst, end)
        SCALE = oracle.COST_SCALE
        fcost = (rec[:, comp.REC_COST].astype(np.int64) + SCALE // 2) // SCALE
        acc = rec[:, comp.REC_ACC] == 1
        if bool(np.any(acc & (rec[:, comp.REC_HASIV] == 0))):
            raise RuntimeError("No barcode match region found; unusual")
        bstart = rec[:, comp.REC_BSTART].astype(np.int64)
        top = rec[:, comp.REC_TOP].astype(np.int64) % gplan.n_patterns
        return {
            "reads": reads.astype(np.int64),
            "rel": hittable.rel_dist_vec(fs, n),
            "rsb": np.where(acc, bstart + rec[:, comp.REC_IVPJ], fs),
            "reb": np.where(acc, bstart + rec[:, comp.REC_IVEJ], fe),
            "rsf": fs,
            "ref": fe,
            "bs": np.where(acc, bstart + rec[:, comp.REC_IVPI], 0),
            "be": np.where(acc, bstart + rec[:, comp.REC_IVEI], 0),
            "mtype": np.where(
                acc, gplan.bar_mtype_codes[top], gplan.flank_code
            ),
            "fcost": fcost,
            "bcost": np.where(
                acc, rec[:, comp.REC_IVCOST].astype(np.int64),
                gplan.flank_cost_len,
            ),
            "label": np.where(acc, gplan.label_base + top, self.flank_label),
            "strand": isrc,
        }

    def _finish_table(
        self, read_ids, seqs, lens, packets, overflow_reads
    ) -> HitTable:
        """Merge per-group packets into the batch HitTable: restore per-
        read insertion order (group-major), run the overlap collapse, and
        splice scalar-fallback rows for overflow reads."""
        col_sets = [
            self._packet_columns(gplan, pkt, lens) for gplan, pkt in packets
        ]
        if col_sets:
            cols = {
                c: np.concatenate([cs[c] for cs in col_sets])
                for c in hittable.COLUMNS
            }
            # stable sort by read: per read, packet (= group) order is
            # preserved — the object path's insertion order
            order = np.argsort(cols["reads"], kind="stable")
            cols = {c: v[order] for c, v in cols.items()}
            if overflow_reads:
                ok = ~np.isin(
                    cols["reads"], np.fromiter(overflow_reads, dtype=np.int64)
                )
                cols = {c: v[ok] for c, v in cols.items()}
            # collapse order: (read, flank start), stable over insertion
            order = np.lexsort((cols["rsf"], cols["reads"]))
            cols = {c: v[order] for c, v in cols.items()}
            hot = hittable.collapse_candidate_rows(
                cols["reads"], cols["rsf"], cols["ref"], COLLAPSE_OVERLAP
            )
            if hot is not None:
                hot_idx = np.nonzero(hot)[0]
                keep_hot = hittable.collapse_keep_indices(
                    cols["reads"][hot_idx].tolist(),
                    cols["rsf"][hot_idx].tolist(),
                    cols["ref"][hot_idx].tolist(),
                    cols["mtype"][hot_idx].tolist(),
                    cols["fcost"][hot_idx].tolist(),
                    cols["bcost"][hot_idx].tolist(),
                    COLLAPSE_OVERLAP,
                )
                if len(keep_hot) != hot_idx.shape[0]:
                    keep = np.ones(cols["reads"].shape[0], dtype=bool)
                    keep[hot_idx] = False
                    keep[hot_idx[np.asarray(keep_hot, dtype=np.int64)]] = True
                    cols = {c: v[keep] for c, v in cols.items()}
        else:
            cols = {c: np.zeros(0, dtype=np.int64) for c in hittable.COLUMNS}

        if overflow_reads:
            extra = []
            for ridx in sorted(overflow_reads):
                matches = self._scalar_fallback().demux(
                    read_ids[ridx], seqs[ridx]
                )
                if not matches:
                    continue
                fb = hittable.matches_to_columns(
                    ridx, matches, self._label_index
                )
                if fb is None:  # pragma: no cover - labels always in vocab
                    raise RuntimeError(
                        "scalar fallback produced a label outside the "
                        "engine vocabulary"
                    )
                extra.append(fb)
            if extra:
                cols = {
                    c: np.concatenate([cols[c]] + [e[c] for e in extra])
                    for c in hittable.COLUMNS
                }
                # a read is either all-fallback or all-device, so the
                # stable read sort keeps each side's internal order
                order = np.argsort(cols["reads"], kind="stable")
                cols = {c: v[order] for c, v in cols.items()}

        return HitTable(
            read_ids=read_ids,
            read_lens=np.asarray(lens, dtype=np.int64),
            cols=cols,
            labels=self.labels,
        )

    def _table_from_fallback(self, read_ids, seqs, lens) -> HitTable:
        return self._finish_table(
            read_ids, seqs, lens, [], set(range(len(seqs)))
        )

    @staticmethod
    def _concat_tables(a: HitTable, b: HitTable) -> HitTable:
        off = len(a.read_ids)
        cols = {
            c: np.concatenate(
                [a.cols[c], b.cols[c] + (off if c == "reads" else 0)]
            )
            for c in hittable.COLUMNS
        }
        return HitTable(
            read_ids=list(a.read_ids) + list(b.read_ids),
            read_lens=np.concatenate([a.read_lens, b.read_lens]),
            cols=cols,
            labels=a.labels,
        )
