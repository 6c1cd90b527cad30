"""The fused per-batch demux call, in PyTorch around the three kernels.

Counterpart of :func:`barbell_tpu.ops.composite.demux_call`, production
branch only: 2-bit concatenated rows with device-derived metadata
(``pack_mode=2``, ``meta_mode='desc'``), the kernel path for every DP
stage, and strand-split barcode-rank lanes.  One call per (group,
batch) runs flank scan -> hit compaction -> flank traceback ->
barcode-window mapping -> barcode rank -> winner interval mapping and
returns the same flat int32 buffer: ``[H_cap * wire-record lanes] ++
[ceil(R/32) overflow-bitmask words] ++ [total]``.

Row coordinate model: every row holds its text in columns
``[tsc, tec]`` (forward rows left-aligned at 0; on-device rc twins
right-aligned ending at L).  Chunk rows (tag 3 descriptors) exist only
in full-scan batches, which this port does not run; see ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from barbell_tpu.ops.oracle import COST_SCALE

from .myers import TOPK as MYERS_TOPK
from .myers import myers_topk
from .rank import rank_pass1
from .window import VTOPK as WIN_VTOPK
from .window import window_interval, window_trace, window_valleys

UNIT = COST_SCALE
BIG = 2**30
CAT_ALIGN = 64  # byte alignment of concatenated rows (host packer too)

# Column layout of the per-hit record.
REC_COLS = 14
(REC_ROW, REC_COL, REC_COST, REC_HAS, REC_BSTART, REC_FSTEXT, REC_TOP,
 REC_ACC, REC_IVPJ, REC_IVEJ, REC_IVPI, REC_IVEI, REC_IVCOST,
 REC_HASIV) = range(REC_COLS)

# Packed wire layout: 6 int32 lanes per hit instead of 14.  Bit layout
# (rec_wire_spec guards every width; wbits = (Wb + 2).bit_length()):
#   lane 0: row (17) | col << 17 (14)
#   lane 1: top (8) | has2 << 8 | accepted << 9 | flank_cost << 10 (21)
#   lane 2: bstart   (read coordinates, unpacked)
#   lane 3: fs_text  (read coordinates, unpacked)
#   lane 4: iv_pj | iv_ej << wbits | iv_pi << 2*wbits | has_iv << 3*wbits
#   lane 5: iv_ei | iv_cost << wbits (21)
REC_WIRE_COLS = 6


def rec_wire_spec(L, R_total, k_units, P, plen, Wb):
    """wbits of the packed 6-lane hit record, or None when any field
    could overflow its lane (then the unpacked 14-lane layout is used).
    demux_call (pack) and the engine (unpack) compute this from the
    same shapes."""
    wbits = int(Wb + 2).bit_length()
    ok = (
        R_total < 2**17
        and L + 2 < 2**14
        and k_units * UNIT < 2**21
        and 2 * P < 2**8
        and plen * UNIT < 2**21
        and 3 * wbits + 1 <= 31
        and wbits + 21 <= 31
    )
    return wbits if ok else None


def unpack_rec_np(flat, cap, wbits):
    """[cap * REC_WIRE_COLS] packed int32 -> [cap, REC_COLS] int32."""
    w = np.asarray(flat[: cap * REC_WIRE_COLS]).reshape(cap, REC_WIRE_COLS)
    u = w.astype(np.uint32)
    mask = np.uint32((1 << wbits) - 1)
    rec = np.empty((cap, REC_COLS), dtype=np.int32)
    rec[:, REC_ROW] = (u[:, 0] & np.uint32(0x1FFFF)).astype(np.int32)
    rec[:, REC_COL] = (u[:, 0] >> 17).astype(np.int32)
    rec[:, REC_TOP] = (u[:, 1] & np.uint32(0xFF)).astype(np.int32)
    rec[:, REC_HAS] = ((u[:, 1] >> 8) & 1).astype(np.int32)
    rec[:, REC_ACC] = ((u[:, 1] >> 9) & 1).astype(np.int32)
    rec[:, REC_COST] = (u[:, 1] >> 10).astype(np.int32)
    rec[:, REC_BSTART] = w[:, 2]
    rec[:, REC_FSTEXT] = w[:, 3]
    rec[:, REC_IVPJ] = (u[:, 4] & mask).astype(np.int32)
    rec[:, REC_IVEJ] = ((u[:, 4] >> wbits) & mask).astype(np.int32)
    rec[:, REC_IVPI] = ((u[:, 4] >> (2 * wbits)) & mask).astype(np.int32)
    rec[:, REC_HASIV] = ((u[:, 4] >> (3 * wbits)) & 1).astype(np.int32)
    rec[:, REC_IVEI] = (u[:, 5] & mask).astype(np.int32)
    rec[:, REC_IVCOST] = (u[:, 5] >> wbits).astype(np.int32)
    return rec


# Column layout of the per-row metadata matrix.  M_ENDS marks ends-mode
# rows: the row holds one END WINDOW of a long read (prefix [0, W) or
# suffix [n-W, n)).
META_COLS = 13
(M_TSC, M_TEC, M_TSTART, M_TEND, M_LO, M_HI, M_OFF, M_N, M_ISRC,
 M_FSIMPLE, M_BASEROW, M_NCHUNKS, M_ENDS) = range(META_COLS)


def _complement_masks(m):
    """Nibble complement (A<->T, C<->G = bit reversal), elementwise."""
    m = m.to(torch.int32)
    c = ((m & 1) << 3) | ((m & 2) << 1) | ((m & 4) >> 1) | ((m & 8) >> 3)
    return c.to(torch.uint8)


def _gather_windows(rows, row_idx, starts, W: int):
    """windows[h] = rows[row_idx[h], starts[h] : starts[h] + W] with
    columns (and rows) clamped into the matrix; callers zero out
    anything past their window length, so clamp artifacts are never
    read."""
    R, L = rows.shape
    cols = (starts[:, None] + torch.arange(W, device=rows.device)).clamp(0, L - 1)
    r = row_idx.clamp(0, R - 1)
    return rows[r.long()[:, None], cols.long()]


def _window_cols(rows, starts, W):
    """Per-row fixed-width slices (row h reads its own row)."""
    return _gather_windows(
        rows, torch.arange(rows.shape[0], device=rows.device), starts, W
    )


def _derive_meta(rowdesc, S_pad: int, L: int, ends_w: int, ends_wr: int,
                 halo: int, padding: int):
    """Per-row metadata [R_host + S_pad, META_COLS] from the 4-byte/row
    descriptor: low 2 bits a type tag (0 simple forward read, 1 ends
    PREFIX row, 2 ends SUFFIX row, always right after its prefix), the
    rest the read length ``n`` (0 for padding rows).  Rows
    ``[R_host, R_host + S_pad)`` are the flip+complement twins of host
    rows ``[0, S_pad)``: a tag-0 twin is the rc simple row, a tag-1 twin
    the RC SUFFIX window, a tag-2 twin the RC PREFIX window.  Must match
    the host planner (``_materialize``)."""
    dev = rowdesc.device
    R_host = rowdesc.shape[0]
    tag = rowdesc & 3
    n = rowdesc >> 2  # rowdesc >= 0: arithmetic shift is logical here
    Wl = ends_w
    Wr = ends_wr if ends_wr else ends_w
    rowid = torch.arange(R_host, dtype=torch.int32, device=dev)

    def build(block_tag, block_n, block_row, twin: bool):
        is_simple = block_tag == 0
        is_pre = block_tag == 1
        is_suf = block_tag == 2
        is_ends = is_pre | is_suf
        valid = (block_n > 0) & (block_tag != 3)
        z = torch.zeros_like(block_n)
        # Suffix-claim start, row-local: the prefix (width Wl) claims
        # end positions [0, Wl-1-PADDING] and the suffix (width Wr)
        # [C, n] with C = max(n-Wr+halo+1, Wl-PADDING).
        suf_lo = torch.clamp(Wl + Wr - padding - block_n, min=halo + 1)
        if not twin:
            tsc = z
            tec = torch.where(is_simple, block_n, torch.where(is_pre, Wl, Wr))
            ts = is_simple | is_pre
            te = is_simple | is_suf
            lo = torch.where(is_suf, suf_lo, 0)
            hi = torch.where(
                is_simple, block_n, torch.where(is_pre, Wl - 1 - padding, Wr)
            )
            off = torch.where(is_suf, block_n - Wr, 0)
            isrc = z
        else:
            # flip of the corresponding host row, right-aligned at L
            tsc = torch.where(
                is_simple, L - block_n, torch.where(is_pre, L - Wl, L - Wr)
            )
            tec = torch.full_like(block_n, L)
            ts = is_simple | is_suf  # tag-2 flip = rc PREFIX
            te = is_simple | is_pre  # tag-1 flip = rc SUFFIX
            lo = torch.where(is_pre, (L - Wl) + suf_lo, tsc)
            hi = torch.where(is_suf, L - 1 - padding, L)
            off = torch.where(is_pre, block_n - Wl, 0)
            isrc = torch.ones_like(block_n)
        # ends rows: prefix host row p, suffix p+1; the barcode-window
        # cover base is p for both, and for twins the cover rows are
        # the FORWARD host rows
        base = torch.where(is_suf, block_row - 1, block_row)
        cols = [None] * META_COLS
        cols[M_TSC] = tsc
        cols[M_TEC] = torch.where(valid, tec, 0)
        cols[M_TSTART] = (ts & valid).to(torch.int32)
        cols[M_TEND] = (te & valid).to(torch.int32)
        cols[M_LO] = torch.where(valid, lo, 0)
        cols[M_HI] = torch.where(valid, hi, -1)
        cols[M_OFF] = torch.where(valid, off, 0)
        cols[M_N] = block_n
        cols[M_ISRC] = isrc
        cols[M_FSIMPLE] = torch.where(is_simple, block_row, -1)
        cols[M_BASEROW] = torch.where(valid, base, 0)
        cols[M_NCHUNKS] = torch.where(is_ends, 2, 1)
        cols[M_ENDS] = (is_ends & valid).to(torch.int32)
        return torch.stack([c.to(torch.int32) for c in cols], dim=1)

    host = build(tag, n, rowid, twin=False)
    twin = build(tag[:S_pad], n[:S_pad], rowid[:S_pad], twin=True)
    return torch.cat([host, twin], dim=0)


def _assemble_rows(flat_codes, row_start, exc, hlen, L: int, S_pad: int):
    """Rows from the concatenated 2-bit codes: each host row's
    ceil(len/4) code bytes scatter into the padded [R_host, L] layout as
    single-base masks (1 << code), positions past the row's content
    zero out, the exception list overrides N/IUPAC/junk bytes (entries
    are (flat_pos, mask) pairs; out-of-range positions are padding and
    dropped), and the rc twin block is the flip + complement of host
    rows [0, S_pad)."""
    dev = flat_codes.device
    R0 = row_start.shape[0]
    Q = L // 4
    idx = (row_start[:, None] + torch.arange(Q, device=dev)).clamp(
        0, flat_codes.shape[0] - 1
    )
    b = flat_codes[idx.long()].to(torch.int32)
    codes = torch.stack([(b >> (2 * s)) & 3 for s in range(4)], dim=2).reshape(R0, L)
    masks = (1 << codes).to(torch.uint8)
    jpos = torch.arange(L, device=dev)
    masks = torch.where(jpos[None, :] < hlen[:, None], masks, 0).to(torch.uint8)
    # scatter with a spill slot: dropped entries land on index R0 * L
    flat = torch.cat([masks.reshape(-1), torch.zeros(1, dtype=torch.uint8, device=dev)])
    pos = exc[:, 0].long()
    pos = torch.where((pos >= 0) & (pos < R0 * L), pos, R0 * L)
    flat[pos] = exc[:, 1].to(torch.uint8)
    host_rows = flat[: R0 * L].reshape(R0, L)
    rc_twin = _complement_masks(host_rows[:S_pad].flip(1))
    return torch.cat([host_rows, rc_twin], dim=0)


def _scan_keys(flank, patw, rows, start_col, end_col, lo, hi, emit_lo,
               emit_hi, alpha_scaled: int, K: int, m: int, k_units: int):
    """Top-K flank valley keys (cost*L_key + col) + total count per row:
    the Myers interior, the two alpha boundary windows, and their merge."""
    R, L = rows.shape
    L_key = L + 2
    k_scaled = k_units * UNIT
    i32 = torch.int32

    # Interior: unit-cost Myers with in-kernel top-8 keys; rows with
    # more than 8 interior valleys overflow (count forced above K so the
    # caller falls back).
    keys8, kcnt = myers_topk(
        patw, m, rows, emit_lo.to(i32).contiguous(), emit_hi.to(i32).contiguous(),
        k_units, UNIT * L_key,
    )
    kernel_count = torch.where(kcnt > MYERS_TOPK, kcnt + K + 1, kcnt)

    # Boundary windows: exact alpha semantics near each read's true
    # start/end, both in one valley call over 2R lanes.
    Wb_ = m + k_units + 3
    tsc = torch.clamp(start_col, min=0)
    text_len = end_col - tsc
    lw = _window_cols(rows, tsc, Wb_)
    l_hi = torch.minimum(
        torch.minimum(torch.full_like(hi, m + k_units + 1), hi - tsc), text_len
    )
    l_hi = torch.where(start_col >= 0, l_hi, -1)
    l_lo = torch.clamp(lo - tsc, min=0)
    l_ledge = start_col >= 0
    l_rpos = torch.where(text_len <= Wb_, text_len, -1)

    has_end = end_col <= L
    r_active = has_end & (text_len > m + k_units + 1)
    r_start = torch.where(r_active, end_col - Wb_, 0)
    rw = _window_cols(rows, r_start, Wb_)
    r_lo = torch.where(r_active, Wb_ - 1, 1)
    # guard against overlap with the left window's zone
    r_lo = torch.maximum(
        r_lo, torch.where(start_col >= 0, (tsc + m + k_units + 2) - r_start, 0)
    )
    r_hi = torch.where(r_active, Wb_, -1)
    r_ledge = torch.zeros_like(l_ledge)
    r_rpos = torch.where(r_active, Wb_, -1)

    bkeys, bcnt = window_valleys(
        flank,
        torch.cat([lw, rw], dim=0).contiguous(),
        torch.full((2 * R,), Wb_, dtype=i32, device=rows.device),
        torch.cat([l_ledge, r_ledge]),
        torch.cat([l_rpos, r_rpos]),
        torch.cat([l_lo, r_lo]),
        torch.cat([l_hi, r_hi]),
        alpha_scaled, k_scaled, L_key,
    )
    shift = torch.cat([tsc, r_start])[:, None]
    bkeys = torch.where(bkeys < BIG, bkeys + shift, BIG)
    lcount = torch.where(bcnt[:R] > WIN_VTOPK, bcnt[:R] + K + 1, bcnt[:R])
    rcount = torch.where(bcnt[R:] > WIN_VTOPK, bcnt[R:] + K + 1, bcnt[R:])

    merged = torch.cat([keys8, bkeys[:R], bkeys[R:]], dim=1)
    key_top = merged.sort(dim=1).values[:, :K]
    count = kernel_count + lcount + rcount
    return key_top, count


def demux_call(
    flank,  # [m] u8 flank masks
    patw,  # [4, W_words] int32 view of the Myers pattern words
    patterns_all,  # [2P, plen] u8: fwd pattern stack then rc stack
    host_packed,  # [T] u8 concatenated 2-bit row codes
    rowdesc,  # [R_host] int32 row descriptors
    exc,  # [E, 2] int32 (flat_pos, mask) exceptions
    *,
    gi: tuple,  # (alpha, mask_a, mask_b, k1, iv_a, iv_b) ints
    gf: tuple,  # (perfect, min_score, min_score_diff) floats
    K: int,
    m: int,
    k_units: int,
    Wf: int,  # flank trace window span
    plen: int,  # barcode pattern length
    Wb: int,  # barcode window width
    P: int,  # patterns per strand
    H_cap: int,  # hit-lane capacity (strand halves of H_cap / 2)
    padding: int,  # barcode window padding (PADDING)
    L_rows: int,  # row width
    ends_w: int,  # ends mode: PREFIX window width
    ends_wr: int,  # SUFFIX window width (0 = symmetric)
    halo: int,  # flank halo
    S_pad: int,  # twin-block rows
):
    """The full demux pipeline for one (group, batch); see the module
    doc for the output layout.  Hits beyond a strand half of H_cap are
    dropped — the caller checks ``total <= H_cap`` and retries with a
    larger capacity."""
    if Wb > 255 or H_cap % 256:
        raise ValueError(
            f"strand-split rank lanes need Wb <= 255 and H_cap % 256 == 0 "
            f"(Wb={Wb}, H_cap={H_cap}); the non-split path is not ported"
        )
    if ends_w <= 0:
        raise ValueError("demux_call runs ends-mode batches only (ends_w > 0)")
    dev = host_packed.device
    i32 = torch.int32
    alpha_scaled, mask_a, mask_b, k1_scaled, iv_a, iv_b = (int(v) for v in gi)
    # f32-exact floats: comparisons against them run in f32
    perfect, min_score, min_score_diff = gf

    meta = _derive_meta(rowdesc, S_pad, L_rows, ends_w, ends_wr, halo, padding)
    R_host = rowdesc.shape[0]
    hlen = meta[:R_host, M_TEC]
    nb = (hlen + 3) >> 2
    stride = (nb + (CAT_ALIGN - 1)) // CAT_ALIGN * CAT_ALIGN
    row_start = torch.cat(
        [torch.zeros(1, dtype=i32, device=dev), torch.cumsum(stride[:-1], 0).to(i32)]
    )
    rows = _assemble_rows(host_packed, row_start, exc, hlen, L_rows, S_pad)
    R, L = rows.shape
    L_key = L + 2
    if k_units * UNIT * L_key + L >= 2**30:
        raise ValueError(
            f"valley keys overflow the 2**30 sentinel: k_units={k_units}, "
            f"L={L}; shrink the row width"
        )

    tsc = meta[:, M_TSC]
    tec = meta[:, M_TEC]
    true_start = meta[:, M_TSTART] != 0
    true_end = meta[:, M_TEND] != 0
    v_lo = meta[:, M_LO]
    v_hi = meta[:, M_HI]
    start_col = torch.where(true_start, tsc, -1)
    end_col = torch.where(true_end, tec, L + 2)
    mk = m + k_units
    emit_lo = torch.where(true_start, tsc + mk + 2, v_lo)
    emit_hi = torch.where(true_end, torch.minimum(v_hi, tec - 2), v_hi)

    key_top, count = _scan_keys(
        flank, patw, rows, start_col, end_col, v_lo, v_hi, emit_lo, emit_hi,
        alpha_scaled, K, m, k_units,
    )

    # ---- compact valid hits into strand-split lanes --------------------
    # fwd hits in lanes [0, H_cap/2), rc hits in [H_cap/2, H_cap), each
    # in flat (row-major, then slot) order via cumsum + scatter; a lane
    # is meaningful iff its index < its strand's count.
    flat_valid = (key_top < BIG).reshape(-1)
    total = flat_valid.sum(dtype=i32)
    flat_idx = torch.arange(R * K, dtype=i32, device=dev)
    half = H_cap // 2

    def compact(valid):
        pos = torch.cumsum(valid.to(i32), 0) - 1
        pos = torch.where(valid & (pos < half), pos, half).long()  # spill slot
        out = torch.zeros(half + 1, dtype=i32, device=dev)
        out[pos] = flat_idx
        return out[:half]

    rc_flat = (meta[:, M_ISRC] != 0).repeat_interleave(K)
    fwd_valid = flat_valid & ~rc_flat
    take = torch.cat([compact(fwd_valid), compact(flat_valid & rc_flat)])
    n_fwd = fwd_valid.sum(dtype=i32)
    n_rc = total - n_fwd
    # either half overflowing must trigger the caller's retry
    total_out = torch.maximum(total, 2 * torch.maximum(n_fwd, n_rc))
    lane = torch.arange(H_cap, device=dev)
    hvalid = torch.where(lane < half, lane < n_fwd, lane - half < n_rc)
    hrow = take // K
    hkey = key_top.reshape(-1)[take.long()]
    hcol = torch.where(hvalid, hkey % L_key, 0)
    hcost = torch.where(hvalid, hkey // L_key, 0)

    hm = meta[hrow.long()]  # [H_cap, META_COLS]
    h_tsc, h_tec = hm[:, M_TSC], hm[:, M_TEC]
    h_tstart, h_tend = hm[:, M_TSTART] != 0, hm[:, M_TEND] != 0
    h_off, h_n = hm[:, M_OFF], hm[:, M_N]
    h_isrc = hm[:, M_ISRC]

    # ---- flank traceback (forward-summary DP) --------------------------
    s_col = torch.maximum(h_tsc, hcol - Wf)
    w_len_tr = hcol - s_col
    left_edge = h_tstart & (s_col == h_tsc)
    right_pos = torch.where(h_tend & (hcol == h_tec), w_len_tr, -1)
    tw = _gather_windows(rows, hrow, s_col, Wf)
    jposf = torch.arange(Wf, device=dev)
    tw = torch.where(jposf[None, :] < w_len_tr[:, None], tw, 0).to(torch.uint8)
    f_ts, rlo, rhi = window_trace(
        flank, tw, w_len_tr, left_edge, right_pos, alpha_scaled, mask_a, mask_b
    )

    # ---- map the mask region to a padded fwd barcode window ------------
    s_text = h_off + (s_col - h_tsc)
    lo_t = s_text + rlo
    hi_t = s_text + rhi
    lo2 = torch.where(h_isrc != 0, h_n - hi_t, lo_t)
    hi2 = torch.where(h_isrc != 0, h_n - lo_t, hi_t)
    bstart = torch.clamp(lo2 - padding, min=0)
    bend = torch.minimum(hi2 + padding, h_n)
    has2 = hvalid & (rhi >= 0) & (bend > bstart)
    fs_text = s_text + f_ts

    # The barcode window's forward cover row: a simple read's own row,
    # or for ends rows baserow (prefix, width Wl, text offset 0) or
    # baserow+1 (suffix, width Wr, offset n - Wr), decided by
    # bstart >= n - Wr alone.
    wr_eff = ends_wr if ends_wr else ends_w
    suf = (hm[:, M_ENDS] != 0) & (bstart >= h_n - wr_eff)
    foff = torch.where(suf, h_n - wr_eff, 0)
    frow = torch.where(
        hm[:, M_FSIMPLE] >= 0, hm[:, M_FSIMPLE], hm[:, M_BASEROW] + suf.to(i32)
    )
    frow = frow.clamp(0, R - 1)
    b_startw = torch.clamp(bstart - foff, min=0)
    b_len = torch.where(has2, bend - bstart, 0)

    # ---- barcode rank: each lane against its own strand's patterns -----
    windows = _gather_windows(rows, frow, b_startw, Wb)
    jposb = torch.arange(Wb, device=dev)
    windows = torch.where(jposb[None, :] < b_len[:, None], windows, 0).to(torch.uint8)
    key2, lodhi_best = rank_pass1(patterns_all, windows, b_len, split=half)
    best_cost = key2 // 256
    best_pos = key2 % 256
    strand_off = torch.where(h_isrc != 0, P, 0).to(i32)

    in_k1 = best_cost <= k1_scaled
    matched = in_k1.sum(dim=1)
    use_all = matched <= 1
    cand = (use_all[:, None] | in_k1) & has2[:, None]
    # divide by a device tensor: a CPU-scalar divisor may become a
    # reciprocal multiply on CUDA, which rounds differently
    scores = torch.where(
        cand, lodhi_best / torch.full_like(lodhi_best, perfect), -torch.inf
    )
    top_local = torch.argmax(scores, dim=1).to(i32)
    top = top_local + strand_off  # index into patterns_all
    top_norm = torch.gather(scores, 1, top_local.long()[:, None])[:, 0]
    rest = torch.where(
        torch.arange(scores.shape[1], device=dev)[None, :] == top_local[:, None],
        -torch.inf, scores,
    )
    second_norm = rest.max(dim=1).values
    n_cand = cand.sum(dim=1)
    accepted = (top_norm >= min_score) & (
        (n_cand <= 1) | ((top_norm - second_norm) >= min_score_diff)
    )
    accepted = accepted & has2 & (n_cand > 0)

    # ---- interval mapping for the winner only --------------------------
    pat_top = patterns_all[top.long()]
    end_top = torch.gather(best_pos, 1, top_local.long()[:, None])[:, 0]
    iv_out = window_interval(pat_top, windows, end_top, iv_a, iv_b)
    iv_vals = [iv_out[:, 0], iv_out[:, 1] + 1, iv_out[:, 2], iv_out[:, 3] + 1,
               iv_out[:, 4], iv_out[:, 5]]

    wbits = rec_wire_spec(L, R, k_units, P, plen, Wb)
    if wbits is not None:
        has2_i = has2.to(i32)
        acc_i = accepted.to(i32)
        hasiv_i = iv_vals[5]
        ivs = [torch.where(hasiv_i != 0, v, 0) for v in iv_vals[:5]]
        rec = torch.stack(
            [
                hrow | (hcol << 17),
                top | (has2_i << 8) | (acc_i << 9) | (hcost << 10),
                bstart,
                fs_text,
                ivs[0] | (ivs[1] << wbits) | (ivs[2] << (2 * wbits))
                | (hasiv_i << (3 * wbits)),
                ivs[3] | (ivs[4] << wbits),
            ],
            dim=1,
        ).to(i32)
    else:
        rec = torch.stack(
            [hrow, hcol, hcost, has2.to(i32), bstart, fs_text, top,
             accepted.to(i32), *iv_vals],
            dim=1,
        ).to(i32)
    # Rows whose valley count exceeded the K lanes (the engine falls
    # those reads back to the scalar path), one bit per row.
    over = (count > K).to(torch.int64)
    nw = (R + 31) // 32
    over = torch.cat([over, torch.zeros(nw * 32 - R, dtype=torch.int64, device=dev)])
    words = (over.reshape(nw, 32) << torch.arange(32, device=dev)).sum(dim=1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(i32)
    return torch.cat([rec.reshape(-1), words, total_out.reshape(1).to(i32)])
