"""The fused per-batch demux call, in PyTorch around the three kernels.

Counterpart of :func:`barbell_tpu.ops.composite.demux_call`,
:func:`~barbell_tpu.ops.composite.demux_call_mono` and
:func:`~barbell_tpu.ops.composite.demux_call_fused` on their kernel
path.  A batch arrives as 2-bit concatenated rows (``pack_mode=2``) with
device-derived (``meta_mode='desc'``) or uploaded (``'wire'``)
metadata, or as padded 2-bit rows (``pack_mode=1``) or nibble rows
(``pack_mode=0``) with uploaded metadata; its arrays come as separate
tensors or as named segments of one uint8 blob (``spans``, one
host-to-device copy a batch); the scan is the whole read (``ends_w =
0``, with chunk rows) or its ends; barcode-rank lanes are split by
strand when ``H_cap % 256 == 0`` and ranked against both strands'
patterns otherwise.  The batch prefix
(metadata, rows, rc twins) runs once per batch; then each group runs
flank scan -> hit compaction -> flank traceback -> barcode-window
mapping -> barcode rank -> winner interval mapping and returns the same
flat int32 buffer: ``[H_cap * wire-record lanes] ++ [ceil(R/32)
overflow-bitmask words] ++ [total]``; a fused call concatenates the
groups' buffers.

The staged composites :func:`flank_scan`, :func:`flank_trace` and
:func:`barcode_rank` are the call's stages as separately testable
pieces on the same kernels (their plain versions on CPU tensors); their
``*_reference`` variants run :mod:`barbell_tpu_torch.ops.device`'s move
table and traceback on any device, the conformance anchors.  The five
are :func:`~barbell_tpu_torch.models.graphs.compiled` with the
reference's static arguments (plus the scalars a kernel takes by
value): on the card each call replays one CUDA graph per key.

Row coordinate model: every row holds its text in columns
``[tsc, tec]`` (forward rows left-aligned at 0; on-device rc twins
right-aligned ending at L; host-built chunk rows of both strands
left-aligned).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.graphs import compiled
from . import device as dev_ops
from .myers import TOPK as MYERS_TOPK
from .myers import myers_topk
from .oracle import COST_SCALE
from .rank import rank_pass1, rank_pass1_split
from .window import VTOPK as WIN_VTOPK
from .window import window_interval, window_trace, window_valleys

UNIT = COST_SCALE
BIG = 2**30
CAT_ALIGN = 64  # default byte alignment of concatenated rows (host packer too)

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

# Packed layout of chunk-row metadata: 6 int32 lanes per row.
# tsc/tec/lo/hi+1 are row coordinates <= MAX_ROW_LEN (8192) < 2**14,
# off/n/fsimple keep 32 bits, baserow < 2**16 rows, nchunks < 2**15.
META_WIRE_COLS = 6


def pack_meta_np(meta) -> np.ndarray:
    """[R, META_COLS] logical int32 -> [R, META_WIRE_COLS] packed int32."""
    m = np.ascontiguousarray(meta, dtype=np.int64)
    tsc, tec = m[:, M_TSC], m[:, M_TEC]
    lo, hi = m[:, M_LO], m[:, M_HI]
    baserow, nch = m[:, M_BASEROW], m[:, M_NCHUNKS]
    # exceptions, not asserts: an overflow would bleed into the next
    # bit field (wrong cover rows -> windows from unrelated reads)
    if not (
        tsc.min(initial=0) >= 0
        and lo.min(initial=0) >= 0
        and hi.min(initial=0) >= -1
        and baserow.min(initial=0) >= 0
        and max(tsc.max(initial=0), tec.max(initial=0),
                lo.max(initial=0), hi.max(initial=0) + 1) < 1 << 14
    ):
        raise ValueError("row coordinate exceeds the 14-bit meta field")
    if baserow.max(initial=0) >= 1 << 16:
        raise ValueError("baserow exceeds the 16-bit meta field")
    if nch.min(initial=0) < 0 or nch.max(initial=0) >= 1 << 15:
        raise ValueError("nchunks exceeds the 15-bit meta field")
    lane1 = (
        lo
        | ((m[:, M_TSTART] != 0) << 14)
        | ((m[:, M_TEND] != 0) << 15)
        | ((hi + 1) << 16)
        | ((m[:, M_ISRC] != 0) << 30)
        | ((m[:, M_ENDS] != 0).astype(np.int64) << 31)
    )
    out = np.empty((m.shape[0], META_WIRE_COLS), dtype=np.int32)
    out[:, 0] = tsc | (tec << 16)
    out[:, 1] = (lane1 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    out[:, 2] = m[:, M_OFF]
    out[:, 3] = m[:, M_N]
    out[:, 4] = m[:, M_FSIMPLE]
    out[:, 5] = baserow | (nch << 16)
    return out


def _unpack_meta(meta):
    """Device-side inverse of :func:`pack_meta_np` -> [R, META_COLS].
    torch's ``>>`` on int32 is arithmetic, like jnp's: the masks below
    keep every field exact (``c0 >= 0``; M_ENDS is the sign bit)."""
    c0, c1, c5 = meta[:, 0], meta[:, 1], meta[:, 5]
    cols = [None] * META_COLS
    cols[M_TSC] = c0 & 0xFFFF
    cols[M_TEC] = c0 >> 16
    cols[M_TSTART] = (c1 >> 14) & 1
    cols[M_TEND] = (c1 >> 15) & 1
    cols[M_LO] = c1 & 0x3FFF
    cols[M_HI] = ((c1 >> 16) & 0x3FFF) - 1
    cols[M_OFF] = meta[:, 2]
    cols[M_N] = meta[:, 3]
    cols[M_ISRC] = (c1 >> 30) & 1
    cols[M_FSIMPLE] = meta[:, 4]
    cols[M_BASEROW] = c5 & 0xFFFF
    cols[M_NCHUNKS] = c5 >> 16
    cols[M_ENDS] = (c1 >> 31) & 1
    return torch.stack(cols, dim=1).to(torch.int32)


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


def _derive_meta(rowdesc, chunk_meta, S_pad: int, L: int, ends_w: int,
                 ends_wr: int, halo: int, padding: int):
    """Per-row metadata [R_host + S_pad, META_COLS] from the 4-byte/row
    descriptor: low 2 bits a type tag, the rest a payload —

    * tag 0: simple forward read, payload = read length ``n`` (0 for
      padding rows, which are invalid);
    * tag 1: ends PREFIX row of a long read, payload = ``n``;
    * tag 2: ends SUFFIX row (always right after its prefix), payload
      = ``n``;
    * tag 3: chunk row of a long read (whole-read scan), payload =
      index into ``chunk_meta``, the :func:`pack_meta_np` table of the
      chunk rows (the only rows whose metadata is not length-derived).

    Rows ``[R_host, R_host + S_pad)`` are the flip+complement twins of
    host rows ``[0, S_pad)``: a tag-0 twin is the rc simple row, a tag-1
    twin the RC SUFFIX window, a tag-2 twin the RC PREFIX window, and a
    tag-3 twin is invalid (chunk rows ship both strands from the host).
    Must match the host planner (``_materialize``)."""
    dev = rowdesc.device
    R_host = rowdesc.shape[0]
    tag = rowdesc & 3
    n = rowdesc >> 2  # rowdesc >= 0: arithmetic shift is logical here
    Wl = ends_w
    Wr = ends_wr if ends_wr else ends_w
    rowid = torch.arange(R_host, dtype=torch.int32, device=dev)
    cm = _unpack_meta(chunk_meta)
    ci = n.clamp(0, chunk_meta.shape[0] - 1).long()

    def build(block_tag, block_n, block_row, twin: bool):
        is_simple = block_tag == 0
        is_pre = block_tag == 1
        is_suf = block_tag == 2
        is_chunk = block_tag == 3
        is_ends = is_pre | is_suf
        valid = block_n > 0
        if twin:
            valid = valid & ~is_chunk
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
        out = torch.stack([c.to(torch.int32) for c in cols], dim=1)
        if not twin:
            # splice the real chunk metadata over tag-3 host rows
            out = torch.where(is_chunk[:, None], cm[ci], out)
        return out

    host = build(tag, n, rowid, twin=False)
    twin = build(tag[:S_pad], n[:S_pad], rowid[:S_pad], twin=True)
    return torch.cat([host, twin], dim=0)


def unpack_rows(packed):
    """[R, L/2] nibble-packed rows -> [R, L] mask bytes (low nibble
    first)."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=2).reshape(packed.shape[0], -1)


def pack_rows_np(rows):
    """Host-side nibble packing (numpy).  Masks to 4 bits first: invalid
    bytes encode to 255, which would otherwise clobber the neighbouring
    nibble; a 255 mask degrades to 15 (N), the oracle's "matches
    everything" for unknown bytes."""
    r = rows & 0xF
    return (r[:, 0::2] | (r[:, 1::2] << 4)).astype(rows.dtype)


def _apply_exceptions(masks, exc):
    """The exception list's (flat_pos, mask) pairs written over the
    [R0, L] mask rows; out-of-range positions are padding and land on a
    spill slot past the rows (the reference drops them)."""
    R0, L = masks.shape
    flat = torch.cat([masks.reshape(-1),
                      torch.zeros(1, dtype=torch.uint8, device=masks.device)])
    pos = exc[:, 0].long()
    pos = torch.where((pos >= 0) & (pos < R0 * L), pos, R0 * L)
    flat[pos] = exc[:, 1].to(torch.uint8)
    return flat[: R0 * L].reshape(R0, L)


def _codes_to_masks(b, hlen, L: int):
    """[R0, L/4] 2-bit code bytes -> [R0, L] single-base masks (1 <<
    code), zero past each row's content (code 0 would read as 'A')."""
    b = b.to(torch.int32)
    R0 = b.shape[0]
    codes = torch.stack([(b >> (2 * s)) & 3 for s in range(4)], dim=2).reshape(R0, L)
    masks = (1 << codes).to(torch.uint8)
    jpos = torch.arange(L, device=b.device)
    return torch.where(jpos[None, :] < hlen[:, None], masks, 0).to(torch.uint8)


def _cat_rows(flat_codes, row_start, exc, hlen, L: int):
    """Host rows [R0, L] from the concatenated 2-bit codes: each row's
    ceil(len/4) code bytes scatter into the padded layout as masks, and
    the exception list overrides N/IUPAC/junk bytes."""
    R0 = row_start.shape[0]
    idx = (row_start[:, None] + torch.arange(L // 4, device=flat_codes.device)).clamp(
        0, flat_codes.shape[0] - 1
    )
    return _apply_exceptions(_codes_to_masks(flat_codes[idx.long()], hlen, L), exc)


def _rows2(packed2, exc, hlen):
    """Host rows [R0, L] from padded 2-bit rows [R0, L/4] (pack mode 1):
    :func:`_cat_rows` without the byte gather."""
    return _apply_exceptions(
        _codes_to_masks(packed2, hlen, 4 * packed2.shape[1]), exc
    )


def batch_rows(parts, *, pack_mode: int, L_rows: int, S_pad: int,
               ends_w: int, ends_wr: int, halo: int, padding: int,
               cat_align: int = CAT_ALIGN):
    """The group-independent prefix of a batch's device call: (rows
    [R_host + S_pad, L] u8 masks, metadata [R_host + S_pad, META_COLS]).

    ``parts`` names the uploaded batch arrays in one of two layouts:

    * descriptor metadata (``meta_mode='desc'``, pack mode 2 only):
      ``host_packed`` (concatenated 2-bit codes), ``rowdesc``,
      ``chunk_meta``, ``exc``; the metadata and the row starts are
      derived here and the rc twin block is the flip + complement of
      host rows ``[0, S_pad)``;
    * uploaded ("wire") metadata: ``host_packed``, ``meta`` (the
      :func:`pack_meta_np` table of every row, twins included),
      ``simple_idx`` (the host row of each twin), ``exc`` and
      ``row_start`` (the rows' byte starts), with ``host_packed`` the
      concatenated 2-bit codes (``pack_mode=2``), padded 2-bit rows
      ``[R_host, L/4]`` (``pack_mode=1``, which ignores ``row_start``)
      or nibble rows ``[R_host, L/2]`` (``pack_mode=0``, which ignores
      ``exc`` and ``row_start``).

    ``cat_align`` is the host packer's row alignment in the
    concatenated codes (the descriptor layout re-derives the row starts
    with it)."""
    host_packed, exc = parts["host_packed"], parts["exc"]
    if pack_mode not in (0, 1, 2):
        raise ValueError(f"unknown pack mode {pack_mode}")
    if "rowdesc" in parts:
        if pack_mode != 2:
            raise ValueError("meta_mode='desc' requires pack_mode 2")
        rowdesc = parts["rowdesc"]
        meta = _derive_meta(rowdesc, parts["chunk_meta"], S_pad, L_rows,
                            ends_w, ends_wr, halo, padding)
        hlen = meta[: rowdesc.shape[0], M_TEC]
        nb = (hlen + 3) >> 2
        stride = (nb + (cat_align - 1)) // cat_align * cat_align
        row_start = torch.cat([
            torch.zeros(1, dtype=torch.int32, device=host_packed.device),
            torch.cumsum(stride[:-1], 0).to(torch.int32),
        ])
        host_rows = _cat_rows(host_packed, row_start, exc, hlen, L_rows)
        twin_src = host_rows[:S_pad]
    else:
        meta = _unpack_meta(parts["meta"])
        if pack_mode == 2:
            row_start = parts["row_start"]
            host_rows = _cat_rows(host_packed, row_start, exc,
                                  meta[: row_start.shape[0], M_TEC], L_rows)
        elif pack_mode == 1:
            host_rows = _rows2(host_packed, exc, meta[: host_packed.shape[0], M_TEC])
        else:
            host_rows = unpack_rows(host_packed)
        twin_src = host_rows[parts["simple_idx"].long()]
    rows = torch.cat([host_rows, _complement_masks(twin_src.flip(1))], dim=0)
    return rows, meta


def _scan_keys(flank, patw, rows, start_col, end_col, lo, hi, emit_lo,
               emit_hi, alpha_scaled, K: int, m: int, k_units: int):
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


class GroupArgs(NamedTuple):
    """One group's tensors and constants for :func:`demux_call_fused`."""

    flank: torch.Tensor  # [m] u8 flank masks
    patw: torch.Tensor  # [4, W_words] int32 view of the Myers pattern words
    patterns_all: torch.Tensor  # [2P, plen] u8: fwd pattern stack then rc stack
    gi: tuple  # (alpha, mask_a, mask_b, k1, iv_a, iv_b, step) ints
    gf: tuple  # (perfect, min_score, min_score_diff) floats
    m: int
    k_units: int
    Wf: int  # flank trace window span
    plen: int  # barcode pattern length
    Wb: int  # barcode window width
    P: int  # patterns per strand


def demux_call(
    flank,
    patw,
    patterns_all,
    host_packed,  # [T] u8 concatenated 2-bit row codes
    rowdesc,  # [R_host] int32 row descriptors
    chunk_meta,  # [C, META_WIRE_COLS] int32 packed chunk-row metadata
    exc,  # [E, 2] int32 (flat_pos, mask) exceptions
    *,
    gi: tuple,
    gf: tuple,
    K: int,
    m: int,
    k_units: int,
    Wf: int,
    plen: int,
    Wb: int,
    P: int,
    H_cap: int,
    padding: int,
    L_rows: int,
    ends_w: int,
    ends_wr: int,
    halo: int,
    S_pad: int,
):
    """The full demux pipeline for one (group, batch) on descriptor
    metadata: :func:`demux_call_fused` with one group (see
    :class:`GroupArgs` and :func:`demux_call_fused` for the arguments,
    the module doc for the output layout)."""
    return demux_call_fused(
        [GroupArgs(flank, patw, patterns_all, gi, gf, m, k_units, Wf, plen,
                   Wb, P)],
        dict(host_packed=host_packed, rowdesc=rowdesc, chunk_meta=chunk_meta,
             exc=exc),
        K=K, H_cap=H_cap, pack_mode=2, L_rows=L_rows, S_pad=S_pad,
        ends_w=ends_w, ends_wr=ends_wr, halo=halo, padding=padding,
    )


def demux_call_fused(
    groups,  # [GroupArgs] in plan order
    parts,  # the batch's arrays, named as batch_rows reads them, or its blob
    *,
    K: int,
    H_cap: int,  # hit-lane capacity of every group (strand halves of H_cap / 2)
    pack_mode: int,  # 2: concatenated 2-bit codes; 1: padded 2-bit rows; 0: nibble rows
    L_rows: int,  # row width
    S_pad: int,  # twin-block rows
    ends_w: int,  # ends mode: PREFIX window width (0 = whole-read scan)
    ends_wr: int,  # SUFFIX window width (0 = symmetric)
    halo: int,  # flank halo
    padding: int,  # barcode window padding (PADDING)
    cat_align: int = CAT_ALIGN,  # row alignment of the concatenated codes
    spans=None,  # the blob's layout (build_blob_named) when parts is a blob
):
    """Every group's demux for one batch: the batch prefix
    (:func:`batch_rows`: metadata and rows, which depend on no group)
    once, then each group's body.  ``parts`` is a dict of the batch's
    tensors or, with ``spans``, the uint8 blob that carries them all
    (:func:`_blob_parts` slices it on its device).  Returns the groups'
    flat buffers (see the module doc) concatenated in group order; each
    group's length follows its own record layout
    (:func:`rec_wire_spec`)."""
    outs = demux_call_groups(
        groups, parts, K=K, H_cap=H_cap, pack_mode=pack_mode, L_rows=L_rows,
        S_pad=S_pad, ends_w=ends_w, ends_wr=ends_wr, halo=halo, padding=padding,
        cat_align=cat_align, spans=spans)
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def demux_call_groups(groups, parts, *, K: int, H_cap: int, pack_mode: int,
                      L_rows: int, S_pad: int, ends_w: int, ends_wr: int,
                      halo: int, padding: int, cat_align: int = CAT_ALIGN,
                      spans=None) -> list:
    """:func:`demux_call_fused`'s groups' flat buffers, one a group in
    group order, before their concatenation (each ends in the group's
    hit total)."""
    if spans is not None:
        parts = _blob_parts(parts, spans)
    rows, meta = batch_rows(parts, pack_mode=pack_mode, L_rows=L_rows,
                            S_pad=S_pad, ends_w=ends_w, ends_wr=ends_wr,
                            halo=halo, padding=padding, cat_align=cat_align)
    return [_group_body(rows, meta, g, K=K, H_cap=H_cap, padding=padding,
                        ends_w=ends_w, ends_wr=ends_wr) for g in groups]


def demux_call_mono(group: GroupArgs, blob, *, spans, **statics):
    """One group's demux with every per-batch array riding ONE uint8
    blob (one host-to-device copy a batch): :func:`batch_rows` on the
    blob's segments, then :func:`_group_body`.  ``spans`` is the
    (name, byte offset, shape) layout of :func:`build_blob_named`;
    ``statics`` are :func:`demux_call_fused`'s keyword arguments."""
    return demux_call_fused([group], blob, spans=spans, **statics)


def build_blob_named(*segs):
    """(blob uint8, spans) from (name, numpy array) segments, in order;
    every segment but ``host_packed`` is int32 and starts 4-byte aligned
    so the device reads it in place (:func:`_blob_parts`)."""
    spans = []
    off = 0
    chunks = []
    for name, arr in segs:
        if off % 4:
            pad = 4 - off % 4
            chunks.append(np.zeros(pad, dtype=np.uint8))
            off += pad
        spans.append((name, off, tuple(arr.shape)))
        raw = arr.reshape(-1).view(np.uint8)
        chunks.append(raw)
        off += raw.size
    return np.concatenate(chunks), tuple(spans)


def build_blob_np(host_packed, simple_idx, meta_packed, exc, row_start):
    """(blob, spans) of the uploaded-metadata layout."""
    return build_blob_named(
        ("host_packed", np.ascontiguousarray(host_packed, dtype=np.uint8)),
        ("simple_idx", np.ascontiguousarray(simple_idx, dtype=np.int32)),
        ("meta", np.ascontiguousarray(meta_packed, dtype=np.int32)),
        ("exc", np.ascontiguousarray(exc, dtype=np.int32)),
        ("row_start", np.ascontiguousarray(row_start, dtype=np.int32)),
    )


def build_blob_desc_np(host_packed, rowdesc, chunk_meta_packed, exc):
    """(blob, spans) of the descriptor layout (``meta_mode='desc'``): the
    codes, the 4-byte row descriptors, the chunk rows' packed metadata
    and the exceptions; the rest is derived on the device."""
    return build_blob_named(
        ("host_packed", np.ascontiguousarray(host_packed, dtype=np.uint8)),
        ("rowdesc", np.ascontiguousarray(rowdesc, dtype=np.int32)),
        ("chunk_meta", np.ascontiguousarray(chunk_meta_packed, dtype=np.int32)),
        ("exc", np.ascontiguousarray(exc, dtype=np.int32)),
    )


def _blob_parts(blob, spans):
    """The blob's named segments as tensors on its device, without a
    copy: ``host_packed`` a uint8 view, every other segment the int32
    reinterpretation of its bytes (4-byte aligned by the layout, which
    ``Tensor.view(torch.int32)`` checks)."""
    parts = {}
    for name, off, shape in spans:
        n = int(np.prod(shape, dtype=np.int64))
        if name == "host_packed":
            parts[name] = blob[off : off + n].view(shape)
        else:
            parts[name] = blob[off : off + 4 * n].view(torch.int32).view(shape)
    return parts


def _group_body(rows, meta, group: GroupArgs, *, K, H_cap, padding, ends_w,
                ends_wr):
    """One group's demux on a batch's rows and metadata: flank scan ->
    hit compaction -> flank trace -> barcode-window mapping -> barcode
    rank -> selection -> winner interval -> record packing.  Hits beyond
    H_cap (or, with strand-split lanes, beyond a strand half of it) are
    dropped — the caller checks ``total <= H_cap`` and retries with a
    larger capacity."""
    flank, patw, patterns_all, gi, gf, m, k_units, Wf, plen, Wb, P = group
    if Wb > 255:
        raise ValueError(f"the rank key packs positions in 8 bits (Wb={Wb})")
    dev = rows.device
    i32 = torch.int32
    alpha_scaled, mask_a, mask_b, k1_scaled, iv_a, iv_b, step = (
        int(v) for v in gi
    )
    # f32-exact floats: comparisons against them run in f32
    perfect, min_score, min_score_diff = gf

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

    # ---- compact valid hits into lanes ---------------------------------
    # Valid hits take lanes in flat (row-major, then slot) order via
    # cumsum + scatter; a lane is meaningful iff its index < the count.
    # Strand-split (H_cap % 256 == 0): fwd hits in lanes [0, H_cap/2),
    # rc hits in [H_cap/2, H_cap), so the rank kernel evaluates only the
    # lane's own strand's P patterns instead of all 2P.
    split = H_cap % 256 == 0
    flat_valid = (key_top < BIG).reshape(-1)
    total = flat_valid.sum(dtype=i32)
    flat_idx = torch.arange(R * K, dtype=i32, device=dev)
    half = H_cap // 2

    def compact(valid, cap):
        pos = torch.cumsum(valid.to(i32), 0) - 1
        pos = torch.where(valid & (pos < cap), pos, cap).long()  # spill slot
        out = torch.zeros(cap + 1, dtype=i32, device=dev)
        out[pos] = flat_idx
        return out[:cap]

    lane = torch.arange(H_cap, device=dev)
    if split:
        rc_flat = (meta[:, M_ISRC] != 0).repeat_interleave(K)
        fwd_valid = flat_valid & ~rc_flat
        take = torch.cat(
            [compact(fwd_valid, half), compact(flat_valid & rc_flat, half)]
        )
        n_fwd = fwd_valid.sum(dtype=i32)
        n_rc = total - n_fwd
        # either half overflowing must trigger the caller's retry
        total_out = torch.maximum(total, 2 * torch.maximum(n_fwd, n_rc))
        hvalid = torch.where(lane < half, lane < n_fwd, lane - half < n_rc)
    else:
        take = compact(flat_valid, H_cap)
        total_out = total
        hvalid = lane < total
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

    # The barcode window's forward cover row: a simple read's own row;
    # for chunk rows the chunk k = bstart // step of the read's forward
    # cover rows (baserow + k, text offset k * step); for ends rows
    # baserow (prefix, width Wl, text offset 0) or baserow + 1 (suffix,
    # width Wr, offset n - Wr), decided by bstart >= n - Wr alone.
    simple = hm[:, M_FSIMPLE] >= 0
    k_idx = bstart // step if step > 0 else torch.zeros_like(bstart)
    k_idx = torch.minimum(
        k_idx.clamp(min=0), torch.clamp(hm[:, M_NCHUNKS] - 1, min=0)
    )
    foff = torch.where(simple, 0, k_idx * step)
    if ends_w:
        wr_eff = ends_wr if ends_wr else ends_w
        is_ends = hm[:, M_ENDS] != 0
        suf = is_ends & (bstart >= h_n - wr_eff)
        k_idx = torch.where(is_ends, suf.to(i32), k_idx)
        foff = torch.where(is_ends, torch.where(suf, h_n - wr_eff, 0), foff)
    frow = torch.where(simple, hm[:, M_FSIMPLE], hm[:, M_BASEROW] + k_idx)
    frow = frow.clamp(0, R - 1)
    b_startw = torch.clamp(bstart - foff, min=0)
    b_len = torch.where(has2, bend - bstart, 0)

    # ---- barcode rank --------------------------------------------------
    windows = _gather_windows(rows, frow, b_startw, Wb)
    jposb = torch.arange(Wb, device=dev)
    windows = torch.where(jposb[None, :] < b_len[:, None], windows, 0).to(torch.uint8)
    if split:
        # [H, P] strand-local: each lane against its own strand's stack
        key2, lodhi_best = rank_pass1_split(patterns_all, windows, b_len, half)
        lane_mask = None
        strand_off = torch.where(h_isrc != 0, P, 0).to(i32)
    else:
        # [H, 2P] against both stacks, masked to the lane's own strand
        key2, lodhi_best = rank_pass1(patterns_all, windows, b_len)
        lane_mask = (
            torch.arange(2 * P, device=dev)[None, :] // P == h_isrc[:, None]
        )
        strand_off = torch.zeros(H_cap, dtype=i32, device=dev)
    best_cost = key2 // 256
    best_pos = key2 % 256
    top_local, accepted = _select(best_cost, lodhi_best, has2, k1_scaled, perfect,
                                  min_score, min_score_diff, lane_mask)
    top = top_local.to(i32) + strand_off  # index into patterns_all

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


# ---------------------------------------------------------------------------
# Staged composites: the fused call's stages, one at a time
# ---------------------------------------------------------------------------


class FlankScanOut(NamedTuple):
    rows: torch.Tensor  # [R_total, L] assembled rows (on the device)
    packed: torch.Tensor  # [R_total, 2K+1] int32: K col | K cost | count


@compiled(static_argnames=("K", "m", "k_units"), by_value=("alpha_scaled",))
def flank_scan(pattern, patw, host_packed, simple_idx, start_col, end_col, lo,
               hi, emit_lo, emit_hi, alpha_scaled, *, K: int, m: int,
               k_units: int) -> FlankScanOut:
    """Flank scan of nibble rows ``host_packed`` [R_host, L/2] plus the
    rc twins of host rows ``simple_idx``: the rows, and per row the K
    lowest valley keys split into column and cost (BIG where empty) and
    the valley count (``count + K + 1`` marks a row with more than 8
    interior or boundary valleys).  ``patw`` is the int32 view of the
    Myers pattern words; ``start_col`` / ``end_col`` / ``lo`` / ``hi`` /
    ``emit_lo`` / ``emit_hi`` are per row, as :func:`_group_body` derives
    them.  Runs Myers top-K and the window valley kernel (their plain
    versions on CPU tensors)."""
    host_rows = unpack_rows(host_packed)
    twins = _complement_masks(host_rows[simple_idx.long()].flip(1))
    rows = torch.cat([host_rows, twins], dim=0)
    key_top, count = _scan_keys(
        pattern, patw, rows, start_col, end_col, lo, hi, emit_lo, emit_hi,
        alpha_scaled, K, m, k_units,
    )
    L_key = rows.shape[1] + 2
    found = key_top < BIG
    pos = torch.where(found, key_top % L_key, 0)
    cost = torch.where(found, key_top // L_key, BIG)
    packed = torch.cat([pos, cost, count[:, None]], dim=1).to(torch.int32)
    return FlankScanOut(rows=rows, packed=packed)


def unpack_flank_scan(packed, K: int):
    """(col [R, K], cost [R, K], valid [R, K], count [R]) of
    :func:`flank_scan`'s ``packed``."""
    pos = packed[:, :K]
    cost = packed[:, K : 2 * K]
    count = packed[:, 2 * K]
    return pos, cost, cost < BIG, count


def _masked_windows(rows, row_idx, win_start, w_len, W: int):
    windows = _gather_windows(rows, row_idx, win_start, W)
    jpos = torch.arange(W, device=rows.device)
    return torch.where(jpos[None, :] < w_len[:, None], windows, 0).to(torch.uint8)


@compiled(static_argnames=("m", "W"), by_value=("alpha_scaled", "region_a", "region_b"))
def flank_trace(pattern, rows, row_idx, win_start, left_edge, right_pos, end_j,
                valid, region_a, region_b, alpha_scaled, *, m: int, W: int):
    """[H, 4] int32: text start, region lo, region hi, has region (all
    window-relative) of the flank's optimal path ending at ``end_j`` in
    each lane's window ``rows[row_idx, win_start : win_start + W]``.
    Runs the window trace kernel (its plain version on CPU tensors);
    ``valid`` is unused here, as in the reference's fused form."""
    windows = _masked_windows(rows, row_idx, win_start, end_j, W)
    ts, rlo, rhi = window_trace(pattern, windows, end_j, left_edge, right_pos,
                                alpha_scaled, region_a, region_b)
    return torch.stack([ts, rlo, rhi, (rhi >= 0).to(torch.int32)], dim=1).to(torch.int32)


@compiled(static_argnames=("m", "W"))
def flank_trace_reference(pattern, rows, row_idx, win_start, left_edge,
                          right_pos, end_j, valid, region_a, region_b,
                          alpha_scaled, *, m: int, W: int):
    """:func:`flank_trace` by :func:`~barbell_tpu_torch.ops.device.window_dp`
    and :func:`~barbell_tpu_torch.ops.device.traceback_reduce` (the
    conformance anchor, on any device)."""
    windows = _masked_windows(rows, row_idx, win_start, end_j, W)
    wdp = dev_ops.window_dp(pattern[None, :], windows, left_edge, right_pos,
                            alpha_scaled)
    tr = dev_ops.traceback_reduce(wdp.moves, end_j[:, None], valid[:, None],
                                  region_a, region_b, 0, 0, m=m, W=W)
    return torch.stack(
        [tr.text_start[:, 0], tr.region_lo[:, 0], tr.region_hi[:, 0],
         tr.has_region[:, 0].to(torch.int32)],
        dim=1,
    ).to(torch.int32)


def _select(best_cost, lodhi, hvalid, k1_scaled, perfect, min_score,
            min_score_diff, allowed=None):
    """(top, accepted) of the barcode selection over each lane's
    ``allowed`` patterns (default all): candidates within k1 (every
    allowed pattern when at most one is), the best normalized Lodhi
    score, accepted above ``min_score`` and ``min_score_diff`` ahead of
    the second; ties to the first pattern.  Comparisons run in f32; the
    scalars may be numbers or 0-d device tensors."""
    P = best_cost.shape[1]
    in_k1 = best_cost <= k1_scaled
    if allowed is not None:
        in_k1 = in_k1 & allowed
    use_all = in_k1.sum(dim=1) <= 1
    cand = (use_all[:, None] | in_k1) & hvalid[:, None]
    if allowed is not None:
        cand = cand & allowed
    # divide by a device tensor: a CPU-scalar divisor may become a
    # reciprocal multiply on CUDA, which rounds differently
    if isinstance(perfect, torch.Tensor):
        den = perfect.to(device=lodhi.device, dtype=lodhi.dtype).expand_as(lodhi)
    else:
        den = torch.full_like(lodhi, float(perfect))
    scores = torch.where(cand, lodhi / den, -torch.inf)
    top = torch.argmax(scores, dim=1)
    top_norm = torch.gather(scores, 1, top[:, None])[:, 0]
    rest = torch.where(
        torch.arange(P, device=scores.device)[None, :] == top[:, None],
        -torch.inf, scores,
    )
    second_norm = rest.max(dim=1).values
    n_cand = cand.sum(dim=1)
    accepted = (top_norm >= min_score) & (
        (n_cand <= 1) | ((top_norm - second_norm) >= min_score_diff)
    )
    return top, accepted & hvalid & (n_cand > 0)


@compiled(static_argnames=("m", "W"), by_value=("iv_a", "iv_b"))
def barcode_rank(patterns, rows, row_idx, win_start, w_len, hvalid, k1_scaled,
                 iv_a, iv_b, perfect, min_score, min_score_diff, *, m: int,
                 W: int):
    """[H, 8] int32: top pattern, accepted, read_bar_start,
    read_bar_end, bar_start, bar_end, bar_cost, has_interval, for one
    strand's pattern stack [P, m] over each lane's window.  The rank
    runs the non-split rank kernel when ``W <= 255`` and the summary DP
    (:mod:`~barbell_tpu_torch.ops.device`) otherwise; then the selection
    and the winner's interval by the window interval kernel (plain
    versions on CPU tensors)."""
    windows = _masked_windows(rows, row_idx, win_start, w_len, W)
    H = windows.shape[0]
    dev = windows.device
    if W <= 255:
        key, lodhi_best = rank_pass1(patterns, windows, w_len)
        best_cost, best_pos = key // 256, key % 256
    else:
        summ = dev_ops.window_dp_summary(
            patterns[None], windows, torch.zeros(H, dtype=torch.bool, device=dev),
            torch.full((H,), -1, dtype=torch.int32, device=dev), UNIT, 0, -1,
            iv_a, iv_b, with_lodhi=True,
        )
        best = dev_ops.best_valley_per_pattern(summ.ends, w_len)
        best_cost, best_pos = best.cost, best.pos
        lodhi_best = torch.gather(summ.lodhi, 2, best_pos.long()[:, :, None])[:, :, 0]
    top, accepted = _select(best_cost, lodhi_best, hvalid.to(torch.bool),
                            k1_scaled, perfect, min_score, min_score_diff)
    end_top = torch.gather(best_pos, 1, top[:, None])[:, 0]
    iv = window_interval(patterns[top], windows, end_top, iv_a, iv_b)
    return torch.stack(
        [top.to(torch.int32), accepted.to(torch.int32), iv[:, 0], iv[:, 1] + 1,
         iv[:, 2], iv[:, 3] + 1, iv[:, 4], iv[:, 5]],
        dim=1,
    ).to(torch.int32)


@compiled(static_argnames=("m", "W"))
def barcode_rank_reference(patterns, rows, row_idx, win_start, w_len, hvalid,
                           k1_scaled, iv_a, iv_b, perfect, min_score,
                           min_score_diff, *, m: int, W: int):
    """:func:`barcode_rank` by every lane's
    :func:`~barbell_tpu_torch.ops.device.window_dp` and
    :func:`~barbell_tpu_torch.ops.device.traceback_reduce` (the
    conformance anchor, on any device).  Lanes outside the candidates
    are not traced, so their interval fields keep the walk's initial
    values: compare lanes where ``hvalid``."""
    windows = _masked_windows(rows, row_idx, win_start, w_len, W)
    H = windows.shape[0]
    dev = windows.device
    bdp = dev_ops.window_dp(
        patterns, windows, torch.zeros(H, dtype=torch.bool, device=dev),
        torch.full((H,), -1, dtype=torch.int32, device=dev), UNIT,
    )
    best = dev_ops.best_valley_per_pattern(bdp.ends, w_len)
    hv = hvalid.to(torch.bool)
    in_k1 = best.cost <= k1_scaled
    cand = ((in_k1.sum(dim=1) <= 1)[:, None] | in_k1) & hv[:, None]
    tr = dev_ops.traceback_reduce(bdp.moves, best.pos, cand, 0, -1, iv_a, iv_b,
                                  m=m, W=W)
    top, accepted = _select(best.cost, tr.lodhi, hv, k1_scaled, perfect,
                            min_score, min_score_diff)

    def pick(arr):
        return torch.gather(arr, 1, top[:, None])[:, 0].to(torch.int32)

    return torch.stack(
        [top.to(torch.int32), accepted.to(torch.int32), pick(tr.iv_pj),
         pick(tr.iv_ej) + 1, pick(tr.iv_pi), pick(tr.iv_ei) + 1,
         pick(tr.iv_cost), pick(tr.has_interval)],
        dim=1,
    ).to(torch.int32)
