"""Interior flank scan: bit-parallel Myers search for flank valleys.

Counterpart of :mod:`barbell_tpu.ops.pallas_myers` in both its modes.
Unit-cost semiglobal search of one IUPAC flank over every row (column-0
boundary ``i``, no overhang alpha); a position ``j`` inside ``[emit_lo,
emit_hi]`` is a valley when its end cost ``e <= k`` and ``e <= e[j-1]``
and ``e < e[j+1]``.  Position 0 is never emitted and positions are
decided for ``j < L`` only.

* :func:`myers_topk` (``myers_topk_from_words``): per row the 8 lowest
  keys ``cost * klmul + j`` sorted ascending with ``2**30`` sentinels,
  plus the exact valley count (``count > 8`` means dropped valleys:
  callers treat it as overflow).  The flank scan of every path.
* :func:`myers_valleys` (``myers_valleys`` / ``myers_valleys_from_words``):
  the u8 valley-cost map [R, L], 255 where ``j`` is no valley.  No path
  of either package calls it; it is held to its Pallas counterpart.

Each launches the CUDA kernel (``csrc/myers.cu``) for CUDA tensors and
runs its plain version (:func:`myers_topk_plain`,
:func:`myers_valleys_plain`) for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

TOPK = 8
BIG = 2**30
_M32 = 0xFFFFFFFF


def pattern_words(pattern_masks: np.ndarray):
    """(words [4, W] uint32, W, top_bit) — per-base membership bitvectors."""
    m = len(pattern_masks)
    W = (m + 31) // 32
    words = np.zeros((4, W), dtype=np.uint32)
    for i, mask in enumerate(pattern_masks):
        w, b = divmod(i, 32)
        for base in range(4):
            if mask & (1 << base):
                words[base, w] |= np.uint32(1 << b)
    return words, W, (m - 1) % 32


def _valleys_plain(patw, m: int, rows, emit_lo, emit_hi, k_units: int):
    """(valley [R, L] bool, cost [R, L] int64) by the Myers recurrence in
    int64 lanes masked to 32 bits (torch has no unsigned add-with-carry
    or logical shift on int32), vectorized over rows, one text position
    at a time."""
    R, L = rows.shape
    dev = rows.device
    W = patw.shape[1]
    top_bit = (m - 1) % 32
    pw = patw.to(torch.int64) & _M32  # [4, W]
    # equality words for every 4-bit text mask: OR of its bases' words
    mask = torch.arange(16, device=dev)[:, None]
    lut = torch.zeros((16, W), dtype=torch.int64, device=dev)
    for b in range(4):
        lut = lut | (((mask >> b) & 1) * pw[b][None, :])
    text = rows.to(torch.int64) & 15
    pv = [torch.full((R,), _M32, dtype=torch.int64, device=dev) for _ in range(W)]
    mv = [torch.zeros(R, dtype=torch.int64, device=dev) for _ in range(W)]
    e_cur = torch.full((R,), m, dtype=torch.int64, device=dev)
    e_prev = torch.full((R,), 2**20, dtype=torch.int64, device=dev)
    lo = emit_lo.to(torch.int64)
    hi = emit_hi.to(torch.int64)
    valleys = torch.zeros((R, L), dtype=torch.bool, device=dev)
    costs = torch.zeros((R, L), dtype=torch.int64, device=dev)
    for j in range(L):
        eqs = lut[text[:, j]]
        sc = torch.zeros(R, dtype=torch.int64, device=dev)
        ph_in = sc
        mh_in = sc
        for w in range(W):
            eq = eqs[:, w]
            p, mm = pv[w], mv[w]
            xv = eq | mm
            t1 = eq & p
            s1 = (t1 + p) & _M32
            c1 = (s1 < t1).to(torch.int64)
            s2 = (s1 + sc) & _M32
            c2 = (s2 < s1).to(torch.int64)
            sc = c1 | c2
            xh = (s2 ^ p) | eq
            ph = mm | (~(xh | p) & _M32)
            mh = p & xh
            if w == W - 1:
                ph_top = (ph >> top_bit) & 1
                mh_top = (mh >> top_bit) & 1
            ph_s = ((ph << 1) & _M32) | ph_in
            ph_in = ph >> 31
            mh_s = ((mh << 1) & _M32) | mh_in
            mh_in = mh >> 31
            pv[w] = mh_s | (~(xv | ph_s) & _M32)
            mv[w] = ph_s & xv
        e_next = e_cur + ph_top - mh_top
        valley = (
            (e_cur <= k_units) & (e_cur <= e_prev) & (e_cur < e_next)
            & (lo <= j) & (hi >= j)
        )
        valleys[:, j] = valley
        costs[:, j] = e_cur
        e_prev = e_cur
        e_cur = e_next
    return valleys, costs


def myers_topk_plain(patw, m: int, rows, emit_lo, emit_hi, k_units: int,
                     klmul: int):
    """Plain PyTorch version of :func:`myers_topk`."""
    R, L = rows.shape
    dev = rows.device
    valleys, costs = _valleys_plain(patw, m, rows, emit_lo, emit_hi, k_units)
    jpos = torch.arange(L, device=dev)[None, :]
    keys = torch.where(valleys, costs * klmul + jpos, BIG)
    count = valleys.sum(dim=1)
    top = keys.sort(dim=1).values[:, :TOPK]
    if top.shape[1] < TOPK:
        top = torch.cat(
            [top, torch.full((R, TOPK - top.shape[1]), BIG, dtype=torch.int64,
                             device=dev)],
            dim=1,
        )
    return top.to(torch.int32), count.to(torch.int32)


def _check(patw, m: int, rows, name: str):
    """(R, L, W) after checking what the kernel assumes of its inputs."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    R, L = rows.shape
    W = patw.shape[1]
    if not 1 <= W <= 4 or W != (m + 31) // 32:
        raise ValueError(f"{name}: flank length {m} needs 1-4 words, got W={W}")
    if L % 16 or rows.data_ptr() % 16:
        raise ValueError(f"{name}: rows need L % 16 == 0 and 16-byte alignment")
    return R, L, W


def myers_topk(patw, m: int, rows, emit_lo, emit_hi, k_units: int,
               klmul: int):
    """Top-8 valley keys [R, 8] int32 and exact counts [R] int32.

    ``patw`` is the [4, W] int32 view of :func:`pattern_words`' uint32
    words; ``rows`` [R, L] uint8 base masks; ``emit_lo``/``emit_hi`` [R]
    int32 per-row emission bounds; ``klmul`` the key multiplier."""
    dev = rows.device
    if dev.type == "cpu":
        return myers_topk_plain(patw, m, rows, emit_lo, emit_hi, k_units, klmul)
    R, L, W = _check(patw, m, rows, "myers_topk")
    lib = _build.load()
    keys = torch.empty((R, TOPK), dtype=torch.int32, device=dev)
    cnt = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return keys, cnt
    with torch.cuda.device(dev):
        err = lib.bb_myers_topk(
            _build.ptr(rows, "rows", torch.uint8, dev, (R, L)),
            _build.ptr(patw, "patw", torch.int32, dev, (4, W)),
            _build.ptr(emit_lo, "emit_lo", torch.int32, dev, (R,)),
            _build.ptr(emit_hi, "emit_hi", torch.int32, dev, (R,)),
            keys.data_ptr(), cnt.data_ptr(),
            R, L, W, (m - 1) % 32, m, int(k_units), int(klmul),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "bb_myers_topk")
    _build.count_launch(myers_topk)
    return keys, cnt


myers_topk.launches = 0


def myers_valleys_plain(patw, m: int, rows, emit_lo, emit_hi, k_units: int):
    """Plain PyTorch version of :func:`myers_valleys`."""
    valleys, costs = _valleys_plain(patw, m, rows, emit_lo, emit_hi, k_units)
    return torch.where(valleys, costs, 255).to(torch.uint8)


def myers_valleys(patw, m: int, rows, emit_lo, emit_hi, k_units: int):
    """Valley-cost map [R, L] uint8: the end cost in edit units where
    position ``j`` is a valley, 255 elsewhere.  Arguments as in
    :func:`myers_topk`; ``k_units`` must stay below 255."""
    dev = rows.device
    if dev.type == "cpu":
        return myers_valleys_plain(patw, m, rows, emit_lo, emit_hi, k_units)
    R, L, W = _check(patw, m, rows, "myers_valleys")
    if not 0 <= k_units < 255:
        raise ValueError(f"myers_valleys: k_units {k_units} must be < 255")
    lib = _build.load()
    out = torch.empty((R, L), dtype=torch.uint8, device=dev)
    if R == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.bb_myers_valleys(
            _build.ptr(rows, "rows", torch.uint8, dev, (R, L)),
            _build.ptr(patw, "patw", torch.int32, dev, (4, W)),
            _build.ptr(emit_lo, "emit_lo", torch.int32, dev, (R,)),
            _build.ptr(emit_hi, "emit_hi", torch.int32, dev, (R,)),
            out.data_ptr(), R, L, W, (m - 1) % 32, m, int(k_units),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "bb_myers_valleys")
    _build.count_launch(myers_valleys)
    return out


myers_valleys.launches = 0
