"""Barcode rank: best valley key and Lodhi score per (window, pattern).

Counterpart of :mod:`barbell_tpu.ops.pallas_rank`.  For every (hit
window h, barcode pattern p) pair: the semiglobal edit DP of p over
window h, the Lodhi gap-weighted score (lambda = 0.5) carried along each
cell's optimal path with ties broken diag > up > left, and the best
plateau-valley key ``cost * 256 + j`` with the f32 score at that key.

``split > 0`` is the strand-split form (``rank_pass1_split``): lanes
``[0, split)`` are ranked against ``patterns[:P]``, lanes
``[split, H)`` against ``patterns[P:]``, with ``P = len(patterns) // 2``,
giving [H, P] in strand-local pattern indices.  ``split = 0`` ranks
every lane against every pattern (``rank_pass1``), giving [H, 2P].

:func:`rank_pass1` and :func:`rank_pass1_split` launch the CUDA kernel
(``csrc/rank.cu``) for CUDA tensors, each counting its own launches,
and run :func:`rank_pass1_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from .oracle import COST_SCALE

UNIT = COST_SCALE
BIGK = 2**30
A_DIAG = 0.25  # lambda**2
A_GAP = 0.5
#: pattern rows a thread holds (the kernel's template instances)
ROWS = (1, 2, 3, 4, 6, 8, 11, 12, 16)


def plan(m: int, W: int):
    """(R, G) of the kernel's wavefront: R pattern rows per thread, G
    threads per (lane, pattern) pair (:func:`_build.wavefront_plan`)."""
    return _build.wavefront_plan(m, W, ROWS)


def _prepare(patterns, windows, split):
    Pa, m = patterns.shape
    H, W = windows.shape
    if W > 255:
        raise ValueError("rank: the valley key packs the position into 8 bits")
    if split and (Pa % 2 or not 0 < split <= H):
        raise ValueError(f"rank: split {split} needs 2P patterns and 0 < split <= H")
    if W % 2:
        # the reference kernel advances two columns per step over an
        # even-padded window; pad the same way so lanes with
        # w_len > W see the same zero column
        windows = torch.cat(
            [windows, torch.zeros((H, 1), dtype=windows.dtype,
                                  device=windows.device)],
            dim=1,
        )
    return windows, (Pa // 2 if split else Pa)


def rank_pass1_plain(patterns, windows, w_len, split: int = 0):
    """Plain PyTorch version, vectorized over (lane, pattern) pairs; the
    f32 Lodhi update runs as separate elementwise ops (each rounded), in
    the reference's order."""
    windows, P = _prepare(patterns, windows, split)
    dev = windows.device
    H, W = windows.shape
    m = patterns.shape[1]
    i32, f32 = torch.int32, torch.float32
    pidx = torch.arange(P, device=dev)[None, :].expand(H, P)
    if split:
        pidx = pidx + torch.where(torch.arange(H, device=dev) >= split, P, 0)[:, None]
    pats = patterns.to(i32)[pidx]  # [H, P, m]
    win = windows.to(i32)
    wl = w_len.to(i32)[:, None]
    C = [torch.full((H, P), i * UNIT, dtype=i32, device=dev) for i in range(m + 1)]
    zf = torch.zeros((H, P), dtype=f32, device=dev)
    T1 = [zf] * (m + 1)
    T2 = [zf] * (m + 1)
    S = [zf] * (m + 1)
    zi = torch.zeros((H, P), dtype=i32, device=dev)
    prv = torch.full((H, P), BIGK, dtype=i32, device=dev)
    e_c = torch.full((H, P), m * UNIT, dtype=i32, device=dev)
    s_c = zf
    best_key = torch.full((H, P), BIGK, dtype=i32, device=dev)
    best_s = zf
    for j in range(1, W + 1):
        tch = win[:, j - 1][:, None]
        dc, dt1, dt2, ds = zi, zf, zf, zf  # row i-1 @ col j-1
        uc, ut1, ut2, us = zi, zf, zf, zf  # row i-1 @ col j
        for i in range(1, m + 1):
            lc, lt1, lt2, ls = C[i], T1[i], T2[i], S[i]  # row i @ col j-1
            eq = (pats[:, :, i - 1] & tch) != 0
            diag = dc + torch.where(eq, 0, UNIT).to(i32)
            lft = lc + UNIT
            upc = uc + UNIT
            c = torch.minimum(torch.minimum(diag, lft), upc)
            dok = c == diag
            uok = c == upc
            mf = (dok & eq).to(f32)
            a = torch.where(dok, A_DIAG, A_GAP).to(f32)
            st1 = torch.where(dok, dt1, torch.where(uok, ut1, lt1))
            st2 = torch.where(dok, dt2, torch.where(uok, ut2, lt2))
            ss = torch.where(dok, ds, torch.where(uok, us, ls))
            t1 = a * (st1 + mf)
            t2 = a * (st2 + mf * st1)
            s = ss + (mf * a) * st2
            C[i], T1[i], T2[i], S[i] = c, t1, t2, s
            dc, dt1, dt2, ds = lc, lt1, lt2, ls
            uc, ut1, ut2, us = c, t1, t2, s
        e = torch.where(wl >= j, uc, BIGK)
        # valley at position j - 1 (its right neighbour is e)
        isv = (e_c <= prv) & (e_c < e)
        key = torch.where(isv, e_c * 256 + (j - 1), BIGK)
        better = isv & (key < best_key)
        best_key = torch.where(better, key, best_key)
        best_s = torch.where(better, s_c, best_s)
        prv, e_c, s_c = e_c, e, us
    # final position j = W (right neighbour +inf); masked positions
    # carry BIGK and are excluded
    isv = (e_c <= prv) & (e_c < BIGK)
    key = torch.where(isv, e_c * 256 + W, BIGK)
    better = isv & (key < best_key)
    return (
        torch.where(better, key, best_key),
        torch.where(better, s_c, best_s),
    )


def _launch(wrapper, patterns, windows, w_len, split: int):
    """Launch the kernel and count it on ``wrapper``; CPU tensors take
    the plain version (and count nothing)."""
    if windows.device.type == "cpu":
        return rank_pass1_plain(patterns, windows, w_len, split)
    dev = windows.device
    if dev.type != "cuda":
        raise ValueError(f"rank: unsupported device {dev}")
    windows, P = _prepare(patterns, windows, split)
    windows = windows.contiguous()
    w_len = w_len.to(torch.int32).contiguous()
    H, W = windows.shape
    Pa, m = patterns.shape
    R, G = plan(m, W)
    lib = _build.load()
    key = torch.empty((H, P), dtype=torch.int32, device=dev)
    lodhi = torch.empty((H, P), dtype=torch.float32, device=dev)
    if H * P == 0:
        return key, lodhi
    with torch.cuda.device(dev):
        err = lib.bb_rank(
            _build.ptr(patterns, "patterns", torch.uint8, dev, (Pa, m)),
            _build.ptr(windows, "windows", torch.uint8, dev, (H, W)),
            _build.ptr(w_len, "w_len", torch.int32, dev, (H,)),
            key.data_ptr(), lodhi.data_ptr(), H, P, m, W, int(split), UNIT,
            R, G, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "bb_rank")
    _build.count_launch(wrapper)
    return key, lodhi


def rank_pass1(patterns, windows, w_len):
    """Non-split form: (key [H, 2P] int32, lodhi [H, 2P] float32), every
    lane against every pattern.

    ``patterns`` [Pa, m] uint8 IUPAC masks; ``windows`` [H, W] uint8
    (content left-aligned, zero tail); ``w_len`` [H] valid lengths."""
    return _launch(rank_pass1, patterns, windows, w_len, 0)


def rank_pass1_split(patterns, windows, w_len, split: int):
    """Strand-split form: (key [H, P], lodhi [H, P]) in strand-local
    pattern indices, lanes ``[0, split)`` against ``patterns[:P]`` and
    the rest against ``patterns[P:]``."""
    if split <= 0:
        raise ValueError(f"rank_pass1_split: split must be > 0, got {split}")
    return _launch(rank_pass1_split, patterns, windows, w_len, split)


rank_pass1.launches = 0
rank_pass1_split.launches = 0
