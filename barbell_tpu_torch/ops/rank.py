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
    """Plain PyTorch version, vectorized over (lane, pattern) pairs and
    over each anti-diagonal of the DP (cell (i, j) needs (i-1, j-1),
    (i, j-1) and (i-1, j), all on the two diagonals before it); the f32
    Lodhi update runs as separate elementwise ops (each rounded), in the
    reference's order.  The valley scan then runs over the last row.
    A lane with ``w_len <= 0`` has no cell to rank: its only valley is
    position 0 (key ``m * UNIT * 256``, score 0), and the DP runs over
    the other lanes alone."""
    windows, P = _prepare(patterns, windows, split)
    dev = windows.device
    m = patterns.shape[1]
    i32, f32 = torch.int32, torch.float32
    pidx = torch.arange(P, device=dev)[None, :].expand(windows.shape[0], P)
    if split:
        pidx = pidx + torch.where(torch.arange(windows.shape[0], device=dev) >= split,
                                  P, 0)[:, None]
    live = torch.nonzero(w_len > 0)[:, 0]
    if live.numel() < windows.shape[0]:
        key = torch.full(pidx.shape, m * UNIT * 256, dtype=i32, device=dev)
        lodhi = torch.zeros(pidx.shape, dtype=f32, device=dev)
        if live.numel():
            key[live], lodhi[live] = _rank_lanes(patterns.to(i32)[pidx[live]],
                                                 windows[live].to(i32), w_len[live])
        return key, lodhi
    return _rank_lanes(patterns.to(i32)[pidx], windows.to(i32), w_len)


def _rank_lanes(pats, win, w_len):
    """:func:`rank_pass1_plain` on each lane's own pattern stack ``pats``
    [H, P, m] int32 over its window ``win`` [H, W] int32 (W even)."""
    dev = win.device
    H, P, m = pats.shape
    W = win.shape[1]
    i32, f32 = torch.int32, torch.float32
    rows = torch.arange(1, m + 1, device=dev)  # row i of each diagonal's cells
    # the last two diagonals, cell (i, d - i) at row index i (0..m):
    # row 0 is the free start (cost 0); column 0 costs i * UNIT
    col0 = (torch.arange(m + 1, device=dev) * UNIT).to(i32).expand(H, P, m + 1)
    zf = torch.zeros((H, P, m + 1), dtype=f32, device=dev)
    zero_c = torch.zeros((H, P, 1), dtype=i32, device=dev)
    zero_f = torch.zeros((H, P, 1), dtype=f32, device=dev)
    prev1 = (col0, zf, zf, zf)  # diagonal 1: (0, 1) and (1, 0)
    prev2 = (col0, zf, zf, zf)  # diagonal 0: (0, 0)
    last_c = torch.empty((H, P, W + 1), dtype=i32, device=dev)
    last_s = torch.zeros((H, P, W + 1), dtype=f32, device=dev)
    last_c[:, :, 0] = m * UNIT
    for d in range(2, m + W + 1) if W else ():
        j = d - rows  # [m]
        tch = win[:, (j - 1).clamp(0, W - 1)][:, None, :]  # [H, 1, m]
        lc, lt1, lt2, ls = (a[:, :, 1:] for a in prev1)  # row i @ col j-1
        uc, ut1, ut2, us = (a[:, :, :-1] for a in prev1)  # row i-1 @ col j
        dc, dt1, dt2, ds = (a[:, :, :-1] for a in prev2)  # row i-1 @ col j-1
        eq = (pats & tch) != 0
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
        # cells at column 0 (and before it: unused) keep the boundary
        inside = (j >= 1)[None, None, :]
        c = torch.where(inside, c, col0[:, :, 1:])
        t1, t2, s = (torch.where(inside, x, 0.0) for x in (t1, t2, s))
        prev2 = prev1
        prev1 = (torch.cat([zero_c, c], 2), torch.cat([zero_f, t1], 2),
                 torch.cat([zero_f, t2], 2), torch.cat([zero_f, s], 2))
        if 1 <= d - m <= W:  # the last row's cell of column d - m
            last_c[:, :, d - m] = c[:, :, m - 1]
            last_s[:, :, d - m] = s[:, :, m - 1]
    # valleys of the last row: position p (0..W) with e[p] <= e[p - 1]
    # and e[p] < e[p + 1], +inf outside and past each window's length;
    # the lowest key cost * 256 + p wins (keys are unique)
    pos = torch.arange(W + 1, device=dev)
    e = torch.where(pos <= w_len.to(i32)[:, None, None], last_c, BIGK)
    e[:, :, 0] = m * UNIT
    big = torch.full((H, P, 1), BIGK, dtype=i32, device=dev)
    prv = torch.cat([big, e[:, :, :-1]], 2)
    nxt = torch.cat([e[:, :, 1:], big], 2)
    isv = (e <= prv) & (e < nxt)
    key = torch.where(isv, e * 256 + pos.to(i32), BIGK)
    best_key, best_p = key.min(dim=2)
    best_s = torch.gather(last_s, 2, best_p[:, :, None])[:, :, 0]
    return best_key, torch.where(best_key < BIGK, best_s, 0.0)


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
