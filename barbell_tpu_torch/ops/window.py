"""Per-lane window DP in three modes (valley / trace / interval).

Counterpart of :mod:`barbell_tpu.ops.pallas_window`: one pattern
against one small text window per lane, with the alpha overhang on the
left-edge column-0 steps and on the vertical steps at ``right_pos``,
move ties broken diag, then up (only when not diag), then left.

* :func:`window_valleys` — the 8 lowest valley keys ``cost * klmul + j``
  and the exact count per lane (read-boundary windows of the flank scan);
* :func:`window_trace` — (text start, region lo, region hi) at each
  lane's end column (flank traceback);
* :func:`window_interval` — the barcode interval ``[iv_a, iv_b)`` mapped
  through the optimal path ending at each lane's end column.

Each launches the CUDA kernel (``csrc/window.cu``) for CUDA tensors and
runs :func:`window_plain` for CPU tensors.  A pattern given as one [m]
vector is shared by every lane.
"""

from __future__ import annotations

import torch

from .. import _build
from .oracle import COST_SCALE

UNIT = COST_SCALE
BIGK = 2**30
VTOPK = 8

MODE_VALLEY = 0
MODE_TRACE = 1
MODE_INTERVAL = 2
_N_SUMM = {MODE_TRACE: 3, MODE_INTERVAL: 6}
_MAXM = 128  # csrc/window.cu MAXM


def window_plain(mode, pat, win, c0, ledge, rpos, ehi, wlen, alpha, ra, rb,
                 k_scaled, klmul):
    """Plain PyTorch version of the kernel, vectorized over lanes.

    ``pat`` [m] or [H, m]; ``win`` [H, W]; ``c0`` is ``emit_lo``
    (valley) or the end column (trace / interval).  Each column's costs
    come from the closed form of the in-column "up" chain, ``C[i] =
    i*vert + cummin_k(X[k] - k*vert)`` with ``X = min(diag, left)``
    (exact integer arithmetic); path summaries then run down the column
    row by row.  Returns (keys [H, 8], count [H]) in valley mode, else
    the captured [H, 3] / [H, 6] table."""
    dev = win.device
    H, W = win.shape
    m = pat.shape[-1]
    i64 = torch.int64
    pat = pat.to(i64).expand(H, m)
    win = win.to(i64)
    c0 = c0.to(i64)
    vert_edge = torch.where(ledge.to(torch.bool), alpha, UNIT).to(i64)
    rpos = rpos.to(i64)
    iota = torch.arange(m + 1, dtype=i64, device=dev)
    C = iota[None, :] * vert_edge[:, None]  # column 0
    ns = _N_SUMM.get(mode, 0)
    if mode == MODE_TRACE:
        in_r0 = (iota - 1 >= ra)[None, :].expand(H, m + 1)
        S = [
            torch.where(in_r0, 0, BIGK).to(i64),
            torch.where(in_r0, 0, -1).to(i64),
            torch.zeros((H, m + 1), dtype=i64, device=dev),
        ]
        row0 = (BIGK, -1, 0)
        order = (2, 0, 1)  # captured (ts, rlo, rhi)
    elif mode == MODE_INTERVAL:
        has0 = ((iota - 1 >= ra) & (rb > ra))[None, :].expand(H, m + 1)
        ei0 = torch.clamp(iota - 1, max=rb - 1)[None, :].expand(H, m + 1)
        z = torch.zeros((H, m + 1), dtype=i64, device=dev)
        S = [
            torch.where(has0, ra, 0).to(i64),
            z.clone(),
            torch.where(has0, ei0, -1).to(i64),
            torch.where(has0, 0, -1).to(i64),
            torch.where(has0, ei0 - ra + 1, 0).to(i64),
            has0.to(i64),
        ]
        row0 = (0, 0, -1, -1, 0, 0)
        order = (1, 3, 0, 2, 4, 5)  # captured (pj, ej, pi, ei, cost, has)
    if ns:
        cap = torch.zeros((H, ns), dtype=i64, device=dev)
        hit0 = c0 == 0
        for o, s in enumerate(order):
            cap[:, o] = torch.where(hit0, S[s][:, m], cap[:, o])
    else:
        elo, eh, wl = c0, ehi.to(i64), wlen.to(i64)
        e0 = C[:, m]
        e_c = torch.where((elo <= 0) & (eh >= 0) & (e0 <= k_scaled), e0, BIGK)
        prv = torch.full((H,), BIGK, dtype=i64, device=dev)
        keys = torch.full((H, W + 1), BIGK, dtype=i64, device=dev)

    for j in range(1, W + 1):
        tch = win[:, j - 1]
        vert = torch.where(rpos == j, alpha, UNIT).to(i64)[:, None]
        eq = (pat & tch[:, None]) != 0  # [H, m]
        diag = C[:, :-1] + torch.where(eq, 0, UNIT)
        left = C[:, 1:] + UNIT
        X = torch.minimum(diag, left)
        Y = torch.cat(
            [torch.zeros((H, 1), dtype=i64, device=dev), X - iota[1:] * vert],
            dim=1,
        )
        Cn = torch.cummin(Y, dim=1).values + iota * vert
        c = Cn[:, 1:]
        dok = c == diag
        uok = (c == Cn[:, :-1] + vert) & ~dok
        if ns:
            rows_i = iota[1:][None, :]
            u_i = torch.where(dok | uok, rows_i - 1, rows_i)
            u_j = torch.where(uok, j, j - 1)
            if mode == MODE_TRACE:
                in_r = (u_i >= ra) & (u_i <= rb)
                lo_c = torch.where(in_r, u_j, BIGK)
                hi_c = torch.where(in_r, u_j, -1)
                at0 = u_i == 0
            else:
                in_iv = (u_i >= ra) & (u_i < rb)
                nonmatch = (in_iv & ~(dok & eq)).to(i64)
            new = [torch.empty_like(s) for s in S]
            cur = list(row0)
            for s in range(ns):
                new[s][:, 0] = row0[s]
            for i in range(1, m + 1):
                d, u = dok[:, i - 1], uok[:, i - 1]
                v = [
                    torch.where(d, S[s][:, i - 1], torch.where(u, cur[s], S[s][:, i]))
                    for s in range(ns)
                ]
                if mode == MODE_TRACE:
                    cur = [
                        torch.minimum(v[0], lo_c[:, i - 1]),
                        torch.maximum(v[1], hi_c[:, i - 1]),
                        torch.where(at0[:, i - 1], u_j[:, i - 1], v[2]),
                    ]
                else:
                    iv = in_iv[:, i - 1]
                    first = iv & (v[5] == 0)
                    ui, uj = u_i[:, i - 1], u_j[:, i - 1]
                    cur = [
                        torch.where(first, ui, v[0]),
                        torch.where(first, uj, v[1]),
                        torch.where(iv, ui, v[2]),
                        torch.where(iv, uj, v[3]),
                        v[4] + nonmatch[:, i - 1],
                        v[5] | iv.to(i64),
                    ]
                for s in range(ns):
                    new[s][:, i] = cur[s]
            S = new
            hit = c0 == j
            for o, s in enumerate(order):
                cap[:, o] = torch.where(hit, S[s][:, m], cap[:, o])
        else:
            e_raw = Cn[:, m]
            e_next = torch.where(
                (wl >= j) & (elo <= j) & (eh >= j) & (e_raw <= k_scaled),
                e_raw, BIGK,
            )
            # valley at j - 1: e <= prv and e < next
            isv = (e_c < BIGK) & (e_c <= prv) & (e_c < e_next)
            keys[:, j - 1] = torch.where(isv, e_c * klmul + (j - 1), BIGK)
            prv, e_c = e_c, e_next
        C = Cn

    if ns:
        return cap.to(torch.int32)
    # final valley at j = W (right neighbour +inf)
    isv = (e_c < BIGK) & (e_c <= prv)
    keys[:, W] = torch.where(isv, e_c * klmul + W, BIGK)
    count = (keys < BIGK).sum(dim=1)
    top = keys.sort(dim=1).values[:, :VTOPK]
    if top.shape[1] < VTOPK:
        top = torch.cat(
            [top, torch.full((H, VTOPK - top.shape[1]), BIGK, dtype=i64,
                             device=dev)],
            dim=1,
        )
    return top.to(torch.int32), count.to(torch.int32)


#: pattern rows a thread holds (the kernel's template instances)
ROWS = (1, 2, 3, 4)


def plan(m: int, W: int):
    """(R, G) of the kernel's wavefront: R <= 4 pattern rows per thread,
    G threads per lane (:func:`_build.wavefront_plan`)."""
    if not 1 <= m <= _MAXM:
        raise ValueError(f"window kernel: pattern length {m} outside 1..{_MAXM}")
    return _build.wavefront_plan(m, W, ROWS)


def _launch(wrapper, mode, pat, win, c0, ledge, rpos, ehi, wlen, alpha, ra,
            rb, k_scaled, klmul):
    """Launch the kernel in ``mode`` and count it on ``wrapper``.  The
    per-lane arrays a mode does not read are ``None`` (the kernel gets
    ``c0`` in their place): ``ledge``/``rpos`` in interval mode,
    ``ehi``/``wlen`` outside valley mode."""
    dev = win.device
    if dev.type != "cuda":
        raise ValueError(f"window kernel: unsupported device {dev}")
    H, W = win.shape
    m = pat.shape[-1]
    R, G = plan(m, W)
    shared = pat.dim() == 1
    lib = _build.load()
    i32 = torch.int32
    if mode == MODE_VALLEY:
        out = torch.empty((H, VTOPK), dtype=i32, device=dev)
        cnt = torch.empty(H, dtype=i32, device=dev)
    else:
        out = torch.empty((H, _N_SUMM[mode]), dtype=i32, device=dev)
        cnt = out
    result = (out, cnt) if mode == MODE_VALLEY else out
    if H == 0:
        return result
    p_c0 = _build.ptr(c0, "c0", i32, dev, (H,))
    lanes = [p_c0 if t is None else _build.ptr(t, name, i32, dev, (H,))
             for t, name in ((ledge, "left_edge"), (rpos, "right_pos"),
                             (ehi, "emit_hi"), (wlen, "w_len"))]
    with torch.cuda.device(dev):
        err = lib.bb_window(
            mode,
            _build.ptr(pat, "pattern", torch.uint8, dev, (m,) if shared else (H, m)),
            0 if shared else m,
            _build.ptr(win, "windows", torch.uint8, dev, (H, W)),
            p_c0, *lanes, out.data_ptr(), cnt.data_ptr(),
            H, m, W, UNIT, int(alpha), int(ra), int(rb), int(k_scaled),
            int(klmul), R, G, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "bb_window")
    _build.count_launch(wrapper)
    return result


def _i32(x):
    return x.to(torch.int32).contiguous()


def window_valleys(pattern, windows, w_len, left_edge, right_pos, emit_lo,
                   emit_hi, alpha_scaled, k_scaled, klmul):
    """Alpha-aware valley scan per lane: (keys [H, 8], count [H]).

    Key = scaled_cost * klmul + end_position; valleys outside
    [emit_lo, emit_hi] or past w_len are excluded.  Count > 8 means
    dropped valleys."""
    args = (
        MODE_VALLEY, pattern, windows, _i32(emit_lo), _i32(left_edge),
        _i32(right_pos), _i32(emit_hi), _i32(w_len), alpha_scaled, 0, 0,
        k_scaled, klmul,
    )
    if windows.device.type == "cpu":
        return window_plain(*args)
    return _launch(window_valleys, *args)


def window_trace(pattern, windows, end_j, left_edge, right_pos, alpha_scaled,
                 region_a, region_b):
    """(text_start, region_lo, region_hi) [H] each at each lane's end
    position."""
    if windows.device.type == "cpu":
        z = torch.zeros_like(end_j, dtype=torch.int32)
        out = window_plain(
            MODE_TRACE, pattern, windows, _i32(end_j), _i32(left_edge),
            _i32(right_pos), z, z, alpha_scaled, region_a, region_b, 0, 0,
        )
    else:
        out = _launch(
            window_trace, MODE_TRACE, pattern, windows, _i32(end_j),
            _i32(left_edge), _i32(right_pos), None, None, alpha_scaled,
            region_a, region_b, 0, 0,
        )
    return out[:, 0], out[:, 1], out[:, 2]


def window_interval(patterns_h, windows, end_j, iv_a, iv_b):
    """Barcode interval mapping at each lane's end position (plain
    unit-cost semiglobal; no alpha boundaries on barcode windows).
    Returns [H, 6]: iv_pj, iv_ej, iv_pi, iv_ei, iv_cost, has_iv."""
    if windows.device.type == "cpu":
        z = torch.zeros_like(end_j, dtype=torch.int32)
        return window_plain(
            MODE_INTERVAL, patterns_h, windows, _i32(end_j), z, z - 1, z, z,
            UNIT, iv_a, iv_b, 0, 0,
        )
    return _launch(
        window_interval, MODE_INTERVAL, patterns_h, windows, _i32(end_j),
        None, None, None, None, UNIT, iv_a, iv_b, 0, 0,
    )


window_valleys.launches = 0
window_trace.launches = 0
window_interval.launches = 0
