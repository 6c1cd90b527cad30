// Per-lane window DP: one pattern against one small text window per
// lane, with the alpha overhang boundary, in three modes.
//
// Replaces barbell_tpu/ops/pallas_window.py::_kernel:
//   MODE_VALLEY   (window_valleys)  alpha-aware end-cost curve -> the 8
//                 lowest valley keys (cost * klmul + j) and the exact count
//   MODE_TRACE    (window_trace)    alignment start column and mask-region
//                 text span carried along the optimal path, captured at
//                 the lane's end column
//   MODE_INTERVAL (window_interval) the winning barcode's interval mapped
//                 through the optimal path ending at the lane's end column
// Same move tie-break as the Pallas kernel: diag, then up (only when not
// diag), then left.
//
// Design: an anti-diagonal wavefront in registers.  A group of G
// threads (a power of two, at most a warp) owns one lane; thread g
// holds pattern rows g*R+1 .. g*R+R (R <= 4, a template constant) as a
// cost and NS path summaries each (NS = 0 valley, 3 trace, 6 interval).
// At step s thread g works on column j = s - g + 1 with its own column
// costs (the vertical step is alpha at j == right_pos, the column-0
// boundary i * step0); it takes row g*R at column j from thread g-1 by
// __shfl_up_sync (computed there one step earlier) and keeps the
// previous step's value as the diagonal.  Every register array is
// indexed by unrolled constants, so nothing spills to local memory; the
// row-m values are picked by selects.  The thread holding row m tracks
// valleys (valley mode) or captures the summaries at the end column.
// A shared flank (pattern stride 0) is loaded once per block into
// shared memory; the window byte of a thread's column is read one step
// ahead.  The wrapper (ops/window.py) picks (R, G) per pattern length.
//
// Only the columns the output depends on run: trace and interval stop
// at the lane's end column (none when it lies outside 0..W); valley
// mode stops at min(W, w_len, emit_hi), past which every end cost is
// masked to BIGK, so the final check there equals the full sweep's.
//
// What bounds it on an H100: the DP's integer operations (chip_smoke.py
// WINDOW_PER_CELL) over the cells those columns need, plus the
// wavefront's ramp (G - 1 idle steps a lane) and padding rows.  The
// earlier one-thread-per-lane form ran a serial chain of m x W cells per
// thread with its columns in local memory, at 44-96 blocks for the
// card's 132 SMs.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;
constexpr int MODE_VALLEY = 0;
constexpr int MODE_TRACE = 1;
constexpr int MODE_INTERVAL = 2;
constexpr int MAXM = 128;  // longest pattern a lane may carry

template <int MODE>
struct Summ {
    static constexpr int N = MODE == MODE_TRACE ? 3 : (MODE == MODE_INTERVAL ? 6 : 0);
    static constexpr int A = N > 0 ? N : 1;  // array extent
};

// Summary captured into output column o: trace (ts, rlo, rhi) from the
// summaries (rlo, rhi, ts); interval (pj, ej, pi, ei, cost, has) from
// (pi, pj, ei, ej, cost, has).
template <int MODE>
__device__ __forceinline__ constexpr int cap_src(int o) {
    return MODE == MODE_TRACE
               ? (o + 2) % 3
               : (o == 0 ? 1 : o == 1 ? 3 : o == 2 ? 0 : o == 3 ? 2 : o);
}

// Summaries of the path to (i, 0), the up-chain through (0,0)..(i-1,0).
template <int MODE>
__device__ __forceinline__ void col0(int i, int ra, int rb, int (&v)[Summ<MODE>::A]) {
    if constexpr (MODE == MODE_TRACE) {
        const bool in_r0 = i - 1 >= ra;
        v[0] = in_r0 ? 0 : bb::BIGK;  // region_lo
        v[1] = in_r0 ? 0 : -1;        // region_hi
        v[2] = 0;                     // text start
    } else if constexpr (MODE == MODE_INTERVAL) {
        const bool has0 = (i - 1 >= ra) && (rb > ra);
        const int ei0 = min(i - 1, rb - 1);
        v[0] = has0 ? ra : 0;            // iv_pi
        v[1] = 0;                        // iv_pj
        v[2] = has0 ? ei0 : -1;          // iv_ei
        v[3] = has0 ? 0 : -1;            // iv_ej
        v[4] = has0 ? ei0 - ra + 1 : 0;  // iv_cost
        v[5] = has0 ? 1 : 0;             // has_iv
    }
}

// Summaries of row 0 at every column j >= 1 (free start).
template <int MODE>
__device__ __forceinline__ int row0(int k) {
    if constexpr (MODE == MODE_TRACE) {
        return k == 0 ? bb::BIGK : (k == 1 ? -1 : 0);
    } else {
        return (k == 2 || k == 3) ? -1 : 0;
    }
}

template <int MODE, int R>
__global__ void __launch_bounds__(THREADS) window_kernel(
    const uint8_t* __restrict__ pat, long long pat_stride,
    const uint8_t* __restrict__ win, const int* __restrict__ c0,
    const int* __restrict__ ledge, const int* __restrict__ rpos,
    const int* __restrict__ ehi, const int* __restrict__ wlen,
    int* __restrict__ out, int* __restrict__ out_cnt, int H, int m, int W,
    int unit, int alpha, int ra, int rb, int k_scaled, int klmul, int G) {
    constexpr int NS = Summ<MODE>::N;
    constexpr int NSA = Summ<MODE>::A;
    __shared__ uint8_t spat[MAXM];
    if (pat_stride == 0) {  // one flank for every lane
        for (int i = threadIdx.x; i < m; i += THREADS) spat[i] = pat[i];
        __syncthreads();
    }
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    const int g = threadIdx.x & (G - 1);
    const long long lane = tid / G;
    const bool valid = lane < H;
    const int h = valid ? (int)lane : 0;
    const uint8_t* p = pat_stride == 0 ? spat : pat + (long long)h * pat_stride;
    const uint8_t* w = win + (long long)h * W;
    // the interval mode has no alpha boundary (left_edge 0, right_pos -1)
    const int step0 = (MODE != MODE_INTERVAL && ledge[h] != 0) ? alpha : unit;
    const int rp = MODE == MODE_INTERVAL ? -1 : rpos[h];
    const int endj = c0[h];  // emit_lo in valley mode
    int wend;
    if constexpr (MODE == MODE_VALLEY) {
        wend = max(0, min(W, min(wlen[h], ehi[h])));
    } else {
        wend = (endj >= 0 && endj <= W) ? endj : 0;
    }
    if (!valid) wend = 0;

    // ---- column j = 0: boundary (left_edge ? alpha : 1) * i ------------
    const int base = g * R;
    int pc[R], C[R];
    int S[NSA][R];
    bool reg_prev[R], reg_cur[R];  // region / interval holds row i-1 / i
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = base + r + 1;
        pc[r] = i <= m ? p[i - 1] : 0;
        C[r] = i * step0;
        if constexpr (NS > 0) {
            int v[NSA];
            col0<MODE>(i, ra, rb, v);
#pragma unroll
            for (int k = 0; k < NS; ++k) S[k][r] = v[k];
        }
        if constexpr (MODE == MODE_TRACE) {
            reg_prev[r] = i - 1 >= ra && i - 1 <= rb;
            reg_cur[r] = i >= ra && i <= rb;
        } else {
            reg_prev[r] = i - 1 >= ra && i - 1 < rb;
            reg_cur[r] = i >= ra && i < rb;
        }
    }
    // row base at column j - 1 (the first row's diagonal) and at the
    // last column this thread finished (sent to thread g + 1)
    int pv_c = base * step0, out_c = 0;
    int pv_s[NSA], out_s[NSA];
    if constexpr (NS > 0) col0<MODE>(base, ra, rb, pv_s);
#pragma unroll
    for (int k = 0; k < NSA; ++k) out_s[k] = 0;

    // row m is register rm of thread gm
    const int gm = (m - 1) / R;
    const int rm = (m - 1) - gm * R;
    const bool owner = g == gm;

    int cap[NSA];
#pragma unroll
    for (int o = 0; o < NSA; ++o) cap[o] = 0;
    if constexpr (NS > 0) {
        if (owner && endj == 0) {  // captured from column 0
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if (r == rm) {
#pragma unroll
                    for (int o = 0; o < NS; ++o) cap[o] = S[cap_src<MODE>(o)][r];
                }
            }
        }
    }

    // ---- valley tracker ---------------------------------------------------
    int tk[bb::TOPK];
#pragma unroll
    for (int s = 0; s < bb::TOPK; ++s) tk[s] = bb::BIGK;
    int count = 0;
    int prv = bb::BIGK;  // e[-1]
    int e_c = bb::BIGK;
    if constexpr (MODE == MODE_VALLEY) {
        const int e0 = m * step0;
        e_c = (0 >= endj && 0 <= ehi[h] && e0 <= k_scaled) ? e0 : bb::BIGK;
    }

    // the warp runs until its slowest lane's row m reaches column wend
    const int nsteps = __reduce_max_sync(FULL, wend > 0 ? wend + gm : 0);
    int tch = (g == 0 && wend > 0) ? w[0] : 0;
    for (int s = 0; s < nsteps; ++s) {
        const int j = s - g + 1;
        int in_c = __shfl_up_sync(FULL, out_c, 1, G);
        int in_s[NSA];
#pragma unroll
        for (int k = 0; k < NS; ++k) in_s[k] = __shfl_up_sync(FULL, out_s[k], 1, G);
        if (g == 0) {  // row 0: free start, zero cost
            in_c = 0;
#pragma unroll
            for (int k = 0; k < NS; ++k) in_s[k] = row0<MODE>(k);
        }
        // next step's window byte, loaded ahead of this step's cells
        const int jn = j + 1;
        const int tch_next = (jn >= 1 && jn <= wend) ? w[jn - 1] : 0;
        if (j >= 1 && j <= wend) {
            const int vert = j == rp ? alpha : unit;
            int d_c = pv_c, up_c = in_c;
            int d_s[NSA], up_s[NSA];
#pragma unroll
            for (int k = 0; k < NS; ++k) {
                d_s[k] = pv_s[k];
                up_s[k] = in_s[k];
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const bool eq = (pc[r] & tch) != 0;
                const int l_c = C[r];
                const int diag = d_c + (eq ? 0 : unit);
                const int left = l_c + unit;
                const int up = up_c + vert;
                const int c = min(min(diag, left), up);
                const bool dok = c == diag;
                const bool uok = (c == up) && !dok;
                if constexpr (NS > 0) {
                    // sources: diag <- (i-1, j-1), up <- (i-1, j), left <-
                    // (i, j-1); then include the edge predecessor u
                    const bool from_above = dok || uok;  // u_i = i - 1
                    const int u_j = uok ? j : j - 1;
                    const bool in_r = from_above ? reg_prev[r] : reg_cur[r];
                    int v[NS];
#pragma unroll
                    for (int k = 0; k < NS; ++k) {
                        const int l_s = S[k][r];
                        v[k] = dok ? d_s[k] : (uok ? up_s[k] : l_s);
                        d_s[k] = l_s;
                    }
                    int nv[NS];
                    if constexpr (MODE == MODE_TRACE) {
                        const bool at0 = from_above && base + r == 0;  // u_i == 0
                        nv[0] = min(v[0], in_r ? u_j : bb::BIGK);
                        nv[1] = max(v[1], in_r ? u_j : -1);
                        nv[2] = at0 ? u_j : v[2];
                    } else {
                        const int u_i = from_above ? base + r : base + r + 1;
                        const bool first = in_r && v[5] == 0;
                        const bool is_match = dok && eq;
                        nv[0] = first ? u_i : v[0];
                        nv[1] = first ? u_j : v[1];
                        nv[2] = in_r ? u_i : v[2];
                        nv[3] = in_r ? u_j : v[3];
                        nv[4] = v[4] + ((in_r && !is_match) ? 1 : 0);
                        nv[5] = v[5] | (in_r ? 1 : 0);
                    }
#pragma unroll
                    for (int k = 0; k < NS; ++k) {
                        S[k][r] = nv[k];
                        up_s[k] = nv[k];
                    }
                }
                C[r] = c;
                d_c = l_c;
                up_c = c;
            }
            pv_c = in_c;
            out_c = up_c;
#pragma unroll
            for (int k = 0; k < NS; ++k) {
                pv_s[k] = in_s[k];
                out_s[k] = up_s[k];
            }
            if (owner) {
                if constexpr (MODE == MODE_VALLEY) {
                    int cm = C[0];
#pragma unroll
                    for (int r = 1; r < R; ++r) cm = r == rm ? C[r] : cm;
                    // j <= wend keeps j <= w_len and j <= emit_hi
                    const int e_next = (j >= endj && cm <= k_scaled) ? cm : bb::BIGK;
                    // valley at j - 1: e <= prv and e < next
                    if (e_c < bb::BIGK && e_c <= prv && e_c < e_next) {
                        bb::topk_insert(tk, e_c * klmul + (j - 1));
                        ++count;
                    }
                    prv = e_c;
                    e_c = e_next;
                } else if (j == endj) {
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        if (r == rm) {
#pragma unroll
                            for (int o = 0; o < NS; ++o) cap[o] = S[cap_src<MODE>(o)][r];
                        }
                    }
                }
            }
        }
        tch = tch_next;
    }

    if (!(owner && valid)) return;
    if constexpr (MODE == MODE_VALLEY) {
        // final valley at wend: its right neighbour is +inf (wend = W)
        // or a masked BIGK column
        if (e_c < bb::BIGK && e_c <= prv) {
            bb::topk_insert(tk, e_c * klmul + wend);
            ++count;
        }
#pragma unroll
        for (int s = 0; s < bb::TOPK; ++s) out[(size_t)h * bb::TOPK + s] = tk[s];
        out_cnt[h] = count;
    } else {
#pragma unroll
        for (int o = 0; o < NS; ++o) out[(size_t)h * NS + o] = cap[o];
    }
}

template <int MODE, int R>
cudaError_t launch(const uint8_t* pat, long long pat_stride, const uint8_t* win,
                   const int* c0, const int* ledge, const int* rpos,
                   const int* ehi, const int* wlen, int* out, int* out_cnt,
                   int H, int m, int W, int unit, int alpha, int ra, int rb,
                   int k_scaled, int klmul, int G, cudaStream_t stream) {
    const long long blocks = ((long long)H * G + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    window_kernel<MODE, R><<<(unsigned)blocks, THREADS, 0, stream>>>(
        pat, pat_stride, win, c0, ledge, rpos, ehi, wlen, out, out_cnt, H, m,
        W, unit, alpha, ra, rb, k_scaled, klmul, G);
    return cudaSuccess;
}

template <int MODE>
cudaError_t launch_rows(int rows, const uint8_t* pat, long long pat_stride,
                        const uint8_t* win, const int* c0, const int* ledge,
                        const int* rpos, const int* ehi, const int* wlen,
                        int* out, int* out_cnt, int H, int m, int W, int unit,
                        int alpha, int ra, int rb, int k_scaled, int klmul,
                        int G, cudaStream_t stream) {
    switch (rows) {
#define BB_WINDOW_ROWS(RR)                                                       \
    case RR:                                                                     \
        return launch<MODE, RR>(pat, pat_stride, win, c0, ledge, rpos, ehi,      \
                                wlen, out, out_cnt, H, m, W, unit, alpha, ra,    \
                                rb, k_scaled, klmul, G, stream);
        BB_WINDOW_ROWS(1)
        BB_WINDOW_ROWS(2)
        BB_WINDOW_ROWS(3)
        BB_WINDOW_ROWS(4)
#undef BB_WINDOW_ROWS
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// rows: R pattern rows per thread (1-4); group: G threads per lane, a
// power of two <= 32 with G * R >= m.  Arrays a mode does not read
// (ledge, rpos in interval mode; ehi, wlen outside valley mode) may be
// any int32 [H] array.
extern "C" int bb_window(int mode, const void* pat, long long pat_stride,
                         const void* win, const void* c0, const void* ledge,
                         const void* rpos, const void* ehi, const void* wlen,
                         void* out, void* out_cnt, int H, int m, int W,
                         int unit, int alpha, int ra, int rb, int k_scaled,
                         int klmul, int rows, int group, void* stream) {
    if (m < 1 || m > MAXM || group < 1 || group > 32 ||
        (group & (group - 1)) != 0 || group * rows < m)
        return (int)cudaErrorInvalidValue;
    if (H <= 0) return (int)cudaGetLastError();
    auto s = static_cast<cudaStream_t>(stream);
    auto pp = static_cast<const uint8_t*>(pat);
    auto wp = static_cast<const uint8_t*>(win);
    auto a = static_cast<const int*>(c0);
    auto b = static_cast<const int*>(ledge);
    auto c = static_cast<const int*>(rpos);
    auto d = static_cast<const int*>(ehi);
    auto e = static_cast<const int*>(wlen);
    auto o = static_cast<int*>(out);
    auto oc = static_cast<int*>(out_cnt);
    cudaError_t err;
    switch (mode) {
        case MODE_VALLEY:
            err = launch_rows<MODE_VALLEY>(rows, pp, pat_stride, wp, a, b, c, d, e,
                                           o, oc, H, m, W, unit, alpha, ra, rb,
                                           k_scaled, klmul, group, s);
            break;
        case MODE_TRACE:
            err = launch_rows<MODE_TRACE>(rows, pp, pat_stride, wp, a, b, c, d, e,
                                          o, oc, H, m, W, unit, alpha, ra, rb,
                                          k_scaled, klmul, group, s);
            break;
        case MODE_INTERVAL:
            err = launch_rows<MODE_INTERVAL>(rows, pp, pat_stride, wp, a, b, c, d,
                                             e, o, oc, H, m, W, unit, alpha, ra,
                                             rb, k_scaled, klmul, group, s);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
