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
// Design: one thread per lane.  The DP column (m + 1 cells) and the
// per-cell path summaries are thread-local arrays updated in place
// column by column; the diagonal predecessor and the cell above are
// carried in registers.  The pattern pointer has a per-lane stride, so the
// flank modes read one shared flank (stride 0) instead of a broadcast
// [H, m] copy.
//
// What bounds it on an H100: a lane is a chain of (m x W) dependent cells
// of ~10 (valley) to ~40 (interval) integer ops; with 2.8k-16k lanes per
// call only a few warps run per SM, so it is latency-bound.  The thread-
// local columns (up to 7 x 129 ints) sit in L1-backed local memory,
// which holds them at these lane counts.
#include "common.cuh"

namespace {

constexpr int MODE_VALLEY = 0;
constexpr int MODE_TRACE = 1;
constexpr int MODE_INTERVAL = 2;
constexpr int MAXM = 128;  // longest pattern a lane may carry

template <int MODE>
struct Summ {
    static constexpr int N = MODE == MODE_TRACE ? 3 : (MODE == MODE_INTERVAL ? 6 : 1);
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

template <int MODE>
__global__ void window_kernel(
    const uint8_t* __restrict__ pat, long long pat_stride,
    const uint8_t* __restrict__ win, const int* __restrict__ c0,
    const int* __restrict__ ledge, const int* __restrict__ rpos,
    const int* __restrict__ ehi, const int* __restrict__ wlen,
    int* __restrict__ out, int* __restrict__ out_cnt, int H, int m, int W,
    int unit, int alpha, int ra, int rb, int k_scaled, int klmul) {
    constexpr int NS = Summ<MODE>::N;
    const int h = blockIdx.x * blockDim.x + threadIdx.x;
    if (h >= H) return;
    const uint8_t* p = pat + (long long)h * pat_stride;
    const uint8_t* w = win + (long long)h * W;
    const int rp = rpos[h];
    const int step0 = ledge[h] != 0 ? alpha : unit;

    // ---- column j = 0: boundary (left_edge ? alpha : 1) * i ------------
    int C[MAXM + 1];
    for (int i = 0; i <= m; ++i) C[i] = i * step0;
    int S[NS][MAXM + 1];
    int row0[NS];
    if constexpr (MODE == MODE_TRACE) {
        // path to (i, 0) is the up-chain through (0,0)..(i-1,0)
        for (int i = 0; i <= m; ++i) {
            const bool in_r0 = i - 1 >= ra;
            S[0][i] = in_r0 ? 0 : bb::BIGK;  // region_lo
            S[1][i] = in_r0 ? 0 : -1;        // region_hi
            S[2][i] = 0;                     // text start
        }
        row0[0] = bb::BIGK;
        row0[1] = -1;
        row0[2] = 0;
    } else if constexpr (MODE == MODE_INTERVAL) {
        for (int i = 0; i <= m; ++i) {
            const bool has0 = (i - 1 >= ra) && (rb > ra);
            const int ei0 = min(i - 1, rb - 1);
            S[0][i] = has0 ? ra : 0;            // iv_pi
            S[1][i] = 0;                        // iv_pj
            S[2][i] = has0 ? ei0 : -1;          // iv_ei
            S[3][i] = has0 ? 0 : -1;            // iv_ej
            S[4][i] = has0 ? ei0 - ra + 1 : 0;  // iv_cost
            S[5][i] = has0 ? 1 : 0;             // has_iv
        }
        row0[0] = 0;
        row0[1] = 0;
        row0[2] = -1;
        row0[3] = -1;
        row0[4] = 0;
        row0[5] = 0;
    }
    int cap[NS];
    const int endj = c0[h];
    if constexpr (MODE != MODE_VALLEY) {
#pragma unroll
        for (int o = 0; o < NS; ++o) {
            cap[o] = endj == 0 ? S[cap_src<MODE>(o)][m] : 0;
        }
    }

    // ---- valley tracker ---------------------------------------------------
    int tk[bb::TOPK];
#pragma unroll
    for (int s = 0; s < bb::TOPK; ++s) tk[s] = bb::BIGK;
    int count = 0;
    int prv = bb::BIGK;  // e[-1]
    int e_c = bb::BIGK;
    int elo = 0, eh = 0, wl = 0;
    if constexpr (MODE == MODE_VALLEY) {
        elo = c0[h];
        eh = ehi[h];
        wl = wlen[h];
        const int e0 = C[m];
        e_c = (0 >= elo && 0 <= eh && e0 <= k_scaled) ? e0 : bb::BIGK;
    }

    for (int j = 1; j <= W; ++j) {
        const int tch = w[j - 1];
        const int vert = j == rp ? alpha : unit;
        // boundary cell (0, j): free start, zero state
        int d_c = C[0];
        C[0] = 0;
        int up_c = 0;
        int d_s[NS], up_s[NS];
        if constexpr (MODE != MODE_VALLEY) {
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                d_s[s] = S[s][0];
                S[s][0] = row0[s];
                up_s[s] = row0[s];
            }
        }
        for (int i = 1; i <= m; ++i) {
            const bool eq = (p[i - 1] & tch) != 0;
            const int l_c = C[i];
            const int diag = d_c + (eq ? 0 : unit);
            const int left = l_c + unit;
            const int up = up_c + vert;
            const int c = min(min(diag, left), up);
            const bool dok = c == diag;
            const bool uok = (c == up) && !dok;
            C[i] = c;
            if constexpr (MODE != MODE_VALLEY) {
                // sources: diag <- prev[i-1], up <- cur[i-1], left <- prev[i];
                // then include the edge predecessor u
                const int u_i = (dok || uok) ? i - 1 : i;
                const int u_j = uok ? j : j - 1;
                int v[NS];
#pragma unroll
                for (int s = 0; s < NS; ++s) {
                    const int l_s = S[s][i];
                    v[s] = dok ? d_s[s] : (uok ? up_s[s] : l_s);
                    d_s[s] = l_s;
                }
                int nv[NS];
                if constexpr (MODE == MODE_TRACE) {
                    const bool in_r = u_i >= ra && u_i <= rb;
                    nv[0] = min(v[0], in_r ? u_j : bb::BIGK);
                    nv[1] = max(v[1], in_r ? u_j : -1);
                    nv[2] = u_i == 0 ? u_j : v[2];
                } else {
                    const bool in_iv = u_i >= ra && u_i < rb;
                    const bool first = in_iv && v[5] == 0;
                    const bool is_match = dok && eq;
                    nv[0] = first ? u_i : v[0];
                    nv[1] = first ? u_j : v[1];
                    nv[2] = in_iv ? u_i : v[2];
                    nv[3] = in_iv ? u_j : v[3];
                    nv[4] = v[4] + ((in_iv && !is_match) ? 1 : 0);
                    nv[5] = v[5] | (in_iv ? 1 : 0);
                }
#pragma unroll
                for (int s = 0; s < NS; ++s) {
                    S[s][i] = nv[s];
                    up_s[s] = nv[s];
                }
            }
            d_c = l_c;
            up_c = c;
        }
        if constexpr (MODE == MODE_VALLEY) {
            const int e_next =
                (j <= wl && j >= elo && j <= eh && up_c <= k_scaled) ? up_c : bb::BIGK;
            // valley at j - 1: e <= prv and e < next
            if (e_c < bb::BIGK && e_c <= prv && e_c < e_next) {
                bb::topk_insert(tk, e_c * klmul + (j - 1));
                ++count;
            }
            prv = e_c;
            e_c = e_next;
        } else if (endj == j) {
#pragma unroll
            for (int o = 0; o < NS; ++o)
                cap[o] = up_s[cap_src<MODE>(o)];
        }
    }

    if constexpr (MODE == MODE_VALLEY) {
        // final valley at j = W (right neighbour +inf)
        if (e_c < bb::BIGK && e_c <= prv) {
            bb::topk_insert(tk, e_c * klmul + W);
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

template <int MODE>
void launch(const uint8_t* pat, long long pat_stride, const uint8_t* win,
            const int* c0, const int* ledge, const int* rpos, const int* ehi,
            const int* wlen, int* out, int* out_cnt, int H, int m, int W,
            int unit, int alpha, int ra, int rb, int k_scaled, int klmul,
            cudaStream_t stream) {
    const int threads = 64;
    const int blocks = (H + threads - 1) / threads;
    window_kernel<MODE><<<blocks, threads, 0, stream>>>(
        pat, pat_stride, win, c0, ledge, rpos, ehi, wlen, out, out_cnt, H, m,
        W, unit, alpha, ra, rb, k_scaled, klmul);
}

}  // namespace

extern "C" int bb_window(int mode, const void* pat, long long pat_stride,
                         const void* win, const void* c0, const void* ledge,
                         const void* rpos, const void* ehi, const void* wlen,
                         void* out, void* out_cnt, int H, int m, int W,
                         int unit, int alpha, int ra, int rb, int k_scaled,
                         int klmul, void* stream) {
    if (m < 1 || m > MAXM) return (int)cudaErrorInvalidValue;
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
    if (H > 0) {
        switch (mode) {
            case MODE_VALLEY:
                launch<MODE_VALLEY>(pp, pat_stride, wp, a, b, c, d, e, o, oc, H, m, W,
                                    unit, alpha, ra, rb, k_scaled, klmul, s);
                break;
            case MODE_TRACE:
                launch<MODE_TRACE>(pp, pat_stride, wp, a, b, c, d, e, o, oc, H, m, W,
                                   unit, alpha, ra, rb, k_scaled, klmul, s);
                break;
            case MODE_INTERVAL:
                launch<MODE_INTERVAL>(pp, pat_stride, wp, a, b, c, d, e, o, oc, H, m,
                                      W, unit, alpha, ra, rb, k_scaled, klmul, s);
                break;
            default:
                return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}
