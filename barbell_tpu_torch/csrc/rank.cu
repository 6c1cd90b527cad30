// Barcode rank: for every (hit window h, barcode pattern p) pair, the
// semiglobal edit DP of p over window h with the Lodhi gap-weighted
// score carried along each cell's optimal path (lambda = 0.5, ties
// diag > up > left), reduced to the best plateau-valley key
// cost * 256 + j and the f32 Lodhi score at that key.
//
// Replaces barbell_tpu/ops/pallas_rank.py::_kernel, in its strand-split
// form (rank_pass1_split: lanes [0, split) use patterns [0, P), lanes
// [split, H) patterns [P, 2P)) and its plain form (rank_pass1,
// split = 0: every lane against every pattern).
//
// Design: an anti-diagonal wavefront in registers.  A group of G
// threads (a power of two, at most a warp) owns one (lane, pattern)
// pair; thread g holds pattern rows g*R+1 .. g*R+R, R a template
// constant, as (C, T1, T2, S) registers.  At step s thread g works on
// column j = s - g + 1: it takes row g*R at column j from thread g-1
// with __shfl_up_sync (computed there one step earlier) and keeps the
// previous step's value as the diagonal.  Rows past m in the last
// threads compute unused values.  Nothing lives in shared memory: each
// thread keeps its R pattern bytes in registers and reads the window
// byte of its column (a broadcast within the pair's lane) one step
// ahead.  The wrapper (ops/rank.py) picks (R, G) per pattern length.
//
// Only the columns the output depends on run: past column w_len the
// end cost is masked to BIGK, so no later position can be a valley and
// the valley at w_len is decided by the final check (right neighbour
// BIGK); a pair sweeps columns 1 .. min(W, w_len).
//
// Numerics: the Lodhi update a*(t1+mf), a*(t2+mf*t1), s+(mf*a)*t2 is
// written with __fmul_rn/__fadd_rn (and the file builds with
// --fmad=false) so no step contracts into an FMA: scores are bit-
// identical to the f32 reference.
//
// What bounds it on an H100: the DP's operations, 19 int32 and 8 f32
// per cell (chip_smoke.py RANK_INT_PER_CELL / RANK_F32_PER_CELL) over
// P x m x sum_h min(W, w_len_h) cells, plus the wavefront's ramp
// (G - 1 idle steps a pair) and padding rows (G*R - m).  The design
// keeps the column state out of shared memory (the earlier form moved
// 32 bytes of shared memory per cell and fit 8 warps an SM), so
// occupancy is set by registers.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;

__device__ __forceinline__ void rank_cell(int pch, int tch, int unit,
                                          int dc, float dt1, float dt2, float ds,
                                          int lc, float lt1, float lt2, float ls,
                                          int uc, float ut1, float ut2, float us,
                                          int& c, float& t1, float& t2, float& s) {
    const bool eq = (pch & tch) != 0;
    const int diag = dc + (eq ? 0 : unit);
    const int lft = lc + unit;
    const int upc = uc + unit;
    c = min(min(diag, lft), upc);
    const bool dok = c == diag;
    const bool uok = c == upc;
    const float mf = (dok && eq) ? 1.0f : 0.0f;
    const float a = dok ? 0.25f : 0.5f;
    const float st1 = dok ? dt1 : (uok ? ut1 : lt1);
    const float st2 = dok ? dt2 : (uok ? ut2 : lt2);
    const float ss = dok ? ds : (uok ? us : ls);
    t1 = __fmul_rn(a, __fadd_rn(st1, mf));
    t2 = __fmul_rn(a, __fadd_rn(st2, __fmul_rn(mf, st1)));
    s = __fadd_rn(ss, __fmul_rn(__fmul_rn(mf, a), st2));
}

template <int R>
__global__ void __launch_bounds__(THREADS)
rank_kernel(const uint8_t* __restrict__ pats, const uint8_t* __restrict__ win,
            const int* __restrict__ wlen, int* __restrict__ key_out,
            float* __restrict__ lodhi_out, int H, int P, int m, int W,
            int split, int unit, int G) {
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    const int g = threadIdx.x & (G - 1);
    const long long pair = tid / G;
    const bool valid = pair < (long long)H * P;
    const int h = valid ? (int)(pair / P) : 0;
    const int p = valid ? (int)(pair % P) : 0;
    const int pidx = (split > 0 && h >= split) ? p + P : p;
    const uint8_t* pat = pats + (long long)pidx * m;
    const uint8_t* w = win + (long long)h * W;
    const int wend = valid ? min(W, max(wlen[h], 0)) : 0;

    // column j = 0: C[i] = i * UNIT, Lodhi state all zero
    const int base = g * R;
    int pc[R], C[R];
    float T1[R], T2[R], S[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = base + r + 1;
        pc[r] = i <= m ? pat[i - 1] : 0;
        C[r] = i * unit;
        T1[r] = T2[r] = S[r] = 0.0f;
    }
    // row base at column j - 1 (the first row's diagonal) and at the
    // last column this thread finished (sent to thread g + 1)
    int pv_c = base * unit;
    float pv_t1 = 0.f, pv_t2 = 0.f, pv_s = 0.f;
    int out_c = 0;
    float out_t1 = 0.f, out_t2 = 0.f, out_s = 0.f;

    // row m is register rm of thread gm: the valley tracker's end cost
    const int gm = (m - 1) / R;
    const int rm = (m - 1) - gm * R;
    const bool owner = g == gm;
    int prv = bb::BIGK;   // e[-1]
    int e_c = m * unit;   // e[0]
    float s_c = 0.0f;
    int best_key = bb::BIGK;
    float best_s = 0.0f;

    // the warp runs until its slowest pair's row m reaches column wend
    const int nsteps = __reduce_max_sync(FULL, wend > 0 ? wend + gm : 0);
    int tch = (g == 0 && wend > 0) ? w[0] : 0;
    for (int s = 0; s < nsteps; ++s) {
        const int j = s - g + 1;
        int in_c = __shfl_up_sync(FULL, out_c, 1, G);
        float in_t1 = __shfl_up_sync(FULL, out_t1, 1, G);
        float in_t2 = __shfl_up_sync(FULL, out_t2, 1, G);
        float in_s = __shfl_up_sync(FULL, out_s, 1, G);
        if (g == 0) {  // row 0 is always the zero state
            in_c = 0;
            in_t1 = in_t2 = in_s = 0.0f;
        }
        // next step's window byte, loaded ahead of this step's cells
        const int jn = j + 1;
        const int tch_next = (jn >= 1 && jn <= wend) ? w[jn - 1] : 0;
        if (j >= 1 && j <= wend) {
            // (d*) = row i-1 @ col j-1, (u*) = row i-1 @ col j
            int dc = pv_c, uc = in_c;
            float dt1 = pv_t1, dt2 = pv_t2, ds = pv_s;
            float ut1 = in_t1, ut2 = in_t2, us = in_s;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int lc = C[r];
                const float lt1 = T1[r], lt2 = T2[r], ls = S[r];
                rank_cell(pc[r], tch, unit, dc, dt1, dt2, ds, lc, lt1, lt2, ls,
                          uc, ut1, ut2, us, C[r], T1[r], T2[r], S[r]);
                dc = lc; dt1 = lt1; dt2 = lt2; ds = ls;
                uc = C[r]; ut1 = T1[r]; ut2 = T2[r]; us = S[r];
            }
            pv_c = in_c; pv_t1 = in_t1; pv_t2 = in_t2; pv_s = in_s;
            out_c = uc; out_t1 = ut1; out_t2 = ut2; out_s = us;
            if (owner) {
                int e = C[0];
                float se = S[0];
#pragma unroll
                for (int r = 1; r < R; ++r) {
                    if (r == rm) {
                        e = C[r];
                        se = S[r];
                    }
                }
                // decide the valley at position j - 1 (its right
                // neighbour is e; j <= w_len, so e is unmasked)
                if (e_c <= prv && e_c < e) {
                    const int key = e_c * 256 + (j - 1);
                    if (key < best_key) {
                        best_key = key;
                        best_s = s_c;
                    }
                }
                prv = e_c;
                e_c = e;
                s_c = se;
            }
        }
        tch = tch_next;
    }
    if (owner && valid) {
        // position wend: its right neighbour is +inf (wend = W) or a
        // masked BIGK column (wend = w_len < W); later positions carry
        // BIGK and are never valleys
        if (e_c <= prv && e_c < bb::BIGK) {
            const int key = e_c * 256 + wend;
            if (key < best_key) {
                best_key = key;
                best_s = s_c;
            }
        }
        key_out[pair] = best_key;
        lodhi_out[pair] = best_s;
    }
}

template <int R>
cudaError_t launch(const void* pats, const void* win, const void* wlen,
                   void* key_out, void* lodhi_out, int H, int P, int m, int W,
                   int split, int unit, int G, cudaStream_t stream) {
    const long long threads = (long long)H * P * G;
    const long long blocks = (threads + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    rank_kernel<R><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(pats), static_cast<const uint8_t*>(win),
        static_cast<const int*>(wlen), static_cast<int*>(key_out),
        static_cast<float*>(lodhi_out), H, P, m, W, split, unit, G);
    return cudaSuccess;
}

}  // namespace

// rows: R pattern rows per thread (one of 1, 2, 3, 4, 6, 8, 11, 12, 16);
// group: G threads per pair, a power of two <= 32 with G * R >= m.
extern "C" int bb_rank(const void* pats, const void* win, const void* wlen,
                       void* key_out, void* lodhi_out, int H, int P, int m,
                       int W, int split, int unit, int rows, int group,
                       void* stream) {
    if (m < 1 || group < 1 || group > 32 || (group & (group - 1)) != 0 ||
        (long long)group * rows < m)
        return (int)cudaErrorInvalidValue;
    if ((long long)H * P == 0) return (int)cudaGetLastError();
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (rows) {
#define BB_RANK_ROWS(RR)                                                         \
    case RR:                                                                     \
        err = launch<RR>(pats, win, wlen, key_out, lodhi_out, H, P, m, W, split, \
                         unit, group, s);                                        \
        break;
        BB_RANK_ROWS(1)
        BB_RANK_ROWS(2)
        BB_RANK_ROWS(3)
        BB_RANK_ROWS(4)
        BB_RANK_ROWS(6)
        BB_RANK_ROWS(8)
        BB_RANK_ROWS(11)
        BB_RANK_ROWS(12)
        BB_RANK_ROWS(16)
#undef BB_RANK_ROWS
        default:
            return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
