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
// Design: one thread per (lane, pattern) pair; consecutive threads share
// a lane, so the window bytes they read are broadcasts.  The four DP
// column arrays (C, T1, T2, S over the m + 1 pattern rows) live in
// shared memory laid out [row][thread], conflict-free, updated in place
// with the diagonal predecessor carried in registers.
//
// Numerics: the Lodhi update a*(t1+mf), a*(t2+mf*t1), s+(mf*a)*t2 is
// written with __fmul_rn/__fadd_rn (and the file builds with
// --fmad=false) so no step contracts into an FMA: scores are bit-
// identical to the f32 reference.
//
// What bounds it on an H100: ~25 ops per DP cell over H x P x m x W cells
// (flagship: 2816 x 96 x 44 x 66 = 785M cells); shared-memory traffic is
// 32 bytes per cell.  At 64 threads x 720 bytes per block, ~4 blocks fit
// an SM, so the kernel is bound by issue and shared-memory latency.
#include "common.cuh"

namespace {

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

__global__ void rank_kernel(const uint8_t* __restrict__ pats,
                            const uint8_t* __restrict__ win,
                            const int* __restrict__ wlen,
                            int* __restrict__ key_out,
                            float* __restrict__ lodhi_out, int H, int P,
                            int m, int W, int split, int unit) {
    extern __shared__ unsigned char smem[];
    const int bd = blockDim.x;
    const int tid = threadIdx.x;
    int* Cc = reinterpret_cast<int*>(smem);
    float* T1 = reinterpret_cast<float*>(Cc + (m + 1) * bd);
    float* T2 = T1 + (m + 1) * bd;
    float* Sc = T2 + (m + 1) * bd;

    const long long t = (long long)blockIdx.x * bd + tid;
    if (t >= (long long)H * P) return;
    const int h = (int)(t / P);
    const int p = (int)(t % P);
    const int pidx = (split > 0 && h >= split) ? p + P : p;
    const uint8_t* pat = pats + (long long)pidx * m;
    const uint8_t* w = win + (long long)h * W;
    const int wl = wlen[h];

    // column j = 0: C[i] = i * UNIT, Lodhi state all zero
    for (int i = 0; i <= m; ++i) {
        Cc[i * bd + tid] = i * unit;
        T1[i * bd + tid] = 0.0f;
        T2[i * bd + tid] = 0.0f;
        Sc[i * bd + tid] = 0.0f;
    }
    int prv = bb::BIGK;   // e[-1]
    int e_c = m * unit;   // e[0]
    float s_c = 0.0f;
    int best_key = bb::BIGK;
    float best_s = 0.0f;

    for (int j = 1; j <= W; ++j) {
        const int tch = w[j - 1];
        // row 0 is always zero state; (d*) = row i-1 @ col j-1,
        // (u*) = row i-1 @ col j
        int dc = 0, uc = 0;
        float dt1 = 0.f, dt2 = 0.f, ds = 0.f, ut1 = 0.f, ut2 = 0.f, us = 0.f;
        for (int i = 1; i <= m; ++i) {
            const int o = i * bd + tid;
            const int lc = Cc[o];
            const float lt1 = T1[o], lt2 = T2[o], ls = Sc[o];
            int c;
            float t1, t2, s;
            rank_cell(pat[i - 1], tch, unit, dc, dt1, dt2, ds, lc, lt1, lt2, ls,
                      uc, ut1, ut2, us, c, t1, t2, s);
            Cc[o] = c;
            T1[o] = t1;
            T2[o] = t2;
            Sc[o] = s;
            dc = lc; dt1 = lt1; dt2 = lt2; ds = ls;
            uc = c; ut1 = t1; ut2 = t2; us = s;
        }
        const int e = j <= wl ? uc : bb::BIGK;
        // decide the valley at position j - 1 (its right neighbour is e)
        if (e_c <= prv && e_c < e) {
            const int key = e_c * 256 + (j - 1);
            if (key < best_key) {
                best_key = key;
                best_s = s_c;
            }
        }
        prv = e_c;
        e_c = e;
        s_c = us;
    }
    // final position j = W (right neighbour +inf); masked positions
    // carry BIGK and are excluded
    if (e_c <= prv && e_c < bb::BIGK) {
        const int key = e_c * 256 + W;
        if (key < best_key) {
            best_key = key;
            best_s = s_c;
        }
    }
    key_out[t] = best_key;
    lodhi_out[t] = best_s;
}

}  // namespace

extern "C" int bb_rank(const void* pats, const void* win, const void* wlen,
                       void* key_out, void* lodhi_out, int H, int P, int m,
                       int W, int split, int unit, void* stream) {
    if (m < 1) return (int)cudaErrorInvalidValue;
    const int threads = 64;
    const size_t smem = (size_t)16 * (m + 1) * threads;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const long long n = (long long)H * P;
    if (n > 0) {
        const int blocks = (int)((n + threads - 1) / threads);
        rank_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(pats), static_cast<const uint8_t*>(win),
            static_cast<const int*>(wlen), static_cast<int*>(key_out),
            static_cast<float*>(lodhi_out), H, P, m, W, split, unit);
    }
    return (int)cudaGetLastError();
}
