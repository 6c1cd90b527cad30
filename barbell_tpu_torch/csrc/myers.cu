// Interior flank scan: unit-cost semiglobal bit-parallel Myers search of
// one IUPAC flank over every row, with the 8 lowest plateau-valley keys
// (cost * klmul + j, ascending) and the exact valley count per row.
//
// Replaces barbell_tpu/ops/pallas_myers.py::_kernel in top-K mode
// (reached through myers_topk_from_words).
//
// Design: one thread per row.  The pattern's W <= 4 Pv/Mv words, the
// running end cost and the top-8 chain live in registers; the per-text-
// mask equality words are a 16 x W table in shared memory (the TPU kernel
// selected them with four vector wheres).  Each thread reads its own row
// once, 16 bytes at a time.
//
// What bounds it on an H100: the scan is a chain of ~35 dependent integer
// ops per pattern word per text position, and a flagship batch has only
// ~8k rows (~62 threads per SM), so the kernel is latency-bound: neither
// the 8k x 512 bytes it reads nor the ALUs are near their limits.  More
// rows per SM (several rows per warp lane, or splitting L with a carry
// fix-up) is the lever for a later change.
#include "common.cuh"

namespace {

template <int W>
__global__ void myers_topk_kernel(
    const uint8_t* __restrict__ rows, const uint32_t* __restrict__ patw,
    const int* __restrict__ emit_lo, const int* __restrict__ emit_hi,
    int* __restrict__ keys, int* __restrict__ cnt,
    int R, int L, int top_bit, int m, int k, int klmul) {
    __shared__ uint32_t lut[16][W];
    if (threadIdx.x < 16) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
            uint32_t v = 0;
            for (int b = 0; b < 4; ++b)
                if ((threadIdx.x >> b) & 1) v |= patw[b * W + w];
            lut[threadIdx.x][w] = v;
        }
    }
    __syncthreads();
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;

    uint32_t pv[W], mv[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        pv[w] = 0xFFFFFFFFu;
        mv[w] = 0u;
    }
    int tk[bb::TOPK];
#pragma unroll
    for (int s = 0; s < bb::TOPK; ++s) tk[s] = bb::BIGK;
    int e_cur = m;         // end cost at position j (edit units)
    int e_prev = 1 << 20;  // at j - 1: position 0 is never a valley
    int count = 0;
    const int lo = emit_lo[r];
    const int hi = emit_hi[r];
    const uint4* row = reinterpret_cast<const uint4*>(rows + (size_t)r * L);

    for (int c = 0; c < L / 16; ++c) {
        const uint4 v = row[c];
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 16; ++q) {
            const int j = c * 16 + q;
            const uint32_t tb = (words[q >> 2] >> ((q & 3) * 8)) & 15u;
            uint32_t sc = 0, ph_in = 0, mh_in = 0, ph_top = 0, mh_top = 0;
#pragma unroll
            for (int w = 0; w < W; ++w) {
                const uint32_t eq = lut[tb][w];
                const uint32_t p = pv[w], mm = mv[w];
                const uint32_t xv = eq | mm;
                const uint32_t t1 = eq & p;
                const uint32_t s1 = t1 + p;
                const uint32_t c1 = s1 < t1;
                const uint32_t s2 = s1 + sc;
                const uint32_t c2 = s2 < s1;
                sc = c1 | c2;
                const uint32_t xh = (s2 ^ p) | eq;
                const uint32_t ph = mm | ~(xh | p);
                const uint32_t mh = p & xh;
                if (w == W - 1) {
                    ph_top = (ph >> top_bit) & 1u;
                    mh_top = (mh >> top_bit) & 1u;
                }
                const uint32_t ph_s = (ph << 1) | ph_in;
                ph_in = ph >> 31;
                const uint32_t mh_s = (mh << 1) | mh_in;
                mh_in = mh >> 31;
                pv[w] = mh_s | ~(xv | ph_s);
                mv[w] = ph_s & xv;
            }
            const int e_next = e_cur + (int)ph_top - (int)mh_top;
            // decide position j with (e_prev, e_cur, e_next)
            if (e_cur <= k && e_cur <= e_prev && e_cur < e_next && j >= lo &&
                j <= hi) {
                bb::topk_insert(tk, e_cur * klmul + j);
                ++count;
            }
            e_prev = e_cur;
            e_cur = e_next;
        }
    }
#pragma unroll
    for (int s = 0; s < bb::TOPK; ++s) keys[(size_t)r * bb::TOPK + s] = tk[s];
    cnt[r] = count;
}

template <int W>
void launch(const uint8_t* rows, const uint32_t* patw, const int* emit_lo,
            const int* emit_hi, int* keys, int* cnt, int R, int L,
            int top_bit, int m, int k, int klmul, cudaStream_t stream) {
    const int threads = 64;
    const int blocks = (R + threads - 1) / threads;
    myers_topk_kernel<W><<<blocks, threads, 0, stream>>>(
        rows, patw, emit_lo, emit_hi, keys, cnt, R, L, top_bit, m, k, klmul);
}

}  // namespace

extern "C" int bb_myers_topk(const void* rows, const void* patw,
                             const void* emit_lo, const void* emit_hi,
                             void* keys, void* cnt, int R, int L, int W,
                             int top_bit, int m, int k, int klmul,
                             void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto a = static_cast<const uint8_t*>(rows);
    auto p = static_cast<const uint32_t*>(patw);
    auto lo = static_cast<const int*>(emit_lo);
    auto hi = static_cast<const int*>(emit_hi);
    auto ko = static_cast<int*>(keys);
    auto co = static_cast<int*>(cnt);
    if (R > 0) {
        switch (W) {
            case 1: launch<1>(a, p, lo, hi, ko, co, R, L, top_bit, m, k, klmul, s); break;
            case 2: launch<2>(a, p, lo, hi, ko, co, R, L, top_bit, m, k, klmul, s); break;
            case 3: launch<3>(a, p, lo, hi, ko, co, R, L, top_bit, m, k, klmul, s); break;
            case 4: launch<4>(a, p, lo, hi, ko, co, R, L, top_bit, m, k, klmul, s); break;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}
