// Interior flank scan: unit-cost semiglobal bit-parallel Myers search of
// one IUPAC flank over every row.  Two output modes, one template flag:
// top-K (the 8 lowest plateau-valley keys cost * klmul + j, ascending, and
// the exact valley count per row) and map (a u8 valley-cost map [R, L],
// 255 where position j is no valley).
//
// Replaces barbell_tpu/ops/pallas_myers.py::_kernel in both modes: top-K
// (reached through myers_topk_from_words) and map (myers_valleys,
// myers_valleys_from_words).
//
// Design: each row's positions are split into S segments of SEG columns
// (S a power of two <= 32, SEG a multiple of 16; the wrapper's plan,
// barbell_tpu_torch/_build.py segment_plan).  The S threads of a row are
// adjacent lanes of one warp.  Segment s decides the positions [a, b) =
// [s * SEG, min(L, (s + 1) * SEG)) that lie in the row's emission range
// [emit_lo, emit_hi]: it starts the Myers state fresh WARMUP columns
// before the first of them and stops after the column that gives the end
// cost right of the last, so a row's work ends at its emission range and
// a row whose range is empty does none.  The pattern's W <= 4 Pv/Mv
// words, the running end cost and the segment's top-8 chain live in
// registers; the per-text-mask equality words are a 16 x W table in
// shared memory.  A thread reads its columns 16 bytes at a time from the
// aligned word holding its first column and zeroes the bytes before that
// column: a zero byte matches no pattern base, and the fresh column
// (D[i] = i) stays fresh through it, so that is the same as starting
// there.  Top-K mode then merges the S sorted lists in 8 rounds: the
// minimum of the lanes' list heads by __shfl_xor_sync, the lowest lane
// holding it pops (keys are unique within a row, apart from the 2**30
// sentinels, for klmul > L); counts are summed the same way.  Map mode
// needs no merge: each segment writes its own [a, b) bytes.
//
// The warm-up, WARMUP = m + k columns (warmup_cols below).  Position j's
// end cost e[j] is the least cost of the pattern against text [i, j) over
// all i; a scan started fresh at column s0 gives that minimum over
// i >= s0, never lower.  An alignment of cost c <= k spans at most
// m + c text columns (each of its insertions costs one), so e[j] <= k is
// exact once j - m - e[j] >= s0.  A segment decides j >= d = s0 + WARMUP
// from e[j - 1], e[j] and e[j + 1]:
//   - e[j] <= k is exact, since j - m - k >= s0;
//   - the test e[j] <= e[j - 1] can only change if the true e[j - 1] is
//     below e[j] <= k, so e[j - 1] <= k - 1 and (j - 1) - m - (k - 1) >= s0
//     makes it exact; an overestimate above k changes no answer;
//   - e[j] < e[j + 1] likewise: e[j + 1] <= k is exact at j + 1 >= d, and
//     an overestimate above k >= e[j] changes no answer.
// So the valleys, keys and counts are those of one pass over the row.
// One column less is wrong: a cost-k alignment of k insertions spans
// m + k columns, and ending at d it would start one column before s0
// (tests/test_torch_myers.py shows the difference on such a row).
//
// What bounds it on an H100: the scan is a chain of dependent integer ops
// (~23 per pattern word and ~15 per position, chip_smoke.py MYERS_*) per
// text column.  With one thread per row (the earlier form) a flagship
// batch ran ~2 warps an SM and the whole time was one thread's chain over
// L columns; S segments give S times the threads and a chain of
// SEG + WARMUP columns, against WARMUP / SEG of extra work.  Rows are read
// once, 16 bytes a load; map mode writes one byte per position.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;

// columns a segment scans before the first position it decides
__device__ __forceinline__ int warmup_cols(int m, int k) { return m + k; }

// the 16 bytes of a row word with the first `skip` bytes zeroed
__device__ __forceinline__ uint32_t keep_from(uint32_t word, int byte0, int skip) {
    const int n = skip - byte0;  // bytes of this u32 to zero
    if (n <= 0) return word;
    if (n >= 4) return 0u;
    return word & (0xFFFFFFFFu << (8 * n));
}

template <int W, bool TOPK>
__global__ void __launch_bounds__(THREADS) myers_kernel(
    const uint8_t* __restrict__ rows, const uint32_t* __restrict__ patw,
    const int* __restrict__ emit_lo, const int* __restrict__ emit_hi,
    int* __restrict__ keys, int* __restrict__ cnt, uint8_t* __restrict__ map,
    int R, int L, int top_bit, int m, int k, int klmul, int seg, int log2s) {
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
    const int S = 1 << log2s;
    const int t = blockIdx.x * THREADS + threadIdx.x;
    const int r = t >> log2s;
    const int s = t & (S - 1);
    const int a = min(L, s * seg);
    const int b = min(L, a + seg);
    // the positions this segment decides: [a, b) within [emit_lo, emit_hi]
    int dlo = 1, dhi = 0;
    if (r < R) {
        dlo = max(a, emit_lo[r]);
        dhi = min(b - 1, emit_hi[r]);
    }
    const bool work = dlo <= dhi;
    const int s0 = work ? max(0, dlo - warmup_cols(m, k)) : 0;
    const int c_begin = work ? s0 >> 4 : a >> 4;
    const int c_end = work ? (dhi >> 4) + 1 : a >> 4;
    uint4* out_row = nullptr;
    if (!TOPK) {
        if (r >= R) return;
        out_row = reinterpret_cast<uint4*>(map + (size_t)r * L);
        const uint4 none = make_uint4(FULL, FULL, FULL, FULL);
        for (int c = a >> 4; c < (b >> 4); ++c)
            if (c < c_begin || c >= c_end) out_row[c] = none;
    }

    uint32_t pv[W], mv[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        pv[w] = 0xFFFFFFFFu;
        mv[w] = 0u;
    }
    int tk[bb::TOPK];
#pragma unroll
    for (int q = 0; q < bb::TOPK; ++q) tk[q] = bb::BIGK;
    int e_cur = m;         // end cost at position j (edit units)
    int e_prev = 1 << 20;  // at j - 1: decides position 0 of a scan from 0
    int count = 0;
    const uint4* row = reinterpret_cast<const uint4*>(rows + (size_t)r * L);

    for (int c = c_begin; c < c_end; ++c) {
        uint4 v = row[c];
        if (c == c_begin) {  // the warm-up starts at column s0
            const int skip = s0 & 15;
            v.x = keep_from(v.x, 0, skip);
            v.y = keep_from(v.y, 4, skip);
            v.z = keep_from(v.z, 8, skip);
            v.w = keep_from(v.w, 12, skip);
        }
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
        uint32_t ob[4] = {0u, 0u, 0u, 0u};  // map mode: 16 output bytes
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
            const bool valley = e_cur <= k && e_cur <= e_prev &&
                                e_cur < e_next && j >= dlo && j <= dhi;
            if (TOPK) {
                if (valley) {
                    // e * klmul is formed for valleys only: it overflows
                    // int32 for the large costs of non-valley positions
                    bb::topk_insert(tk, e_cur * klmul + j);
                    ++count;
                }
            } else {
                // a valley's cost is <= k < 255
                const uint32_t byte = valley ? (uint32_t)e_cur : 255u;
                ob[q >> 2] |= byte << ((q & 3) * 8);
            }
            e_prev = e_cur;
            e_cur = e_next;
        }
        // warm-up words lie before a (a multiple of 16): not this segment's
        if (!TOPK && c >= (a >> 4)) out_row[c] = make_uint4(ob[0], ob[1], ob[2], ob[3]);
    }
    if (TOPK) {
        // merge the row's S sorted lists: 8 rounds of (group minimum of
        // the heads, the lowest lane holding it pops)
        const int lane = threadIdx.x & 31;
        const unsigned group = (S == 32 ? FULL : ((1u << S) - 1u)) << (lane & ~(S - 1));
        for (int off = 1; off < S; off <<= 1) count += __shfl_xor_sync(FULL, count, off);
        int out[bb::TOPK];
#pragma unroll
        for (int i = 0; i < bb::TOPK; ++i) {
            int mn = tk[0];
            for (int off = 1; off < S; off <<= 1) mn = min(mn, __shfl_xor_sync(FULL, mn, off));
            out[i] = mn;
            const unsigned holders = __ballot_sync(FULL, tk[0] == mn) & group;
            if (lane == __ffs(holders) - 1) {
#pragma unroll
                for (int q = 0; q + 1 < bb::TOPK; ++q) tk[q] = tk[q + 1];
                tk[bb::TOPK - 1] = bb::BIGK;
            }
        }
        if (s == 0 && r < R) {
#pragma unroll
            for (int q = 0; q < bb::TOPK; ++q) keys[(size_t)r * bb::TOPK + q] = out[q];
            cnt[r] = count;
        }
    }
}

template <int W, bool TOPK>
void launch(const uint8_t* rows, const uint32_t* patw, const int* emit_lo,
            const int* emit_hi, int* keys, int* cnt, uint8_t* map, int R,
            int L, int top_bit, int m, int k, int klmul, int seg, int log2s,
            cudaStream_t stream) {
    const long long threads = (long long)R << log2s;
    const int blocks = (int)((threads + THREADS - 1) / THREADS);
    myers_kernel<W, TOPK><<<blocks, THREADS, 0, stream>>>(
        rows, patw, emit_lo, emit_hi, keys, cnt, map, R, L, top_bit, m, k,
        klmul, seg, log2s);
}

template <bool TOPK>
int dispatch(const void* rows, const void* patw, const void* emit_lo,
             const void* emit_hi, int* keys, int* cnt, uint8_t* map, int R,
             int L, int W, int top_bit, int m, int k, int klmul, int seg,
             int S, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    auto a = static_cast<const uint8_t*>(rows);
    auto p = static_cast<const uint32_t*>(patw);
    auto lo = static_cast<const int*>(emit_lo);
    auto hi = static_cast<const int*>(emit_hi);
    // S a power of two <= 32 (a row's lanes within one warp), SEG a
    // positive multiple of 16 covering the row
    if (S < 1 || S > 32 || (S & (S - 1)) || seg <= 0 || seg % 16 ||
        (long long)seg * S < L || L % 16)
        return (int)cudaErrorInvalidValue;
    const int log2s = __builtin_ctz(S);
    if (R > 0) {
        switch (W) {
            case 1: launch<1, TOPK>(a, p, lo, hi, keys, cnt, map, R, L, top_bit, m, k, klmul, seg, log2s, st); break;
            case 2: launch<2, TOPK>(a, p, lo, hi, keys, cnt, map, R, L, top_bit, m, k, klmul, seg, log2s, st); break;
            case 3: launch<3, TOPK>(a, p, lo, hi, keys, cnt, map, R, L, top_bit, m, k, klmul, seg, log2s, st); break;
            case 4: launch<4, TOPK>(a, p, lo, hi, keys, cnt, map, R, L, top_bit, m, k, klmul, seg, log2s, st); break;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bb_myers_topk(const void* rows, const void* patw,
                             const void* emit_lo, const void* emit_hi,
                             void* keys, void* cnt, int R, int L, int W,
                             int top_bit, int m, int k, int klmul, int seg,
                             int S, void* stream) {
    return dispatch<true>(rows, patw, emit_lo, emit_hi,
                          static_cast<int*>(keys), static_cast<int*>(cnt),
                          nullptr, R, L, W, top_bit, m, k, klmul, seg, S,
                          stream);
}

extern "C" int bb_myers_valleys(const void* rows, const void* patw,
                                const void* emit_lo, const void* emit_hi,
                                void* map, int R, int L, int W, int top_bit,
                                int m, int k, int seg, int S, void* stream) {
    return dispatch<false>(rows, patw, emit_lo, emit_hi, nullptr, nullptr,
                           static_cast<uint8_t*>(map), R, L, W, top_bit, m, k,
                           0, seg, S, stream);
}
