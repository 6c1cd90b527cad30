// Native FASTQ IO: batched multi-file reader (plain + gzip) and
// per-label writers.  Host-side input pipeline feeding the device
// demux engine — the throughput-critical equivalent of the reference's
// parallel FASTQ reader / gzip writer dependencies.
//
// C ABI (ctypes):
//   reader:
//     void* bbio_reader_open(const char** paths, int n);
//     long  bbio_reader_next_batch(void* r, int max_records,
//                                  char* data, long data_cap,
//                                  long* rec_offsets /* 4*(max_records+... ) */);
//       data layout per record: header\0 seq\0 qual\0 back to back;
//       rec_offsets stores, per record, 4 longs:
//         header_off, seq_off, qual_off, qual_end
//       returns #records (0 = EOF, -1 = parse error, -2 = buffer too
//       small for a single record).
//     void  bbio_reader_close(void* r);
//   writer:
//     void* bbio_writer_open(const char* path, int gzip_level);
//     int   bbio_writer_write(void* w, const char* header, long hlen,
//                             const char* seq, long slen,
//                             const char* qual, long qlen);
//     int   bbio_writer_close(void* w);

#include <climits>
#include <cstdio>
#ifdef __AVX2__
#include <immintrin.h>
#endif
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

constexpr size_t CHUNK = 1 << 20;

struct Reader {
    std::vector<std::string> paths;
    size_t path_idx = 0;

    FILE* fp = nullptr;
    bool is_gzip = false;
    z_stream zs;
    std::vector<unsigned char> zin;
    size_t zin_len = 0, zin_pos = 0;
    bool zin_eof = false;
    bool z_member_done = true;  // inflate sits at a gzip member boundary

    std::vector<char> buf;  // decompressed/raw buffered bytes
    size_t buf_pos = 0;
    bool failed = false;

    ~Reader() { close_current(); }

    void close_current() {
        if (fp) {
            if (is_gzip) inflateEnd(&zs);
            fclose(fp);
            fp = nullptr;
        }
    }

    bool open_next() {
        close_current();
        if (path_idx >= paths.size()) return false;
        const std::string& p = paths[path_idx++];
        fp = fopen(p.c_str(), "rb");
        if (!fp) { failed = true; return false; }
        // Sniff the gzip magic WITHOUT rewinding: FIFOs / process
        // substitution (<(zcat ...)) are not seekable, so the sniffed
        // bytes are handed forward instead of re-read.
        int c1 = fgetc(fp), c2 = fgetc(fp);
        is_gzip = (c1 == 0x1f && c2 == 0x8b);
        if (is_gzip) {
            memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) { failed = true; return false; }
            zin.resize(CHUNK);
            zin[0] = 0x1f;
            zin[1] = 0x8b;
            zin_len = 2;
            zin_pos = 0;
            zin_eof = false;
            z_member_done = true;
        } else {
            if (c1 != EOF) buf.push_back(static_cast<char>(c1));
            if (c2 != EOF) buf.push_back(static_cast<char>(c2));
        }
        return true;
    }

    // Append more bytes to buf; returns false at EOF of current file.
    bool fill() {
        if (!fp) {
            size_t before = buf.size();
            if (!open_next()) return false;
            if (buf.size() > before) return true;  // sniffed bytes handed over
        }
        size_t old = buf.size();
        if (!is_gzip) {
            buf.resize(old + CHUNK);
            size_t got = fread(buf.data() + old, 1, CHUNK, fp);
            buf.resize(old + got);
            if (got == 0) {
                close_current();
                return false;
            }
            return true;
        }
        // gzip path
        buf.resize(old + CHUNK);
        zs.next_out = reinterpret_cast<unsigned char*>(buf.data() + old);
        zs.avail_out = CHUNK;
        while (zs.avail_out > 0) {
            if (zin_pos == zin_len && !zin_eof) {
                zin_len = fread(zin.data(), 1, zin.size(), fp);
                zin_pos = 0;
                if (zin_len == 0) zin_eof = true;
            }
            if (zin_pos == zin_len && zin_eof) {
                // Input exhausted mid-member = TRUNCATED stream: fail
                // loudly (the pure-Python path raises EOFError here);
                // a clean EOF only ever lands on a member boundary.
                if (!z_member_done) { failed = true; buf.resize(old); return false; }
                break;
            }
            zs.next_in = zin.data() + zin_pos;
            zs.avail_in = static_cast<unsigned>(zin_len - zin_pos);
            int rc = inflate(&zs, Z_NO_FLUSH);
            zin_pos = zin_len - zs.avail_in;
            if (rc == Z_STREAM_END) {
                // multi-member gzip support: reset and keep inflating
                z_member_done = true;
                inflateReset2(&zs, 16 + MAX_WBITS);
                continue;
            }
            if (rc != Z_OK) { failed = true; buf.resize(old); return false; }
            z_member_done = false;
        }
        buf.resize(old + (CHUNK - zs.avail_out));
        // Close ONLY on a zero-byte fill: a productive fill that also
        // exhausted the member must still report one EOF (return
        // false) before the next file opens, exactly like the plain
        // path's final fread()==0 — otherwise a .gz whose last line
        // lacks '\n' gets stitched onto the next file's first record.
        if (buf.size() == old) {
            close_current();
            return false;
        }
        return true;
    }

    void compact() {
        if (buf_pos > 0) {
            buf.erase(buf.begin(), buf.begin() + buf_pos);
            buf_pos = 0;
        }
    }

    // Find next '\n' at/after `from`; grows buffer as needed.
    // Returns npos on EOF with no newline.
    size_t find_nl(size_t from) {
        while (true) {
            const char* base = buf.data();
            const char* hit = static_cast<const char*>(
                memchr(base + from, '\n', buf.size() - from));
            if (hit) return static_cast<size_t>(hit - base);
            from = buf.size();
            if (!fill()) return std::string::npos;
        }
    }
};

struct Writer {
    FILE* fp = nullptr;
    gzFile gz = nullptr;

    int write(const char* p, size_t n) {
        if (gz) return gzwrite(gz, p, static_cast<unsigned>(n)) == static_cast<int>(n) ? 0 : -1;
        return fwrite(p, 1, n, fp) == n ? 0 : -1;
    }
};

}  // namespace

extern "C" {

// Encode IUPAC bytes through `lut` (256 entries, 4-bit masks) and
// nibble-pack straight into padded device rows: out[i] is L/2 bytes,
// low nibble = even column.  Releases the GIL via ctypes; this is the
// host hot path feeding the TPU demux engine (replaces a per-read
// numpy LUT gather + a whole-matrix numpy pack).
void bbio_encode_pack_rows(const unsigned char* seqs, const long* offs,
                           const int* lens, int n, int L,
                           const unsigned char* lut, unsigned char* out) {
    const int half = L / 2;
    for (int i = 0; i < n; i++) {
        const unsigned char* s = seqs + offs[i];
        unsigned char* p = out + (long)i * half;
        const int len = lens[i];
        const int pairs = len / 2;
        for (int j = 0; j < pairs; j++) {
            p[j] = (unsigned char)((lut[s[2 * j]] & 0xF) |
                                   ((lut[s[2 * j + 1]] & 0xF) << 4));
        }
        if (len & 1) p[pairs] = (unsigned char)(lut[s[len - 1]] & 0xF);
        if (pairs + (len & 1) < half)
            memset(p + pairs + (len & 1), 0, half - pairs - (len & 1));
    }
}

// Encode one read span into 2-bit codes at p (zeroed, ceil(len/4)
// bytes).  Exceptions (bytes whose IUPAC mask is not a single base)
// are appended to exc_out as (flat_base + j, mask) int32 pairs.
// Returns the updated exception count.
//
// Fast path (AVX2): chunks of 32 bytes that are pure acgtACGT encode
// arithmetically — for those bytes lut2[c] provably equals
// t ^ (t >> 1) with t = (c >> 1) & 3 (A0 C1 G2 T3) — and pack via
// multiply-add, 32 bases -> 8 output bytes per iteration.  Any chunk
// containing other bytes (U/u, IUPAC, junk) takes the scalar LUT path
// so semantics stay exactly lut2/lutm-defined.
static inline long encode_2bit_span(const unsigned char* s, int len,
                                    unsigned char* p, long flat_base,
                                    const unsigned char* lut2,
                                    const unsigned char* lutm,
                                    int* exc_out, long n_exc,
                                    long exc_cap) {
    int j = 0;
#ifdef __AVX2__
    const __m256i lc = _mm256_set1_epi8(0x20);
    const __m256i ca = _mm256_set1_epi8('a');
    const __m256i cc = _mm256_set1_epi8('c');
    const __m256i cg = _mm256_set1_epi8('g');
    const __m256i ct = _mm256_set1_epi8('t');
    const __m256i three = _mm256_set1_epi8(3);
    const __m256i one = _mm256_set1_epi8(1);
    const __m256i mul14 = _mm256_set1_epi16(0x0401);      // bytes (1, 4)
    const __m256i mul116 = _mm256_set1_epi32(0x00100001);  // words (1, 16)
    const __m256i collect = _mm256_setr_epi8(
        0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
        0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1);
    for (; j + 32 <= len; j += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(s + j));
        __m256i vl = _mm256_or_si256(v, lc);
        __m256i ok = _mm256_or_si256(
            _mm256_or_si256(_mm256_cmpeq_epi8(vl, ca),
                            _mm256_cmpeq_epi8(vl, cc)),
            _mm256_or_si256(_mm256_cmpeq_epi8(vl, cg),
                            _mm256_cmpeq_epi8(vl, ct)));
        if (_mm256_movemask_epi8(ok) != -1) {
            for (int e = j; e < j + 32; e++) {
                unsigned char code = lut2[s[e]];
                if (code > 3) {
                    if (n_exc < exc_cap) {
                        exc_out[2 * n_exc] = (int)(flat_base + e);
                        exc_out[2 * n_exc + 1] = (int)(lutm[s[e]] & 0xF);
                    }
                    n_exc++;
                    code = 0;  // placeholder; the exception overrides it
                }
                p[e >> 2] |= (unsigned char)(code << ((e & 3) * 2));
            }
            continue;
        }
        __m256i t = _mm256_and_si256(_mm256_srli_epi16(v, 1), three);
        __m256i code = _mm256_xor_si256(
            t, _mm256_and_si256(_mm256_srli_epi16(t, 1), one));
        __m256i w16 = _mm256_maddubs_epi16(code, mul14);
        __m256i w32 = _mm256_madd_epi16(w16, mul116);
        __m256i sh = _mm256_shuffle_epi8(w32, collect);
        unsigned int lo = (unsigned int)_mm256_extract_epi32(sh, 0);
        unsigned int hi = (unsigned int)_mm256_extract_epi32(sh, 4);
        memcpy(p + (j >> 2), &lo, 4);
        memcpy(p + (j >> 2) + 4, &hi, 4);
    }
#endif
    for (; j < len; j++) {
        unsigned char code = lut2[s[j]];
        if (code > 3) {
            if (n_exc < exc_cap) {
                exc_out[2 * n_exc] = (int)(flat_base + j);
                exc_out[2 * n_exc + 1] = (int)(lutm[s[j]] & 0xF);
            }
            n_exc++;
            code = 0;  // placeholder; the exception overrides it
        }
        p[j >> 2] |= (unsigned char)(code << ((j & 3) * 2));
    }
    return n_exc;
}

// 2-bit variant: A/C/G/T pack 4 bases/byte (half the host->device wire
// bytes of the nibble form); any byte whose IUPAC mask is not a single
// base (N, degenerate codes, junk) is emitted as an exception PAIR
// (flat_pos, mask) applied device-side.  Pairs (not flat_pos*16|mask)
// so positions up to 2^31 rows*cols survive int32 — the packed form
// wrapped negative for rows >= 2^27/L and silently corrupted row 0.
// Returns the exception count (may exceed exc_cap — caller must then
// fall back to nibbles).  exc_out holds 2*exc_cap ints.
// lut2: byte -> 0..3 code or 255;  lutm: byte -> 4-bit mask (& 0xF).
long bbio_encode_pack2_rows(const unsigned char* seqs, const long* offs,
                            const int* lens, int n, int L,
                            const unsigned char* lut2,
                            const unsigned char* lutm,
                            unsigned char* out, int* exc_out,
                            long exc_cap) {
    const int quarter = L / 4;
    long n_exc = 0;
    for (int i = 0; i < n; i++) {
        unsigned char* p = out + (long)i * quarter;
        memset(p, 0, quarter);
        n_exc = encode_2bit_span(seqs + offs[i], lens[i], p, (long)i * L,
                                 lut2, lutm, exc_out, n_exc, exc_cap);
    }
    return n_exc;
}

// Concatenated 2-bit variant: rows pack back to back (each starting at
// starts[i], a byte offset into `out`; ceil(len/4) bytes per row) so
// row padding never crosses the wire.  Exceptions still address the
// PADDED layout (flat_pos = row*L + col, emitted as (pos, mask) int32
// pairs) — the device applies them after scattering rows into the
// padded buffer.  exc_out holds 2*exc_cap ints.
long bbio_encode_pack2_cat(const unsigned char* seqs, const long* offs,
                           const int* lens, const long* starts, int n,
                           int L, const unsigned char* lut2,
                           const unsigned char* lutm, unsigned char* out,
                           int* exc_out, long exc_cap) {
    long n_exc = 0;
    for (int i = 0; i < n; i++) {
        unsigned char* p = out + starts[i];
        memset(p, 0, (lens[i] + 3) / 4);
        n_exc = encode_2bit_span(seqs + offs[i], lens[i], p, (long)i * L,
                                 lut2, lutm, exc_out, n_exc, exc_cap);
    }
    return n_exc;
}

// Reverse-complement 2-bit span encode: output position j reads source
// byte s_end[-j] (s_end points at the source byte for j = 0) through
// the COMPLEMENT LUTs.  Same exception convention as encode_2bit_span.
//
// Fast path (AVX2): mirror of the forward fast path — load 32 source
// bytes ending at s_end[-j], byte-reverse the vector, and complement
// the 2-bit code with XOR 3 (A0<->T3, C1<->G2 under the t^(t>>1) map).
static inline long encode_2bit_span_rc(const unsigned char* s_end, int len,
                                       unsigned char* p, long flat_base,
                                       const unsigned char* lut2r,
                                       const unsigned char* lutmr,
                                       int* exc_out, long n_exc,
                                       long exc_cap) {
    int j = 0;
#ifdef __AVX2__
    const __m256i lc = _mm256_set1_epi8(0x20);
    const __m256i ca = _mm256_set1_epi8('a');
    const __m256i cc = _mm256_set1_epi8('c');
    const __m256i cg = _mm256_set1_epi8('g');
    const __m256i ct = _mm256_set1_epi8('t');
    const __m256i three = _mm256_set1_epi8(3);
    const __m256i one = _mm256_set1_epi8(1);
    const __m256i mul14 = _mm256_set1_epi16(0x0401);      // bytes (1, 4)
    const __m256i mul116 = _mm256_set1_epi32(0x00100001);  // words (1, 16)
    const __m256i collect = _mm256_setr_epi8(
        0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
        0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1);
    const __m256i rev_lane = _mm256_setr_epi8(
        15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0,
        15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
    for (; j + 32 <= len; j += 32) {
        // source bytes s_end[-(j+31)] .. s_end[-j], reversed into
        // output order
        __m256i v = _mm256_loadu_si256((const __m256i*)(s_end - j - 31));
        v = _mm256_shuffle_epi8(v, rev_lane);
        v = _mm256_permute2x128_si256(v, v, 1);
        __m256i vl = _mm256_or_si256(v, lc);
        __m256i ok = _mm256_or_si256(
            _mm256_or_si256(_mm256_cmpeq_epi8(vl, ca),
                            _mm256_cmpeq_epi8(vl, cc)),
            _mm256_or_si256(_mm256_cmpeq_epi8(vl, cg),
                            _mm256_cmpeq_epi8(vl, ct)));
        if (_mm256_movemask_epi8(ok) != -1) {
            for (int e = j; e < j + 32; e++) {
                unsigned char code = lut2r[s_end[-e]];
                if (code > 3) {
                    if (n_exc < exc_cap) {
                        exc_out[2 * n_exc] = (int)(flat_base + e);
                        exc_out[2 * n_exc + 1] = (int)(lutmr[s_end[-e]] & 0xF);
                    }
                    n_exc++;
                    code = 0;  // placeholder; the exception overrides it
                }
                p[e >> 2] |= (unsigned char)(code << ((e & 3) * 2));
            }
            continue;
        }
        __m256i t = _mm256_and_si256(_mm256_srli_epi16(v, 1), three);
        __m256i code = _mm256_xor_si256(
            t, _mm256_and_si256(_mm256_srli_epi16(t, 1), one));
        code = _mm256_xor_si256(code, three);  // complement
        __m256i w16 = _mm256_maddubs_epi16(code, mul14);
        __m256i w32 = _mm256_madd_epi16(w16, mul116);
        __m256i sh = _mm256_shuffle_epi8(w32, collect);
        unsigned int lo = (unsigned int)_mm256_extract_epi32(sh, 0);
        unsigned int hi = (unsigned int)_mm256_extract_epi32(sh, 4);
        memcpy(p + (j >> 2), &lo, 4);
        memcpy(p + (j >> 2) + 4, &hi, 4);
    }
#endif
    for (; j < len; j++) {
        unsigned char code = lut2r[s_end[-j]];
        if (code > 3) {
            if (n_exc < exc_cap) {
                exc_out[2 * n_exc] = (int)(flat_base + j);
                exc_out[2 * n_exc + 1] = (int)(lutmr[s_end[-j]] & 0xF);
            }
            n_exc++;
            code = 0;  // placeholder; the exception overrides it
        }
        p[j >> 2] |= (unsigned char)(code << ((j & 3) * 2));
    }
    return n_exc;
}

// Encode long-read chunk rows (fwd + rc strands) as 2-bit codes
// straight from the raw read bytes — replaces the per-read Python
// loop (numpy LUT encode + revcomp + per-chunk slice/pack) that was
// the largest GIL-bound host phase per batch.  Row i covers read
// row_read[i] (index into offs/read_lens) at span
// [row_off[i], row_off[i] + row_len[i]) in ITS OWN strand's
// coordinates (rc spans address the reverse-complemented read, i.e.
// rc position q maps to source byte n-1-q).  Output bytes go to
// out + row_out_start[i] (caller-zeroed buffer); exceptions are
// (row_flat_base[i] + col, mask) int32 pairs appended from n_exc_in.
// Returns the total exception count (may exceed exc_cap — caller must
// then fall back to nibble rows).
long bbio_encode_pack2_chunks(
    const unsigned char* seqs, const long* offs, const int* read_lens,
    int n_rows, const int* row_read, const long* row_off,
    const int* row_len, const unsigned char* row_isrc,
    const long* row_out_start, const long* row_flat_base,
    const unsigned char* lut2f, const unsigned char* lutmf,
    const unsigned char* lut2r, const unsigned char* lutmr,
    unsigned char* out, int* exc_out, long n_exc_in, long exc_cap) {
    long n_exc = n_exc_in;
    for (int i = 0; i < n_rows; i++) {
        const int r = row_read[i];
        const int len = row_len[i];
        unsigned char* p = out + row_out_start[i];
        memset(p, 0, (len + 3) / 4);
        if (row_isrc[i]) {
            const long n = read_lens[r];
            const unsigned char* s_end = seqs + offs[r] + (n - 1 - row_off[i]);
            n_exc = encode_2bit_span_rc(s_end, len, p, row_flat_base[i],
                                        lut2r, lutmr, exc_out, n_exc,
                                        exc_cap);
        } else {
            const unsigned char* s = seqs + offs[r] + row_off[i];
            n_exc = encode_2bit_span(s, len, p, row_flat_base[i], lut2f,
                                     lutmf, exc_out, n_exc, exc_cap);
        }
    }
    return n_exc;
}

// ---- CPU benchmark anchor: scalar bit-parallel Myers cost proxy -----
//
// Approximates the reference's per-read compute (whole-read flank scan
// on both strands + per-valley multi-barcode window scans,
// `src/annotate/searcher.rs:430-490`) with the same algorithm class —
// Hyyrö/Myers bit-parallel edit distance over IUPAC match masks — so
// bench.py's vs_baseline denominator is MEASURED on this host at the
// reference's default 10 threads rather than invented.  Not wired into
// any production path.

namespace {

struct PeqW {
    unsigned long long w[16];  // per 4-bit text mask
};

void build_peq(const unsigned char* pat, int m, int nw, PeqW* peq) {
    for (int wi = 0; wi < nw; wi++)
        for (int tm = 0; tm < 16; tm++) peq[wi].w[tm] = 0;
    for (int i = 0; i < m; i++) {
        unsigned pm = pat[i] & 0xF;
        for (int tm = 1; tm < 16; tm++)
            if (pm & tm) peq[i >> 6].w[tm] |= 1ULL << (i & 63);
    }
}

// Semi-global (free text prefix/suffix) Myers search; per position j
// the running score is the best edit distance of the pattern vs any
// text substring ending at j.  Returns the number of k-thresholded
// valleys; valleys[] (optional, cap n) receives their end positions.
int myers_scan(const unsigned char* tmask, int n, const PeqW* peq, int m,
               int k, int* valleys, int valleys_cap) {
    const int nw = (m + 63) >> 6;
    if (m <= 0 || nw > 4) return -1;  // Pv/Mv hold 4 words = m <= 256
    unsigned long long Pv[4], Mv[4];
    for (int b = 0; b < nw; b++) {
        Pv[b] = ~0ULL;
        Mv[b] = 0;
    }
    const int top_b = (m - 1) >> 6;
    const unsigned long long top = 1ULL << ((m - 1) & 63);
    int score = m;
    int prev2 = INT_MAX, prev = INT_MAX, prev_j = -1;
    int n_valleys = 0;
    for (int j = 0; j < n; j++) {
        const unsigned tm = tmask[j] & 0xF;
        unsigned long long add_c = 0, hp_c = 0, hn_c = 0;
        for (int b = 0; b < nw; b++) {
            const unsigned long long Eq = peq[b].w[tm];
            const unsigned long long X = Eq | Mv[b];
            const unsigned long long XP = X & Pv[b];
            unsigned long long s1 = XP + Pv[b];
            unsigned long long c1 = s1 < XP;
            unsigned long long sum = s1 + add_c;
            add_c = c1 | (sum < s1);
            const unsigned long long D0 = (sum ^ Pv[b]) | X;
            const unsigned long long HP = Mv[b] | ~(D0 | Pv[b]);
            const unsigned long long HN = Pv[b] & D0;
            if (b == top_b) {
                if (HP & top) score++;
                else if (HN & top) score--;
            }
            const unsigned long long HPs = (HP << 1) | hp_c;
            const unsigned long long HNs = (HN << 1) | hn_c;
            hp_c = HP >> 63;
            hn_c = HN >> 63;
            Pv[b] = HNs | ~(D0 | HPs);
            Mv[b] = HPs & D0;
        }
        // valley = local minimum of the score track, <= k
        if (prev <= k && prev <= prev2 && prev < score) {
            if (valleys && n_valleys < valleys_cap) valleys[n_valleys] = prev_j;
            n_valleys++;
        }
        prev2 = prev;
        prev = score;
        prev_j = j;
    }
    if (prev <= k && prev <= prev2) {
        if (valleys && n_valleys < valleys_cap) valleys[n_valleys] = prev_j;
        n_valleys++;
    }
    return n_valleys;
}

constexpr int kRcMask[16] = {0, 8, 4, 12, 2, 10, 6, 14,
                             1, 9, 5, 13, 3, 11, 7, 15};

}  // namespace

// Runs the demux cost proxy over n_reads with n_threads (read-striped):
// flank Myers over fwd + rc masks, then per flank valley a scan of all
// n_bars barcode patterns over a (win + pad) window around the valley.
// Returns the total number of flank valleys found (sanity signal and
// dead-code-elimination guard).
long bbio_myers_anchor(const unsigned char* seqs, const long* offs,
                       const int* lens, int n_reads,
                       const unsigned char* lutm, const unsigned char* flank,
                       int m_flank, int k_flank, const unsigned char* bars,
                       int n_bars, int m_bar, int k_bar, int win,
                       int n_threads) {
    // myers_scan holds 4 pattern words (m <= 256); bar_peq is built
    // with one word per pattern (m_bar <= 64).  Guard both — an
    // oversized pattern must fail loudly, not overflow the stack.
    if (m_flank <= 0 || m_flank > 256 || n_bars < 0 ||
        (n_bars > 0 && (m_bar <= 0 || m_bar > 64)) || n_threads < 1)
        return -1;
    std::vector<PeqW> flank_peq((m_flank + 63) / 64);
    build_peq(flank, m_flank, (int)flank_peq.size(), flank_peq.data());
    std::vector<PeqW> bar_peq((size_t)n_bars);
    for (int p = 0; p < n_bars; p++)
        build_peq(bars + (long)p * m_bar, m_bar, 1, &bar_peq[p]);

    std::vector<long> found((size_t)n_threads, 0);
    auto work = [&](int t) {
        std::vector<unsigned char> fwd, rc;
        std::vector<int> valleys(64);
        long local = 0;
        for (int i = t; i < n_reads; i += n_threads) {
            const unsigned char* s = seqs + offs[i];
            const int n = lens[i];
            if (n == 0) continue;
            fwd.resize(n);
            rc.resize(n);
            for (int j = 0; j < n; j++) fwd[j] = lutm[s[j]] & 0xF;
            for (int j = 0; j < n; j++) rc[j] = kRcMask[fwd[n - 1 - j]];
            for (const auto* text : {&fwd, &rc}) {
                int nv = myers_scan(text->data(), n, flank_peq.data(),
                                    m_flank, k_flank, valleys.data(),
                                    (int)valleys.size());
                local += nv;
                const int shown = nv < (int)valleys.size()
                                      ? nv
                                      : (int)valleys.size();
                for (int v = 0; v < shown; v++) {
                    int start = valleys[v] - win;
                    if (start < 0) start = 0;
                    int wlen = win + 2 * 10;
                    if (start + wlen > n) wlen = n - start;
                    if (wlen <= 0) continue;
                    for (int p = 0; p < n_bars; p++)
                        myers_scan(text->data() + start, wlen, &bar_peq[p],
                                   m_bar, k_bar, nullptr, 0);
                }
            }
        }
        found[t] = local;
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
    long total = 0;
    for (long f : found) total += f;
    return total;
}

// Single-text valley scan (conformance tests for the anchor's Myers).
long bbio_myers_valleys(const unsigned char* text, int n,
                        const unsigned char* lutm, const unsigned char* pat,
                        int m, int k, int* out_valleys, int cap) {
    if (m <= 0 || m > 256) return -1;  // myers_scan word-count bound
    std::vector<unsigned char> tm((size_t)(n > 0 ? n : 1));
    for (int j = 0; j < n; j++) tm[j] = lutm[text[j]] & 0xF;
    std::vector<PeqW> peq((m + 63) / 64);
    build_peq(pat, m, (int)peq.size(), peq.data());
    return myers_scan(tm.data(), n, peq.data(), m, k, out_valleys, cap);
}

void* bbio_reader_open(const char** paths, int n) {
    Reader* r = new Reader();
    for (int i = 0; i < n; i++) r->paths.emplace_back(paths[i]);
    return r;
}

void bbio_reader_close(void* rp) { delete static_cast<Reader*>(rp); }

long bbio_reader_next_batch(void* rp, int max_records, char* data,
                            long data_cap, long* rec_offsets) {
    Reader& r = *static_cast<Reader*>(rp);
    if (r.failed) return -1;
    long n_rec = 0;
    long out = 0;
    while (n_rec < max_records) {
        // Amortized compaction: erasing the consumed prefix is an
        // O(buf) memmove, so doing it every record made the reader
        // O(records x CHUNK) per chunk (~2GB moved per 1MB read at
        // 500B records).  Compact only once >= half a chunk has been
        // consumed — O(1) amortized per byte, memory still bounded.
        if (r.buf_pos >= CHUNK / 2) r.compact();
        // ensure at least one byte
        if (r.buf_pos >= r.buf.size()) {
            if (!r.fill()) {
                if (r.failed) return -1;
                if (r.path_idx < r.paths.size() || r.fp) continue;  // next file
                break;  // true EOF
            }
        }
        size_t p = r.buf_pos;
        // skip blank lines
        while (p < r.buf.size() && (r.buf[p] == '\n' || r.buf[p] == '\r')) p++;
        if (p >= r.buf.size()) { r.buf_pos = p; continue; }
        if (r.buf[p] != '@') return -1;

        size_t h_end = r.find_nl(p);
        if (h_end == std::string::npos) return -1;
        size_t s_start = h_end + 1;
        size_t s_end = r.find_nl(s_start);
        if (s_end == std::string::npos) return -1;
        size_t plus = s_end + 1;
        size_t plus_end = r.find_nl(plus);
        if (plus_end == std::string::npos || r.buf[plus] != '+') return -1;
        size_t q_start = plus_end + 1;
        size_t q_end = r.find_nl(q_start);
        if (q_end == std::string::npos) {
            // final record may lack trailing newline only via fill() EOF;
            // accept qual up to buffer end
            q_end = r.buf.size();
            if (q_end <= q_start) return -1;
        }

        auto trim = [&](size_t start, size_t end) {
            while (end > start && (r.buf[end - 1] == '\r')) end--;
            return end;
        };
        size_t h_e = trim(p + 1, h_end);
        size_t s_e = trim(s_start, s_end);
        size_t q_e = trim(q_start, q_end);
        if ((s_e - s_start) != (q_e - q_start)) return -1;

        long hlen = static_cast<long>(h_e - (p + 1));
        long slen = static_cast<long>(s_e - s_start);
        long need = hlen + 1 + slen + 1 + slen + 1;
        if (out + need > data_cap) {
            if (n_rec == 0) return -2;  // single record larger than buffer
            break;                       // flush what we have
        }

        long* off = rec_offsets + 4 * n_rec;
        off[0] = out;
        memcpy(data + out, r.buf.data() + p + 1, hlen);
        out += hlen;
        data[out++] = '\0';
        off[1] = out;
        memcpy(data + out, r.buf.data() + s_start, slen);
        out += slen;
        data[out++] = '\0';
        off[2] = out;
        memcpy(data + out, r.buf.data() + q_start, slen);
        out += slen;
        data[out++] = '\0';
        off[3] = off[2] + slen;

        r.buf_pos = (q_end < r.buf.size()) ? q_end + 1 : q_end;
        n_rec++;
    }
    return n_rec;
}

void* bbio_writer_open(const char* path, int gzip_level) {
    Writer* w = new Writer();
    if (gzip_level > 0) {
        char mode[8];
        snprintf(mode, sizeof(mode), "wb%d", gzip_level);
        w->gz = gzopen(path, mode);
        if (!w->gz) { delete w; return nullptr; }
    } else {
        w->fp = fopen(path, "wb");
        if (!w->fp) { delete w; return nullptr; }
    }
    return w;
}

int bbio_writer_write(void* wp, const char* header, long hlen,
                      const char* seq, long slen, const char* qual,
                      long qlen) {
    Writer& w = *static_cast<Writer*>(wp);
    if (w.write("@", 1)) return -1;
    if (w.write(header, hlen)) return -1;
    if (w.write("\n", 1)) return -1;
    if (w.write(seq, slen)) return -1;
    if (w.write("\n+\n", 3)) return -1;
    if (w.write(qual, qlen)) return -1;
    if (w.write("\n", 1)) return -1;
    return 0;
}

// Pre-formatted block append (the Python side buffers whole FASTQ
// records and flushes ~256KB at a time: one ctypes call per block
// instead of one 6-argument call per record).
int bbio_writer_write_raw(void* wp, const char* buf, long n) {
    return static_cast<Writer*>(wp)->write(buf, static_cast<size_t>(n));
}

int bbio_writer_close(void* wp) {
    Writer* w = static_cast<Writer*>(wp);
    int rc = 0;
    if (w->gz) rc = gzclose(w->gz) == Z_OK ? 0 : -1;
    if (w->fp) rc = fclose(w->fp) == 0 ? 0 : -1;
    delete w;
    return rc;
}

}  // extern "C"
