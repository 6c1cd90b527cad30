// FASTQ record reader shared by the native IO library (fastq_io.cpp)
// and the batch reader that builds Python objects (fastq_batch.cpp):
// several files in order, plain or gzip (multi-member), regular files
// or named pipes, and the record checks in one place (next_record).

#pragma once

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace bbio {

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

// Where one FASTQ record lies in Reader::buf: the header without its
// '@' and trailing '\r's, the sequence and the quality (each
// [start, end)), and where the scan goes on after the record.
struct RecordSpan {
    size_t h0, h1, s0, s1, q0, q1, next;
};

// Scans the record at or after `pos` in r.buf, reading more input as
// needed: blank lines are skipped, then the header must start with
// '@', the separator with '+', and the sequence and quality (less
// trailing '\r's) must be equally long.  Returns 1 with `rec` filled,
// 0 at the end of all input, -1 on malformed or unreadable input.  It
// neither moves r.buf_pos nor compacts, so spans found earlier stay
// valid (as offsets) until the caller compacts.
inline int next_record(Reader& r, size_t pos, RecordSpan& rec) {
    while (true) {
        if (pos >= r.buf.size()) {
            if (!r.fill()) {
                if (r.failed) return -1;
                if (r.path_idx < r.paths.size() || r.fp) continue;  // next file
                return 0;  // true EOF
            }
        }
        size_t p = pos;
        // skip blank lines
        while (p < r.buf.size() && (r.buf[p] == '\n' || r.buf[p] == '\r')) p++;
        if (p >= r.buf.size()) { pos = p; continue; }
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
        rec.h0 = p + 1;
        rec.h1 = trim(p + 1, h_end);
        rec.s0 = s_start;
        rec.s1 = trim(s_start, s_end);
        rec.q0 = q_start;
        rec.q1 = trim(q_start, q_end);
        if ((rec.s1 - rec.s0) != (rec.q1 - rec.q0)) return -1;
        rec.next = (q_end < r.buf.size()) ? q_end + 1 : q_end;
        return 1;
    }
}

}  // namespace bbio
