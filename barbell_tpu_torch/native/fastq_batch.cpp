// FASTQ batches as Python objects in one call: the kit runner's four
// lists (read ids, descriptions, sequences, qualities) built straight
// from the reader's buffer; and the kit runner's filter tail and trim
// of a batch's runs of one read in one call.  Loaded through
// ctypes.PyDLL (each call starts and ends holding the interpreter
// lock), built against the interpreter's own headers.
//
// C ABI:
//   void*     bbfq_open(const char** paths, int n);
//   PyObject* bbfq_next(void* r, int max_records);
//       (ids, descs, seqs, quals): lists of str, str, bytes, bytes;
//       None at the end of input; raises ValueError on malformed
//       input and UnicodeDecodeError on a header byte above 0x7F, as
//       bytes.decode("ascii") does.
//   void      bbfq_close(void* r);
//   PyObject* bbkt_close_runs(...);  see below.
//
// A batch is read in three steps.  (1) Without the lock: scan the
// records (fastq_reader.h: the file reads, the record checks) and
// split each header.  (2) With the lock: allocate every object
// uninitialised (no copy yet).  (3) Without the lock: copy the bytes
// into the objects, which no other thread can reach yet.  The lists
// are then made with the lock held.  So the lock is held for the
// allocations alone, and each sequence and quality is copied once.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <unordered_map>
#include <vector>

#include "fastq_reader.h"

namespace {

// Python's str.isspace() over ASCII: 0x09-0x0D, 0x1C-0x1F and 0x20.
inline bool py_space(unsigned char c) {
    return (c >= 0x09 && c <= 0x0D) || (c >= 0x1C && c <= 0x20);
}

struct Rec {
    bbio::RecordSpan span;
    size_t id_end;      // the id is [h0, id_end)
    size_t desc_start;  // the description is [desc_start, h1)
    bool ascii;
};

struct Copy {
    char* dst;
    size_t src;
    size_t len;
};

struct BatchReader {
    bbio::Reader r;
    std::vector<Rec> recs;
    std::vector<PyObject*> objs;  // 4 a record: id, desc, seq, qual
    std::vector<Copy> copies;
};

// Scans up to max_records records into br.recs; the spans stay valid
// until the next scan (which compacts first).  0 or the count; -1 on
// malformed input.
long scan(BatchReader& br, int max_records) {
    bbio::Reader& r = br.r;
    br.recs.clear();
    if (r.failed) return -1;
    r.compact();
    size_t pos = r.buf_pos;
    while (static_cast<long>(br.recs.size()) < max_records) {
        Rec rec;
        int rc = bbio::next_record(r, pos, rec.span);
        if (rc < 0) return -1;
        if (rc == 0) break;
        const unsigned char* h =
            reinterpret_cast<const unsigned char*>(r.buf.data());
        size_t i = rec.span.h0, end = rec.span.h1;
        unsigned char any = 0;
        for (size_t j = i; j < end; j++) any |= h[j];
        rec.ascii = any < 0x80;
        while (i < end && !py_space(h[i])) i++;
        rec.id_end = i;
        while (i < end && py_space(h[i])) i++;
        rec.desc_start = i;
        br.recs.push_back(rec);
        pos = rec.span.next;
    }
    r.buf_pos = pos;
    return static_cast<long>(br.recs.size());
}

void release(std::vector<PyObject*>& objs) {
    for (PyObject* o : objs) Py_XDECREF(o);
    objs.clear();
}

// An uninitialised str of n ASCII characters (its copy queued), or
// nullptr with MemoryError set.
PyObject* new_str(BatchReader& br, size_t src, size_t n) {
    PyObject* o = PyUnicode_New(static_cast<Py_ssize_t>(n), 127);
    if (o && n) br.copies.push_back({static_cast<char*>(PyUnicode_DATA(o)), src, n});
    return o;
}

PyObject* new_bytes(BatchReader& br, size_t src, size_t n) {
    PyObject* o = PyBytes_FromStringAndSize(nullptr, static_cast<Py_ssize_t>(n));
    if (o && n) br.copies.push_back({PyBytes_AS_STRING(o), src, n});
    return o;
}

}  // namespace

extern "C" {

void* bbfq_open(const char** paths, int n) {
    BatchReader* br = new BatchReader();
    for (int i = 0; i < n; i++) br->r.paths.emplace_back(paths[i]);
    return br;
}

void bbfq_close(void* p) { delete static_cast<BatchReader*>(p); }

PyObject* bbfq_next(void* p, int max_records) {
    BatchReader& br = *static_cast<BatchReader*>(p);
    long n;
    Py_BEGIN_ALLOW_THREADS
    n = scan(br, max_records);
    Py_END_ALLOW_THREADS
    if (n < 0) {
        PyErr_SetString(PyExc_ValueError, "malformed FASTQ input");
        return nullptr;
    }
    if (n == 0) Py_RETURN_NONE;

    const char* buf = br.r.buf.data();
    for (const Rec& rec : br.recs) {
        if (!rec.ascii) {
            // the whole header's error, as bytes.decode("ascii") raises it
            PyObject* ok = PyUnicode_DecodeASCII(
                buf + rec.span.h0,
                static_cast<Py_ssize_t>(rec.span.h1 - rec.span.h0), nullptr);
            Py_XDECREF(ok);
            return nullptr;
        }
    }
    br.copies.clear();
    br.objs.assign(4 * static_cast<size_t>(n), nullptr);
    for (long i = 0; i < n; i++) {
        const Rec& rec = br.recs[i];
        const bbio::RecordSpan& s = rec.span;
        PyObject** o = &br.objs[4 * i];
        if (!(o[0] = new_str(br, s.h0, rec.id_end - s.h0)) ||
            !(o[1] = new_str(br, rec.desc_start, s.h1 - rec.desc_start)) ||
            !(o[2] = new_bytes(br, s.s0, s.s1 - s.s0)) ||
            !(o[3] = new_bytes(br, s.q0, s.q1 - s.q0))) {
            release(br.objs);
            return nullptr;
        }
    }
    Py_BEGIN_ALLOW_THREADS
    for (const Copy& c : br.copies) memcpy(c.dst, buf + c.src, c.len);
    Py_END_ALLOW_THREADS

    PyObject* lists[4];
    for (int k = 0; k < 4; k++) {
        lists[k] = PyList_New(n);
        if (!lists[k]) {
            for (int j = 0; j < k; j++) Py_DECREF(lists[j]);
            release(br.objs);
            return nullptr;
        }
    }
    for (long i = 0; i < n; i++)
        for (int k = 0; k < 4; k++) PyList_SET_ITEM(lists[k], i, br.objs[4 * i + k]);
    br.objs.clear();  // the lists own them now
    return Py_BuildValue("(NNNN)", lists[0], lists[1], lists[2], lists[3]);
}

}  // extern "C"

// ---------------------------------------------------------------------
// The kit runner's filter tail and trim of a batch, in one call:
//
//   PyObject* bbkt_close_runs(PyObject* ids, PyObject* descs,
//       PyObject* seqs, PyObject* quals, PyObject* slabels,
//       PyObject* lines, PyObject* cutrows, PyObject* names,
//       const int64_t* cols, long n, PyObject* pend_id, long pend_n,
//       long cap);
//
// Takes the batch's n reads as the reader made them (ids, descs: str;
// seqs, quals: bytes), each read's structure label (slabels: str, None
// for a read without rows), the batch's annotation lines (lines: str a
// row, no newline), each pattern's cut strings a row (cutrows[w][j]:
// str), the trimmed files' names (names: str) and cols, an int64 [8, n]
// array: each read's first row and row count, winning pattern, filter
// pass, whether the pattern has the preset cut shape, cut start and end
// (-1: the record's end) and trimmed file (an index of names).  pend_id
// and pend_n are the run the previous batch left open (None and 0 where
// none) and its record count; cap is the runner's early-flush count.
//
// Walks the reads by the runner's rules: a run is delimited only by a
// read of another id that has rows; a read without rows joins the live
// run where its id is the run's and is passed over where it is not; a
// run that reaches cap records is flushed early.  A run that starts in
// this batch, is closed in it and holds one read, which does not pass
// the filter or passes with the preset cut shape, is closed here.  Every
// other run is handed to the runner's object path whole: runs of several
// reads, other cut shapes, runs the cap closes, the run the previous
// batch left open, and the run still open at the batch's end.  This walk
// is where the run rules live; the runner only follows its events.
//
// Returns a list in feed order of (a) for each run the object path
// takes, the pair (flags, [read positions]): flags 1 (CARRY) where the
// run is the one the previous batch left open (always the first event
// then, its positions possibly none), 2 (OPEN) where it is still open at
// the batch's end, 4 (CAP) where the cap closed it; and (b) for each
// stretch of runs closed here, the tuple
//   (blocks, ppr, filt, failed, counts, n_runs, n_kept, n_failed):
// blocks {name: bytes} of trimmed FASTQ records, ppr the
// pattern_per_read.tsv lines, filt the filtered.tsv lines joined by
// newlines (none at the end), failed the failed ids a line each, and
// counts {structure label: runs}.  Returns None where the arguments are
// not as described; the runner then walks the batch in Python
// (kit_columnar.walk_runs), closing nothing here.
//
// The lock is released for the walk, the sizing and the copies, and
// held to read the lists' items (the caller's lists keep every item
// alive), to allocate the returned objects and to build the result.

namespace {

struct Str {
    const char* p = nullptr;
    Py_ssize_t n = 0;
    int kind = 0;
    bool ascii = false;  // a compact ASCII str: its data is its bytes
};

bool as_str(PyObject* o, Str& s) {
    if (!PyUnicode_Check(o)) return false;
    s.p = static_cast<const char*>(PyUnicode_DATA(o));
    s.n = PyUnicode_GET_LENGTH(o);
    s.kind = PyUnicode_KIND(o);
    s.ascii = PyUnicode_IS_COMPACT_ASCII(o);
    return true;
}

// str equality: a str is stored in the narrowest kind that holds it
inline bool same(const Str& a, const Str& b) {
    return a.n == b.n && a.kind == b.kind &&
           memcmp(a.p, b.p, static_cast<size_t>(a.n) * a.kind) == 0;
}

struct Buf {
    const char* p = nullptr;
    Py_ssize_t n = 0;
    bool ok = false;  // a bytes object
};

inline char* put(char* d, const char* s, Py_ssize_t n) {
    memcpy(d, s, static_cast<size_t>(n));
    return d + n;
}

struct Read {
    Str id, desc, slab;
    Buf seq, qual;
    PyObject* slab_obj = nullptr;
};

struct Chunk {
    std::vector<long> runs;     // each run's one read
    std::vector<Py_ssize_t> block;  // record bytes a file
    Py_ssize_t ppr = 0, filt = 0, failed = 0;
    long kept = 0, n_failed = 0;
    std::unordered_map<PyObject*, long> counts;
    // the returned objects, made with the lock held, and their data
    std::vector<PyObject*> blocks;
    PyObject *ppr_o = nullptr, *filt_o = nullptr, *failed_o = nullptr;
    std::vector<char*> to;
    char *ppr_p = nullptr, *filt_p = nullptr, *failed_p = nullptr;

    void release() {
        for (PyObject*& o : blocks) Py_CLEAR(o);
        Py_CLEAR(ppr_o);
        Py_CLEAR(filt_o);
        Py_CLEAR(failed_o);
    }
};

enum { CARRY = 1, OPEN = 2, CAP = 4 };

// a run the object path takes: its reads in this batch
struct Group {
    std::vector<long> reads;
    int flags;
};

struct Event {
    long group;  // a run for the object path, or -1
    long chunk;  // a stretch of runs closed here, or -1
};

struct Cols {
    const int64_t *start, *len, *win, *passed, *simple, *st, *en, *slot;
};

// Python's s[lo:hi] for 0 <= lo < hi: [a, b) within a sequence of n
inline void slice(int64_t lo, int64_t hi, Py_ssize_t n, Py_ssize_t& a, Py_ssize_t& b) {
    a = lo < n ? static_cast<Py_ssize_t>(lo) : n;
    b = hi < n ? static_cast<Py_ssize_t>(hi) : n;
}

struct Walk {
    Walk(const std::vector<Read>& reads_, const std::vector<Str>& lines_,
         const std::vector<std::vector<Str>>& cutrows_, const Cols& c_, size_t n_names_)
        : reads(reads_), lines(lines_), cutrows(cutrows_), c(c_), n_names(n_names_) {}

    const std::vector<Read>& reads;
    const std::vector<Str>& lines;
    const std::vector<std::vector<Str>>& cutrows;
    const Cols& c;
    size_t n_names;

    std::vector<Event> events;
    std::vector<Group> groups;
    std::vector<Chunk> chunks;
    long cur = -1;  // the stretch closed runs join, or -1

    // the live run
    bool on = false, carried = false;
    Str id;
    long recs = 0, first = -1;
    std::vector<long> mine;  // its reads in this batch

    // whether the run of read i alone can be closed here
    bool closable(long i) const {
        const Read& r = reads[i];
        if (!r.id.ascii || !r.slab_obj || !r.slab.ascii) return false;
        if (!c.passed[i]) return true;
        if (!c.simple[i] || !r.desc.ascii || !r.seq.ok || !r.qual.ok) return false;
        int64_t w = c.win[i], s = c.start[i], l = c.len[i];
        if (w < 0 || w >= static_cast<int64_t>(cutrows.size())) return false;
        const std::vector<Str>& cuts = cutrows[w];
        if (l != static_cast<int64_t>(cuts.size()) || s < 0 ||
            s + l > static_cast<int64_t>(lines.size()))
            return false;
        for (int64_t j = 0; j < l; j++)
            if (!lines[s + j].ascii || !cuts[j].ascii) return false;
        return c.st[i] >= 0 && c.en[i] >= -1 && c.slot[i] >= 0 &&
               c.slot[i] < static_cast<int64_t>(n_names);
    }

    // the live run to the object path
    void hand_over(int flags) {
        groups.push_back({mine, flags | (carried ? CARRY : 0)});
        events.push_back({static_cast<long>(groups.size()) - 1, -1});
        cur = -1;
    }

    void close(bool by_cap) {
        if (!on) return;
        if (!by_cap && !carried && recs == 1 && closable(first)) {
            if (cur < 0) {
                chunks.emplace_back();
                cur = static_cast<long>(chunks.size()) - 1;
                events.push_back({-1, cur});
            }
            chunks[cur].runs.push_back(first);
        } else {
            hand_over(by_cap ? CAP : 0);
        }
        on = carried = false;
        mine.clear();
    }

    void run(long n, long cap) {
        for (long i = 0; i < n; i++) {
            const Str& rid = reads[i].id;
            if (c.len[i] > 0) {
                if (!on || !same(rid, id)) {
                    close(false);
                    on = true;
                    carried = false;
                    id = rid;
                    recs = 1;
                    first = i;
                    mine.assign(1, i);
                } else {
                    recs++;
                    mine.push_back(i);
                }
            } else if (on && same(rid, id)) {
                recs++;  // a read without rows joins the live run
                mine.push_back(i);
            }
            if (on && recs >= cap) close(true);
        }
        // the run still open: the object path holds it into the next batch
        if (on) hand_over(OPEN);
    }

    // the bytes each stretch writes
    void size() {
        for (Chunk& ch : chunks) {
            ch.block.assign(n_names, 0);
            Py_ssize_t rows = 0;
            for (long i : ch.runs) {
                const Read& r = reads[i];
                ch.ppr += r.id.n + r.slab.n + 2;
                ch.counts[r.slab_obj]++;
                if (!c.passed[i]) continue;
                int64_t s = c.start[i], l = c.len[i];
                const std::vector<Str>& cuts = cutrows[c.win[i]];
                for (int64_t j = 0; j < l; j++) ch.filt += lines[s + j].n + cuts[j].n;
                rows += l;
                int64_t e = c.en[i] < 0 ? r.seq.n : c.en[i];
                if (c.st[i] >= e) {
                    ch.failed += r.id.n + 1;
                    ch.n_failed++;
                    continue;
                }
                Py_ssize_t s0, s1, q0, q1;
                slice(c.st[i], e, r.seq.n, s0, s1);
                slice(c.st[i], e, r.qual.n, q0, q1);
                ch.block[c.slot[i]] += 1 + r.id.n + (r.desc.n ? 1 + r.desc.n : 0) + 1 +
                                       (s1 - s0) + 3 + (q1 - q0) + 1;
                ch.kept++;
            }
            if (rows) ch.filt += rows - 1;
        }
    }

    // the bytes into the objects allocated for them
    void fill() {
        for (Chunk& ch : chunks) {
            std::vector<char*>& to = ch.to;
            char *pp = ch.ppr_p, *fp = ch.filt_p, *xp = ch.failed_p;
            bool row0 = true;
            for (long i : ch.runs) {
                const Read& r = reads[i];
                pp = put(pp, r.id.p, r.id.n);
                *pp++ = '\t';
                pp = put(pp, r.slab.p, r.slab.n);
                *pp++ = '\n';
                if (!c.passed[i]) continue;
                int64_t s = c.start[i], l = c.len[i];
                const std::vector<Str>& cuts = cutrows[c.win[i]];
                for (int64_t j = 0; j < l; j++) {
                    if (!row0) *fp++ = '\n';
                    row0 = false;
                    fp = put(fp, lines[s + j].p, lines[s + j].n);
                    fp = put(fp, cuts[j].p, cuts[j].n);
                }
                int64_t e = c.en[i] < 0 ? r.seq.n : c.en[i];
                if (c.st[i] >= e) {
                    xp = put(xp, r.id.p, r.id.n);
                    *xp++ = '\n';
                    continue;
                }
                Py_ssize_t s0, s1, q0, q1;
                slice(c.st[i], e, r.seq.n, s0, s1);
                slice(c.st[i], e, r.qual.n, q0, q1);
                char*& b = to[c.slot[i]];
                *b++ = '@';
                b = put(b, r.id.p, r.id.n);
                if (r.desc.n) {
                    *b++ = ' ';
                    b = put(b, r.desc.p, r.desc.n);
                }
                *b++ = '\n';
                b = put(b, r.seq.p + s0, s1 - s0);
                b = put(b, "\n+\n", 3);
                b = put(b, r.qual.p + q0, q1 - q0);
                *b++ = '\n';
            }
        }
    }
};

// a list, of n items where n >= 0
bool is_list(PyObject* o, Py_ssize_t n) {
    return PyList_Check(o) && (n < 0 || PyList_GET_SIZE(o) == n);
}

// a new str of n ASCII characters, filled later
PyObject* new_ascii(Py_ssize_t n) { return PyUnicode_New(n, 127); }

PyObject* chunk_tuple(Chunk& ch, PyObject* names) {
    PyObject* blocks = PyDict_New();
    PyObject* counts = PyDict_New();
    if (!blocks || !counts) goto fail;
    for (size_t k = 0; k < ch.blocks.size(); k++) {
        if (ch.blocks[k] &&
            PyDict_SetItem(blocks, PyList_GET_ITEM(names, k), ch.blocks[k]) < 0)
            goto fail;
    }
    for (const auto& kv : ch.counts) {
        PyObject* had = PyDict_GetItemWithError(counts, kv.first);
        if (!had && PyErr_Occurred()) goto fail;
        PyObject* v = PyLong_FromLong(kv.second + (had ? PyLong_AsLong(had) : 0));
        if (!v) goto fail;
        int rc = PyDict_SetItem(counts, kv.first, v);
        Py_DECREF(v);
        if (rc < 0) goto fail;
    }
    {
        PyObject* t = Py_BuildValue("(NOOONlll)", blocks, ch.ppr_o, ch.filt_o, ch.failed_o,
                                    counts, static_cast<long>(ch.runs.size()), ch.kept,
                                    ch.n_failed);
        if (!t) {
            // "N" steals blocks and counts even on failure
            return nullptr;
        }
        return t;
    }
fail:
    Py_XDECREF(blocks);
    Py_XDECREF(counts);
    return nullptr;
}

// (flags, [read positions]) of a run for the object path
PyObject* group_pair(const Group& g) {
    PyObject* reads = PyList_New(static_cast<Py_ssize_t>(g.reads.size()));
    if (!reads) return nullptr;
    for (size_t k = 0; k < g.reads.size(); k++) {
        PyObject* v = PyLong_FromLong(g.reads[k]);
        if (!v) {
            Py_DECREF(reads);
            return nullptr;
        }
        PyList_SET_ITEM(reads, static_cast<Py_ssize_t>(k), v);
    }
    return Py_BuildValue("(iN)", g.flags, reads);
}

}  // namespace

extern "C" PyObject* bbkt_close_runs(PyObject* ids, PyObject* descs, PyObject* seqs,
                                     PyObject* quals, PyObject* slabels, PyObject* lines,
                                     PyObject* cutrows, PyObject* names, const int64_t* cols,
                                     long n, PyObject* pend_id, long pend_n, long cap) {
    if (n < 0 || !cols || !is_list(ids, n) || !is_list(descs, n) || !is_list(seqs, n) ||
        !is_list(quals, n) || !is_list(slabels, n) || !is_list(lines, -1) ||
        !is_list(cutrows, -1) || !is_list(names, -1) || cap < 1)
        Py_RETURN_NONE;
    // (1) with the lock: where each item's data lies
    std::vector<Read> reads(static_cast<size_t>(n));
    for (long i = 0; i < n; i++) {
        Read& r = reads[i];
        if (!as_str(PyList_GET_ITEM(ids, i), r.id)) Py_RETURN_NONE;
        as_str(PyList_GET_ITEM(descs, i), r.desc);
        PyObject* lab = PyList_GET_ITEM(slabels, i);
        if (as_str(lab, r.slab)) r.slab_obj = lab;
        PyObject* s = PyList_GET_ITEM(seqs, i);
        PyObject* q = PyList_GET_ITEM(quals, i);
        if (PyBytes_Check(s)) r.seq = {PyBytes_AS_STRING(s), PyBytes_GET_SIZE(s), true};
        if (PyBytes_Check(q)) r.qual = {PyBytes_AS_STRING(q), PyBytes_GET_SIZE(q), true};
    }
    std::vector<Str> line(static_cast<size_t>(PyList_GET_SIZE(lines)));
    for (size_t j = 0; j < line.size(); j++) as_str(PyList_GET_ITEM(lines, j), line[j]);
    std::vector<std::vector<Str>> cuts(static_cast<size_t>(PyList_GET_SIZE(cutrows)));
    for (size_t w = 0; w < cuts.size(); w++) {
        PyObject* row = PyList_GET_ITEM(cutrows, w);
        if (!PyList_Check(row)) Py_RETURN_NONE;
        cuts[w].resize(static_cast<size_t>(PyList_GET_SIZE(row)));
        for (size_t j = 0; j < cuts[w].size(); j++) as_str(PyList_GET_ITEM(row, j), cuts[w][j]);
    }
    size_t n_names = static_cast<size_t>(PyList_GET_SIZE(names));
    for (size_t k = 0; k < n_names; k++)
        if (!PyUnicode_Check(PyList_GET_ITEM(names, k))) Py_RETURN_NONE;
    Str pend;
    bool has_pend = pend_id != Py_None;
    if (has_pend && !as_str(pend_id, pend)) Py_RETURN_NONE;

    Cols c{cols,         cols + n,     cols + 2 * n, cols + 3 * n,
           cols + 4 * n, cols + 5 * n, cols + 6 * n, cols + 7 * n};
    Walk wk(reads, line, cuts, c, n_names);
    if (has_pend) {
        wk.on = wk.carried = true;
        wk.id = pend;
        wk.recs = pend_n;
    }
    // (2) without the lock: the runs, and the bytes of those closed here
    Py_BEGIN_ALLOW_THREADS
    wk.run(n, cap);
    wk.size();
    Py_END_ALLOW_THREADS

    // (3) with the lock: the objects, uninitialised
    bool ok = true;
    for (Chunk& ch : wk.chunks) {
        ch.blocks.assign(n_names, nullptr);
        for (size_t k = 0; ok && k < n_names; k++)
            if (ch.block[k] && !(ch.blocks[k] = PyBytes_FromStringAndSize(nullptr, ch.block[k])))
                ok = false;
        if (ok && !((ch.ppr_o = new_ascii(ch.ppr)) && (ch.filt_o = new_ascii(ch.filt)) &&
                    (ch.failed_o = new_ascii(ch.failed))))
            ok = false;
        if (!ok) break;
        ch.to.assign(n_names, nullptr);
        for (size_t k = 0; k < n_names; k++)
            if (ch.blocks[k]) ch.to[k] = PyBytes_AS_STRING(ch.blocks[k]);
        ch.ppr_p = static_cast<char*>(PyUnicode_DATA(ch.ppr_o));
        ch.filt_p = static_cast<char*>(PyUnicode_DATA(ch.filt_o));
        ch.failed_p = static_cast<char*>(PyUnicode_DATA(ch.failed_o));
    }
    if (!ok) {
        for (Chunk& ch : wk.chunks) ch.release();
        return nullptr;
    }
    // (4) without the lock: the bytes, into objects no other thread sees yet
    Py_BEGIN_ALLOW_THREADS
    wk.fill();
    Py_END_ALLOW_THREADS

    // (5) with the lock: the result
    PyObject* out = PyList_New(static_cast<Py_ssize_t>(wk.events.size()));
    if (!out) {
        for (Chunk& ch : wk.chunks) ch.release();
        return nullptr;
    }
    for (size_t k = 0; k < wk.events.size(); k++) {
        const Event& ev = wk.events[k];
        PyObject* item = ev.chunk < 0 ? group_pair(wk.groups[ev.group])
                                      : chunk_tuple(wk.chunks[ev.chunk], names);
        if (!item) {
            Py_DECREF(out);
            for (Chunk& ch : wk.chunks) ch.release();
            return nullptr;
        }
        PyList_SET_ITEM(out, static_cast<Py_ssize_t>(k), item);
    }
    for (Chunk& ch : wk.chunks) ch.release();  // the tuples hold their own references
    return out;
}
