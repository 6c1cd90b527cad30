// FASTQ batches as Python objects in one call: the kit runner's four
// lists (read ids, descriptions, sequences, qualities) built straight
// from the reader's buffer.  Loaded through ctypes.PyDLL (the call
// starts and ends holding the interpreter lock), built against the
// interpreter's own headers.
//
// C ABI:
//   void*     bbfq_open(const char** paths, int n);
//   PyObject* bbfq_next(void* r, int max_records);
//       (ids, descs, seqs, quals): lists of str, str, bytes, bytes;
//       None at the end of input; raises ValueError on malformed
//       input and UnicodeDecodeError on a header byte above 0x7F, as
//       bytes.decode("ascii") does.
//   void      bbfq_close(void* r);
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
