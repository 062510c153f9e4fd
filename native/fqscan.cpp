// Native FASTQ scanner — the host-side data-loader hot path.
//
// Capability parity with the reference's reader/parser machinery
// (SURVEY.md C5 srcfile:SeqArcRead.cpp cultbuf record-boundary cutting; C7
// getBlockRead record parsing), which is C++ in the reference.  The
// rebuild keeps the device compute in JAX and this host runtime in
// C++: one pass over the raw block finds every line span, validates the
// 4-line record structure, and returns the spans as int64 arrays that the
// Python layer turns into SoA numpy views without re-scanning.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>

extern "C" {

// Largest prefix of buf that ends a whole number of 4-line records.
// Returns 0 when fewer than 4 newlines exist.
int64_t fq_record_boundary(const uint8_t* buf, int64_t n) {
    int64_t count = 0;
    int64_t last4 = -1;
    for (int64_t i = 0; i < n; ++i) {
        if (buf[i] == '\n') {
            ++count;
            if ((count & 3) == 0) last4 = i;
        }
    }
    return last4 + 1;
}

// Scan line spans.  starts/ends must have room for max_lines entries.
// If missing_final_nl, a trailing unterminated line is counted.
// Returns the number of lines found, or -1 if max_lines was exceeded.
int64_t fq_line_spans(const uint8_t* buf, int64_t n, int missing_final_nl,
                      int64_t* starts, int64_t* ends, int64_t max_lines) {
    int64_t k = 0;
    int64_t start = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (buf[i] == '\n') {
            if (k >= max_lines) return -1;
            starts[k] = start;
            ends[k] = i;
            ++k;
            start = i + 1;
        }
    }
    if (missing_final_nl && start < n) {
        if (k >= max_lines) return -1;
        starts[k] = start;
        ends[k] = n;
        ++k;
    }
    return k;
}

// One-pass FASTQ block validation + per-record field spans.
// For R = nlines/4 records, fills (R,) arrays: id_start/id_end (excluding
// '@'), seq_start/seq_end, plus_start/plus_end (excluding '+'),
// qual_start/qual_end.  Returns R, or a negative error code:
//   -1 line count not divisible by 4, -2 bad '@', -3 bad '+',
//   -4 seq/qual length mismatch, -5 span buffer overflow.
int64_t fq_parse_block(const uint8_t* buf, int64_t n, int missing_final_nl,
                       int64_t* scratch_starts, int64_t* scratch_ends,
                       int64_t max_lines,
                       int64_t* id_s, int64_t* id_e,
                       int64_t* sq_s, int64_t* sq_e,
                       int64_t* pl_s, int64_t* pl_e,
                       int64_t* qu_s, int64_t* qu_e) {
    int64_t nl = fq_line_spans(buf, n, missing_final_nl,
                               scratch_starts, scratch_ends, max_lines);
    if (nl < 0) return -5;
    if (nl & 3) return -1;
    int64_t R = nl / 4;
    for (int64_t r = 0; r < R; ++r) {
        int64_t li = 4 * r;
        int64_t is = scratch_starts[li], ie = scratch_ends[li];
        int64_t ss = scratch_starts[li + 1], se = scratch_ends[li + 1];
        int64_t ps = scratch_starts[li + 2], pe = scratch_ends[li + 2];
        int64_t qs = scratch_starts[li + 3], qe = scratch_ends[li + 3];
        if (is >= ie || buf[is] != '@') return -2;
        if (ps >= pe || buf[ps] != '+') return -3;
        if (se - ss != qe - qs) return -4;
        id_s[r] = is + 1; id_e[r] = ie;
        sq_s[r] = ss;     sq_e[r] = se;
        pl_s[r] = ps + 1; pl_e[r] = pe;
        qu_s[r] = qs;     qu_e[r] = qe;
    }
    return R;
}

// Gather concatenation: out[sum(lens)] = buf slices — the SoA flattening
// step (seq/qual streams) without Python-level index math.
void fq_gather(const uint8_t* buf, const int64_t* starts,
               const int64_t* ends, int64_t n_spans, uint8_t* out) {
    int64_t o = 0;
    for (int64_t i = 0; i < n_spans; ++i) {
        int64_t len = ends[i] - starts[i];
        std::memcpy(out + o, buf + starts[i], (size_t)len);
        o += len;
    }
}

// Scatter: inverse of fq_gather for the block assembler.
void fq_scatter(const uint8_t* flat, const int64_t* dest_starts,
                const int64_t* lens, int64_t n_spans, uint8_t* out) {
    int64_t o = 0;
    for (int64_t i = 0; i < n_spans; ++i) {
        std::memcpy(out + dest_starts[i], flat + o, (size_t)lens[i]);
        o += lens[i];
    }
}

}  // extern "C"
