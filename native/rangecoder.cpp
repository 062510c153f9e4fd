// Native serial adaptive range coder — host-side codec for small streams.
//
// Role parity with the reference's per-symbol coder (SURVEY.md §2.1,
// srcfile:EncapFqzComp.cpp: 64-bit-low range coder + SIMPLE_MODEL<N>
// adaptive frequency tables).  In the rebuild the *large* streams
// (sequence / quality) are coded by the wave-synchronized interleaved rANS
// on device; the many *small* per-block streams (flags, lengths, ID bytes,
// mismatch metadata) are coded here instead (CodecParams.host_stream_max
// picks the coder): a classic carry-propagating range coder (LZMA-style
// shift-low) with adaptive per-context symbol counts.
//
// The bitstream is its own format (marker 0x02 at the Python layer); a pure
// Python mirror (ops/host_rans.py) produces bit-identical output for
// environments without the native library.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTop = 1u << 24;

struct REnc {
    uint64_t low = 0;
    uint32_t range = 0xFFFFFFFFu;
    uint8_t cache = 0;
    uint64_t cache_size = 1;
    uint8_t* out;
    int64_t cap;
    int64_t n = 0;
    bool overflow = false;

    explicit REnc(uint8_t* o, int64_t c) : out(o), cap(c) {}

    inline void put(uint8_t b) {
        if (n >= cap) { overflow = true; return; }
        out[n++] = b;
    }

    inline void shift_low() {
        if ((uint32_t)low < 0xFF000000u || (low >> 32)) {
            uint8_t carry = (uint8_t)(low >> 32);
            put((uint8_t)(cache + carry));
            while (--cache_size) put((uint8_t)(0xFF + carry));
            cache = (uint8_t)(low >> 24);
        }
        cache_size++;
        low = (uint32_t)low << 8;
    }

    inline void encode(uint32_t start, uint32_t size, uint32_t total) {
        uint32_t r = range / total;
        low += (uint64_t)start * r;
        range = size * r;
        while (range < kTop) { shift_low(); range <<= 8; }
    }

    void flush() { for (int i = 0; i < 5; ++i) shift_low(); }
};

struct RDec {
    uint32_t range = 0xFFFFFFFFu;
    uint32_t code = 0;
    const uint8_t* in;
    int64_t len;
    int64_t pos = 0;

    RDec(const uint8_t* i, int64_t l) : in(i), len(l) {
        pos = 1;  // first byte emitted by encoder is always 0 (cache init)
        for (int k = 0; k < 4; ++k) code = (code << 8) | get();
    }

    inline uint8_t get() { return pos < len ? in[pos++] : 0; }

    inline uint32_t decode_freq(uint32_t total, uint32_t& r) {
        r = range / total;
        uint32_t v = code / r;
        return v >= total ? total - 1 : v;
    }

    inline void decode_update(uint32_t start, uint32_t size, uint32_t r) {
        code -= start * r;
        range = size * r;
        while (range < kTop) {
            code = (code << 8) | get();
            range <<= 8;
        }
    }
};

// Adaptive per-context model: counts[n_ctx][alphabet] uint32, start at
// `init`, +`inc` per coded symbol, halve (keeping >= 1) when the row total
// exceeds `cap` — the same update rule as the device models so ratios match.
struct Model {
    std::vector<uint32_t> counts;
    std::vector<uint32_t> totals;
    int32_t A;
    int32_t inc, cap;

    Model(int32_t n_ctx, int32_t alphabet, int32_t init_, int32_t inc_,
          int32_t cap_)
        : counts((size_t)n_ctx * alphabet, (uint32_t)init_),
          totals((size_t)n_ctx, (uint32_t)init_ * alphabet),
          A(alphabet), inc(inc_), cap(cap_) {}

    inline uint32_t* row(uint32_t ctx) { return counts.data() + (size_t)ctx * A; }

    inline void update(uint32_t ctx, uint32_t sym) {
        uint32_t* c = row(ctx);
        c[sym] += inc;
        uint32_t t = totals[ctx] + inc;
        if ((int64_t)t > cap) {
            t = 0;
            for (int32_t i = 0; i < A; ++i) { c[i] = (c[i] + 1) >> 1; t += c[i]; }
        }
        totals[ctx] = t;
    }
};

}  // namespace

extern "C" {

// Encode n symbols (alphabet <= 256) with caller-supplied context ids.
// Returns bytes written, or -1 on overflow / bad args.
int64_t rc_encode_ctx(const uint8_t* syms, const uint32_t* ctx, int64_t n,
                      int32_t n_ctx, int32_t alphabet, int32_t init,
                      int32_t inc, int32_t cap, uint8_t* out,
                      int64_t out_cap) {
    if (alphabet < 1 || alphabet > 256 || n_ctx < 1 || init < 1) return -1;
    Model m(n_ctx, alphabet, init, inc, cap);
    REnc enc(out, out_cap);
    for (int64_t i = 0; i < n; ++i) {
        uint32_t cx = ctx ? ctx[i] : 0;
        uint32_t s = syms[i];
        const uint32_t* c = m.row(cx);
        uint32_t start = 0;
        for (uint32_t k = 0; k < s; ++k) start += c[k];
        enc.encode(start, c[s], m.totals[cx]);
        m.update(cx, s);
        if (enc.overflow) return -1;
    }
    enc.flush();
    return enc.overflow ? -1 : enc.n;
}

int64_t rc_decode_ctx(const uint8_t* in, int64_t in_len, const uint32_t* ctx,
                      int64_t n, int32_t n_ctx, int32_t alphabet,
                      int32_t init, int32_t inc, int32_t cap,
                      uint8_t* syms_out) {
    if (alphabet < 1 || alphabet > 256 || n_ctx < 1 || init < 1) return -1;
    Model m(n_ctx, alphabet, init, inc, cap);
    RDec dec(in, in_len);
    for (int64_t i = 0; i < n; ++i) {
        uint32_t cx = ctx ? ctx[i] : 0;
        const uint32_t* c = m.row(cx);
        uint32_t r;
        uint32_t f = dec.decode_freq(m.totals[cx], r);
        uint32_t start = 0, s = 0;
        while (start + c[s] <= f) { start += c[s]; ++s; }
        dec.decode_update(start, c[s], r);
        syms_out[i] = (uint8_t)s;
        m.update(cx, s);
    }
    return n;
}

// Fallback name codec (reference parity: encode_name @0x421070, SURVEY.md
// §2.1 path 2 — fqzcomp-style per-TOKEN adaptive models diffed against the
// previous read's name).  Used when ID binning fails (unstructured IDs:
// SRA hashes, instrument coordinates, barcodes).
//
// Each name is tokenized into maximal digit runs, maximal alpha runs, and
// single other-chars.  Token t of the current name is coded relative to
// token t of the previous name through a relation symbol (model ctx =
// token index x previous relation):
//   0 MATCH  — byte-identical to the previous name's token t (~0 bits)
//   1 DELTA  — both canonical digit runs, value delta in [1, 256]:
//              one delta byte through a per-token model (counters, tiles)
//   2 NEW    — token spelled out: chars through (token, prev-char) models,
//              '\n'-terminated ('\n' cannot occur inside a line)
//   3 END    — no more tokens (name finished)
// Token-aligned diffing means a changing field does not destroy the match
// of everything after it (the weakness of whole-prefix schemes).
// Bit-identical Python mirror: host_rans._py_encode_names.
constexpr int32_t kNameTokMax = 32;          // token index saturates here
constexpr uint8_t kNameTerm = 10;            // '\n'
constexpr int32_t kRelBase = 0;                              // 32*4 rows
constexpr int32_t kDeltaBase = kRelBase + kNameTokMax * 4;   // 32 rows
constexpr int32_t kCharBase = kDeltaBase + kNameTokMax;      // 32*256 rows
constexpr int32_t kNameNCtx = kCharBase + kNameTokMax * 256;

struct NameTok {
    int32_t start, len;
    uint64_t val;     // digit-run value (canonical runs only)
    bool is_digit;
    bool canon;       // digit run, <= 18 digits, no leading zero (or "0")
};

static inline bool name_alnum(uint8_t c) {
    return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z')
        || (c >= 'a' && c <= 'z');
}

// Tokens are maximal ALNUM runs (one token per hash/field — mixed
// hex/base36 fields must stay single tokens so later tokens keep their
// index alignment across names) or single other-chars.  A run that is all
// digits carries its numeric value for DELTA coding.
static inline int name_tokenize(const uint8_t* s, int64_t L, NameTok* toks,
                                int max_toks) {
    int nt = 0;
    int64_t i = 0;
    while (i < L && nt < max_toks) {
        NameTok& t = toks[nt++];
        t.start = (int32_t)i;
        if (name_alnum(s[i])) {
            uint64_t v = 0;
            bool all_digit = true;
            int64_t j = i;
            while (j < L && name_alnum(s[j])) {
                if (s[j] >= '0' && s[j] <= '9') v = v * 10 + (s[j] - '0');
                else all_digit = false;
                ++j;
            }
            t.len = (int32_t)(j - i);
            t.is_digit = all_digit;
            t.val = all_digit ? v : 0;
            t.canon = all_digit && t.len <= 18
                && (s[i] != '0' || t.len == 1);
            i = j;
        } else {
            t.len = 1;
            t.is_digit = false;
            t.val = 0;
            t.canon = false;
            ++i;
        }
    }
    // overflow tail: lump the rest into one final "other" token
    if (i < L && nt == max_toks) {
        toks[nt - 1].len = (int32_t)(L - toks[nt - 1].start);
        toks[nt - 1].is_digit = false;
        toks[nt - 1].canon = false;
    }
    return nt;
}

constexpr int kMaxToks = 256;  // plenty; index saturates at kNameTokMax

int64_t rc_encode_names(const uint8_t* cat, const int32_t* lens, int64_t R,
                        int32_t init, int32_t inc, int32_t cap,
                        uint8_t* out, int64_t out_cap) {
    if (init < 1) return -1;
    Model m(kNameNCtx, 256, init, inc, cap);
    REnc enc(out, out_cap);
    std::vector<NameTok> ptoks(kMaxToks), ctoks(kMaxToks);
    int pnt = 0;
    const uint8_t* prev = nullptr;
    const uint8_t* cur = cat;
    for (int64_t r = 0; r < R; ++r) {
        int64_t L = lens[r];
        int cnt = name_tokenize(cur, L, ctoks.data(), kMaxToks);
        uint32_t prel = 0;
        for (int t = 0; t <= cnt; ++t) {
            int ti = t < kNameTokMax ? t : kNameTokMax - 1;
            uint32_t rel;
            if (t == cnt) {
                rel = 3;  // END
            } else {
                const NameTok& c = ctoks[t];
                rel = 2;  // NEW
                if (t < pnt) {
                    const NameTok& p = ptoks[t];
                    if (c.len == p.len
                        && memcmp(cur + c.start, prev + p.start, c.len) == 0)
                        rel = 0;  // MATCH
                    else if (c.is_digit && c.canon && p.is_digit && p.canon
                             && c.val > p.val && c.val - p.val <= 256)
                        rel = 1;  // DELTA
                }
            }
            uint32_t rcx = kRelBase + (uint32_t)ti * 4 + prel;
            {
                const uint32_t* cw = m.row(rcx);
                uint32_t start = 0;
                for (uint32_t k = 0; k < rel; ++k) start += cw[k];
                enc.encode(start, cw[rel], m.totals[rcx]);
                m.update(rcx, rel);
            }
            prel = rel;
            if (rel == 3) break;
            if (rel == 1) {
                uint32_t d = (uint32_t)(ctoks[t].val - ptoks[t].val - 1);
                uint32_t dcx = kDeltaBase + ti;
                const uint32_t* cw = m.row(dcx);
                uint32_t start = 0;
                for (uint32_t k = 0; k < d; ++k) start += cw[k];
                enc.encode(start, cw[d], m.totals[dcx]);
                m.update(dcx, d);
            } else if (rel == 2) {
                const NameTok& c = ctoks[t];
                uint32_t pc = 0;
                for (int32_t i = 0; i <= c.len; ++i) {
                    uint32_t s = i < c.len ? cur[c.start + i] : kNameTerm;
                    uint32_t ccx = kCharBase + (uint32_t)ti * 256 + pc;
                    const uint32_t* cw = m.row(ccx);
                    uint32_t start = 0;
                    for (uint32_t k = 0; k < s; ++k) start += cw[k];
                    enc.encode(start, cw[s], m.totals[ccx]);
                    m.update(ccx, s);
                    pc = s;
                }
            }
            if (enc.overflow) return -1;
        }
        std::swap(ptoks, ctoks);
        pnt = cnt;
        prev = cur;
        cur += L;
        if (enc.overflow) return -1;
    }
    enc.flush();
    return enc.overflow ? -1 : enc.n;
}

// Decodes R names into `cat_out` (exactly total_len bytes) and their
// lengths into lens_out.  Returns total bytes or -1 on a malformed stream.
int64_t rc_decode_names(const uint8_t* in, int64_t in_len, int64_t R,
                        int64_t total_len, int32_t init, int32_t inc,
                        int32_t cap, uint8_t* cat_out, int32_t* lens_out) {
    if (init < 1) return -1;
    Model m(kNameNCtx, 256, init, inc, cap);
    RDec dec(in, in_len);
    std::vector<NameTok> ptoks(kMaxToks);
    int pnt = 0;
    const uint8_t* prev = nullptr;
    uint8_t* cur = cat_out;
    int64_t written = 0;
    for (int64_t r = 0; r < R; ++r) {
        int64_t L = 0;
        uint32_t prel = 0;
        for (int t = 0;; ++t) {
            int ti = t < kNameTokMax ? t : kNameTokMax - 1;
            uint32_t rcx = kRelBase + (uint32_t)ti * 4 + prel;
            uint32_t rel;
            {
                const uint32_t* cw = m.row(rcx);
                uint32_t rr;
                uint32_t f = dec.decode_freq(m.totals[rcx], rr);
                uint32_t start = 0, s = 0;
                while (start + cw[s] <= f) { start += cw[s]; ++s; }
                dec.decode_update(start, cw[s], rr);
                m.update(rcx, s);
                rel = s;
            }
            prel = rel;
            if (rel == 3) break;
            if (rel > 3 || (rel <= 1 && t >= pnt)) return -1;  // corrupt
            if (rel == 0) {
                const NameTok& p = ptoks[t];
                if (written + p.len > total_len) return -1;
                memcpy(cur + L, prev + p.start, p.len);
                L += p.len;
                written += p.len;
            } else if (rel == 1) {
                uint32_t dcx = kDeltaBase + ti;
                const uint32_t* cw = m.row(dcx);
                uint32_t rr;
                uint32_t f = dec.decode_freq(m.totals[dcx], rr);
                uint32_t start = 0, s = 0;
                while (start + cw[s] <= f) { start += cw[s]; ++s; }
                dec.decode_update(start, cw[s], rr);
                m.update(dcx, s);
                uint64_t v = ptoks[t].val + s + 1;
                char buf[24];
                int n = snprintf(buf, sizeof buf, "%llu",
                                 (unsigned long long)v);
                if (written + n > total_len) return -1;
                memcpy(cur + L, buf, n);
                L += n;
                written += n;
            } else {
                uint32_t pc = 0;
                for (;;) {
                    uint32_t ccx = kCharBase + (uint32_t)ti * 256 + pc;
                    const uint32_t* cw = m.row(ccx);
                    uint32_t rr;
                    uint32_t f = dec.decode_freq(m.totals[ccx], rr);
                    uint32_t start = 0, s = 0;
                    while (start + cw[s] <= f) { start += cw[s]; ++s; }
                    dec.decode_update(start, cw[s], rr);
                    m.update(ccx, s);
                    pc = s;
                    if (s == kNameTerm) break;
                    if (written >= total_len) return -1;
                    cur[L++] = (uint8_t)s;
                    ++written;
                }
            }
            if (t >= kMaxToks) return -1;
        }
        lens_out[r] = (int32_t)L;
        pnt = name_tokenize(cur, L, ptoks.data(), kMaxToks);
        prev = cur;
        cur += L;
    }
    return written == total_len ? written : -1;
}

// Order-1 byte codec: context = previous symbol (0 for the first).
int64_t rc_encode_o1(const uint8_t* syms, int64_t n, int32_t alphabet,
                     int32_t init, int32_t inc, int32_t cap, uint8_t* out,
                     int64_t out_cap) {
    if (alphabet < 1 || alphabet > 256 || init < 1) return -1;
    Model m(alphabet, alphabet, init, inc, cap);
    REnc enc(out, out_cap);
    uint32_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t s = syms[i];
        const uint32_t* c = m.row(prev);
        uint32_t start = 0;
        for (uint32_t k = 0; k < s; ++k) start += c[k];
        enc.encode(start, c[s], m.totals[prev]);
        m.update(prev, s);
        prev = s;
        if (enc.overflow) return -1;
    }
    enc.flush();
    return enc.overflow ? -1 : enc.n;
}

int64_t rc_decode_o1(const uint8_t* in, int64_t in_len, int64_t n,
                     int32_t alphabet, int32_t init, int32_t inc,
                     int32_t cap, uint8_t* syms_out) {
    if (alphabet < 1 || alphabet > 256 || init < 1) return -1;
    Model m(alphabet, alphabet, init, inc, cap);
    RDec dec(in, in_len);
    uint32_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* c = m.row(prev);
        uint32_t r;
        uint32_t f = dec.decode_freq(m.totals[prev], r);
        uint32_t start = 0, s = 0;
        while (start + c[s] <= f) { start += c[s]; ++s; }
        dec.decode_update(start, c[s], r);
        syms_out[i] = (uint8_t)s;
        m.update(prev, s);
        prev = s;
    }
    return n;
}

}  // extern "C"
