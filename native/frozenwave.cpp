// Host-native execution backend for the frozen wave-rANS engine.
//
// Mirrors fastqueeze_tpu/ops/engine.py's frozen (usemodel) coding path
// BIT-IDENTICALLY: the payload bytes produced/consumed here are exactly the
// device kernels' (_encode_fused_frozen / _decode_fused_frozen over the
// round-robin lane layout of ops/lanes.py).  Which backend runs a stream is
// a pure execution choice (ops/host_frozen.py: this coder on a CPU
// backend, the device kernels on an accelerator); the archive cannot tell
// them apart.
//
// Coding scheme recap (ops/engine.py module docstring): L interleaved rANS
// lanes, 32-bit states, 16-bit renorm words, 14-bit frequencies; lane l
// codes the concatenated symbols of reads l, l+L, l+2L, ...; emitted words
// from all lanes interleave in canonical (wave, lane) order; the serialized
// stream is [T|L|n_words|n_symbols, L x u32 final states, words].  Frozen
// tables are quantized to cumulative frequencies summing to exactly 2^14
// with floor(cum * M / C) — f >= 1 for every count >= 1 when the row total
// is capped at <= M (the router enforces cap <= M).
//
// Model context walks mirror models/base.py SeqModel / QualModel (the same
// formulas as the trainer in trainhist.cpp).

#include <cstdint>
#include <vector>

#include <emmintrin.h>

#include "wavemodels.h"

namespace {

using fqwave::SeqM;
using fqwave::QualM;
using fqwave::make_seq;
using fqwave::make_qual;

constexpr uint32_t kRansL = 1u << 16;
constexpr uint32_t kProbBits = 14;
constexpr uint32_t kRansM = 1u << kProbBits;
constexpr uint32_t kMaskM = kRansM - 1;

using fqwave::RcpTable;
using fqwave::rcp_div;

// #i in [0, A) with row[i] <= low.  Rows are strictly increasing
// (every count >= 1, total <= M), so the count IS the successor of the
// decoded symbol: sym = count - 1 (row[0] = 0 is always <= low).  An
// 8-lane SSE compare with an early exit replaces the binary search —
// the search's ~log2(A) dependent, poorly-predicted branches were the
// decode loop's biggest stall after the row fetch itself.
static inline int32_t count_le(const uint16_t* row, int32_t A,
                               uint32_t low) {
    const __m128i bias = _mm_set1_epi16(static_cast<short>(0x8000));
    const __m128i lowv = _mm_set1_epi16(
        static_cast<short>(static_cast<int>(low) ^ 0x8000));
    int32_t cnt = 0, i = 0;
    for (; i + 8 <= A; i += 8) {
        __m128i v = _mm_xor_si128(
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(row + i)),
            bias);
        int gt = _mm_movemask_epi8(_mm_cmpgt_epi16(v, lowv));
        if (gt) return cnt + (__builtin_ctz(gt) >> 1);
        cnt += 8;
    }
    for (; i < A; ++i) {
        if (row[i] > low) break;
        ++cnt;
    }
    return cnt;
}

// Lane machinery (LaneSt, advance_lane, LaneLayout, init_lanes,
// reverse_rans_merge) is shared with adaptwave.cpp via wavemodels.h.
using fqwave::LaneLayout;
using fqwave::LaneSt;
using fqwave::advance_lane;
using fqwave::init_lanes;
using fqwave::reverse_rans_merge;

// --- encode: wave-major forward (start, freq) walk (a context depends
//     only on the lane's own earlier symbols, so every lane's row for
//     wave t is known up front — pass A prefetches them, hiding the
//     scattered big-table fetch across L lanes), then per-lane reverse
//     rANS; words merged into canonical (wave asc, lane asc) order ---

template <class Model>
int64_t encode_impl(const uint16_t* cum, int32_t A, const uint8_t* syms,
                    const int64_t* counts, int64_t R, int64_t L,
                    const Model& m, uint16_t* words_out, int64_t words_cap,
                    uint32_t* states_out) {
    const LaneLayout lay(counts, R, L);
    std::vector<uint16_t> ts(lay.nsym), tf(lay.nsym);
    auto ls = init_lanes(L, m, nullptr);
    for (int64_t t = 0; t < lay.tmax; ++t) {
        for (int64_t l = 0; l < L; ++l) {         // pass A: ctx + prefetch
            if (t >= lay.lane_len[l]) continue;
            LaneSt<Model>& s = ls[l];
            advance_lane(s, m, counts, lay.roff.data(), R, L, l);
            s.ctx = m.ctx(s.st, s.pos);
            __builtin_prefetch(cum + s.ctx * (A + 1));
        }
        for (int64_t l = 0; l < L; ++l) {         // pass B: (start, freq)
            if (t >= lay.lane_len[l]) continue;
            LaneSt<Model>& s = ls[l];
            const int32_t sym = syms[s.off + s.pos];
            const uint16_t* row = cum + s.ctx * (A + 1);
            const int64_t idx = lay.seg[l] + t;
            ts[idx] = row[sym];
            tf[idx] = static_cast<uint16_t>(row[sym + 1] - row[sym]);
            m.update(s.st, sym);
            ++s.pos;
        }
    }
    return reverse_rans_merge(ts.data(), tf.data(), lay, words_out,
                              words_cap, states_out);
}

// --- decode: wave-major forward pass across lanes (the word stream is
//     consumed in exactly the order encode laid it down); pass A
//     prefetches each lane's cum row, pass B decodes ---

template <class Model>
void decode_impl(const uint16_t* cum, int32_t A, const uint32_t* states,
                 const uint16_t* words, int64_t n_words,
                 const int64_t* counts, int64_t R, int64_t L,
                 const Model& m, uint8_t* out) {
    const LaneLayout lay(counts, R, L);
    auto ls = init_lanes(L, m, states);
    const int64_t tmax = lay.tmax;
    const std::vector<int64_t>& lane_len = lay.lane_len;
    const std::vector<int64_t>& roff = lay.roff;
    int64_t wp = 0;
    for (int64_t t = 0; t < tmax; ++t) {
        for (int64_t l = 0; l < L; ++l) {         // pass A: ctx + prefetch
            if (t >= lane_len[l]) continue;
            LaneSt<Model>& s = ls[l];
            advance_lane(s, m, counts, roff.data(), R, L, l);
            s.ctx = m.ctx(s.st, s.pos);
            __builtin_prefetch(cum + s.ctx * (A + 1));
        }
        for (int64_t l = 0; l < L; ++l) {         // pass B: decode
            if (t >= lane_len[l]) continue;
            LaneSt<Model>& s = ls[l];
            const uint16_t* row = cum + s.ctx * (A + 1);
            const uint32_t low = s.x & kMaskM;
            // largest sym with row[sym] <= low (row strictly increasing
            // when every count >= 1 and the row total is <= M)
            const int32_t lo = count_le(row, A, low) - 1;
            const uint32_t start = row[lo];
            const uint32_t f = row[lo + 1] - start;
            uint32_t xn = f * (s.x >> kProbBits) + low - start;
            if (xn < kRansL) {
                // past-the-end reads mirror the device's zero padding
                // (only reachable on corrupt streams; MD5 reports those)
                const uint32_t w = wp < n_words ? words[wp] : 0;
                xn = (xn << 16) | w;
                ++wp;
            }
            s.x = xn;
            out[s.off + s.pos] = static_cast<uint8_t>(lo);
            m.update(s.st, lo);
            ++s.pos;
        }
    }
}

}  // namespace

extern "C" {

// (n_ctx, A) int32 counts -> (n_ctx, A+1) u16 cumulative freqs summing to
// 2^14 (engine._quant: F_i = floor(cum_i * M / C), F_0 = 0, F_A = M).
void fq_quant_table(const int32_t* counts, int64_t n_ctx, int32_t A,
                    uint16_t* cum) {
    for (int64_t r = 0; r < n_ctx; ++r) {
        const int32_t* row = counts + r * A;
        uint16_t* o = cum + r * (A + 1);
        int64_t c = 0;
        for (int32_t a = 0; a < A; ++a) c += row[a];
        if (c <= 0) c = 1;      // unreachable for trained tables (init >= 1)
        int64_t acc = 0;
        o[0] = 0;
        for (int32_t a = 0; a < A; ++a) {
            acc += row[a];
            o[a + 1] = static_cast<uint16_t>((acc * kRansM) / c);
        }
    }
}

// Returns n_words, or -1 (bad kind/spec or words_cap overflow).
// kind 0 = seq (spec: mask, magic); kind 1 = qual (spec: k, base,
// hash_bits, drop_bits, pos_bits, qlevel, drop_init).
int64_t fq_frozen_encode(const uint16_t* cum, int32_t A, const uint8_t* syms,
                         const int64_t* counts, int64_t R, int64_t L,
                         int32_t kind, const int64_t* spec,
                         uint16_t* words_out, int64_t words_cap,
                         uint32_t* states_out) {
    if (kind == 0) {
        SeqM m;
        if (!make_seq(spec, &m)) return -1;
        return encode_impl(cum, A, syms, counts, R, L, m, words_out,
                           words_cap, states_out);
    }
    if (kind == 1) {
        QualM m;
        if (!make_qual(spec, &m)) return -1;
        return encode_impl(cum, A, syms, counts, R, L, m, words_out,
                           words_cap, states_out);
    }
    return -1;
}

// Returns 0, or -1 (bad kind/spec).
int64_t fq_frozen_decode(const uint16_t* cum, int32_t A,
                         const uint32_t* states, const uint16_t* words,
                         int64_t n_words, const int64_t* counts, int64_t R,
                         int64_t L, int32_t kind, const int64_t* spec,
                         uint8_t* out) {
    if (kind == 0) {
        SeqM m;
        if (!make_seq(spec, &m)) return -1;
        decode_impl(cum, A, states, words, n_words, counts, R, L, m, out);
        return 0;
    }
    if (kind == 1) {
        QualM m;
        if (!make_qual(spec, &m)) return -1;
        decode_impl(cum, A, states, words, n_words, counts, R, L, m, out);
        return 0;
    }
    return -1;
}

}  // extern "C"
