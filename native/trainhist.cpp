// Frozen-model training histograms (host hot path).
//
// The usemodel trainer (fastqueeze_tpu/pipeline/frozen.py, reference
// analogue: SeqArcPreProcess encode_*_formodel, SURVEY.md §3.4) histograms
// every (context, symbol) pair of a ~16M-symbol prefix.  The contexts are
// the same rolling-register formulas the device models use
// (models/base.py SeqModel / QualModel); a single serial pass here skips
// the table transfers of the device trainer and beats the vectorized-numpy
// fallback by an order of magnitude.

#include <cstdint>

extern "C" {

// hist must be zeroed, size (1 << 2*order) * 4 int32 entries.
// codes: 2-bit bases, read-major, degenerate bases already stripped.
void fq_seq_hist(const uint8_t* codes, const int64_t* lengths, int64_t n_reads,
                 int32_t order, uint32_t magic, int32_t* hist) {
    const uint32_t mask = (order >= 16) ? 0xFFFFFFFFu
                                        : ((1u << (2 * order)) - 1u);
    int64_t off = 0;
    for (int64_t r = 0; r < n_reads; ++r) {
        uint32_t ctx = magic & mask;
        const int64_t len = lengths[r];
        for (int64_t i = 0; i < len; ++i) {
            const uint32_t sym = codes[off + i];
            ++hist[(static_cast<int64_t>(ctx) << 2) | sym];
            ctx = ((ctx << 2) | sym) & mask;
        }
        off += len;
    }
}

// hist must be zeroed, size n_ctx * alphabet int32 entries
// (n_ctx = 1<<20 for qlevel >= 3, else 1<<16).
// q: Phred values (char - 33), read-major.
void fq_qual_hist(const uint8_t* q, const int64_t* lengths, int64_t n_reads,
                  int32_t qlevel, int32_t drop_init, int32_t alphabet,
                  int32_t* hist) {
    int64_t off = 0;
    for (int64_t r = 0; r < n_reads; ++r) {
        int32_t q1 = 0, q2 = 0, drops = drop_init;
        const int64_t len = lengths[r];
        for (int64_t i = 0; i < len; ++i) {
            const int32_t sym = q[off + i];
            int32_t ctx = (((q1 > q2 ? q1 : q2) << 6) + q1) & 0xFFF;
            if (qlevel >= 2) {
                if (q1 == q2) ctx += 0x1000;
                ctx += ((drops < 56 ? drops : 56) & ~7) << 10;
            }
            if (qlevel >= 3) {
                const int32_t p3 = static_cast<int32_t>(i) >> 3;
                ctx += (p3 < 15 ? p3 : 15) << 16;
            }
            ++hist[static_cast<int64_t>(ctx) * alphabet + sym];
            drops += (q1 > sym) ? (q1 - sym) : 0;
            q2 = q1;
            q1 = sym;
        }
        off += len;
    }
}

// In-place inc/init weighting + deterministic cap rescale: counts =
// hist*inc + init, then halve rows (rounding up) until total <= cap.
// Bit-identical to frozen._cap_rescale / engine._train_counts.
void fq_cap_rescale(int32_t* hist, int64_t n_rows, int32_t alphabet,
                    int32_t inc, int32_t init, int32_t cap) {
    for (int64_t r = 0; r < n_rows; ++r) {
        int32_t* row = hist + r * alphabet;
        int64_t tot = 0;
        for (int32_t a = 0; a < alphabet; ++a) {
            const int64_t v = static_cast<int64_t>(row[a]) * inc + init;
            row[a] = static_cast<int32_t>(v);
            tot += v;
        }
        for (int it = 0; it < 24 && tot > cap; ++it) {
            tot = 0;
            for (int32_t a = 0; a < alphabet; ++a) {
                row[a] = (row[a] + 1) >> 1;
                tot += row[a];
            }
        }
    }
}

// Pseudo-random 1-in-stride read sampling (frozen.py _sample_keep must
// stay bit-identical).  A plain (r % stride) sample aliases with any
// periodic structure in the input — replicated files, PE interleaving,
// tile/lane ordering — and can systematically exclude part of the
// content from training; hashing the read index decorrelates the sample
// from all such periods.
static inline int fq_keep_read(int64_t r, int64_t stride) {
    if (stride <= 1) return 1;
    return (uint32_t)((uint32_t)r * 2654435761u)
           <= (uint32_t)(0xFFFFFFFFu / (uint32_t)stride);
}

// Marker the loader uses to reject .so builds from before the sampling
// rule changed (the rule is a C <-> numpy contract).
int32_t fq_sampling_version(void) { return 2; }

// Fused one-pass frozen-model trainer over the RAW ASCII streams
// (fastqueeze_tpu/pipeline/frozen.py train_frozen fast path).  Replaces
// the python glue — read-stride subsample, base mapping, degenerate strip,
// phred conversion — that otherwise costs seconds of numpy copies on the
// training prefix.  Reads not picked by fq_keep_read are skipped entirely;
// non-ACGT bases are skipped in the seq-context walk (the numpy path
// strips them before building contexts — same compacted stream).
// seq_hist: (1<<2*order)*4 int32, zeroed (or accumulating) by the caller.
// qhist: n_qctx*alphabet int32 likewise.  qlut maps raw quality CHARS to
// coded symbols (dense ranks for the binned-quality fast path, or
// identity-minus-33); caller guarantees every char present maps below
// `alphabet`.  Returns max coded symbol seen (-1 if no symbols).
int32_t fq_train_prefix(const uint8_t* seq, const uint8_t* qual,
                        const int64_t* lengths, int64_t n_reads,
                        int64_t stride, int32_t order, uint32_t magic,
                        int32_t qlevel, int32_t drop_init, int32_t alphabet,
                        const uint8_t* qlut,
                        int32_t* seq_hist, int32_t* qhist) {
    const uint32_t mask = (order >= 16) ? 0xFFFFFFFFu
                                        : ((1u << (2 * order)) - 1u);
    int8_t bmap[256];
    for (int i = 0; i < 256; ++i) bmap[i] = -1;
    bmap['A'] = 0; bmap['C'] = 1; bmap['G'] = 2; bmap['T'] = 3;
    int32_t qmax = -1;
    int64_t off = 0;
    for (int64_t r = 0; r < n_reads; ++r) {
        const int64_t len = lengths[r];
        if (!fq_keep_read(r, stride)) { off += len; continue; }
        uint32_t ctx = magic & mask;
        int32_t q1 = 0, q2 = 0, drops = drop_init;
        for (int64_t i = 0; i < len; ++i) {
            const int8_t b = bmap[seq[off + i]];
            if (b >= 0) {
                ++seq_hist[(static_cast<int64_t>(ctx) << 2) | b];
                ctx = ((ctx << 2) | static_cast<uint32_t>(b)) & mask;
            }
            const int32_t sym = static_cast<int32_t>(qlut[qual[off + i]]);
            if (sym > qmax) qmax = sym;
            int32_t qc = (((q1 > q2 ? q1 : q2) << 6) + q1) & 0xFFF;
            if (qlevel >= 2) {
                if (q1 == q2) qc += 0x1000;
                qc += ((drops < 56 ? drops : 56) & ~7) << 10;
            }
            if (qlevel >= 3) {
                const int32_t p3 = static_cast<int32_t>(i) >> 3;
                qc += (p3 < 15 ? p3 : 15) << 16;
            }
            ++qhist[static_cast<int64_t>(qc) * alphabet + sym];
            drops += (q1 > sym) ? (q1 - sym) : 0;
            q2 = q1;
            q1 = sym;
        }
        off += len;
    }
    return qmax;
}

// Rank-chain quality-context histogram (models/base.py QualModel k>=2,
// frozen.py _select_qctx) over the same stride sample as fq_train_prefix.
// qlut maps raw quality chars to dense ranks; conditioning ranks clamp to
// cbase-1 (OOV ranks of later blocks).  hash_bits > 0 folds the chain
// through the Knuth multiplicative hash on the uint32 ring (bit-identical
// to the jnp/numpy mirrors).  hist: (rows << (drop_bits + pos_bits)) *
// alphabet int32, zeroed by the caller.
void fq_qctx_hist2(const uint8_t* qual, const int64_t* lengths,
                   int64_t n_reads, int64_t stride, const uint8_t* qlut,
                   int32_t alphabet, int32_t k, int32_t cbase,
                   int32_t drop_bits, int32_t pos_bits, int32_t hash_bits,
                   int32_t drop_init, int32_t* hist) {
    const int32_t qcap = cbase - 1;
    int64_t off = 0;
    for (int64_t r = 0; r < n_reads; ++r) {
        const int64_t len = lengths[r];
        if (!fq_keep_read(r, stride)) { off += len; continue; }
        int32_t q[4] = {0, 0, 0, 0};        // q[0] = q1 (most recent)
        int32_t drops = drop_init;
        for (int64_t i = 0; i < len; ++i) {
            const int32_t sym = static_cast<int32_t>(qlut[qual[off + i]]);
            int64_t ctx = q[0] < qcap ? q[0] : qcap;
            for (int32_t j = 1; j < k; ++j) {
                const int32_t qc = q[j] < qcap ? q[j] : qcap;
                ctx = ctx * cbase + qc;
            }
            if (hash_bits) {
                ctx = (static_cast<uint32_t>(ctx) * 2654435761u)
                      & ((1u << hash_bits) - 1);
            }
            if (drop_bits) {
                const int32_t m = (1 << drop_bits) - 1;
                const int32_t d = drops >> 3;
                ctx = (ctx << drop_bits) | (d < m ? d : m);
            }
            if (pos_bits) {
                const int32_t m = (1 << pos_bits) - 1;
                const int32_t pp = static_cast<int32_t>(i >> 4);
                ctx = (ctx << pos_bits) | (pp < m ? pp : m);
            }
            ++hist[ctx * alphabet + sym];
            drops += (q[0] > sym) ? (q[0] - sym) : 0;
            for (int32_t j = 3; j > 0; --j) q[j] = q[j - 1];
            q[0] = sym;
        }
        off += len;
    }
}

// Transfer-packing twins of ops/engine.py _pack{2,6}/_unpack{2,6}_host:
// grids cross the host-device link packed, and the pack/unpack passes
// themselves must not eat the saving.  n = number of 4-symbol groups
// (T*L/4).
void fq_pack2(const uint8_t* grid, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* g = grid + 4 * i;
        out[i] = static_cast<uint8_t>(g[0] | (g[1] << 2) | (g[2] << 4)
                                      | (g[3] << 6));
    }
}

void fq_unpack2(const uint8_t* packed, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t v = packed[i];
        uint8_t* g = out + 4 * i;
        g[0] = v & 3; g[1] = (v >> 2) & 3; g[2] = (v >> 4) & 3;
        g[3] = (v >> 6) & 3;
    }
}

void fq_pack6(const uint8_t* grid, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* g = grid + 4 * i;
        const uint32_t v = static_cast<uint32_t>(g[0])
                           | (static_cast<uint32_t>(g[1]) << 6)
                           | (static_cast<uint32_t>(g[2]) << 12)
                           | (static_cast<uint32_t>(g[3]) << 18);
        uint8_t* o = out + 3 * i;
        o[0] = v & 0xFF; o[1] = (v >> 8) & 0xFF; o[2] = (v >> 16) & 0xFF;
    }
}

void fq_unpack6(const uint8_t* packed, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* p = packed + 3 * i;
        const uint32_t v = static_cast<uint32_t>(p[0])
                           | (static_cast<uint32_t>(p[1]) << 8)
                           | (static_cast<uint32_t>(p[2]) << 16);
        uint8_t* g = out + 4 * i;
        g[0] = v & 63; g[1] = (v >> 6) & 63; g[2] = (v >> 12) & 63;
        g[3] = (v >> 18) & 63;
    }
}

// Ragged read-major flat symbols <-> (T, L) wave grid (ops/lanes.py).
// Read r (start wave start_t[r], lane lane[r]) occupies grid rows
// start_t[r]..start_t[r]+counts[r]-1 of column lane[r].  esz = 1 or 2.
void fq_grid_scatter(const uint8_t* flat, int32_t esz, const int64_t* counts,
                     const int64_t* start_t, const int64_t* lane,
                     int64_t n_reads, int64_t L, uint8_t* grid) {
    int64_t off = 0;
    if (esz == 1) {
        for (int64_t r = 0; r < n_reads; ++r) {
            uint8_t* col = grid + start_t[r] * L + lane[r];
            const int64_t c = counts[r];
            for (int64_t i = 0; i < c; ++i) col[i * L] = flat[off + i];
            off += c;
        }
    } else {
        const uint16_t* f16 = reinterpret_cast<const uint16_t*>(flat);
        uint16_t* g16 = reinterpret_cast<uint16_t*>(grid);
        for (int64_t r = 0; r < n_reads; ++r) {
            uint16_t* col = g16 + start_t[r] * L + lane[r];
            const int64_t c = counts[r];
            for (int64_t i = 0; i < c; ++i) col[i * L] = f16[off + i];
            off += c;
        }
    }
}

void fq_grid_gather(const uint8_t* grid, int32_t esz, const int64_t* counts,
                    const int64_t* start_t, const int64_t* lane,
                    int64_t n_reads, int64_t L, uint8_t* flat) {
    int64_t off = 0;
    if (esz == 1) {
        for (int64_t r = 0; r < n_reads; ++r) {
            const uint8_t* col = grid + start_t[r] * L + lane[r];
            const int64_t c = counts[r];
            for (int64_t i = 0; i < c; ++i) flat[off + i] = col[i * L];
            off += c;
        }
    } else {
        const uint16_t* g16 = reinterpret_cast<const uint16_t*>(grid);
        uint16_t* f16 = reinterpret_cast<uint16_t*>(flat);
        for (int64_t r = 0; r < n_reads; ++r) {
            const uint16_t* col = g16 + start_t[r] * L + lane[r];
            const int64_t c = counts[r];
            for (int64_t i = 0; i < c; ++i) f16[off + i] = col[i * L];
            off += c;
        }
    }
}

// Decimal rendering of the ID binner's numeric-VAR delta columns
// (pipeline/idproc.py): "%ld\n" per value.  Returns bytes written, or -1
// if cap would overflow.
int64_t fq_render_dec(const int64_t* vals, int64_t n, uint8_t* out,
                      int64_t cap) {
    int64_t w = 0;
    char tmp[24];
    for (int64_t i = 0; i < n; ++i) {
        int64_t v = vals[i];
        int k = 0;
        if (v < 0) {
            if (w >= cap) return -1;
            out[w++] = '-';
            v = -v;   // int64 min cannot appear: deltas of line numbers
        }
        do { tmp[k++] = static_cast<char>('0' + (v % 10)); v /= 10; }
        while (v);
        if (w + k + 1 > cap) return -1;
        while (k) out[w++] = static_cast<uint8_t>(tmp[--k]);
        out[w++] = '\n';
    }
    return w;
}

// ID-binning tokenizer (pipeline/idproc.py): split each ID line into
// maximal digit / non-digit runs.  buf = concatenated IDs, offs = (R+1)
// line offsets.  Writes per-read token counts and flat token (start, end)
// pairs; returns total tokens, or -1 if cap would overflow.
int64_t fq_id_tokenize(const uint8_t* buf, const int64_t* offs, int64_t R,
                       int64_t cap, int64_t* ntok, int64_t* tstart,
                       int64_t* tend) {
    int64_t m = 0;
    for (int64_t r = 0; r < R; ++r) {
        int64_t p = offs[r];
        const int64_t e = offs[r + 1];
        int64_t n = 0;
        while (p < e) {
            const bool dig = buf[p] >= '0' && buf[p] <= '9';
            int64_t q = p + 1;
            while (q < e && ((buf[q] >= '0' && buf[q] <= '9') == dig)) ++q;
            if (m >= cap) return -1;
            tstart[m] = p;
            tend[m] = q;
            ++m;
            ++n;
            p = q;
        }
        ntok[r] = n;
    }
    return m;
}

}  // extern "C"

#include "wavemodels.h"

extern "C" {

// Quality-context histogram v3: one pass emits BOTH the full stride-
// sampled histogram and the odd-parity-half histogram used as the
// holdout evaluation weights in frozen.py _select_qctx (parity =
// ((kept_read_index * 2654435761) >> 16) & 1, matching the hash-parity
// split in model_hists — kept_read_index counts sampled reads in input
// order).  The model walk is the canonical fqwave::QualM mirror, so
// this covers the fqzcomp-formula path (k < 2, qlevel 1..3) as well as
// the rank chains, replacing the numpy qual_ctx_flat holdout pass that
// dominated large-input training (~30 s per train at 64 M symbols).
void fq_qctx_hist3(const uint8_t* qual, const int64_t* lengths,
                   int64_t n_reads, int64_t stride, const uint8_t* qlut,
                   int32_t alphabet, int32_t k, int32_t cbase,
                   int32_t drop_bits, int32_t pos_bits, int32_t hash_bits,
                   int32_t drop_init, int32_t qlevel,
                   int32_t* hist, int32_t* histB) {
    fqwave::QualM m;
    m.k = k;
    m.base = cbase;
    m.hash_bits = hash_bits;
    m.drop_bits = drop_bits;
    m.pos_bits = pos_bits;
    m.qlevel = qlevel;
    m.drop_init = drop_init;
    int64_t off = 0;
    uint32_t kept = 0;
    for (int64_t r = 0; r < n_reads; ++r) {
        const int64_t len = lengths[r];
        if (!fq_keep_read(r, stride)) { off += len; continue; }
        const bool odd = ((kept * 2654435761u) >> 16) & 1u;
        ++kept;
        fqwave::QualM::State st;
        m.reset(st);
        for (int64_t i = 0; i < len; ++i) {
            const int32_t sym = static_cast<int32_t>(qlut[qual[off + i]]);
            const int64_t cell = m.ctx(st, i) * alphabet + sym;
            ++hist[cell];
            if (histB != nullptr && odd) ++histB[cell];
            m.update(st, sym);
        }
        off += len;
    }
}

}  // extern "C" (fq_qctx_hist3)
