// Host-native gapless seed-and-extend aligner — a decision-for-decision
// mirror of the device kernels in fastqueeze_tpu/align/hash.py
// (_align_batch / _one_strand, narrow mode k <= 15, local index).
//
// Why it exists: it is the aligner of CPU-backend runs (tests, --cpu)
// and the bit-identical reference the device tiers are checked against
// (the reference binary's HashAlignment is host code too, SURVEY.md
// §2.2).  Which backend aligns a block is a free execution
// choice ONLY because this mirror reproduces every BITSTREAM-RELEVANT
// device output exactly: the mapped flags, and pos / is_rev / mis_mask
// for the mapped reads (unmapped reads' pos never reaches the archive —
// they are coded entropy-only).  tests/test_alignhost.py cross-checks
// host vs device on the CPU backend.
//
// The mirror preserves the device's first-occurrence argmin over the
// candidate list exactly, while skipping work the argmin provably cannot
// observe:
//   * invalid candidates (out-of-range / beyond the occ list) are never
//     probed or verified — on device they carry mis = BIG and can only
//     win when no valid candidate exists, i.e. when the read is unmapped;
//   * a candidate whose probe-word mismatches already exceed the current
//     best full count cannot strictly improve the argmin (probe words
//     are a subset of the window, so pmis <= mis); the prefiltered scan
//     is ordered by (pmis, index), so the first such candidate ends the
//     scan (branch-and-bound);
//   * duplicate positions (different seeds emitting the same window)
//     have identical mis; only the first occurrence can win a strict <,
//     so later duplicates are skipped via a per-read hash set, and their
//     probe counts are copied from the first occurrence;
//   * a running best of 0 mismatches cannot be strictly improved.
//
// Keys are uint64 (narrow k <= 15 keys zero-extended; wide k <= 31 keys
// are the device's (hi, lo30) pairs re-joined — pair-lexicographic order
// IS plain u64 order, so the bucket search mirrors both modes with one
// code path).  Only the sharded index stays device-only.  fq_window_batch
// below mirrors the anchored PE mate-rescue verify the same way.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr int32_t BIG = 1 << 28;

static inline int mis2bit(uint32_t x) {
    return __builtin_popcount((x | (x >> 1)) & 0x55555555u);
}

struct Index {
    const uint64_t* keys; int64_t nk;
    const int32_t* offsets;
    const int32_t* positions; int64_t npos;
    const uint32_t* packed; int64_t nw;
    const int32_t* l1; int32_t l1_shift; int32_t search_steps;
    int32_t ref_len;
};

struct Cfg {
    int32_t k, stride, n_cand, max_mis, n_seeds, excl_bp, probe_k;
    int32_t lp;
    int n_words() const { return lp / 16; }
};

// _read_in_ref_frame: word j of the read funnel-shifted into the
// candidate's ref frame.  sh = 2 * (cand & 15).
static inline uint32_t frame_word(const uint32_t* arr, int W, int j,
                                  uint32_t sh) {
    uint32_t a = (j >= 1 && j <= W) ? arr[j - 1] : 0u;
    uint32_t b = (j < W) ? arr[j] : 0u;
    uint32_t shl = 32u - (sh > 1u ? sh : 1u);
    uint32_t hi = (j >= 1 && sh > 0) ? (a << shl) : 0u;
    return hi | (b >> sh);
}

// Per-call scratch: one allocation set reused across every read and
// strand (the old per-read std::vectors were ~20 mallocs per read).
struct Workspace {
    std::vector<uint64_t> kv;     // rolling k-mer at every window start
    std::vector<int32_t> cs;      // degenerate prefix sums (lp + 1)
    std::vector<int64_t> ii;      // per-sample CSR key index
    std::vector<int32_t> occ;     // per-sample occurrence count (or BIG)
    std::vector<int32_t> psv;     // per-sample read offset
    std::vector<uint32_t> cand;   // C * NS candidate windows
    std::vector<int32_t> sel;     // survivors (unfiltered path only)
    // prefilter survivors bucketed by probe count: appending in
    // generation order then walking buckets 0..max_mis yields exactly
    // the (pmis, index) lexicographic order a sort would produce,
    // without sorting
    std::vector<std::vector<int32_t>> bucket;
    std::vector<uint32_t> rw, mw; // packed read + validity words
    std::vector<uint8_t> rc, rdege;
    // open-address hash over candidate values: verified-position set
    // (duplicate windows have identical mis and cannot win the strict-<
    // argmin), reset per (read, strand) by epoch stamping
    std::vector<uint32_t> hkey;
    std::vector<uint32_t> hep;
    uint32_t epoch = 0;
    uint32_t hmask = 0;

    void init(const Cfg& cfg) {
        const int P = cfg.lp - cfg.k + 1;
        const int S = (P + cfg.stride - 1) / cfg.stride;
        const size_t total = (size_t)cfg.n_cand * cfg.n_seeds;
        kv.resize(P);
        cs.resize(cfg.lp + 1);
        ii.resize(S);
        occ.resize(S);
        psv.resize(S);
        cand.resize(total);
        sel.reserve(total);
        bucket.resize(cfg.max_mis + 1);
        for (auto& b : bucket) b.reserve(64);
        rw.resize(cfg.n_words());
        mw.resize(cfg.n_words());
        rc.resize(cfg.lp);
        rdege.resize(cfg.lp);
        uint32_t cap = 64;
        while (cap < 2 * total) cap <<= 1;
        if (cap != hkey.size()) {
            hkey.assign(cap, 0);
            hep.assign(cap, 0);
            epoch = 0;
        }
        hmask = cap - 1;
    }
    // returns slot for key; fresh slots have hep[slot] != epoch
    inline uint32_t slot(uint32_t key) {
        uint32_t h = (key * 2654435761u) & hmask;
        while (hep[h] == epoch && hkey[h] != key) h = (h + 1) & hmask;
        return h;
    }
};

// perf counters (debugging aid, no effect on results):
// [0] strand calls, [1] sampled-seed searches, [2] valid candidates,
// [3] probes computed, [4] probe dup hits, [5] sel size after cap,
// [6] full verifies, [7] verify dup skips, [8] verify words scanned,
// [9] b&b breaks
static int64_t g_stat[12] = {0};

// one_strand: per-read candidate search + verify on an effective-strand
// row.  Mirrors hash.py _one_strand (narrow, l1-bucketed fixed-step
// search).  Returns (mis_best, pos_best); pos_best matches the device
// argmin whenever the read can map (mis_best <= max_mis).
// The caller guarantees ix.packed stays readable for W + 2 words past the
// true word count (the Python wrapper pads the host copy): every probed or
// verified candidate satisfies cand + len <= ref_len, so any frame word
// whose validity mask is non-zero is in range, and masked-out overreads
// land in the zero padding — bit-identical to the device's clamped fetch
// of an all-masked word.
static void one_strand(const Index& ix, const Cfg& cfg, Workspace& ws,
                       const uint8_t* row, const uint8_t* drow,
                       int32_t len, int32_t* mis_out, int32_t* pos_out) {
    const int lp = cfg.lp, k = cfg.k, W = cfg.n_words();
    const int P = lp - k + 1;
    const int S = (P + cfg.stride - 1) / cfg.stride;
    ws.epoch++;
    g_stat[0]++;
    g_stat[1] += S;

    // rolling k-mer at every window start (O(lp), not O(S * k)) and the
    // degenerate prefix sums, one fused pass.  row/drow are only `len`
    // bytes long (flat block layout); positions past len roll in zeros,
    // exactly like the device's zero-padded grid — those windows are
    // already invalid (ok_s), but their kv still feeds the (discarded-
    // result) searches, whose ii values the junk-candidate path of a
    // no-match seed can observe.
    const uint64_t kmask = (k >= 32) ? ~uint64_t(0)
                                     : ((uint64_t(1) << (2 * k)) - 1);
    {
        uint64_t v = 0;
        int32_t c = 0;
        ws.cs[0] = 0;
        for (int i = 0; i < len; i++) {
            v = ((v << 2) | row[i]) & kmask;
            c += drow[i] ? 1 : 0;
            ws.cs[i + 1] = c;
            if (i >= k - 1) ws.kv[i - k + 1] = v;
        }
        for (int i = len; i < lp; i++) {
            v = (v << 2) & kmask;
            ws.cs[i + 1] = c;
            if (i >= k - 1) ws.kv[i - k + 1] = v;
        }
    }

    for (int s = 0; s < S; s++) {
        int q = s * cfg.stride;
        ws.psv[s] = q;
        const uint64_t v = ws.kv[q];
        bool ok_s = (q <= len - k) && (ws.cs[q + k] - ws.cs[q]) == 0;
        // bucket-bounded lower_bound, fixed search_steps (exact mirror)
        int64_t bq = (int64_t)(v >> ix.l1_shift);
        int64_t lo = ix.l1[bq], hi = ix.l1[bq + 1];
        int64_t hi0 = hi;
        for (int t = 0; t < ix.search_steps; t++) {
            bool active = lo < hi;
            int64_t mid = (lo + hi) >> 1;
            int64_t m = mid < ix.nk - 1 ? mid : ix.nk - 1;
            bool less = ix.keys[m] < v;
            if (active && less) lo = mid + 1;
            if (active && !less) hi = mid;
        }
        int64_t i2 = lo < ix.nk - 1 ? lo : ix.nk - 1;
        ws.ii[s] = i2;
        bool found = (ix.keys[i2] == v) && (lo < hi0) && ok_s;
        ws.occ[s] = found ? (ix.offsets[i2 + 1] - ix.offsets[i2]) : BIG;
    }

    // pack the read row into MSB-first u32 words + validity mask words
    // (the fused generation+probe loop below needs them up front)
    std::fill(ws.rw.begin(), ws.rw.end(), 0u);
    std::fill(ws.mw.begin(), ws.mw.end(), 0u);
    for (int i = 0; i < len; i++) {
        uint32_t shv = 2u * (15 - (i & 15));
        ws.rw[i >> 4] |= ((uint32_t)row[i]) << shv;
        ws.mw[i >> 4] |= 3u << shv;
    }
    const uint32_t* rw = ws.rw.data();
    const uint32_t* mw = ws.mw.data();

    const int C = cfg.n_cand;
    const int NS = cfg.n_seeds;
    const int total = C * NS;
    // two-probe-word prefilter (device: lax.top_k(-pmis, K) then mask
    // pmis > max_mis, stable — smaller pmis first, ties by lower index).
    // A candidate whose two probe words already mismatch > max_mis can
    // never be accepted (probe words are a subset of the full window),
    // so both backends drop it before the full verify; the survivors
    // are exactly the prefix of the device's top-K ordering, so the
    // first-occurrence argmin below still mirrors the device argmin.
    const int K = cfg.probe_k;
    const bool prefiltered = K > 0 && total > 2 * K && W > 3;
    const int j1 = 1, j2 = W / 2;
    // the probe words funnel-shift the READ into the candidate's frame;
    // the shift depends only on the candidate's phase (cand & 15), so all
    // 16 variants are precomputed once per strand call
    uint32_t p1r[16], p1m[16], p2r[16], p2m[16];
    if (prefiltered) {
        for (uint32_t ph = 0; ph < 16; ph++) {
            p1r[ph] = frame_word(rw, W, j1, 2 * ph);
            p1m[ph] = frame_word(mw, W, j1, 2 * ph);
            p2r[ph] = frame_word(rw, W, j2, 2 * ph);
            p2m[ph] = frame_word(mw, W, j2, 2 * ph);
        }
    }

    // candidates from the n_seeds least-frequent sampled seeds, probed as
    // they are generated (one fused pass).  The device carries invalid
    // slots as mis = BIG, which can only win when the read is unmapped.
    // Duplicate positions are NOT deduped here: recomputing a duplicate's
    // probe count is cheaper than a hash probe per candidate, and it is
    // deterministic, so sel's (pmis, index) order is unchanged.
    int32_t* occv = ws.occ.data();
    ws.sel.clear();
    for (auto& b : ws.bucket) b.clear();
    int32_t pm_min = BIG;
    int pm_arg = -1;
    bool any_valid = false;
    int n_surv = 0;
    for (int it = 0; it < NS; it++) {
        int jb = 0;
        for (int s = 1; s < S; s++) if (occv[s] < occv[jb]) jb = s;
        int32_t occ_best = occv[jb];
        int32_t pb = ws.psv[jb];
        if (cfg.excl_bp > 0) {
            for (int s = 0; s < S; s++)
                if (std::abs(ws.psv[s] - pb) <= cfg.excl_bp) occv[s] = BIG;
        } else {
            occv[jb] = BIG;
        }
        int64_t base = ix.offsets[ws.ii[jb]];
        int32_t lim = occ_best < C ? occ_best : C;
        if (lim < 0) lim = 0;
        // only the first `lim` slots of this seed's range can be valid
        // on the device (in_range = cj < min(occ_best, C)); the slots
        // past lim carry mis = BIG there and are only observable through
        // an unmapped read's (unused) fallback position.  A no-match seed
        // (occ_best = BIG) still emits C slots from a clamped junk CSR
        // slice — same as the device's clipped gather.
        if (base < 0) base = 0;
        const bool clamped = base + lim > ix.npos;
        const int32_t* posp = ix.positions + base;
        for (int cj = 0; cj < lim; cj++) {
            int64_t ptr = cj;
            if (clamped && base + cj > ix.npos - 1) ptr = ix.npos - 1 - base;
            int32_t cp_i = posp[ptr] - pb;          // int32 frame, as device
            const int c = it * C + cj;
            if (c == 0) ws.cand[0] = (uint32_t)cp_i;   // all-invalid fallback
            if (cp_i < 0 || cp_i + len > ix.ref_len) continue;
            ws.cand[c] = (uint32_t)cp_i;
            any_valid = true;
            g_stat[2]++;
            if (!prefiltered) {
                ws.sel.push_back(c);
                continue;
            }
            g_stat[3]++;
            const uint32_t cp = (uint32_t)cp_i;
            const int64_t w0 = (int64_t)(cp >> 4);
            const uint32_t ph = cp & 15u;
            if (cj + 8 < lim) {  // hide the scattered packed-word fetch
                // same end clamp as the candidate itself: a no-match
                // seed's junk slice can run past the positions array
                int64_t nptr = cj + 8;
                if (clamped && base + nptr > ix.npos - 1)
                    nptr = ix.npos - 1 - base;
                int32_t nxt = posp[nptr] - pb;
                if (nxt >= 0)
                    __builtin_prefetch(ix.packed + (nxt >> 4) + j1);
            }
            // first probe word alone excludes most junk candidates
            // (> max_mis in 16 bases).  The exact two-word count is
            // only observable for candidates that survive (it orders
            // the buckets and feeds the branch-and-bound); an
            // already-excluded candidate's pm only needs to stay
            // > max_mis — its precise value can reach the output
            // solely through the all-pruned fallback position of an
            // UNMAPPED read, which never enters the bitstream.
            int32_t pm = mis2bit((p1r[ph] ^ ix.packed[w0 + j1]) & p1m[ph]);
            if (pm <= cfg.max_mis) {
                pm += mis2bit((p2r[ph] ^ ix.packed[w0 + j2]) & p2m[ph]);
                if (pm <= cfg.max_mis) {
                    ws.bucket[pm].push_back(c);
                    n_surv++;
                }
            } else {
                pm += 8;   // keep > max_mis without the second fetch
            }
            if (pm < pm_min) { pm_min = pm; pm_arg = c; }
        }
    }
    if (!any_valid) {
        // no candidate can map: the read is unmapped on this strand.
        // The device's argmin over an all-BIG row returns its first
        // candidate, so the fallback position is cand[0] — observable
        // only through the indel tier's anchor of an unmapped read.
        *mis_out = BIG;
        *pos_out = (C > 0 && NS > 0) ? (int32_t)ws.cand[0] : 0;
        return;
    }
    if (prefiltered) {
        g_stat[5] += n_surv < K ? n_surv : K;
        if (n_surv == 0) {
            // all candidates pruned: the device argmin over an all-BIG
            // row returns its first selected candidate = min (pmis, idx)
            *mis_out = BIG;
            *pos_out = (int32_t)ws.cand[pm_arg];
            return;
        }
    }

    // verify in (pmis, index) order: buckets ascending, insertion order
    // within each (exactly the device's stable top-K ordering), capped
    // at K entries
    int32_t best_mis = BIG;
    uint32_t best_pos = 0;
    bool have_best = false;
    const int n_buckets = prefiltered ? cfg.max_mis + 1 : 1;
    int taken = 0;
    for (int pm = 0; pm < n_buckets; pm++) {
        const std::vector<int32_t>& lst =
            prefiltered ? ws.bucket[pm] : ws.sel;
        for (size_t t = 0; t < lst.size(); t++) {
            if (prefiltered) {
                // mid-bucket b&b: a verify in this bucket can set
                // best_mis == pm (full count equal to the probe count),
                // after which nothing at this pm can strictly improve
                if (have_best && pm >= best_mis) {
                    g_stat[9]++;
                    pm = n_buckets;
                    break;
                }
                if (taken++ >= K) { pm = n_buckets; break; }
            }
            const int c = lst[t];
            const uint32_t cp = ws.cand[c];
            const uint32_t h = ws.slot(cp);
            if (ws.hep[h] == ws.epoch) {
                // duplicate position: identical mis, cannot improve
                g_stat[7]++;
                continue;
            }
            ws.hep[h] = ws.epoch;
            ws.hkey[h] = cp;
            g_stat[6]++;
            // early-exit: once the running count reaches the current
            // best, this candidate can no longer become the strict min
            const int64_t w0 = (int64_t)(cp >> 4);
            const uint32_t sh = 2u * (cp & 15u);
            int32_t m = 0;
            const int32_t bound = have_best ? best_mis : BIG;
            for (int j = 0; j <= W && m < bound; j++) {
                g_stat[8]++;
                uint32_t refw = ix.packed[w0 + j];
                uint32_t rsel = frame_word(rw, W, j, sh);
                uint32_t msel = frame_word(mw, W, j, sh);
                m += mis2bit((rsel ^ refw) & msel);
            }
            if (!have_best || m < best_mis) {  // first-occurrence argmin
                best_mis = m;
                best_pos = cp;
                have_best = true;
                if (best_mis == 0) { pm = n_buckets; break; }  // floor
            }
        }
    }
    *mis_out = best_mis;
    *pos_out = (int32_t)best_pos;
}

// Full-window mismatch count with a cutoff: exact when the result is
// < bound, otherwise any value >= bound (the caller's argmin can't
// observe which).  Mirrors the device's exact count through the
// strict-< first-occurrence argmin.
static inline int32_t mis_window(const Index& ix, uint32_t cp,
                                 const uint32_t* rw, const uint32_t* mw,
                                 int W, int32_t bound) {
    const int64_t w0 = (int64_t)(cp >> 4);
    const uint32_t sh = 2u * (cp & 15u);
    int32_t m = 0;
    for (int j = 0; j <= W && m < bound; j++) {
        uint32_t refw = ix.packed[w0 + j];
        uint32_t rsel = frame_word(rw, W, j, sh);
        uint32_t msel = frame_word(mw, W, j, sh);
        m += mis2bit((rsel ^ refw) & msel);
    }
    return m;
}

}  // namespace

extern "C" void fq_align_stats(int64_t* out, int32_t reset) {
    for (int i = 0; i < 12; i++) out[i] = g_stat[i];
    if (reset) for (int i = 0; i < 12; i++) g_stat[i] = 0;
}

// strand_mode: 0 = fwd only, 1 = rc only (fallback acceptance),
// 2 = both (use_rev by both_strands rule).  Mirrors _align_batch.
// codes/dege are the FLAT concatenated block arrays; roffs[r] is read
// r's flat offset (the caller selects the tier's read subset by passing
// per-read offsets — no grid marshaling).  lp only sizes the mis_mask
// rows.
extern "C" void fq_align_batch(
    const uint64_t* keys, int64_t nk, const int32_t* offsets,
    const int32_t* positions, int64_t npos,
    const uint32_t* packed, int64_t nw,
    const int32_t* l1, int32_t l1_shift, int32_t search_steps,
    int32_t ref_len,
    const uint8_t* codes, const uint8_t* dege, const int64_t* roffs,
    const int32_t* lengths, int64_t R, int32_t lp,
    int32_t k, int32_t stride, int32_t n_cand, int32_t max_mis,
    int32_t n_seeds, int32_t excl_bp, int32_t probe_k,
    int32_t strand_mode, int32_t both_strands,
    uint8_t* mapped, int32_t* pos_out, uint8_t* rev_out,
    uint8_t* mis_mask) {
    Index ix{keys, nk, offsets, positions, npos, packed, nw,
             l1, l1_shift, search_steps, ref_len};
    Cfg cfg{k, stride, n_cand, max_mis, n_seeds, excl_bp, probe_k, lp};
    Workspace ws;
    ws.init(cfg);
    for (int64_t r = 0; r < R; r++) {
        const uint8_t* row = codes + roffs[r];
        const uint8_t* drow = dege + roffs[r];
        int32_t len = lengths[r];
        if (len > lp) len = lp;   // caller guarantees len <= lp; belt
        bool has_dege = false;
        for (int i = 0; i < len && !has_dege; i++) has_dege = drow[i];

        int32_t mis_f = BIG, pos_f = 0, mis_r = BIG, pos_r = 0;
        if (strand_mode != 1)
            one_strand(ix, cfg, ws, row, drow, len, &mis_f, &pos_f);
        // RC is a *fallback* in the non-both-strands rule (use_rev =
        // mis_f > max_mis): when forward already mapped, the RC result
        // is provably unused — skip the whole RC search (the vectorized
        // device kernel cannot skip, but its RC outputs are discarded
        // by the same where())
        bool need_rc = strand_mode != 0 &&
            !(strand_mode == 2 && !both_strands && mis_f <= max_mis);
        if (need_rc) {
            for (int i = 0; i < lp; i++) {
                ws.rc[i] = i < len ? (uint8_t)(3 - row[len - 1 - i]) : 0;
                ws.rdege[i] = i < len ? drow[len - 1 - i] : 0;
            }
            one_strand(ix, cfg, ws, ws.rc.data(), ws.rdege.data(), len,
                       &mis_r, &pos_r);
        }
        bool use_rev;
        int32_t mis, pos;
        if (strand_mode == 0) {
            use_rev = false; mis = mis_f; pos = pos_f;
        } else if (strand_mode == 1) {
            use_rev = mis_r <= max_mis; mis = mis_r; pos = pos_r;
        } else if (both_strands) {
            use_rev = mis_r < mis_f;
            mis = use_rev ? mis_r : mis_f;
            pos = use_rev ? pos_r : pos_f;
        } else {
            use_rev = mis_f > max_mis;
            mis = use_rev ? mis_r : mis_f;
            pos = use_rev ? pos_r : pos_f;
        }
        bool is_mapped = (mis <= max_mis) && !has_dege && len >= k;
        mapped[r] = is_mapped ? 1 : 0;
        pos_out[r] = pos;
        rev_out[r] = (use_rev && is_mapped) ? 1 : 0;
        uint8_t* mm = mis_mask + r * lp;
        std::memset(mm, 0, lp);
        if (is_mapped) {
            const uint8_t* eff =
                (strand_mode == 1 || (strand_mode == 2 && use_rev))
                    ? ws.rc.data() : row;
            for (int i = 0; i < len; i++) {
                int64_t idx = (int64_t)(uint32_t)pos + i;
                int64_t wi = idx >> 4;
                if (wi > ix.nw - 1) wi = ix.nw - 1;
                uint32_t shv = 2u * (15 - (idx & 15));
                uint8_t refb = (uint8_t)((ix.packed[wi] >> shv) & 3u);
                mm[i] = eff[i] != refb ? 1 : 0;
            }
        }
    }
}

// Anchored windowed verification — decision-for-decision mirror of
// align/hash.py _window_batch (the PE mate-rescue step): for each read,
// every reference offset in [center - n_cand/2, center + n_cand/2) is
// verified on both strands; use_rev = (mis_rc < mis_fwd); mapped =
// best mis <= max_mis and no degenerate bases.  The device computes
// every candidate's exact count and takes the first-occurrence argmin;
// this scan keeps a running strict-< best with an early-exit bound,
// which preserves that argmin exactly (a candidate cut off at the bound
// cannot be the strict minimum, and when the RC best is >= the forward
// best, use_rev is false and the RC position/count are unobservable —
// the device reports mis_fwd then, not the min).  codes/dege are flat;
// packed must carry the caller's zero padding (see fq_align_batch).
extern "C" void fq_window_batch(
    const uint32_t* packed, int64_t nw, int32_t ref_len,
    const uint8_t* codes, const uint8_t* dege, const int64_t* roffs,
    const int32_t* lengths, const int32_t* centers, int64_t R, int32_t lp,
    int32_t n_cand, int32_t max_mis,
    uint8_t* mapped, int32_t* pos_out, uint8_t* rev_out,
    uint8_t* mis_mask) {
    Index ix{nullptr, 0, nullptr, nullptr, 0, packed, nw,
             nullptr, 0, 0, ref_len};
    const int W = lp / 16;
    std::vector<uint32_t> rw(W), mw(W);
    std::vector<uint8_t> rc(lp);
    for (int64_t r = 0; r < R; r++) {
        const uint8_t* row = codes + roffs[r];
        const uint8_t* drow = dege + roffs[r];
        int32_t len = lengths[r];
        if (len > lp) len = lp;
        bool has_dege = false;
        for (int i = 0; i < len && !has_dege; i++) has_dege = drow[i];
        const int32_t c0 = centers[r] - n_cand / 2;

        // strand scan: first-occurrence strict-< argmin over the window
        auto strand = [&](const uint8_t* eff, int32_t* mis_b,
                          int32_t* pos_b, int32_t bound0) {
            std::fill(rw.begin(), rw.end(), 0u);
            std::fill(mw.begin(), mw.end(), 0u);
            for (int i = 0; i < len; i++) {
                uint32_t shv = 2u * (15 - (i & 15));
                rw[i >> 4] |= ((uint32_t)eff[i]) << shv;
                mw[i >> 4] |= 3u << shv;
            }
            int32_t best = BIG, bpos = 0;
            bool have = false;
            for (int32_t cj = 0; cj < n_cand; cj++) {
                const int32_t cp = c0 + cj;
                if (cp < 0 || cp + len > ref_len) continue;
                const int32_t bound =
                    (have && best < bound0) ? best : bound0;
                const int32_t m = mis_window(ix, (uint32_t)cp, rw.data(),
                                             mw.data(), W, bound);
                if (m < bound) {      // exact and strictly better
                    best = m;
                    bpos = cp;
                    have = true;
                    if (best == 0) break;
                }
            }
            *mis_b = have ? best : BIG;
            *pos_b = bpos;
        };

        int32_t mis_f, pos_f, mis_r = BIG, pos_r = 0;
        strand(row, &mis_f, &pos_f, BIG);
        // RC can only be observed when mis_r < mis_f (use_rev rule), so
        // the scan bound starts at mis_f; mis_f == 0 skips RC entirely
        if (mis_f > 0) {
            for (int i = 0; i < lp; i++)
                rc[i] = i < len ? (uint8_t)(3 - row[len - 1 - i]) : 0;
            strand(rc.data(), &mis_r, &pos_r, mis_f < BIG ? mis_f : BIG);
        }
        const bool use_rev = mis_r < mis_f;
        const int32_t mis = use_rev ? mis_r : mis_f;
        const int32_t pos = use_rev ? pos_r : pos_f;
        const bool is_mapped = (mis <= max_mis) && !has_dege;
        mapped[r] = is_mapped ? 1 : 0;
        pos_out[r] = pos;
        rev_out[r] = (use_rev && is_mapped) ? 1 : 0;
        uint8_t* mm = mis_mask + r * lp;
        std::memset(mm, 0, lp);
        if (is_mapped) {
            const uint8_t* eff = use_rev ? rc.data() : row;
            for (int i = 0; i < len; i++) {
                int64_t idx = (int64_t)(uint32_t)pos + i;
                uint32_t shv = 2u * (15 - (idx & 15));
                uint8_t refb =
                    (uint8_t)((ix.packed[idx >> 4] >> shv) & 3u);
                mm[i] = eff[i] != refb ? 1 : 0;
            }
        }
    }
}

// One-indel rescue — decision-for-decision mirror of align/hash.py
// _indel_batch (strand_eval's exclusive-cumsum split scoring over +-G
// shifted compare windows, evaluated in the device's exact variant
// order so strict-< tie-breaks agree).  Anchors on each strand's best
// GAPLESS candidate from the seed search, whose position one_strand
// reproduces exactly for mapped AND unmapped reads (including the
// all-pruned and all-invalid fallbacks) — the indel tier observes the
// anchor of reads the gapless tiers failed.
extern "C" void fq_indel_batch(
    const uint64_t* keys, int64_t nk, const int32_t* offsets,
    const int32_t* positions, int64_t npos,
    const uint32_t* packed, int64_t nw,
    const int32_t* l1, int32_t l1_shift, int32_t search_steps,
    int32_t ref_len,
    const uint8_t* codes, const uint8_t* dege, const int64_t* roffs,
    const int32_t* lengths, int64_t R, int32_t lp,
    int32_t k, int32_t stride, int32_t n_cand, int32_t max_mis,
    int32_t n_seeds, int32_t excl_bp, int32_t probe_k, int32_t G,
    int32_t ops,
    uint8_t* found_out, int32_t* pos_out, int32_t* split_out,
    int32_t* gap_out, int32_t* split2_out, int32_t* gap2_out,
    uint8_t* rev_out, uint8_t* mis_mask) {
    Index ix{keys, nk, offsets, positions, npos, packed, nw,
             l1, l1_shift, search_steps, ref_len};
    Cfg cfg{k, stride, n_cand, max_mis, n_seeds, excl_bp, probe_k, lp};
    Workspace ws;
    ws.init(cfg);
    const int NG = 2 * G + 1;
    // per-strand scratch: E[(2G+1) x (len+1)], F[len+1], cmp rows
    std::vector<int32_t> E(NG * (lp + 1)), F(lp + 1);
    std::vector<uint8_t> cmp(NG * lp), lit(lp), rc(lp), rdege(lp);

    struct SRes {       // strand_eval outputs, decode-splice fields:
        // shift gA past sA, +gB past sB (sB=gB=0 when one op); jb is
        // segment 0's window row; pg/sg the 1-op rows for pass 2
        int32_t tot, sA, gA, sB, gB, po, jb, pg, sg;
    };

    for (int64_t r = 0; r < R; r++) {
        const uint8_t* row = codes + roffs[r];
        const uint8_t* drow = dege + roffs[r];
        int32_t len = lengths[r];
        if (len > lp) len = lp;
        bool has_dege = false;
        for (int i = 0; i < len && !has_dege; i++) has_dege = drow[i];

        auto strand_eval = [&](const uint8_t* c, const uint8_t* d) {
            int32_t mis_g, posi;
            one_strand(ix, cfg, ws, c, d, len, &mis_g, &posi);
            const bool ok_b = posi >= 2 * G &&
                (int64_t)posi + len + 2 * G <= ref_len;
            // compare rows vs the ref at shifts -G..+G and their
            // exclusive cumsums (only s <= len is ever unmasked)
            for (int j = 0; j < NG; j++) {
                const int g = j - G;
                int32_t* Ej = E.data() + j * (lp + 1);
                uint8_t* cj = cmp.data() + j * lp;
                Ej[0] = 0;
                for (int i = 0; i < len; i++) {
                    int64_t idx = (int64_t)posi + g + i;
                    if (idx < 0) idx = 0;
                    if (idx > ref_len - 1) idx = ref_len - 1;
                    const uint32_t shv = 2u * (15 - (idx & 15));
                    const uint8_t rb =
                        (uint8_t)((ix.packed[idx >> 4] >> shv) & 3u);
                    cj[i] = c[i] != rb ? 1 : 0;
                    Ej[i + 1] = Ej[i] + cj[i];
                }
            }
            F[0] = 0;
            for (int i = 0; i < len; i++) {
                lit[i] = c[i] != 0 ? 1 : 0;
                F[i + 1] = F[i] + lit[i];
            }
            const int32_t* E0 = E.data() + G * (lp + 1);
            SRes b{BIG, 0, 0, 0, 0, posi, 0, 0, 0};

            // first-occurrence argmin over s in [0, len - h], strict-<
            // variant chaining (the device's consider() order).  Every
            // variant is prefix-mismatches at one shift + suffix at
            // another, plus the literal-vs-filler cost of h inserted
            // bases between them:
            //   tot[s] = pref[s] + (F[s+h] - F[s]) + (suf[len] - suf[s+h])
            auto consider = [&](const int32_t* pref, const int32_t* suf,
                                int h, int32_t g_out, int32_t d_pos,
                                int32_t pg, int32_t sg) {
                const int32_t slim = len - h;
                int32_t tb = BIG, sb = 0;
                for (int32_t s = 0; s <= slim; s++) {
                    const int32_t tot = pref[s] + (F[s + h] - F[s])
                                        + (suf[len] - suf[s + h]);
                    if (tot < tb) { tb = tot; sb = s; }
                }
                if (tb < b.tot) {
                    b.tot = tb;
                    b.sA = sb;
                    b.gA = g_out;
                    b.po = posi + d_pos;
                    b.pg = pg + G;
                    b.sg = sg + G;
                    b.jb = pg + G;
                }
            };
            for (int g = -G; g <= G; g++) {
                if (g == 0) continue;
                const int32_t* Eg = E.data() + (g + G) * (lp + 1);
                const int h = g > 0 ? g : -g;
                if (g > 0) {
                    // A: seed in prefix, read DELETES g ref bases at s
                    consider(E0, Eg, 0, g, 0, 0, g);
                    // B: seed in suffix, gap -g = insertion of g bases
                    consider(Eg, E0, h, -g, g, g, 0);
                } else {
                    // A: seed in prefix, read INSERTS h bases at s
                    consider(E0, Eg, h, g, 0, 0, g);
                    // B: seed in suffix, gap -g = deletion of h bases
                    consider(Eg, E0, 0, -g, g, g, 0);
                }
            }
            if (!ok_b) b.tot = BIG;
            // pass 2 (greedy second op from the 1-op argmin): only when
            // one op is not enough.  Two families, device parity:
            //  TAIL: op2 at s2 >= s1+h1 moves the remainder to row
            //        sg+g2: tot = pref[s1] + lit1 + (Esg[s2]-Esg[s1+h1])
            //        + lit2 + (E2[len]-E2[s2+h2])
            //  HEAD: a new first op at s0 <= s1-hh re-bases the prefix
            //        [0,s0) to row pg+gh (output pos shifts by gh):
            //        tot = Ej0[s0] + lit0 + (Epg[s1]-Epg[s0+hh]) + lit1
            //        + (Esg[len]-Esg[s1+h1])
            // Gap ascending then split ascending, strict-< within each
            // family; head wins only if strictly better.
            if (ops >= 2 && b.tot > cfg.max_mis && b.tot < BIG) {
                const int h1 = b.gA < 0 ? -b.gA : 0;
                const int32_t s1 = b.sA;
                const int32_t* Epg = E.data() + b.pg * (lp + 1);
                const int32_t* Esg = E.data() + b.sg * (lp + 1);
                const int32_t op1_lit = F[s1 + h1] - F[s1];
                const int32_t base_c = Epg[s1] + op1_lit - Esg[s1 + h1];
                int32_t tt = BIG, st = 0, gt = 0;
                for (int g2 = -G; g2 <= G; g2++) {
                    if (g2 == 0) continue;
                    const int j2 = b.sg + g2;      // tail row index
                    if (j2 < 0 || j2 > 2 * G) continue;
                    const int32_t* E2 = E.data() + j2 * (lp + 1);
                    const int h2 = g2 < 0 ? -g2 : 0;
                    for (int32_t s2 = s1 + h1; s2 <= len - h2; s2++) {
                        const int32_t tot = base_c + Esg[s2]
                            + (F[s2 + h2] - F[s2])
                            + (E2[len] - E2[s2 + h2]);
                        if (tot < tt) { tt = tot; st = s2; gt = g2; }
                    }
                }
                const int32_t tail_c = op1_lit + Esg[len] - Esg[s1 + h1]
                                       + Epg[s1];
                int32_t th = BIG, sh = 0, gh_sel = 0;
                for (int gh = -G; gh <= G; gh++) {
                    if (gh == 0) continue;
                    const int j0 = b.pg + gh;      // new head row index
                    if (j0 < 0 || j0 > 2 * G) continue;
                    const int32_t* Ej0 = E.data() + j0 * (lp + 1);
                    const int hh = gh > 0 ? gh : 0;
                    for (int32_t s0 = 0; s0 <= s1 - hh; s0++) {
                        const int32_t tot = tail_c + Ej0[s0]
                            + (F[s0 + hh] - F[s0]) - Epg[s0 + hh];
                        if (tot < th) { th = tot; sh = s0; gh_sel = gh; }
                    }
                }
                const bool use_head = th < tt;
                const int32_t tbest = use_head ? th : tt;
                if (tbest < b.tot) {
                    b.tot = tbest;
                    if (use_head) {
                        b.sB = b.sA;
                        b.gB = b.gA;
                        b.sA = sh;
                        b.gA = -gh_sel;
                        b.jb = b.pg + gh_sel;
                        b.po += gh_sel;
                    } else {
                        b.sB = st;
                        b.gB = gt;
                    }
                }
            }
            return b;
        };

        SRes f = strand_eval(row, drow);
        SRes rv{BIG, 0, 0, 0, 0, 0, 0, 0, 0};
        bool rc_ran = false;
        if (f.tot > 0) {       // tot_r < tot_f needs tot_f > 0
            for (int i = 0; i < lp; i++) {
                rc[i] = i < len ? (uint8_t)(3 - row[len - 1 - i]) : 0;
                rdege[i] = i < len ? drow[len - 1 - i] : 0;
            }
            rv = strand_eval(rc.data(), rdege.data());
            rc_ran = true;
            // cmp/E/F/lit now hold the RC strand's rows — consistent
            // with the mask construction below when use_rev
        }
        const bool use_rev = rv.tot < f.tot;
        const SRes& b = use_rev ? rv : f;
        const bool is_found =
            b.tot <= max_mis && !has_dege && len >= k;
        found_out[r] = is_found ? 1 : 0;
        pos_out[r] = b.po;
        split_out[r] = b.sA;
        gap_out[r] = b.gA;
        split2_out[r] = b.sB;
        gap2_out[r] = b.gB;
        rev_out[r] = (use_rev && is_found) ? 1 : 0;
        uint8_t* mm = mis_mask + r * lp;
        std::memset(mm, 0, lp);
        if (is_found) {
            if (!use_rev && rc_ran) {
                // RC ran last and overwrote the scratch: rebuild the
                // forward strand's cmp/lit rows for the mask
                (void)strand_eval(row, drow);
            }
            // spliced-window mask: segment rows jb, jb+gA, jb+gA+gB,
            // literal filler over the insertion ranges (identical for
            // the 1-op case, where sB = gB = 0)
            const int32_t hA = b.gA < 0 ? -b.gA : 0;
            const int32_t hB = b.gB < 0 ? -b.gB : 0;
            const uint8_t* r0 = cmp.data() + b.jb * lp;
            const uint8_t* r1 = cmp.data() + (b.jb + b.gA) * lp;
            const uint8_t* r2 = cmp.data() + (b.jb + b.gA + b.gB) * lp;
            for (int i = 0; i < len; i++) {
                uint8_t v;
                if (i < b.sA) v = r0[i];
                else if (i < b.sA + hA) v = hA > 0 ? lit[i] : r1[i];
                else if (i < b.sB) v = r1[i];
                else if (i < b.sB + hB) v = hB > 0 ? lit[i] : r2[i];
                else v = r2[i];
                mm[i] = v;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Radix CSR index build (narrow k <= 15).  Rolling k-mer scan + 2-pass LSD
// counting sort on the 2k-bit key (stable, so positions stay ascending
// within a key) — bit-identical arrays to the numpy argsort path in
// align/index.py:build_from_ref, at O(n) instead of O(n log n).  The
// self-referential mode (pipeline/selfref.py) rebuilds the index several
// times per block, making build cost a first-order encode term.
// kv_out/pos_out/tmp_kv/tmp_pos: caller-allocated, size n - k + 1.
// Returns the number of valid (ambiguity-free) windows written.
// ---------------------------------------------------------------------------
extern "C" int64_t fq_csr_build(const uint8_t* codes, const uint8_t* amb,
                                int64_t n, int32_t k,
                                uint32_t* kv_out, uint32_t* pos_out,
                                uint32_t* tmp_kv, uint32_t* tmp_pos) {
    const int64_t P = n - (int64_t)k + 1;
    // P up to 2^32 - 1: counters/indices are int64, positions fit u32
    if (P <= 0 || P >= (int64_t)0xFFFFFFFF || k < 1 || k > 15) return 0;
    const uint32_t mask = (1u << (2 * k)) - 1;
    int64_t m = 0;
    uint32_t kv = 0;
    // clamped at k: an unbounded int32 counter overflows after 2^31
    // contiguous clean bases (>2 Gbp references) and silently drops
    // half the windows — caught by tools/bigref_check.py
    int32_t clean = 0;
    for (int64_t i = 0; i < n; ++i) {
        kv = ((kv << 2) | codes[i]) & mask;
        clean = amb[i] ? 0 : (clean < k ? clean + 1 : clean);
        if (clean >= k) {
            tmp_kv[m] = kv;
            tmp_pos[m] = (uint32_t)(i - k + 1);
            ++m;
        }
    }
    const int b1 = k;                    // low/high halves: k bits each
    const uint32_t m1 = (1u << b1) - 1;
    {
        std::vector<int64_t> cnt((size_t)1 << b1, 0);
        for (int64_t i = 0; i < m; ++i) ++cnt[tmp_kv[i] & m1];
        int64_t acc = 0;
        for (auto& c : cnt) { const int64_t t = c; c = acc; acc += t; }
        for (int64_t i = 0; i < m; ++i) {
            const int64_t d = cnt[tmp_kv[i] & m1]++;
            kv_out[d] = tmp_kv[i];
            pos_out[d] = tmp_pos[i];
        }
    }
    {
        std::vector<int64_t> cnt((size_t)1 << b1, 0);
        for (int64_t i = 0; i < m; ++i) ++cnt[kv_out[i] >> b1];
        int64_t acc = 0;
        for (auto& c : cnt) { const int64_t t = c; c = acc; acc += t; }
        for (int64_t i = 0; i < m; ++i) {
            const int64_t d = cnt[kv_out[i] >> b1]++;
            tmp_kv[d] = kv_out[i];
            tmp_pos[d] = pos_out[i];
        }
        std::memcpy(kv_out, tmp_kv, (size_t)m * 4);
        std::memcpy(pos_out, tmp_pos, (size_t)m * 4);
    }
    return m;
}

// Wide-key variant (-q tiers, k <= 31: 2k-bit keys as u64).  Same
// contract as fq_csr_build — rolling k-mers in position order + a
// STABLE LSD radix over 16-bit digits (ceil(2k/16) passes), so the
// (kv, pos) arrays are bit-identical to numpy's stable argsort path.
extern "C" int64_t fq_csr_build_wide(const uint8_t* codes,
                                     const uint8_t* amb,
                                     int64_t n, int32_t k,
                                     uint64_t* kv_out, uint32_t* pos_out,
                                     uint64_t* tmp_kv, uint32_t* tmp_pos) {
    const int64_t P = n - (int64_t)k + 1;
    if (P <= 0 || P >= (int64_t)0xFFFFFFFF || k < 1 || k > 31) return 0;
    const uint64_t mask =
        (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
    int64_t m = 0;
    uint64_t kv = 0;
    int32_t clean = 0;            // clamped at k (see fq_csr_build)
    for (int64_t i = 0; i < n; ++i) {
        kv = ((kv << 2) | codes[i]) & mask;
        clean = amb[i] ? 0 : (clean < k ? clean + 1 : clean);
        if (clean >= k) {
            tmp_kv[m] = kv;
            tmp_pos[m] = (uint32_t)(i - k + 1);
            ++m;
        }
    }
    const int passes = (2 * k + 15) / 16;
    uint64_t* src_k = tmp_kv;  uint32_t* src_p = tmp_pos;
    uint64_t* dst_k = kv_out;  uint32_t* dst_p = pos_out;
    std::vector<int64_t> cnt((size_t)1 << 16);
    for (int pass = 0; pass < passes; ++pass) {
        const int sh = 16 * pass;
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t i = 0; i < m; ++i)
            ++cnt[(src_k[i] >> sh) & 0xFFFF];
        int64_t acc = 0;
        for (auto& c : cnt) { const int64_t t = c; c = acc; acc += t; }
        for (int64_t i = 0; i < m; ++i) {
            const int64_t d = cnt[(src_k[i] >> sh) & 0xFFFF]++;
            dst_k[d] = src_k[i];
            dst_p[d] = src_p[i];
        }
        std::swap(src_k, dst_k);
        std::swap(src_p, dst_p);
    }
    if (src_k != kv_out) {      // odd pass count: result sits in tmp
        std::memcpy(kv_out, src_k, (size_t)m * 8);
        std::memcpy(pos_out, src_p, (size_t)m * 4);
    }
    return m;
}

// ---------------------------------------------------------------------------
// One-pass self-referential alignment (pipeline/selfref.py).
//
// The index covers a reference built from ALL candidate reads (block
// order).  Reads are processed in block order; read r may map only to a
// window that (a) ends at or before r's own span start (strictly earlier
// reads — so every constraint input is already decided), (b) lies within
// a SINGLE earlier read's span, and (c) that read is still KEPT
// (unmapped).  Accepted reads are removed from the final reference, so
// positions are emitted directly in FINAL reference coordinates via the
// kept-prefix running sum.  This replaces the wave loop (align against a
// growing prefix, rebuild the index geometrically): one index build, one
// native pass, and reads can map to ANY earlier kept read instead of only
// previous waves.  Encoder policy only — decode consumes the emitted
// flags/positions and rebuilds the identical reference (ref_eligible).
//
// No device twin exists (self-ref forces host execution; the decision
// loop is sequential by construction).  The bit-identical mirror is
// pipeline/selfref._selfref_align_py, cross-checked in tests.
// Decision rule per strand: seeds in least-occurrence-first order
// (first-occurrence argmin, +-excl_bp masking after each pick), first
// seed capped at c1 candidates, later seeds at c2; full-window verify of
// every constraint-surviving candidate, first-occurrence strict-< argmin;
// the seed loop stops once the running best is <= max_mis.  Forward
// strand first; RC only when forward failed (fallback rule), or better-
// of-both when both_strands.
// ---------------------------------------------------------------------------
namespace {

struct SelfCtx {
    const int32_t* span_start;   // E + 1 (ends with allref_len)
    const uint8_t* kept;
    const int32_t* fstart;
    int64_t n_spans;
};

// last span with start <= cp
static inline int64_t owner_of(const SelfCtx& sc, int32_t cp) {
    int64_t lo = 0, hi = sc.n_spans;        // invariant: start[lo] <= cp
    while (lo + 1 < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (sc.span_start[mid] <= cp) lo = mid; else hi = mid;
    }
    return lo;
}

// Masked-range mismatch count: only window offsets in [v0, v1) compare;
// everything else is pre-masked out (those bases are force-patched).
static inline int32_t mis_range(const Index& ix, uint32_t cp,
                                const uint32_t* rw, const uint32_t* mw,
                                int W, int32_t bound, int32_t v0,
                                int32_t v1) {
    const int64_t w0 = (int64_t)(cp >> 4);
    const uint32_t sh = 2u * (cp & 15u);
    const int32_t ph = (int32_t)(cp & 15u);
    int32_t m = 0;
    for (int j = 0; j <= W && m < bound; j++) {
        const int32_t o0 = 16 * j - ph;     // window offset of lane 0
        int32_t lo = v0 - o0, hi = v1 - o0;
        if (lo < 0) lo = 0;
        if (hi > 16) hi = 16;
        if (lo >= hi) continue;
        const uint32_t rmask =
            (lo >= 16 ? 0u : (0xFFFFFFFFu >> (2 * lo)))
            & ~(hi >= 16 ? 0u : (0xFFFFFFFFu >> (2 * hi)));
        uint32_t refw = ix.packed[w0 + j];
        uint32_t rsel = frame_word(rw, W, j, sh);
        uint32_t msel = frame_word(mw, W, j, sh);
        m += mis2bit((rsel ^ refw) & msel & rmask);
    }
    return m;
}

struct SelfHit {
    int32_t mis;     // anchored mismatches + masked-overflow penalty
    int32_t cp;      // all-ref window start
    int32_t fpos;    // FINAL-reference window start
    int32_t v0, v1;  // verified (anchor-span) range in window offsets
};

static void one_strand_self(const Index& ix, const Cfg& cfg, Workspace& ws,
                            const SelfCtx& sc, int32_t my_start,
                            int32_t c2, const uint8_t* row,
                            const uint8_t* drow, int32_t len,
                            SelfHit* hit) {
    const int lp = cfg.lp, k = cfg.k, W = cfg.n_words();
    const int P = lp - k + 1;
    const int S = (P + cfg.stride - 1) / cfg.stride;
    ws.epoch++;

    const uint64_t kmask = (k >= 32) ? ~uint64_t(0)
                                     : ((uint64_t(1) << (2 * k)) - 1);
    {
        uint64_t v = 0;
        int32_t c = 0;
        ws.cs[0] = 0;
        for (int i = 0; i < len; i++) {
            v = ((v << 2) | row[i]) & kmask;
            c += drow[i] ? 1 : 0;
            ws.cs[i + 1] = c;
            if (i >= k - 1) ws.kv[i - k + 1] = v;
        }
        for (int i = len; i < lp; i++) {
            v = (v << 2) & kmask;
            ws.cs[i + 1] = c;
            if (i >= k - 1) ws.kv[i - k + 1] = v;
        }
    }
    for (int s = 0; s < S; s++) {
        int q = s * cfg.stride;
        ws.psv[s] = q;
        const uint64_t v = ws.kv[q];
        bool ok_s = (q <= len - k) && (ws.cs[q + k] - ws.cs[q]) == 0;
        int64_t bq = (int64_t)(v >> ix.l1_shift);
        int64_t lo = ix.l1[bq], hi = ix.l1[bq + 1];
        int64_t hi0 = hi;
        for (int t = 0; t < ix.search_steps; t++) {
            bool active = lo < hi;
            int64_t mid = (lo + hi) >> 1;
            int64_t m = mid < ix.nk - 1 ? mid : ix.nk - 1;
            bool less = ix.keys[m] < v;
            if (active && less) lo = mid + 1;
            if (active && !less) hi = mid;
        }
        int64_t i2 = lo < ix.nk - 1 ? lo : ix.nk - 1;
        ws.ii[s] = i2;
        bool found = (ix.keys[i2] == v) && (lo < hi0) && ok_s;
        // EFFECTIVE occurrence: only positions this read may use — the
        // window must end at or before its own span (pos <= my_start -
        // len + q; bucket positions are ascending, one upper_bound).
        // In the all-reads index the read's own (and later reads')
        // positions would otherwise dominate the least-occurrence seed
        // choice: an error seed unique to the read itself has occ == 1
        // and always looks "most specific" while yielding zero usable
        // candidates.
        int32_t eff = 0;
        if (found) {
            // window must overlap a single EARLIER span by at least
            // len - max_mis bases: cp + (len - max_mis) <= my_start
            const int32_t limit = my_start - len + cfg.max_mis + q;
            const int32_t* b = ix.positions + ix.offsets[i2];
            const int32_t* e2 = ix.positions + ix.offsets[i2 + 1];
            eff = (int32_t)(std::upper_bound(b, e2, limit) - b);
        }
        ws.occ[s] = eff > 0 ? eff : BIG;
    }

    std::fill(ws.rw.begin(), ws.rw.end(), 0u);
    std::fill(ws.mw.begin(), ws.mw.end(), 0u);
    for (int i = 0; i < len; i++) {
        uint32_t shv = 2u * (15 - (i & 15));
        ws.rw[i >> 4] |= ((uint32_t)row[i]) << shv;
        ws.mw[i >> 4] |= 3u << shv;
    }
    const uint32_t* rw = ws.rw.data();
    const uint32_t* mw = ws.mw.data();

    int32_t* occv = ws.occ.data();
    SelfHit best{BIG, 0, 0, 0, len};
    for (int it = 0; it < cfg.n_seeds; it++) {
        if (best.mis <= cfg.max_mis) break;      // seed-level early stop
        int jb = 0;
        for (int s = 1; s < S; s++) if (occv[s] < occv[jb]) jb = s;
        if (occv[jb] >= BIG) break;              // no seed hits the index
        int32_t occ_best = occv[jb];
        int32_t pb = ws.psv[jb];
        if (cfg.excl_bp > 0) {
            for (int s = 0; s < S; s++)
                if (std::abs(ws.psv[s] - pb) <= cfg.excl_bp) occv[s] = BIG;
        } else {
            occv[jb] = BIG;
        }
        const int32_t cap = it == 0 ? cfg.n_cand : c2;
        int64_t base = ix.offsets[ws.ii[jb]];
        int32_t lim = occ_best < cap ? occ_best : cap;   // eff occ: all
        const int32_t* posp = ix.positions + base;       // usable windows
        for (int cj = 0; cj < lim; cj++) {
            int32_t cp_i = posp[cj] - pb;
            if (cp_i < 0) continue;
            // anchor: the single earlier-kept span the window overlaps
            // most; every base outside it is force-masked (patched) and
            // counts as a mismatch — junction-crossing near-duplicates
            // (the dominant match class at coverage) stay mappable
            const int64_t e0 = owner_of(sc, cp_i);
            const int32_t se0 = sc.span_start[e0 + 1];
            int64_t anchor = e0;
            int32_t v0 = 0, v1 = len;
            if (cp_i + len > se0) {
                const int32_t l0 = se0 - cp_i;
                int32_t r1 = 0;
                if (e0 + 1 < sc.n_spans) {
                    const int32_t se1 = sc.span_start[e0 + 2];
                    const int32_t we = cp_i + len < se1 ? cp_i + len : se1;
                    r1 = we - sc.span_start[e0 + 1];
                }
                if (l0 >= r1) {
                    v1 = l0;
                } else {
                    anchor = e0 + 1;
                    v0 = l0;
                    v1 = l0 + r1;
                }
            }
            const int32_t ov = len - (v1 - v0);
            if (ov > cfg.max_mis) continue;
            if (sc.span_start[anchor] >= my_start || !sc.kept[anchor])
                continue;
            const int32_t fpos =
                sc.fstart[anchor] + (cp_i - sc.span_start[anchor]);
            if (fpos < 0) continue;
            const uint32_t cp = (uint32_t)cp_i;
            const uint32_t h = ws.slot(cp);
            if (ws.hep[h] == ws.epoch) continue;   // duplicate position
            ws.hep[h] = ws.epoch;
            ws.hkey[h] = cp;
            if (cj + 8 < lim) {
                int32_t nxt = posp[cj + 8] - pb;
                if (nxt >= 0) __builtin_prefetch(ix.packed + (nxt >> 4));
            }
            const int32_t bound = best.mis - ov;   // need range-mis < this
            if (bound <= 0) continue;
            const int32_t m = mis_range(ix, cp, rw, mw, W, bound, v0, v1);
            const int32_t tot = m + ov;
            if (tot < best.mis) {
                best = SelfHit{tot, cp_i, fpos, v0, v1};
                if (tot == 0) break;
            }
        }
        if (best.mis == 0) break;
    }
    *hit = best;
}

}  // namespace

extern "C" int64_t fq_selfref_align(
    const uint64_t* keys, int64_t nk, const int32_t* offsets,
    const int32_t* positions, int64_t npos,
    const uint32_t* packed, int64_t nw,
    const int32_t* l1, int32_t l1_shift, int32_t search_steps,
    int32_t allref_len,
    const uint8_t* codes, const uint8_t* dege, const int64_t* roffs,
    const int32_t* lengths, int64_t R, int32_t lp,
    const uint8_t* alignable, const uint8_t* is_cand,
    int32_t k, int32_t stride, int32_t c1, int32_t c2,
    int32_t n_seeds, int32_t excl_bp, int32_t max_mis,
    int32_t both_strands,
    uint8_t* mapped, int32_t* pos_out, uint8_t* rev_out,
    uint8_t* mis_mask) {
    Index ix{keys, nk, offsets, positions, npos, packed, nw,
             l1, l1_shift, search_steps, allref_len};
    Cfg cfg{k, stride, c1, max_mis, n_seeds, excl_bp, /*probe_k=*/0, lp};
    Workspace ws;
    {
        // size the position-dedup hash for the LARGER per-seed cap (the
        // rescue seeds use c2 > c1; an overfull open-address table would
        // loop forever inside slot())
        Cfg sizing = cfg;
        sizing.n_cand = c2 > c1 ? c2 : c1;
        ws.init(sizing);
    }

    // candidate span table (block order, contiguous in the all-ref)
    int64_t E = 0;
    for (int64_t r = 0; r < R; r++) E += is_cand[r] ? 1 : 0;
    std::vector<int32_t> span_start(E + 1), fstart(E, 0), span_read(E);
    std::vector<uint8_t> kept(E, 0);
    {
        int64_t e = 0;
        int32_t acc = 0;
        for (int64_t r = 0; r < R; r++) {
            if (!is_cand[r]) continue;
            span_start[e] = acc;
            span_read[e] = (int32_t)r;
            acc += lengths[r];
            e++;
        }
        span_start[E] = acc;
    }
    SelfCtx sc{span_start.data(), kept.data(), fstart.data(), E};

    int64_t n_mapped = 0;
    int32_t run_len = 0;
    int64_t e = 0;
    for (int64_t r = 0; r < R; r++) {
        const int32_t len0 = lengths[r];
        const bool cand = is_cand[r] != 0;
        const int32_t my_start = cand ? span_start[e] : span_start[E];
        uint8_t* mm = mis_mask + r * lp;
        std::memset(mm, 0, lp);
        mapped[r] = 0;
        pos_out[r] = 0;
        rev_out[r] = 0;
        bool is_mapped = false;
        if (alignable[r] && E > 0 && my_start >= k) {
            const uint8_t* row = codes + roffs[r];
            const uint8_t* drow = dege + roffs[r];
            int32_t len = len0 > lp ? lp : len0;
            SelfHit hf{BIG, 0, 0, 0, len}, hr{BIG, 0, 0, 0, len};
            one_strand_self(ix, cfg, ws, sc, my_start, c2, row, drow, len,
                            &hf);
            const bool need_rc = both_strands || hf.mis > max_mis;
            if (need_rc) {
                for (int i = 0; i < lp; i++) {
                    ws.rc[i] = i < len ? (uint8_t)(3 - row[len - 1 - i]) : 0;
                    ws.rdege[i] = i < len ? drow[len - 1 - i] : 0;
                }
                one_strand_self(ix, cfg, ws, sc, my_start, c2,
                                ws.rc.data(), ws.rdege.data(), len, &hr);
            }
            bool use_rev;
            if (both_strands) use_rev = hr.mis < hf.mis;
            else use_rev = hf.mis > max_mis;
            const SelfHit& b = use_rev ? hr : hf;
            if (b.mis <= max_mis) {
                is_mapped = true;
                pos_out[r] = b.fpos;
                rev_out[r] = use_rev ? 1 : 0;
                const uint8_t* eff = use_rev ? ws.rc.data() : row;
                for (int i = 0; i < len; i++) {
                    if (i < b.v0 || i >= b.v1) {  // masked overflow:
                        mm[i] = 1;                // always patched
                        continue;
                    }
                    int64_t idx = (int64_t)(uint32_t)b.cp + i;
                    int64_t wi = idx >> 4;
                    if (wi > ix.nw - 1) wi = ix.nw - 1;
                    uint32_t shv = 2u * (15 - (idx & 15));
                    uint8_t refb = (uint8_t)((ix.packed[wi] >> shv) & 3u);
                    mm[i] = eff[i] != refb ? 1 : 0;
                }
                n_mapped++;
            }
        }
        mapped[r] = is_mapped ? 1 : 0;
        if (cand) {
            if (!is_mapped) {
                kept[e] = 1;
                fstart[e] = run_len;
                run_len += len0;
            }
            e++;
        }
    }
    return n_mapped;
}
