"""Batched seed-and-extend gapless aligner (device-side).

Capability parity with the reference's HashAlignment (SURVEY.md §2.2,
srcfile:HashAlignment.cpp: getHashSeeds @0x4107f0 rolling k-mers +
packed-word compare units, findHashSeeds @0x4108d0 least-frequent-seed
selection sampled every 2 bp, gaplessHashAlignPositions/hashAligner
@0x410990/0x410f50 packed-XOR gapless compare with <= Maxmis accept and a
reverse-complement fallback).

Accelerator-first redesign: the per-read serial loop becomes one jitted batch over
(B, Lp) fixed-shape code grids —

* rolling k-mers for *every* position via k shifted adds,
* seed lookup = vectorized binary search over the CSR key array
  (jnp.searchsorted) instead of a dense 4^k table,
* candidate verification = gathers of 2-bit packed reference words + funnel
  shift + XOR + ``lax.population_count`` (the packed-16-mer-compare idea,
  vectorized over B reads x C candidates at once),
* RC fallback runs the identical pipeline on the reverse-complemented grid.

Everything is static-shaped and branch-free; per-block host code buckets
reads into (B, Lp) grids.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from fastqueeze_tpu.align.index import RefIndex
from fastqueeze_tpu.config import CodecParams

_BIG = jnp.int32(1 << 28)


@dataclass(frozen=True)
class AlignConfig:
    k: int
    stride: int
    n_cand: int          # candidate positions verified per read (per seed)
    max_mis: int
    both_strands: int
    lp: int              # padded read length (multiple of 16)
    n_seeds: int = 1     # how many least-frequent seeds contribute candidates
    excl_bp: int = 0     # exclude +-excl_bp around a picked seed's position
                         # before the next pick (spatial diversity: an error
                         # corrupts ~k/stride consecutive sampled seeds, so
                         # successive argmin picks would cluster on errors)
    l1_shift: int = -1   # >= 0: first-level bucket table is present
    search_steps: int = 16   # binary-search steps within a bucket
    wide: bool = False   # k > 15: 2k-bit keys as (hi, lo30) u32 pairs
    strand: str = "both"     # "fwd" / "rc": single-strand pass (the host
                             # tiers forward first and runs RC only on the
                             # reads forward failed — RC is a *fallback* in
                             # the reference, so a forward-mapped read
                             # never pays the RC lookup+verify)
    probe_k: int = 1024      # two-probe-word prefilter keeps the top-K
                             # candidates for full verify when the list is
                             # > 2K deep (tier-2 rescue); tier 1 sets a
                             # small K to halve its verify gathers
    shard_axis: str = ""     # non-empty: keys/offsets/positions are key-
                             # range shards over this mesh axis; lookups
                             # combine with pmin/pmax collectives and each
                             # shard verifies its slice of the candidates
                             # (SURVEY.md §2.3: index sharded over the devices)

    @property
    def n_words(self) -> int:
        return self.lp // 16


class AlignResult(NamedTuple):
    mapped: np.ndarray    # (R,) bool
    pos: np.ndarray       # (R,) int64 window start in ref coords
    is_rev: np.ndarray    # (R,) bool
    mis_mask: np.ndarray  # (R, Lp) bool, True at mismatch (window coords)
    # one-indel alignments (reference CigaL/CigaV parity, the BWA path's
    # indel capability, SURVEY.md §2.1): split position s and signed gap g.
    # g > 0: read skips g ref bases at s (deletion in the read); g < 0:
    # |g| read bases at s are insertions (coded as literal patches).  The
    # spliced window is read-length long: ref[pos+i] for i<s, then
    # ref[pos+g+i] (filler 0 under insertions).  None = all gapless.
    gap_pos: np.ndarray = None   # (R,) int32 split s (0 where gapless)
    gap_len: np.ndarray = None   # (R,) int32 signed gap g (0 = gapless)
    # optional second op (reference multi-op CigaL/CigaV generality):
    # applies after op1 at s2 >= s1 + max(-g1, 0); cumulative shift
    # g1 + g2 past s2.  0 = read has at most one op.
    gap_pos2: np.ndarray = None  # (R,) int32 second split s2
    gap_len2: np.ndarray = None  # (R,) int32 second signed gap g2
    # long-read tier (no reference equivalent): chunk-level alignment of
    # reads > align_max_len — (reads, offs, clens, sub AlignResult) in
    # the deterministic _lr_grid order, or None
    chunks: tuple = None


def config_from_params(p: CodecParams, lp: int) -> AlignConfig:
    return AlignConfig(k=p.seed_len, stride=p.seed_stride,
                       n_cand=p.seed_max_occ, max_mis=p.max_mis,
                       both_strands=p.both_strands, lp=lp)


def _pack_words(codes, mask, lp):
    """(B, Lp) 2-bit codes + validity -> (B, W) uint32 MSB-first words and
    (B, W) uint32 2-bit-slot masks (0b11 where valid)."""
    B = codes.shape[0]
    W = lp // 16
    c = jnp.where(mask, codes.astype(jnp.uint32), 0).reshape(B, W, 16)
    m = jnp.where(mask, jnp.uint32(3), 0).reshape(B, W, 16)
    shifts = (2 * (15 - jnp.arange(16, dtype=jnp.uint32)))[None, None, :]
    return (c << shifts).sum(axis=2, dtype=jnp.uint32), \
           (m << shifts).sum(axis=2, dtype=jnp.uint32)


def _mis2bit(x):
    """Count differing 2-bit slots in XOR word(s)."""
    y = (x | (x >> 1)) & jnp.uint32(0x55555555)
    return lax.population_count(y).astype(jnp.int32)


def _read_in_ref_frame(rw, mw, j, sh):
    """Read (and mask) word j of the candidate's ALIGNED ref frame, built
    from broadcast per-read packed words by per-candidate register shifts
    — no gathers.  sh = 2 * (cand & 15), shape (B, C); rw/mw (B, W)."""
    W = rw.shape[1]
    shl = 32 - jnp.maximum(sh, 1)

    def sel(arr):
        a = arr[:, None, j - 1] if 1 <= j <= W else jnp.uint32(0)
        b = arr[:, None, j] if j < W else jnp.uint32(0)
        hi = jnp.where(sh > 0, a << shl, 0) if j >= 1 else jnp.uint32(0)
        return hi | (b >> sh)

    return sel(rw), sel(mw)


def _mis_aligned(packed, cand, rw, mw, js=None):
    """Mismatch counts with ONE gather per 16-base ref word: ref words are
    fetched at their natural alignment (packed[cand>>4 + j]) and the READ
    is funnel-shifted into that frame in registers (_read_in_ref_frame).
    Halves the verify's gather traffic vs re-aligning the ref per
    candidate (the aligner is gather-bound).  js selects a subset of
    frame words (prefilter probes); None = all W+1 (exact window count —
    each valid read base lands in exactly one frame word)."""
    B, W = rw.shape
    nw = packed.shape[0]
    w0 = lax.shift_right_logical(cand, jnp.asarray(4, cand.dtype)).astype(
        jnp.int32)
    ph = (cand & jnp.asarray(15, cand.dtype)).astype(jnp.uint32)
    sh = 2 * ph
    mis = jnp.zeros(cand.shape, jnp.int32)
    for j in (range(W + 1) if js is None else js):
        refw = packed[jnp.clip(w0 + j, 0, nw - 1)]
        rsel, msel = _read_in_ref_frame(rw, mw, j, sh)
        mis = mis + _mis2bit((rsel ^ refw) & msel)
    return mis


def _ref_base_at(packed, idx):
    """Gather single 2-bit codes at absolute positions idx."""
    w = packed[jnp.clip(lax.shift_right_logical(idx, jnp.asarray(4, idx.dtype)),
                        0, packed.shape[0] - 1)]
    sh = 2 * (15 - (idx & jnp.asarray(15, idx.dtype))).astype(jnp.uint32)
    return ((w >> sh) & 3).astype(jnp.uint8)


def _one_strand(cfg: AlignConfig, keys, offsets, positions, packed, l1,
                ref_len, codes, dege, lengths):
    """codes (B, Lp) effective-strand 2-bit codes; returns per-read
    (best_mis, best_pos) over the candidate set."""
    B, Lp = codes.shape
    k, stride, C = cfg.k, cfg.stride, cfg.n_cand
    P = Lp - k + 1

    pos_i = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    base_valid = pos_i < lengths[:, None]

    keys_hi, keys_lo = keys
    # rolling k-mers at every start position.  Narrow mode (k <= 15): one
    # u32 per position.  Wide mode ("-q" long seeds, k <= 31, the BWA-SMEM
    # specificity analogue, SURVEY.md C14): 2k-bit keys as (hi, lo30) pairs.
    if cfg.wide:
        hi_mask = jnp.uint32((1 << (2 * k - 30)) - 1)
        kv_lo = jnp.zeros((B, P), jnp.uint32)
        kv_hi = jnp.zeros((B, P), jnp.uint32)
        for j in range(k):
            b = codes[:, j:j + P].astype(jnp.uint32)
            kv_hi = ((kv_hi << 2) | (kv_lo >> 28)) & hi_mask
            kv_lo = ((kv_lo << 2) | b) & jnp.uint32(0x3FFFFFFF)
    else:
        kv = jnp.zeros((B, P), jnp.uint32)
        for j in range(k):
            kv = (kv << 2) | codes[:, j:j + P].astype(jnp.uint32)
    # window validity: inside read and degenerate-free
    cs = jnp.cumsum(dege.astype(jnp.int32), axis=1)
    csz = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), cs], axis=1)
    win_dege = (csz[:, k:] - csz[:, :-k]) > 0
    win_valid = (jnp.arange(P, dtype=jnp.int32)[None, :]
                 <= (lengths[:, None] - k)) & ~win_dege

    # sample every `stride` positions; least-frequent seed(s) win
    ps = np.arange(0, P, stride, dtype=np.int32)
    ok_s = win_valid[:, ps]
    nk = keys_hi.shape[0]
    if cfg.shard_axis:
        # index-sharded lookup: this device holds one key-range shard of
        # the CSR.  Every key lives on exactly one shard, so a local
        # binary search + pmin over the shard axis yields the global
        # occurrence counts (non-owners contribute _BIG).
        q_hi = kv_hi[:, ps] if cfg.wide else kv[:, ps]
        q_lo = kv_lo[:, ps] if cfg.wide else None
        lo = jnp.zeros(q_hi.shape, jnp.int32)
        hi = jnp.full(q_hi.shape, nk, jnp.int32)
        for _ in range(cfg.search_steps):
            active = lo < hi
            mid = (lo + hi) >> 1
            m = jnp.minimum(mid, nk - 1)
            if cfg.wide:
                km_hi = keys_hi[m]
                km_lo = keys_lo[m]
                less = (km_hi < q_hi) | ((km_hi == q_hi) & (km_lo < q_lo))
            else:
                less = keys_hi[m] < q_hi
            lo = jnp.where(active & less, mid + 1, lo)
            hi = jnp.where(active & ~less, mid, hi)
        ii = jnp.minimum(lo, nk - 1)
        eq = keys_hi[ii] == q_hi
        if cfg.wide:
            eq = eq & (keys_lo[ii] == q_lo)
        found_loc = eq & (lo < nk) & ok_s
        occ_loc = jnp.where(
            found_loc, (offsets[ii + 1] - offsets[ii]).astype(jnp.int32),
            _BIG)
        occ = lax.pmin(occ_loc, cfg.shard_axis)

        # all coordinates are uint32 (refs up to 4 G positions without
        # jax x64): a window start that would underflow 0 wraps huge and
        # fails the `cand <= ref_len - length` bound check instead
        cand_list, ok_list = [], []
        C = cfg.n_cand
        cj = jnp.arange(C, dtype=jnp.int32)[None, :]
        ps_j = jnp.asarray(ps, jnp.int32)[None, :]
        s_idx = jnp.arange(occ.shape[1], dtype=jnp.int32)[None, :]
        ref_len_u = ref_len.astype(jnp.uint32)
        max_start = ref_len_u - lengths.astype(jnp.uint32)   # (B,)
        len_fits = lengths.astype(jnp.uint32) <= ref_len_u
        for _ in range(cfg.n_seeds):
            j_best = jnp.argmin(occ, axis=1)
            occ_best = jnp.take_along_axis(occ, j_best[:, None], axis=1)[:, 0]
            if cfg.excl_bp > 0:
                pb = jnp.take_along_axis(ps_j.repeat(occ.shape[0], 0),
                                         j_best[:, None], axis=1)
                occ = jnp.where(jnp.abs(ps_j - pb) <= cfg.excl_bp, _BIG, occ)
            else:
                occ = jnp.where(s_idx == j_best[:, None], _BIG, occ)
            seed_off = jnp.asarray(ps, jnp.int32)[j_best]
            owner = jnp.take_along_axis(found_loc, j_best[:, None],
                                        axis=1)[:, 0]
            key_idx = jnp.take_along_axis(ii, j_best[:, None], axis=1)[:, 0]
            base = offsets[key_idx].astype(jnp.int32)
            in_range = cj < jnp.minimum(occ_best, C)[:, None]
            ptr = jnp.clip(base[:, None] + cj, 0, positions.shape[0] - 1)
            cand_loc = (positions[ptr].astype(jnp.uint32)
                        - seed_off[:, None].astype(jnp.uint32))
            cand_loc = jnp.where(owner[:, None], cand_loc, jnp.uint32(0))
            cand = lax.pmax(cand_loc, cfg.shard_axis)
            has_owner = lax.pmax(owner.astype(jnp.int32),
                                 cfg.shard_axis) > 0
            cand_list.append(cand)
            ok_list.append(in_range & has_owner[:, None] & len_fits[:, None]
                           & (cand <= max_start[:, None]))
        cand = jnp.concatenate(cand_list, axis=1)
        cand_ok = jnp.concatenate(ok_list, axis=1)

        # sharded verification: shard s checks its slice of the candidate
        # list against the (replicated) packed reference; the global best
        # is a pmin on mis, then a pmin on pos among the mis-minimizers
        D = lax.axis_size(cfg.shard_axis)
        S = cand.shape[1]
        Cs = -(-S // D)
        pad = Cs * D - S
        if pad:
            cand = jnp.pad(cand, ((0, 0), (0, pad)))
            cand_ok = jnp.pad(cand_ok, ((0, 0), (0, pad)))
        d = lax.axis_index(cfg.shard_axis)
        cand_s = lax.dynamic_slice_in_dim(cand, d * Cs, Cs, 1)
        ok_sl = lax.dynamic_slice_in_dim(cand_ok, d * Cs, Cs, 1)
        rw, mw = _pack_words(codes, base_valid, Lp)
        mis = _mis_aligned(packed, cand_s, rw, mw)
        mis = jnp.where(ok_sl, mis, _BIG)
        c_best = jnp.argmin(mis, axis=1)
        mis_b = jnp.take_along_axis(mis, c_best[:, None], axis=1)[:, 0]
        pos_b = jnp.take_along_axis(cand_s, c_best[:, None], axis=1)[:, 0]
        mis_g = lax.pmin(mis_b, cfg.shard_axis)
        pos_b = jnp.where(mis_b == mis_g, pos_b, jnp.uint32(0xFFFFFFFF))
        pos_g = lax.pmin(pos_b, cfg.shard_axis)
        return mis_g, pos_g
    if cfg.wide:
        q_hi = kv_hi[:, ps]
        q_lo = kv_lo[:, ps]
        # bucket id = full key >> l1_shift, assembled from the pair
        if cfg.l1_shift >= 30:
            q = (q_hi >> (cfg.l1_shift - 30)).astype(jnp.int32)
        else:
            q = ((q_hi << (30 - cfg.l1_shift))
                 | (q_lo >> cfg.l1_shift)).astype(jnp.int32)
        lo = l1[q].astype(jnp.int32)
        hi = l1[q + 1].astype(jnp.int32)
        hi0 = hi
        for _ in range(cfg.search_steps):
            active = lo < hi
            mid = (lo + hi) >> 1
            m = jnp.minimum(mid, nk - 1)
            km_hi = keys_hi[m]
            km_lo = keys_lo[m]
            less = (km_hi < q_hi) | ((km_hi == q_hi) & (km_lo < q_lo))
            lo = jnp.where(active & less, mid + 1, lo)
            hi = jnp.where(active & ~less, mid, hi)
        ii = jnp.minimum(lo, nk - 1)
        found = ((keys_hi[ii] == q_hi) & (keys_lo[ii] == q_lo)
                 & (lo < hi0) & ok_s)
    else:
        kv_s = kv[:, ps]
        if cfg.l1_shift >= 0:
            # bucket-bounded lower_bound: the first-level table narrows the
            # range to one key-prefix bucket, then a fixed-step binary
            # search runs inside it (fewer scattered gathers)
            q = (kv_s >> cfg.l1_shift).astype(jnp.int32)
            lo = l1[q].astype(jnp.int32)
            hi = l1[q + 1].astype(jnp.int32)
            hi0 = hi
            for _ in range(cfg.search_steps):
                active = lo < hi
                mid = (lo + hi) >> 1
                km = keys_hi[jnp.minimum(mid, nk - 1)]
                less = km < kv_s
                lo = jnp.where(active & less, mid + 1, lo)
                hi = jnp.where(active & ~less, mid, hi)
            ii = jnp.minimum(lo, nk - 1)
            found = (keys_hi[ii] == kv_s) & (lo < hi0) & ok_s
        else:
            ii = jnp.clip(jnp.searchsorted(keys_hi, kv_s), 0, nk - 1)
            found = (keys_hi[ii] == kv_s) & ok_s
    occ = jnp.where(found,
                    (offsets[ii + 1] - offsets[ii]).astype(jnp.int32), _BIG)

    # candidate windows from the cfg.n_seeds least-frequent seeds' CSR slices
    cand_list, ok_list = [], []
    cj = jnp.arange(C, dtype=jnp.int32)[None, :]
    s_idx = jnp.arange(occ.shape[1], dtype=jnp.int32)[None, :]
    ps_j = jnp.asarray(ps, jnp.int32)[None, :]
    for _ in range(cfg.n_seeds):
        j_best = jnp.argmin(occ, axis=1)
        occ_best = jnp.take_along_axis(occ, j_best[:, None], axis=1)[:, 0]
        if cfg.excl_bp > 0:
            pb = jnp.take_along_axis(ps_j.repeat(occ.shape[0], 0),
                                     j_best[:, None], axis=1)
            occ = jnp.where(jnp.abs(ps_j - pb) <= cfg.excl_bp, _BIG, occ)
        else:
            occ = jnp.where(s_idx == j_best[:, None], _BIG, occ)
        seed_off = jnp.asarray(ps, jnp.int32)[j_best]
        key_idx = jnp.take_along_axis(ii, j_best[:, None], axis=1)[:, 0]
        base = offsets[key_idx].astype(jnp.int32)
        in_range = cj < jnp.minimum(occ_best, C)[:, None]
        ptr = jnp.clip(base[:, None] + cj, 0, positions.shape[0] - 1)
        cand = positions[ptr].astype(jnp.int32) - seed_off[:, None]
        cand_list.append(cand)
        ok_list.append(in_range & (cand >= 0)
                       & (cand + lengths[:, None] <= ref_len))
    cand = jnp.concatenate(cand_list, axis=1)
    cand_ok = jnp.concatenate(ok_list, axis=1)

    # gapless packed compare via phase-aligned fetch (_mis_aligned: one
    # gather per 16-base frame word).  Deep candidate lists go through a
    # two-stage verify: two 16 bp probe words rank candidates, the full-
    # window compare runs only on the best K.  A candidate that maps
    # (<= max_mis over the window) has <= max_mis probe mismatches, so
    # ranking by probe mismatches keeps mappable candidates near the top;
    # any kept candidate within the cap is a valid mapping for coding.
    rw, mw = _pack_words(codes, base_valid, Lp)
    cand = cand.astype(jnp.uint32)   # frame math wants unsigned phases
    K = cfg.probe_k
    if K > 0 and cand.shape[1] > 2 * K and cfg.n_words > 3:
        wm = cfg.n_words // 2
        # probes at frame words 1 and wm: both fully inside the read for
        # any phase (word 0 straddles the window start), spread apart so
        # one sequencing error can't poison both
        pmis = _mis_aligned(packed, cand, rw, mw, js=(1, wm))
        pmis = jnp.where(cand_ok, pmis, _BIG)
        _, sel = lax.top_k(-pmis, K)
        cand = jnp.take_along_axis(cand, sel, axis=1)
        # probe words are a subset of the full window, so a candidate
        # with > max_mis probe mismatches can never verify: drop it now.
        # Cannot change which reads map or where; only the (unused)
        # argmin position of unmapped reads.  The host mirror
        # (native/alignhost.cpp) prunes identically.
        cand_ok = (jnp.take_along_axis(cand_ok, sel, axis=1)
                   & (jnp.take_along_axis(pmis, sel, axis=1)
                      <= cfg.max_mis))
    mis = _mis_aligned(packed, cand, rw, mw)
    mis = jnp.where(cand_ok, mis, _BIG)

    c_best = jnp.argmin(mis, axis=1)
    mis_best = jnp.take_along_axis(mis, c_best[:, None], axis=1)[:, 0]
    pos_best = jnp.take_along_axis(cand, c_best[:, None], axis=1)[:, 0]
    return mis_best, pos_best


@functools.partial(jax.jit, static_argnames=("cfg",))
def _align_batch(cfg: AlignConfig, keys, offsets, positions, packed, l1,
                 ref_len, codes, dege, lengths):
    B, Lp = codes.shape
    pos_i = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    valid = pos_i < lengths[:, None]
    has_dege = (dege & valid).any(axis=1)

    if cfg.strand != "rc":
        mis_f, pos_f = _one_strand(cfg, keys, offsets, positions, packed,
                                   l1, ref_len, codes, dege, lengths)

    if cfg.strand != "fwd":
        # reverse complement grid (per read: base i <- 3 - codes[len-1-i])
        ridx = jnp.clip(lengths[:, None] - 1 - pos_i, 0, Lp - 1)
        rc = jnp.where(valid,
                       3 - jnp.take_along_axis(codes.astype(jnp.int32),
                                               ridx, axis=1), 0)
        rc = rc.astype(jnp.uint8)
        rdege = jnp.where(valid, jnp.take_along_axis(
            dege.astype(jnp.int32), ridx, axis=1), 0).astype(bool)
        mis_r, pos_r = _one_strand(cfg, keys, offsets, positions, packed,
                                   l1, ref_len, rc, rdege, lengths)

    if cfg.strand == "fwd":
        use_rev = jnp.zeros(codes.shape[0], bool)
        mis, pos = mis_f, pos_f
    elif cfg.strand == "rc":
        # only reads whose forward pass failed reach this kernel, so an
        # RC hit is by construction the fallback acceptance
        use_rev = mis_r <= cfg.max_mis
        mis, pos = mis_r, pos_r
    elif cfg.both_strands:
        use_rev = mis_r < mis_f
        mis = jnp.where(use_rev, mis_r, mis_f)
        pos = jnp.where(use_rev, pos_r, pos_f)
    else:  # RC only as fallback (reference default, SURVEY.md §2.2)
        use_rev = mis_f > cfg.max_mis
        mis = jnp.where(use_rev, mis_r, mis_f)
        pos = jnp.where(use_rev, pos_r, pos_f)
    mapped = (mis <= cfg.max_mis) & ~has_dege & (lengths >= cfg.k)

    # per-base mismatch mask (window coords) for the accepted alignment
    if cfg.strand == "fwd":
        eff = codes
    elif cfg.strand == "rc":
        eff = rc
    else:
        eff = jnp.where(use_rev[:, None], rc, codes)
    # uint32 window arithmetic: pos is int32 (local index) or uint32
    # (sharded index, refs up to 4 G positions)
    refc = _ref_base_at(packed,
                        jnp.clip(pos[:, None], 0, None).astype(jnp.uint32)
                        + pos_i.astype(jnp.uint32))
    mis_mask = (eff != refc) & valid & mapped[:, None]
    return mapped, pos, use_rev & mapped, mis_mask


@functools.partial(jax.jit, static_argnames=("cfg2", "cfg3", "G", "ops"))
def _rescue_indel_fused(cfg2: AlignConfig, cfg3, G: int, ops: int,
                        keys, offsets, positions, packed, l1, ref_len,
                        codes, dege, lengths, idx, do):
    """Tier-2 deep rescue + tier-3 indel in ONE dispatch.

    The classic device flow syncs with the host at every tier boundary
    because each tier's todo list is computed on the host.  Here the
    host computes only the FIRST todo list (from the
    tier-1 mapped bits, one tiny d2h); the rescue and the indel tier
    then chain on-device: ``idx``/``do`` select this dispatch's compacted
    todo rows out of the resident (B, lp) grids (no re-upload), the
    rescue runs, and the indel tier (static ``ops > 0``) runs masked over
    the SAME capacity on the rescue's failures — its todo is a subset,
    so no overflow is possible and no second round-trip is needed.
    Decisions are bit-identical to the classic tier chain: the same
    kernels run over the same rows in the same order."""
    c = codes[idx]
    d = dege[idx]
    ln = jnp.where(do, lengths[idx], 0)
    if cfg2 is not None:
        m2, p2, r2, mm2 = _align_batch.__wrapped__(
            cfg2, keys, offsets, positions, packed, l1, ref_len, c, d, ln)
        m2 = m2 & do
    else:                   # rescue tier disabled: indel only (static)
        m2 = jnp.zeros_like(do)
        p2 = jnp.zeros(do.shape[0], jnp.int32)
        r2 = jnp.zeros_like(do)
        mm2 = jnp.zeros(c.shape, bool)
    if ops > 0:
        bad = do & ~m2
        ln3 = jnp.where(bad, ln, 0)
        f, pi, s1, g1, s2, g2, ri, mmi = _indel_batch.__wrapped__(
            cfg3, G, ops, keys, offsets, positions, packed, l1, ref_len,
            c, d, ln3)
        f = f & bad
        return m2, p2, r2, mm2, f, pi, s1, g1, s2, g2, ri, mmi
    z = jnp.zeros_like(m2)
    zi = jnp.zeros(m2.shape[0], jnp.int32)
    return (m2, p2, r2, mm2, z, jnp.zeros_like(p2), zi, zi, zi, zi,
            jnp.zeros_like(r2), jnp.zeros_like(mm2))


@functools.partial(jax.jit, static_argnames=("cfg", "G", "ops"))
def _indel_batch(cfg: AlignConfig, G: int, ops: int, keys, offsets,
                 positions, packed, l1, ref_len, codes, dege, lengths):
    """Indel rescue for reads the gapless tiers failed (the BWA path's
    indel capability, reference compressAlignInfo_CigaL/CigaV +
    decomposeAlignInfo @0x433860, SURVEY.md §2.1, recast as batched device code).
    Up to ``ops`` (1 or 2) gap operations per read: a greedy second pass
    extends the 1-op argmin with another split in its tail when one op
    alone cannot reach ``max_mis`` (reference multi-op CigaL/CigaV
    stream generality).

    Per strand: take the best *gapless* candidate from the seed search,
    build per-base compare vectors against the reference at shifts
    -G..+G (2G+1 gathers of the window), and score every split s x gap g
    by exclusive-cumsum algebra — prefix mismatches at one shift + suffix
    mismatches at another + literal cost of inserted bases (compared to
    the filler base 0 so they ride the existing mismatch-patch streams).
    Two anchorings are evaluated from the same compare tensors: seed hit
    in the prefix piece (suffix shifted by g) and seed hit in the suffix
    piece (prefix shifted; output pos = cand+g, gap -g).  All variants are
    (B, L+1) elementwise mins — no extra gathers beyond the 2G+1 windows.

    Returns (found, pos, split, gap, use_rev, mis_mask); mis_mask is in
    spliced-window coords so the downstream patch streams are unchanged.
    """
    B, Lp = codes.shape
    pos_i = jnp.arange(Lp, dtype=jnp.int32)[None, :]
    valid = pos_i < lengths[:, None]
    has_dege = (dege & valid).any(axis=1)
    s_grid = jnp.arange(Lp + 1, dtype=jnp.int32)[None, :]

    def exc(x):
        # exclusive cumsum along the read: col s = mismatches among i < s
        return jnp.pad(jnp.cumsum(x.astype(jnp.int32), axis=1),
                       ((0, 0), (1, 0)))

    def strand_eval(c, d):
        _, cand = _one_strand(cfg, keys, offsets, positions, packed, l1,
                              ref_len, c, d, lengths)
        posi = cand.astype(jnp.int32)
        ok_b = (posi >= 2 * G) & (posi + lengths.astype(jnp.int32)
                                  + 2 * G <= ref_len)
        cmp = []
        for g in range(-G, G + 1):
            idx = posi[:, None] + g + pos_i
            rb = _ref_base_at(packed, jnp.clip(idx, 0, ref_len - 1)
                              .astype(jnp.uint32))
            cmp.append((c != rb) & valid)
        E = [exc(x) for x in cmp]
        F = exc((c != 0) & valid)              # literal-vs-filler cost
        E0 = E[G]
        T = [e[:, -1:] for e in E]

        tot_b = jnp.full((B,), _BIG, jnp.int32)
        s_b = jnp.zeros((B,), jnp.int32)
        g_b = jnp.zeros((B,), jnp.int32)      # output gap
        po_b = posi
        pg_b = jnp.zeros((B,), jnp.int32)     # prefix shift index (g+G)
        sg_b = jnp.zeros((B,), jnp.int32)     # suffix shift index (g+G)

        def consider(tot_s, ok_s, g_out, d_pos, pg, sg):
            nonlocal tot_b, s_b, g_b, po_b, pg_b, sg_b
            tot_s = jnp.where(ok_s, tot_s, _BIG)
            sb = jnp.argmin(tot_s, axis=1).astype(jnp.int32)
            tb = jnp.take_along_axis(tot_s, sb[:, None], axis=1)[:, 0]
            better = tb < tot_b
            tot_b = jnp.where(better, tb, tot_b)
            s_b = jnp.where(better, sb, s_b)
            g_b = jnp.where(better, g_out, g_b)
            po_b = jnp.where(better, posi + d_pos, po_b)
            pg_b = jnp.where(better, pg + G, pg_b)
            sg_b = jnp.where(better, sg + G, sg_b)

        len1 = lengths.astype(jnp.int32)[:, None]
        for g in range(-G, G + 1):
            if g == 0:
                continue
            Eg, Tg = E[g + G], T[g + G]
            h = abs(g)
            pad = ((0, 0), (0, h))
            if g > 0:
                # A: seed in prefix, read DELETES g ref bases at s
                consider(E0 + (Tg - Eg), s_grid <= len1, g, 0, 0, g)
                # B: seed in suffix, output gap -g = insertion of g bases
                tot = (Eg[:, :Lp + 1 - h] + (F[:, h:] - F[:, :Lp + 1 - h])
                       + (T[G] - E0[:, h:]))
                consider(jnp.pad(tot, pad, constant_values=1 << 28),
                         s_grid <= len1 - h, -g, g, g, 0)
            else:
                # A: seed in prefix, read INSERTS h bases at s
                tot = (E0[:, :Lp + 1 - h] + (F[:, h:] - F[:, :Lp + 1 - h])
                       + (Tg - Eg[:, h:]))
                consider(jnp.pad(tot, pad, constant_values=1 << 28),
                         s_grid <= len1 - h, g, 0, 0, g)
                # B: seed in suffix, output gap -g = deletion of h bases
                consider(Eg + (T[G] - E0), s_grid <= len1, -g, g, g, 0)

        tot_b = jnp.where(ok_b, tot_b, _BIG)

        # pass 2 (greedy second op, mirrors native/alignhost.cpp): where
        # one op cannot reach max_mis, re-split the 1-op argmin.  Two
        # symmetric candidate families from the same compare tensors:
        #  TAIL: keep prefix [0,s1)@pg + op1; op2 at s2 >= s1+h1 moves
        #        the remainder to row sg+g2.
        #        tot = pref[s1] + lit1 + (Esg[s2]-Esg[s1+h1]) + lit2
        #              + (E2[len]-E2[s2+h2])
        #  HEAD: keep op1 + tail [s1+h1,len)@sg; a new first op at
        #        s0 <= s1-hh re-bases the prefix [0,s0) to row pg+gh
        #        (output pos shifts by gh; serialized gap -gh).
        #        tot = Ej0[s0] + lit0 + (Epg[s1]-Epg[s0+hh]) + lit1
        #              + (Esg[len]-Esg[s1+h1])
        # Order: gap ascending then split ascending, strict-< chaining
        # within each family; head wins only if strictly better — the
        # identical tie-breaks to the host mirror.  Final fields are the
        # decode splice's (sA,gA,sB,gB): shift gA past sA, +gB past sB,
        # filler over [s,s+max(-g,0)); jb_b = window row of segment 0.
        sA_b, gA_b = s_b, g_b
        sB_b = jnp.zeros((B,), jnp.int32)
        gB_b = jnp.zeros((B,), jnp.int32)
        jb_b, poo_b = pg_b, po_b
        E_st = jnp.stack(E, axis=1)                    # (B, 2G+1, Lp+1)
        if ops >= 2:
            def row_of(j):
                return jnp.take_along_axis(
                    E_st, jnp.clip(j, 0, 2 * G)[:, None, None],
                    axis=1)[:, 0]

            def at(X, i):
                return jnp.take_along_axis(X, i[:, None], axis=1)[:, 0]

            Epg, Esg = row_of(pg_b), row_of(sg_b)
            h1 = jnp.maximum(-g_b, 0)
            s1h = s_b + h1
            lens = lengths.astype(jnp.int32)
            op1_lit = at(F, s1h) - at(F, s_b)
            elig = (tot_b > cfg.max_mis) & (tot_b < _BIG)

            # TAIL family
            base_c = at(Epg, s_b) + op1_lit - at(Esg, s1h)
            t2_b = jnp.full((B,), _BIG, jnp.int32)
            s2_b = jnp.zeros((B,), jnp.int32)
            g2_b = jnp.zeros((B,), jnp.int32)
            for g2 in range(-G, G + 1):
                if g2 == 0:
                    continue
                j2 = sg_b + g2
                okj = (j2 >= 0) & (j2 <= 2 * G)
                E2 = row_of(j2)
                e2len = at(E2, lens)[:, None]
                h2 = -g2 if g2 < 0 else 0
                if h2:
                    tot = (Esg[:, :Lp + 1 - h2]
                           + (F[:, h2:] - F[:, :Lp + 1 - h2])
                           + (e2len - E2[:, h2:]))
                    tot = jnp.pad(tot, ((0, 0), (0, h2)),
                                  constant_values=1 << 28)
                else:
                    tot = Esg + (e2len - E2)
                tot = base_c[:, None] + tot
                ok_s = ((s_grid >= s1h[:, None]) & (s_grid <= len1 - h2)
                        & okj[:, None] & elig[:, None])
                tot = jnp.where(ok_s, tot, _BIG)
                sb = jnp.argmin(tot, axis=1).astype(jnp.int32)
                tb = jnp.take_along_axis(tot, sb[:, None], axis=1)[:, 0]
                better = tb < t2_b
                t2_b = jnp.where(better, tb, t2_b)
                s2_b = jnp.where(better, sb, s2_b)
                g2_b = jnp.where(better, jnp.int32(g2), g2_b)

            # HEAD family
            tail_c = op1_lit + at(Esg, lens) - at(Esg, s1h) + at(Epg, s_b)
            th_b = jnp.full((B,), _BIG, jnp.int32)
            s0_b = jnp.zeros((B,), jnp.int32)
            gh_b = jnp.zeros((B,), jnp.int32)
            for gh in range(-G, G + 1):
                if gh == 0:
                    continue
                j0 = pg_b + gh
                okj = (j0 >= 0) & (j0 <= 2 * G)
                Ej0 = row_of(j0)
                hh = gh if gh > 0 else 0
                if hh:
                    tot = (Ej0[:, :Lp + 1 - hh]
                           + (F[:, hh:] - F[:, :Lp + 1 - hh])
                           - Epg[:, hh:])
                    tot = jnp.pad(tot, ((0, 0), (0, hh)),
                                  constant_values=1 << 28)
                else:
                    tot = Ej0 - Epg
                tot = tail_c[:, None] + tot
                ok_s = ((s_grid <= s_b[:, None] - hh)
                        & okj[:, None] & elig[:, None])
                tot = jnp.where(ok_s, tot, _BIG)
                sb = jnp.argmin(tot, axis=1).astype(jnp.int32)
                tb = jnp.take_along_axis(tot, sb[:, None], axis=1)[:, 0]
                better = tb < th_b
                th_b = jnp.where(better, tb, th_b)
                s0_b = jnp.where(better, sb, s0_b)
                gh_b = jnp.where(better, jnp.int32(gh), gh_b)

            use_head = th_b < t2_b
            t_best = jnp.minimum(t2_b, th_b)
            better2 = t_best < tot_b
            tot_b = jnp.where(better2, t_best, tot_b)
            uh = better2 & use_head
            ut = better2 & ~use_head
            sA_b = jnp.where(uh, s0_b, s_b)
            gA_b = jnp.where(uh, -gh_b, g_b)
            sB_b = jnp.where(uh, s_b, jnp.where(ut, s2_b, 0))
            gB_b = jnp.where(uh, g_b, jnp.where(ut, g2_b, 0))
            jb_b = jnp.where(uh, pg_b + gh_b, pg_b)
            poo_b = jnp.where(uh, po_b + gh_b, po_b)

        # chosen-variant mismatch mask in spliced-window (== read) coords:
        # segment rows jb, jb+gA, jb+gA+gB; literal filler over the
        # insertion ranges (identical for the 1-op case, where sB=gB=0)
        cmp_st = jnp.stack(cmp, axis=1)                    # (B, 2G+1, Lp)

        def seg_row(j):
            return jnp.take_along_axis(
                cmp_st, jnp.clip(j, 0, 2 * G)[:, None, None],
                axis=1)[:, 0]

        r0 = seg_row(jb_b)
        r1 = seg_row(jb_b + gA_b)
        r2 = seg_row(jb_b + gA_b + gB_b)
        lit = (c != 0) & valid
        hA = jnp.maximum(-gA_b, 0)[:, None]
        hB = jnp.maximum(-gB_b, 0)[:, None]
        sAm, sBm = sA_b[:, None], sB_b[:, None]
        mask = jnp.where(
            pos_i < sAm, r0,
            jnp.where(pos_i < sAm + hA, jnp.where(hA > 0, lit, r1),
                      jnp.where(pos_i < sBm, r1,
                                jnp.where(pos_i < sBm + hB,
                                          jnp.where(hB > 0, lit, r2),
                                          r2))))
        return tot_b, sA_b, gA_b, sB_b, gB_b, poo_b, mask & valid

    tot_f, s_f, g_f, s2_f, g2_f, po_f, mk_f = strand_eval(codes, dege)

    ridx = jnp.clip(lengths[:, None] - 1 - pos_i, 0, Lp - 1)
    rc = jnp.where(valid, 3 - jnp.take_along_axis(codes.astype(jnp.int32),
                                                  ridx, axis=1), 0)
    rc = rc.astype(jnp.uint8)
    rdege = jnp.where(valid, jnp.take_along_axis(
        dege.astype(jnp.int32), ridx, axis=1), 0).astype(bool)
    tot_r, s_r, g_r, s2_r, g2_r, po_r, mk_r = strand_eval(rc, rdege)

    use_rev = tot_r < tot_f
    tot = jnp.where(use_rev, tot_r, tot_f)
    found = (tot <= cfg.max_mis) & ~has_dege & (lengths >= cfg.k)
    return (found,
            jnp.where(use_rev, po_r, po_f),
            jnp.where(use_rev, s_r, s_f),
            jnp.where(use_rev, g_r, g_f),
            jnp.where(use_rev, s2_r, s2_f),
            jnp.where(use_rev, g2_r, g2_f),
            use_rev & found,
            jnp.where(use_rev[:, None], mk_r, mk_f))


def _intra(lengths: np.ndarray) -> np.ndarray:
    """Per-symbol position-within-read for concatenated reads."""
    offs = np.cumsum(lengths) - lengths
    return (np.arange(int(lengths.sum()), dtype=np.int64)
            - np.repeat(offs, lengths))


def _gridify(codes_flat, dege_flat, lengths, lp):
    R = len(lengths)
    offs = np.cumsum(lengths) - lengths
    gi = (np.arange(int(lengths.sum()), dtype=np.int64)
          - np.repeat(offs, lengths))
    rows = np.repeat(np.arange(R), lengths)
    codes = np.zeros((R, lp), np.uint8)
    dege = np.zeros((R, lp), bool)
    codes[rows, gi] = codes_flat
    dege[rows, gi] = dege_flat
    return codes, dege


@functools.partial(jax.jit, static_argnames=("lp", "n_cand", "max_mis"))
def _window_batch(lp: int, n_cand: int, max_mis: int, packed, ref_len,
                  codes, dege, lengths, centers):
    """Anchored verification: try every reference offset in
    [center - n_cand/2, center + n_cand/2) for each read, both strands —
    the PE mate-rescue step (reference doPEAlign's consistent-pairing
    preference, SURVEY.md §2.2, recast as a windowed batch)."""
    B = codes.shape[0]
    W = lp // 16
    pos_i = jnp.arange(lp, dtype=jnp.int32)[None, :]
    valid = pos_i < lengths[:, None]
    has_dege = (dege & valid).any(axis=1)
    cand = (centers[:, None] - n_cand // 2
            + jnp.arange(n_cand, dtype=jnp.int32)[None, :])
    cand_ok = (cand >= 0) & (cand + lengths[:, None] <= ref_len)

    def strand(c):
        rw, mw = _pack_words(c, valid, lp)
        mis = _mis_aligned(packed, cand.astype(jnp.uint32), rw, mw)
        mis = jnp.where(cand_ok, mis, _BIG)
        cb = jnp.argmin(mis, axis=1)
        return (jnp.take_along_axis(mis, cb[:, None], axis=1)[:, 0],
                jnp.take_along_axis(cand, cb[:, None], axis=1)[:, 0])

    mis_f, pos_f = strand(codes)
    ridx = jnp.clip(lengths[:, None] - 1 - pos_i, 0, lp - 1)
    rc = jnp.where(valid, 3 - jnp.take_along_axis(
        codes.astype(jnp.int32), ridx, axis=1), 0).astype(jnp.uint8)
    mis_r, pos_r = strand(rc)

    use_rev = mis_r < mis_f
    mis = jnp.where(use_rev, mis_r, mis_f)
    pos = jnp.where(use_rev, pos_r, pos_f)
    mapped = (mis <= max_mis) & ~has_dege
    eff = jnp.where(use_rev[:, None], rc, codes)
    refc = _ref_base_at(packed, jnp.clip(pos[:, None], 0, None) + pos_i)
    mis_mask = (eff != refc) & valid & mapped[:, None]
    return mapped, pos, use_rev & mapped, mis_mask


class Aligner:
    """Host wrapper: holds device copies of the index, buckets read batches.

    Index arrays exceed int32 offsets only for >2G-position references —
    those need the sharded-index path (parallel/mesh.py); guarded here.
    """

    BATCH = 4096

    def __init__(self, idx: RefIndex, params: CodecParams):
        if idx.n_positions >= (1 << 31) or idx.ref_len >= (1 << 31):
            raise ValueError("reference too large for single-chip index; "
                             "use the sharded index path")
        if idx.k > 31:
            raise ValueError("device aligner supports seed_len <= 31")
        self.params = params
        self.ref_len = idx.ref_len
        self.k = idx.k
        self.wide = idx.k > 15

        def _huge(src, dtype):
            # genome-scale indexes (100 Mbp: ~1.3 GB of key/offset/
            # position arrays) are walked randomly per seed — on this
            # box's madvise-only THP policy that is dTLB-bound on 4 KB
            # pages.  Advise BEFORE first touch so the copy faults 2 MB
            # pages in directly (same trick as the quantized cum tables,
            # io/native.madvise_hugepage; ~15% there).
            out = np.empty(len(src), dtype)
            if out.nbytes >= (8 << 20):
                from fastqueeze_tpu.io import native
                native.madvise_hugepage(out)
            out[:] = src
            return out

        keys = _huge(idx.keys, np.uint64)
        if not len(keys):
            keys = np.zeros(1, np.uint64)
        offs = _huge(idx.offsets, np.int32)
        if len(offs) < 2:
            offs = np.zeros(2, np.int32)
        pos = _huge(idx.positions, np.int32)
        if not len(pos):
            pos = np.zeros(1, np.int32)
        # first-level prefix table: bounds the per-seed binary search to one
        # bucket (cuts scattered key gathers roughly in half)
        l1_bits = min(2 * self.k, 18)
        self._l1_shift = max(0, 2 * self.k - l1_bits)
        l1 = np.searchsorted(
            keys >> np.uint64(self._l1_shift),
            np.arange((1 << l1_bits) + 1, dtype=np.uint64)).astype(np.int32)
        # device copies are created LAZILY (_dev_arrays): host-routed
        # runs (CPU backend) never pay the upload, and the self-ref pass
        # builds this index per block for its native aligner only
        self._dev_cache = None
        max_bucket = int(np.diff(l1).max()) if len(l1) > 1 else 1
        self._search_steps = max(1, int(np.ceil(np.log2(max_bucket + 1))))
        # host-native mirror (native/alignhost.cpp): keep numpy copies of
        # the index so the gapless tiers can run on the host CPU (the CPU
        # backend's placement, and the bit-identical reference of the
        # device tiers).  Keys are u64 for both narrow and
        # wide (-q) modes (the device's (hi, lo30) pair order IS u64
        # order); only the sharded index stays device-side.  Mapping
        # decisions are mirrored bit-identically (tests/test_alignhost.py).
        self._h_keys = keys          # uint64
        self._h_offsets = offs
        self._h_positions = pos
        # padded so the native inner loops can fetch up to lp/16 + 1
        # words past the true end without clamping (masked-out slots
        # only; the zero padding is bit-identical to the device's
        # clamped fetch of an all-masked word)
        self._h_pad_words = 1026
        self._h_packed = np.concatenate([
            idx.packed.astype(np.uint32),
            np.zeros(self._h_pad_words, np.uint32)])
        self._h_l1 = l1
        # per-device replicas for block-DP over a mesh (the reference's
        # POSIX-shm index sharing mapped to devices, SURVEY.md §2.3):
        # each block device gets the index arrays once, not per batch
        self._replicas = {}

    def _dev_arrays(self):
        """Default-device index copies, built on first device-tier use."""
        if self._dev_cache is None:
            keys = self._h_keys
            if self.wide:
                dk = (jnp.asarray((keys >> np.uint64(30)).astype(np.uint32)),
                      jnp.asarray((keys & np.uint64(0x3FFFFFFF))
                                  .astype(np.uint32)))
            else:
                dk = (jnp.asarray(keys.astype(np.uint32)),
                      jnp.asarray(np.zeros(1, np.uint32)))
            self._dev_cache = (
                dk, jnp.asarray(self._h_offsets),
                jnp.asarray(self._h_positions),
                jnp.asarray(self._h_packed[:len(self._h_packed)
                                           - self._h_pad_words]),
                jnp.asarray(self._h_l1))
        return self._dev_cache

    @property
    def _keys(self):
        return self._dev_arrays()[0]

    @property
    def _offsets(self):
        return self._dev_arrays()[1]

    @property
    def _positions(self):
        return self._dev_arrays()[2]

    @property
    def _packed(self):
        return self._dev_arrays()[3]

    @property
    def _l1(self):
        return self._dev_arrays()[4]

    def _arrays(self):
        """Index arrays for the calling thread's default device."""
        import jax
        dev = jax.config.jax_default_device
        base = self._dev_arrays()
        if dev is None:
            return base
        rep = self._replicas.get(dev)
        if rep is None:
            put = lambda x: jax.device_put(x, dev)  # noqa: E731
            rep = ((put(base[0][0]), put(base[0][1])),
                   put(base[1]), put(base[2]), put(base[3]), put(base[4]))
            self._replicas[dev] = rep
        return rep

    def _lp_bucket(self, max_len: int) -> int:
        """Bucketed padded length ({1, 1.5} x powers of two, >= 32, x16
        aligned) so the jitted aligner compiles once per bucket."""
        b = 32
        while b < max_len:
            b = b + (b >> 1) if (b & (b - 1)) == 0 else (b // 3) * 4
        return b

    def align(self, codes_flat: np.ndarray, dege_flat: np.ndarray,
              lengths: np.ndarray, allow_indel: bool = True,
              max_indel: Optional[int] = None) -> AlignResult:
        """max_indel: override p.max_indel for this call (the long-read
        chunk tier runs its own gap budget, longread_indel, independent
        of the read-level -q setting)."""
        """codes_flat: concatenated 2-bit read codes (degenerate bases as 0);
        dege_flat: bool mask of degenerate bases; lengths: per-read."""
        R = len(lengths)
        if R == 0 or self.ref_len < self.k:
            lp = 32
            return AlignResult(np.zeros(R, bool), np.zeros(R, np.int64),
                               np.zeros(R, bool), np.zeros((R, lp), bool))
        max_len = int(lengths.max())
        cap = self.params.align_max_len
        if max_len > cap:
            # long reads (ONT/PacBio) skip the short-read gapless aligner:
            # gridding them would blow the (R, lp) batch memory; the block
            # falls back to entropy-only coding for them (the reference's
            # aligner is equally short-read-only)
            sel = np.flatnonzero(lengths <= cap)
            lp = self._lp_bucket(int(lengths[sel].max()) if len(sel) else 32)
            gp = gl = gp2 = gl2 = None
            if (self.params.max_indel if max_indel is None
                    else max_indel) > 0:
                gp = np.zeros(R, np.int32)
                gl = np.zeros(R, np.int32)
                gp2 = np.zeros(R, np.int32)
                gl2 = np.zeros(R, np.int32)
            res = AlignResult(np.zeros(R, bool), np.zeros(R, np.int64),
                              np.zeros(R, bool), np.zeros((R, lp), bool),
                              gp, gl, gp2, gl2)
            if len(sel):
                off = np.cumsum(lengths) - lengths
                idx = (np.repeat(off[sel], lengths[sel])
                       + _intra(lengths[sel]))
                sub = self.align(codes_flat[idx], dege_flat[idx],
                                 lengths[sel], allow_indel, max_indel)
                res.mapped[sel] = sub.mapped
                res.pos[sel] = sub.pos
                res.is_rev[sel] = sub.is_rev
                res.mis_mask[sel] = sub.mis_mask
                if gp is not None and sub.gap_pos is not None:
                    # indel reads' mis_mask is in spliced-window coords;
                    # dropping the gap fields would code them as gapless
                    # and corrupt the block (caught only by decode MD5)
                    res.gap_pos[sel] = sub.gap_pos
                    res.gap_len[sel] = sub.gap_len
                    res.gap_pos2[sel] = sub.gap_pos2
                    res.gap_len2[sel] = sub.gap_len2
            return res
        lp = self._lp_bucket(max_len)
        p = self.params
        cfg = AlignConfig(k=self.k, stride=p.seed_stride,
                          n_cand=p.seed_max_occ, max_mis=p.max_mis,
                          both_strands=p.both_strands, lp=lp,
                          l1_shift=self._l1_shift,
                          search_steps=self._search_steps, wide=self.wide,
                          probe_k=p.seed_probe_k)

        # the host-native tiers read the flat block arrays directly; the
        # (R, lp) grids are only marshaled if a device tier needs them
        roffs = (np.cumsum(lengths) - lengths).astype(np.int64)
        flat = (codes_flat, dege_flat, roffs)
        _grids = []

        def grids():
            if not _grids:
                _grids.append(_gridify(codes_flat, dege_flat, lengths, lp))
            return _grids[0]

        import os
        if (not self._host_ok(lp)
                and os.environ.get("FASTQUEEZE_FUSED_ALIGN", "") == "1"):
            # device-routed fused flow with two host syncs per block,
            # payload-identical to the classic tier chain.  Opt-in: not
            # yet measured against the classic chain on a GPU (the
            # rescue tier is ~26k gathers/read at seed_big_occ=1024)
            return self._align_device_fused(grids, lengths, lp, cfg,
                                            allow_indel, max_indel)

        mapped = np.zeros(R, bool)
        pos = np.zeros(R, np.int64)
        is_rev = np.zeros(R, bool)
        mis_mask = np.zeros((R, lp), bool)

        # tier 1: cheap pass, first seed_max_occ candidates.  With RC as
        # fallback (the reference default) the forward strand runs alone
        # over every read and the RC lookup+verify only over the reads
        # forward failed (~25-40%) — the reference pays the same split
        # serially per read; here it is two batched passes.
        import dataclasses
        if p.both_strands:
            self._run_tier(cfg, flat, grids, lengths, np.arange(R),
                           mapped, pos, is_rev, mis_mask, self.BATCH)
        else:
            self._run_tier(dataclasses.replace(cfg, strand="fwd"),
                           flat, grids, lengths, np.arange(R),
                           mapped, pos, is_rev, mis_mask, self.BATCH)
            todo_rc = np.flatnonzero(~mapped & (lengths >= self.k))
            if len(todo_rc):
                self._run_tier(dataclasses.replace(cfg, strand="rc"),
                               flat, grids, lengths, todo_rc,
                               mapped, pos, is_rev, mis_mask, self.BATCH)

        # tier 2 (beyond reference parity: findHashSeeds checks only the
        # single least-frequent seed's occurrences @0x4108d0, which fails
        # when that seed contains a sequencing error pointing to a wrong
        # locus): rescue unmapped reads with candidates from several
        # *spatially diverse* least-frequent seeds — each pick masks out
        # +-seed_excl_bp around itself so one error can't consume all the
        # picks — and a deeper per-seed candidate list.  On the bundled
        # telomeric data this maps 8,191/10,000 vs the reference's 8,050
        # (exhaustive-verification oracle: 8,224).
        big = p.seed_big_occ
        if big > cfg.n_cand and p.rescue_seeds > 0:
            todo = np.flatnonzero(~mapped & (lengths >= self.k))
            if len(todo):
                cfg2 = AlignConfig(k=self.k, stride=p.seed_stride,
                                   n_cand=big, max_mis=p.max_mis,
                                   both_strands=p.both_strands, lp=lp,
                                   n_seeds=p.rescue_seeds,
                                   excl_bp=p.seed_excl_bp,
                                   l1_shift=self._l1_shift,
                                   search_steps=self._search_steps,
                                   wide=self.wide)
                self._run_tier(cfg2, flat, grids, lengths, todo,
                               mapped, pos, is_rev, mis_mask, 512)

        gap_pos = gap_len = gap_pos2 = gap_len2 = None
        eff_indel = p.max_indel if max_indel is None else max_indel
        if eff_indel > 0 and allow_indel:
            # tier 3: indel rescue for still-unmapped reads (the -q
            # mode's CigaL/CigaV capability; up to p.indel_ops gaps)
            gap_pos = np.zeros(R, np.int32)
            gap_len = np.zeros(R, np.int32)
            gap_pos2 = np.zeros(R, np.int32)
            gap_len2 = np.zeros(R, np.int32)
            todo = np.flatnonzero(~mapped & (lengths >= self.k))
            if len(todo):
                cfg3 = AlignConfig(k=self.k, stride=p.seed_stride,
                                   n_cand=big, max_mis=p.max_mis,
                                   both_strands=p.both_strands, lp=lp,
                                   n_seeds=p.rescue_seeds,
                                   excl_bp=p.seed_excl_bp,
                                   l1_shift=self._l1_shift,
                                   search_steps=self._search_steps,
                                   wide=self.wide)
                # a gap wider than the lane is meaningless and would make
                # the split-scoring slices negative-width
                G_eff = min(eff_indel, lp - 1)
                if self._host_ok(lp):
                    from fastqueeze_tpu.io import native
                    out = native.indel_batch(
                        self._h_keys, self._h_offsets, self._h_positions,
                        self._h_packed, self._h_l1, self._l1_shift,
                        self._search_steps, self.ref_len,
                        codes_flat, dege_flat, roffs[todo], lengths[todo],
                        lp, self.k, p.seed_stride, big, p.max_mis,
                        p.rescue_seeds, p.seed_excl_bp, cfg3.probe_k,
                        G_eff, p.indel_ops)
                    if out is not None:
                        f, p_, s_, g_, s2_, g2_, rv, mm = out
                        upd = todo[f]
                        mapped[upd] = True
                        pos[upd] = p_[f]
                        gap_pos[upd] = s_[f]
                        gap_len[upd] = g_[f]
                        gap_pos2[upd] = s2_[f]
                        gap_len2[upd] = g2_[f]
                        is_rev[upd] = rv[f]
                        mis_mask[upd] = mm[f]
                        return AlignResult(mapped, pos, is_rev, mis_mask,
                                           gap_pos, gap_len,
                                           gap_pos2, gap_len2)
                arrs = self._arrays()
                jobs = []
                B = 512
                cg, dg = grids()
                for s in range(0, len(todo), B):
                    sel = todo[s:s + B]
                    n = len(sel)
                    cb = np.zeros((B, lp), np.uint8)
                    db = np.zeros((B, lp), bool)
                    lb = np.zeros(B, np.int32)
                    cb[:n], db[:n] = cg[sel], dg[sel]
                    lb[:n] = lengths[sel]
                    out = _indel_batch(cfg3, G_eff, p.indel_ops, *arrs,
                                       jnp.int32(self.ref_len),
                                       jnp.asarray(cb), jnp.asarray(db),
                                       jnp.asarray(lb))
                    jobs.append((sel, n, out))
                for sel, n, (f, p_, s_, g_, s2_, g2_, r, mm) in jobs:
                    f = np.asarray(f)[:n]
                    upd = sel[f]
                    mapped[upd] = True
                    pos[upd] = np.asarray(p_)[:n][f]
                    gap_pos[upd] = np.asarray(s_)[:n][f]
                    gap_len[upd] = np.asarray(g_)[:n][f]
                    gap_pos2[upd] = np.asarray(s2_)[:n][f]
                    gap_len2[upd] = np.asarray(g2_)[:n][f]
                    is_rev[upd] = np.asarray(r)[:n][f]
                    mis_mask[upd] = np.asarray(mm)[:n][f]
        return AlignResult(mapped, pos, is_rev, mis_mask, gap_pos, gap_len,
                           gap_pos2, gap_len2)

    def _align_device_fused(self, grids, lengths, lp: int,
                            cfg: AlignConfig,
                            allow_indel: bool = True,
                            max_indel: Optional[int] = None) -> AlignResult:
        """Device-routed alignment in TWO host syncs per block.

        Phase A dispatches the tier-1 both-strand kernel for every batch
        (async), then fetches only the mapped BITS (tiny d2h).  Phase B
        dispatches ONE fused rescue+indel kernel per batch over the
        still-resident device grids with a compacted todo list (no grid
        re-upload, no per-tier sync), then everything is collected.  The
        classic per-tier chain (FASTQUEEZE_FUSED_ALIGN=0) syncs ~5 times
        in sequence; mapping decisions are identical — asserted by
        tests/test_fused_align.py down to archive bytes."""
        import dataclasses
        p = self.params
        R = len(lengths)
        codes_g, dege_g = grids()
        keys, offsets, positions, packed, l1 = self._arrays()
        ref_len = jnp.int32(self.ref_len)
        B = self.BATCH
        jobs = []
        for s in range(0, R, B):
            n = min(B, R - s)
            cb = np.zeros((B, lp), np.uint8)
            db = np.zeros((B, lp), bool)
            lb = np.zeros(B, np.int32)
            cb[:n], db[:n] = codes_g[s:s + n], dege_g[s:s + n]
            lb[:n] = lengths[s:s + n]
            cb_d, db_d, lb_d = (jnp.asarray(cb), jnp.asarray(db),
                                jnp.asarray(lb))
            out = _align_batch(cfg, keys, offsets, positions, packed, l1,
                               ref_len, cb_d, db_d, lb_d)
            jobs.append([s, n, cb_d, db_d, lb_d, out, None, None])
        for j in jobs:                       # round-trip 1: mapped bits
            j[6] = np.asarray(j[5][0])

        big = p.seed_big_occ
        rescue_on = big > cfg.n_cand and p.rescue_seeds > 0
        eff_indel = p.max_indel if max_indel is None else max_indel
        indel_on = eff_indel > 0 and allow_indel
        cfg2 = dataclasses.replace(
            cfg, n_cand=big, n_seeds=p.rescue_seeds,
            excl_bp=p.seed_excl_bp,
            probe_k=AlignConfig.__dataclass_fields__["probe_k"].default
        ) if rescue_on else None
        cfg3 = dataclasses.replace(
            cfg, n_cand=big, n_seeds=p.rescue_seeds,
            excl_bp=p.seed_excl_bp,
            probe_k=AlignConfig.__dataclass_fields__["probe_k"].default)
        G_eff = min(eff_indel, lp - 1) if indel_on else 0
        ops = p.indel_ops if indel_on else 0
        if rescue_on or indel_on:
            # one dispatch per batch at a pow2 capacity (one padded
            # dispatch instead of several small 512-row ones)
            for j in jobs:
                s, n, cb_d, db_d, lb_d, _out, m1, _ = j
                todo = np.flatnonzero(~m1[:n]
                                      & (lengths[s:s + n] >= self.k))
                if not len(todo):
                    continue
                cap = 128
                while cap < len(todo):
                    cap <<= 1
                idxv = np.zeros(cap, np.int32)
                dov = np.zeros(cap, bool)
                idxv[:len(todo)] = todo
                dov[:len(todo)] = True
                j[7] = [(todo, _rescue_indel_fused(
                    cfg2, cfg3, G_eff, ops, keys, offsets, positions,
                    packed, l1, ref_len, cb_d, db_d, lb_d,
                    jnp.asarray(idxv), jnp.asarray(dov)))]

        mapped = np.zeros(R, bool)
        pos = np.zeros(R, np.int64)
        is_rev = np.zeros(R, bool)
        mis_mask = np.zeros((R, lp), bool)
        gap_pos = gap_len = gap_pos2 = gap_len2 = None
        if indel_on:
            gap_pos = np.zeros(R, np.int32)
            gap_len = np.zeros(R, np.int32)
            gap_pos2 = np.zeros(R, np.int32)
            gap_len2 = np.zeros(R, np.int32)
        for j in jobs:                       # round-trip 2: full results
            s, n, _cb, _db, _lb, out, m1, ph2 = j
            m, p_, r, mm = (np.asarray(x) for x in out)
            sl = slice(s, s + n)
            mapped[sl] = m[:n]
            pos[sl] = p_[:n]
            is_rev[sl] = r[:n]
            mis_mask[sl] = mm[:n]
            if ph2 is None:
                continue
            for todo, out2 in ph2:
                k = len(todo)
                (m2, p2, r2, mm2, f, pi, s1, g1, s2g, g2g, ri,
                 mmi) = (np.asarray(x) for x in out2)
                sel = todo + s
                if rescue_on:
                    hit = m2[:k]
                    upd = sel[hit]
                    mapped[upd] = True
                    pos[upd] = p2[:k][hit]
                    is_rev[upd] = r2[:k][hit]
                    mis_mask[upd] = mm2[:k][hit]
                if indel_on:
                    fk = f[:k]
                    upd = sel[fk]
                    mapped[upd] = True
                    pos[upd] = pi[:k][fk]
                    gap_pos[upd] = s1[:k][fk]
                    gap_len[upd] = g1[:k][fk]
                    gap_pos2[upd] = s2g[:k][fk]
                    gap_len2[upd] = g2g[:k][fk]
                    is_rev[upd] = ri[:k][fk]
                    mis_mask[upd] = mmi[:k][fk]
        return AlignResult(mapped, pos, is_rev, mis_mask, gap_pos, gap_len,
                           gap_pos2, gap_len2)

    def rescue_mates(self, codes_flat: np.ndarray, dege_flat: np.ndarray,
                     lengths: np.ndarray, res: AlignResult,
                     max_insr: int) -> AlignResult:
        """PE consistent-pairing rescue (reference doPEAlign preference):
        an unmapped read whose interleaved mate is mapped is re-verified at
        every offset within +-max_insr of the mate's position."""
        R = len(lengths)
        if R < 2 or max_insr <= 0:
            return res
        mate = np.arange(R) ^ 1
        lp = res.mis_mask.shape[1]
        todo = np.flatnonzero(~res.mapped & res.mapped[mate]
                              & (lengths > 0) & (lengths <= lp))
        if not len(todo):
            return res
        C = min(4096, 2 * max_insr + 128)
        mapped, pos = res.mapped.copy(), res.pos.copy()
        is_rev, mis_mask = res.is_rev.copy(), res.mis_mask.copy()
        if self._host_ok(lp):
            from fastqueeze_tpu.io import native
            roffs = (np.cumsum(lengths) - lengths).astype(np.int64)
            out = native.window_batch(
                self._h_packed, self.ref_len, codes_flat, dege_flat,
                roffs[todo], lengths[todo],
                res.pos[mate[todo]].astype(np.int32), lp, C,
                self.params.max_mis)
            if out is not None:
                m, p_, r, mm = out
                upd = todo[m]
                mapped[upd] = True
                pos[upd] = p_[m]
                is_rev[upd] = r[m]
                mis_mask[upd] = mm[m]
                return AlignResult(mapped, pos, is_rev, mis_mask,
                                   res.gap_pos, res.gap_len,
                                   res.gap_pos2, res.gap_len2,
                                   chunks=res.chunks)
        # grid only the rescue candidates (long reads skipped alignment and
        # must not enter the (R, lp) grid)
        off = np.cumsum(lengths) - lengths
        idx = np.repeat(off[todo], lengths[todo]) + _intra(lengths[todo])
        codes_t, dege_t = _gridify(codes_flat[idx], dege_flat[idx],
                                   lengths[todo], lp)
        B = max(64, (1 << 22) // (C * (lp // 16)))     # bound device memory
        jobs = []
        for s in range(0, len(todo), B):
            sel = todo[s:s + B]
            n = len(sel)
            cb = np.zeros((B, lp), np.uint8)
            db = np.zeros((B, lp), bool)
            lb = np.zeros(B, np.int32)
            ctr = np.zeros(B, np.int32)
            cb[:n], db[:n] = codes_t[s:s + n], dege_t[s:s + n]
            lb[:n] = lengths[sel]
            ctr[:n] = res.pos[mate[sel]]
            out = _window_batch(lp, C, self.params.max_mis,
                                self._arrays()[3],
                                jnp.int32(self.ref_len), jnp.asarray(cb),
                                jnp.asarray(db), jnp.asarray(lb),
                                jnp.asarray(ctr))
            jobs.append((sel, n, out))
        for sel, n, (m, p_, r, mm) in jobs:
            m = np.asarray(m)[:n]
            upd = sel[m]
            mapped[upd] = True
            pos[upd] = np.asarray(p_)[:n][m]
            is_rev[upd] = np.asarray(r)[:n][m]
            mis_mask[upd] = np.asarray(mm)[:n][m]
        # window-rescued reads are gapless; existing gap fields carry over
        return AlignResult(mapped, pos, is_rev, mis_mask,
                           res.gap_pos, res.gap_len,
                           res.gap_pos2, res.gap_len2,
                           chunks=res.chunks)

    def _host_ok(self, lp: int) -> bool:
        """Host-native alignment available and routed for this grid?
        Execution-only choice (decisions are bit-identical either way)."""
        if self._h_keys is None or lp // 16 + 2 > self._h_pad_words:
            return False
        from fastqueeze_tpu.io import native
        if native.get_lib() is None:
            return False
        import os
        mode = os.environ.get("FASTQUEEZE_ALIGN_EXEC", "")
        if mode == "host":
            return True
        if mode == "device":
            return False
        from fastqueeze_tpu.ops.host_frozen import auto_host
        return auto_host(self.params)

    def _use_host(self, cfg: AlignConfig) -> bool:
        if cfg.shard_axis:
            return False
        return self._host_ok(cfg.lp)

    def _run_tier(self, cfg: AlignConfig, flat, grids, lengths, rows,
                  mapped, pos, is_rev, mis_mask, batch: int) -> None:
        """Dispatch every batch asynchronously, then collect — one host
        sync for the whole tier instead of one per batch.  flat =
        (codes_flat, dege_flat, roffs); grids() lazily marshals the
        (R, lp) grids only if the device path runs."""
        if self._use_host(cfg):
            from fastqueeze_tpu.io import native
            codes_flat, dege_flat, roffs = flat
            sm = {"fwd": 0, "rc": 1, "both": 2}[cfg.strand]
            out = native.align_batch(
                self._h_keys, self._h_offsets, self._h_positions,
                self._h_packed, self._h_l1, self._l1_shift,
                self._search_steps, self.ref_len,
                codes_flat, dege_flat, roffs[rows], lengths[rows], cfg.lp,
                cfg.k, cfg.stride, cfg.n_cand, cfg.max_mis,
                cfg.n_seeds, cfg.excl_bp, cfg.probe_k, sm,
                int(cfg.both_strands))
            if out is not None:
                m, p_, r, mm = out
                mapped[rows] = m
                pos[rows] = p_
                is_rev[rows] = r
                mis_mask[rows] = mm
                return
        codes, dege = grids()
        lp = codes.shape[1]
        B = batch
        jobs = []
        keys, offsets, positions, packed, l1 = self._arrays()
        for s in range(0, len(rows), B):
            sel = rows[s:s + B]
            n = len(sel)
            cb = np.zeros((B, lp), np.uint8)
            db = np.zeros((B, lp), bool)
            lb = np.zeros(B, np.int32)
            cb[:n], db[:n], lb[:n] = codes[sel], dege[sel], lengths[sel]
            out = _align_batch(
                cfg, keys, offsets, positions,
                packed, l1, jnp.int32(self.ref_len),
                jnp.asarray(cb), jnp.asarray(db), jnp.asarray(lb))
            jobs.append((sel, n, out))
        for sel, n, (m, p_, r, mm) in jobs:
            mapped[sel] = np.asarray(m)[:n]
            pos[sel] = np.asarray(p_)[:n]
            is_rev[sel] = np.asarray(r)[:n]
            mis_mask[sel] = np.asarray(mm)[:n]
