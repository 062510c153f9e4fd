"""Sharded-index aligner for references past the single-device limit.

``Aligner`` (align/hash.py) refuses indexes with >= 2^31 positions
(human-scale whole genomes: GRCh38 is ~3.1 Gbp) because its device and
host tiers carry int32 coordinates.  This facade serves exactly that
regime: the counted-CSR index is split into equal-key-count range shards
over the mesh's devices (parallel/mesh.shard_ref_index, u32 coordinates
— up to 4 Gbp; tools/bigref_check.py checks positions above 2^31) and
every batch runs the one-pass multi-seed gapless kernel with pmin/pmax
lookup collectives (index_sharded_aligner — SURVEY.md §2.3's
"reference index sharded across devices" north star).

Capability envelope vs the single-chip Aligner: gapless only (no indel
rescue tier — such reads stay entropy-coded) and no PE window rescue;
the multi-seed candidate diversity (rescue_seeds/seed_excl_bp) runs
fused into the single pass, so mapping quality tracks the hash tier's.
``pipeline/aligned.prepare_ref`` picks this class automatically when the
index exceeds the single-chip limit.
"""

from __future__ import annotations

import numpy as np

from fastqueeze_tpu.align.hash import AlignResult, _gridify, _intra
from fastqueeze_tpu.align.index import RefIndex
from fastqueeze_tpu.config import CodecParams

# Indexes at or past this many positions (or reference bases) exceed the
# single-chip int32 coordinate space and route here.  Tests monkeypatch
# it to exercise the path at toy scale.
SHARD_MIN_POSITIONS = 1 << 31


class ShardedAligner:
    BATCH = 4096

    def __init__(self, idx: RefIndex, params: CodecParams, devices=None):
        import jax

        from fastqueeze_tpu.parallel.mesh import (
            index_sharded_aligner, make_mesh, shard_ref_index)
        devs = devices or jax.devices()
        n = (params.mesh_n if params.mesh_n and params.mesh_n > 0
             else len(devs))
        n = min(n, len(devs))
        if n < 2:
            raise ValueError(
                f"reference has {idx.n_positions} indexed positions — past "
                "the single-chip int32 limit; the sharded-index path needs "
                "a multi-device mesh (--mesh N, N >= 2)")
        self.params = params
        self.k = idx.k
        self.ref_len = idx.ref_len
        self.n_shards = n
        self.mesh = make_mesh(n, ctx_shards=n)
        # the shards go to the devices here, once; batches move only reads
        self._align_batch = index_sharded_aligner(
            self.mesh, shard_ref_index(idx, n))

    def _lp_bucket(self, max_len: int) -> int:
        lp = 32
        while lp < max_len:
            lp *= 2
        return lp

    def align(self, codes_flat: np.ndarray, dege_flat: np.ndarray,
              lengths: np.ndarray, allow_indel: bool = True,
              max_indel=None) -> AlignResult:
        """Aligner.align-compatible: indel arguments are accepted and
        ignored (gapless envelope — gap fields come back None)."""
        p = self.params
        R = len(lengths)
        if R == 0 or self.ref_len < self.k:
            lp = 32
            return AlignResult(np.zeros(R, bool), np.zeros(R, np.int64),
                               np.zeros(R, bool), np.zeros((R, lp), bool))
        cap = p.align_max_len
        max_len = int(lengths.max())
        if max_len > cap:
            # long reads skip the per-read grid (their chunks arrive here
            # separately via the long-read tier) — same shell as Aligner
            sel = np.flatnonzero(lengths <= cap)
            lp = self._lp_bucket(int(lengths[sel].max()) if len(sel)
                                 else 32)
            res = AlignResult(np.zeros(R, bool), np.zeros(R, np.int64),
                              np.zeros(R, bool), np.zeros((R, lp), bool))
            if len(sel):
                off = np.cumsum(lengths) - lengths
                idx2 = (np.repeat(off[sel], lengths[sel])
                        + _intra(lengths[sel]))
                sub = self.align(codes_flat[idx2], dege_flat[idx2],
                                 lengths[sel])
                res.mapped[sel] = sub.mapped
                res.pos[sel] = sub.pos
                res.is_rev[sel] = sub.is_rev
                res.mis_mask[sel] = sub.mis_mask
            return res
        lp = self._lp_bucket(max_len)
        codes_g, dege_g = _gridify(codes_flat, dege_flat, lengths, lp)
        mapped = np.zeros(R, bool)
        pos = np.zeros(R, np.int64)
        is_rev = np.zeros(R, bool)
        mis_mask = np.zeros((R, lp), bool)
        B = self.BATCH
        jobs = []
        for s in range(0, R, B):
            n = min(B, R - s)
            cb = np.zeros((B, lp), np.uint8)
            db = np.zeros((B, lp), bool)
            lb = np.zeros(B, np.int64)
            cb[:n], db[:n] = codes_g[s:s + n], dege_g[s:s + n]
            lb[:n] = lengths[s:s + n]
            out = self._align_batch(
                p, cb, db, lb, n_seeds=p.rescue_seeds,
                excl_bp=p.seed_excl_bp, n_cand=p.seed_max_occ)
            jobs.append((s, n, out))
        for s, n, (m, p_, r, mm) in jobs:
            sl = slice(s, s + n)
            mapped[sl] = np.asarray(m)[:n]
            # u32 coordinates (refs to 4 Gbp) — widen before int64 use
            pos[sl] = np.asarray(p_)[:n].astype(np.uint32).astype(np.int64)
            is_rev[sl] = np.asarray(r)[:n]
            mis_mask[sl] = np.asarray(mm)[:n]
        return AlignResult(mapped, pos, is_rev, mis_mask)

    def rescue_mates(self, codes_flat, dege_flat, lengths, res,
                     max_insr):
        """PE insert-window rescue is not in the sharded envelope (the
        anchored window verify carries int32 coords); pairs keep their
        independent mappings."""
        return res
