"""Genome-scale aligned benchmark: one JSON line.

Runs the structured synthetic genome (tools/genome_fixture.py) through the
full aligned stack and reports what BASELINE.md's reference rows never
could (the reference was only ever measured on a 500 kb toy ref):

  * k=14 hash-tier index build time + index size + peak RSS at 100 Mbp
    (reference: 90 s / 2.1 GB dense table for 500 kb, HashRefIndex64)
  * map rate / ratio / encode+decode reads/s for the hash tier
  * k=22 -q tier (long seeds + multi-op indel): build, map rate, ratio
  * with >= 2 devices, an index-sharded alignment check
    (parallel/mesh.shard_ref_index + index_sharded_aligner) asserting
    agreement with the local kernel on the same genome reads

Everything runs in the calling process on the default JAX backend, with
the default placement.  The fixture is cached in --out-dir (default
tmp_genome/ in the checkout, gitignored) so repeat runs skip generation.
``run()`` is what bench.py calls.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _shard_check(fa: str) -> dict:
    """Index-sharded alignment over every visible device vs the local
    single-device kernel on the same 256 reads."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fastqueeze_tpu.align import hash as H
    from fastqueeze_tpu.align.index import build_from_ref
    from fastqueeze_tpu.align.ref import load_fasta
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.parallel.mesh import (index_sharded_aligner,
                                              make_mesh, shard_ref_index)
    n = len(jax.devices())
    if n < 2:
        return {"skipped": f"needs >= 2 devices, have {n}"}
    ref = load_fasta(fa)
    p = CodecParams(seed_max_occ=32)
    idx = build_from_ref(ref, p)
    al = H.Aligner(idx, p)
    rng = np.random.default_rng(17)
    R, L = 256, 150
    starts = rng.integers(0, ref.length - L, R)
    lp = al._lp_bucket(L)
    cg = np.zeros((R, lp), np.uint8)
    for i, st in enumerate(starts):
        c = ref.codes[st:st + L].copy()
        mp = rng.integers(0, L, rng.integers(0, 4))
        c[mp] = (c[mp] + 1) % 4
        if i % 3 == 0:
            c = 3 - c[::-1]
        cg[i, :L] = c
    dg = np.zeros((R, lp), bool)
    lengths = np.full(R, L, np.int64)
    cfg1 = H.AlignConfig(k=idx.k, stride=p.seed_stride,
                         n_cand=p.seed_max_occ, max_mis=p.max_mis,
                         both_strands=p.both_strands, lp=lp,
                         l1_shift=al._l1_shift,
                         search_steps=al._search_steps, wide=al.wide)
    lm, _, _, lmm = H._align_batch(
        cfg1, al._keys, al._offsets, al._positions, al._packed, al._l1,
        jnp.int32(idx.ref_len), jnp.asarray(cg), jnp.asarray(dg),
        jnp.asarray(lengths.astype(np.int32)))
    mesh = make_mesh(n, ctx_shards=n)
    t0 = time.time()
    sh = shard_ref_index(idx, n)
    t_shard = time.time() - t0
    t0 = time.time()
    m, _pos, _rev, mm = index_sharded_aligner(mesh, sh)(p, cg, dg,
                                                        lengths)
    m = np.asarray(m)
    t_align = time.time() - t0
    agree = bool(np.array_equal(m, np.asarray(lm))
                 and np.array_equal(np.asarray(mm).sum(1),
                                    np.asarray(lmm).sum(1)))
    if not agree:
        raise RuntimeError("index-sharded alignment disagrees with the "
                           "local kernel")
    return {"reads": R, "mapped": int(m.sum()), "agrees_with_local": agree,
            "n_shards": n, "shard_s": round(t_shard, 2),
            "align_s": round(t_align, 2), "keys_per_shard": int(sh["kp"])}


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def run(mbp: int, reads: int, out_dir: str) -> dict:
    """All rows for an ``mbp``-Mbp genome and ``reads`` reads; raises if
    any round trip is not bit-exact."""
    from genome_fixture import build_fixture

    from fastqueeze_tpu.align.index import (build_from_ref, index_path,
                                            save_index)
    from fastqueeze_tpu.align.ref import load_fasta
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.pipeline.aligned import compress_se_aligned
    from fastqueeze_tpu.pipeline.driver import decompress

    out = {"size_mbp": mbp, "reads": reads}
    t0 = time.time()
    fa, fq = build_fixture(out_dir, mbp * 1_000_000, reads,
                           read_len=150, indel_frac=0.03)
    out["fixture_s"] = round(time.time() - t0, 1)
    fq_md5 = hashlib.md5(open(fq, "rb").read()).digest()
    tmp = os.path.join(out_dir, "bench_arcs")
    os.makedirs(tmp, exist_ok=True)

    # --- k14 hash-tier index: timed fresh build (the BENCH row) ---
    ref = load_fasta(fa)
    t0 = time.time()
    idx = build_from_ref(ref, CodecParams())
    out["index_build_s"] = round(time.time() - t0, 1)
    out["index_mb"] = round((idx.keys.nbytes + idx.offsets.nbytes
                             + idx.positions.nbytes + idx.packed.nbytes)
                            / 2**20, 1)
    out["index_keys"] = idx.n_keys
    save_index(idx, index_path(fa))
    del idx, ref

    # --- hash tier: cold (incl. index load + model training) + warm ---
    arc = os.path.join(tmp, "hash.fqz")
    t0 = time.time()
    s = compress_se_aligned(CodecParams(threads=1), fa, fq, arc)
    cold = time.time() - t0
    t0 = time.time()
    s = compress_se_aligned(CodecParams(threads=1), fa, fq, arc)
    warm = time.time() - t0
    out["hash"] = {
        "mapped": s["mapped"], "map_rate": round(s["mapped"] / s["reads"], 4),
        "ratio": round(s["ratio"], 3),
        "enc_cold_reads_per_s": round(reads / cold, 1),
        "enc_reads_per_s": round(reads / warm, 1),
    }
    t0 = time.time()
    outs = decompress(arc, os.path.join(tmp, "back"), force=True,
                      threads=1, ref=fa)
    ddt = time.time() - t0
    out["hash"]["dec_reads_per_s"] = round(reads / ddt, 1)
    out["hash"]["dec_ok"] = (
        hashlib.md5(open(outs[0], "rb").read()).digest() == fq_md5)

    # --- long-read tier (no reference equivalent): HiFi-like 5-20 kb
    # reads at 0.3% substitution error, chunk-anchor-mapped ---
    lr_fq = os.path.join(out_dir, "longreads2.fq")
    n_lr = 2000
    if not os.path.exists(lr_fq):
        import numpy as np

        from fastqueeze_tpu.align.ref import load_fasta as _lf
        r = _lf(fa)
        codes = np.where(r.amb_mask, np.uint8(4), r.codes)
        rng = np.random.default_rng(4)
        with open(lr_fq, "wb") as fh:
            for i in range(n_lr):
                L = int(rng.integers(5_000, 20_000))
                st = int(rng.integers(0, len(codes) - L))
                rd = codes[st:st + L + 16].copy()
                # HiFi-like: 0.3% subs + ~1e-4/bp homopolymer-ish indels
                for _ in range(max(0, int(rng.poisson(L * 1e-4)))):
                    at = int(rng.integers(20, L - 20))
                    g = int(rng.integers(1, 3))
                    if rng.random() < 0.5:
                        rd = np.concatenate([rd[:at], rd[at + g:]])
                    else:
                        rd = np.concatenate(
                            [rd[:at],
                             rng.integers(0, 4, g).astype(np.uint8),
                             rd[at:]])
                rd = rd[:L]
                amb = rd == 4
                err = (rng.random(L) < 0.003) & ~amb
                rd[err] ^= rng.integers(1, 4, int(err.sum())).astype(
                    np.uint8)
                if i % 2:
                    rd = np.where(rd == 4, 4,
                                  3 - np.where(amb, 0, rd))[::-1]
                seq = np.frombuffer(b"ACGTN", np.uint8)[rd].tobytes()
                fh.write(b"@LR.%d\n%s\n+\n%s\n"
                         % (i, seq, bytes([73]) * L))
    lr_md5 = hashlib.md5(open(lr_fq, "rb").read()).digest()
    from fastqueeze_tpu.pipeline.driver import compress_se as _cse
    s_plain = _cse(CodecParams(threads=1), lr_fq,
                   os.path.join(tmp, "lr_plain.fqz"))
    arc_lr = os.path.join(tmp, "lr.fqz")
    s_lr = compress_se_aligned(CodecParams(threads=1), fa, lr_fq, arc_lr)
    t0 = time.time()
    s_lr = compress_se_aligned(CodecParams(threads=1), fa, lr_fq, arc_lr)
    dlr = time.time() - t0
    t0 = time.time()
    outs_lr = decompress(arc_lr, os.path.join(tmp, "lr_back"), force=True,
                         threads=1, ref=fa)
    dlrd = time.time() - t0
    lr_bases = os.path.getsize(lr_fq) // 2
    out["longread"] = {
        "reads": n_lr,
        "ratio": round(s_lr["ratio"], 2),
        "entropy_only_ratio": round(s_plain["ratio"], 2),
        "enc_mbases_per_s": round(lr_bases / 1e6 / dlr, 2),
        "dec_mbases_per_s": round(lr_bases / 1e6 / dlrd, 2),
        "dec_ok": (hashlib.md5(open(outs_lr[0], "rb").read()).digest()
                   == lr_md5),
    }

    # --- -q long-seed tier (k=22 wide keys + multi-op indel) ---
    ref = load_fasta(fa)
    t0 = time.time()
    idxq = build_from_ref(ref, CodecParams(seed_len=22))
    out["q_index_build_s"] = round(time.time() - t0, 1)
    save_index(idxq, index_path(fa))       # -q runs see the k22 index
    del idxq, ref
    arcq = os.path.join(tmp, "q.fqz")
    mkq = lambda: CodecParams(threads=1, seed_len=22, max_indel=3)  # noqa: E731
    sq = compress_se_aligned(mkq(), fa, fq, arcq)       # warm-up
    t0 = time.time()
    sq = compress_se_aligned(mkq(), fa, fq, arcq)
    dq = time.time() - t0
    out["q_mode"] = {
        "mapped": sq["mapped"],
        "map_rate": round(sq["mapped"] / sq["reads"], 4),
        "ratio": round(sq["ratio"], 3),
        "enc_reads_per_s": round(reads / dq, 1),
    }
    outsq = decompress(arcq, os.path.join(tmp, "backq"), force=True,
                       threads=1, ref=fa)
    out["q_mode"]["dec_ok"] = (
        hashlib.md5(open(outsq[0], "rb").read()).digest() == fq_md5)
    out["peak_rss_mb"] = round(_rss_mb(), 0)

    out["index_sharded"] = _shard_check(fa)
    for row in ("hash", "longread", "q_mode"):
        if not out[row]["dec_ok"]:
            raise RuntimeError(f"genome bench: {row} round trip failed")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=int, default=100)
    ap.add_argument("--reads", type=int, default=300_000)
    ap.add_argument("--out-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tmp_genome"))
    a = ap.parse_args()
    print(json.dumps(run(a.mbp, a.reads, a.out_dir)))


if __name__ == "__main__":
    main()
