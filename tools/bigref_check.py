"""Beyond-int32 reference validation: a 2.2 Gbp reference (more windows
than 2^31 — the human-genome scale the single-device aligner refuses)
through the sharded-index path, checking COORDINATE EXACTNESS for reads
sampled above 2^31.

The u32/u64 coordinate tiers only engage at this size; the unit test (tests/test_genome_scale.py)
drives the dtype plumbing with a faked length.  This runs the real
thing: native CSR build over 2.2e9 windows (u32 positions), 4-way key
range shards (parallel/mesh.shard_ref_index), and the index-sharded
alignment kernel over an 8-virtual-device mesh.  Error-free reads from
a random genome map uniquely, so the check is exact: every read sampled
at position p (including p > 2^31) must map at exactly p.

Prints one JSON line; about 25 min and 70 GB of host RSS on one CPU core.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["FASTQUEEZE_NO_COMPILE_CACHE"] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> None:
    import resource

    import jax
    jax.config.update("jax_platforms", "cpu")

    from fastqueeze_tpu.align.index import build_from_ref
    from fastqueeze_tpu.align.ref import RefSeq
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.parallel.mesh import (index_sharded_aligner,
                                              make_mesh, shard_ref_index)

    G = 2_200_000_000                      # > 2^31 windows
    out = {"ref_bp": G}
    rng = np.random.default_rng(123)
    t0 = time.time()
    codes = rng.integers(0, 4, G, dtype=np.int64).astype(np.uint8)
    out["gen_s"] = round(time.time() - t0, 1)
    ref = RefSeq(codes=codes, amb_mask=np.zeros(G, bool), names=["big"],
                 bounds=np.array([0, G]), md5="big")
    p = CodecParams(seed_max_occ=32)
    t0 = time.time()
    idx = build_from_ref(ref, p)
    out["index_build_s"] = round(time.time() - t0, 1)
    out["n_positions"] = idx.n_positions
    out["n_keys"] = idx.n_keys
    out["pos_dtype"] = str(idx.positions.dtype)
    assert idx.n_positions > (1 << 31), "must exceed int32 positions"

    # reads: half sampled ABOVE 2^31, half below; error-free -> exact map
    R, L = 64, 150
    his = rng.integers((1 << 31), G - L, R // 2)
    los = rng.integers(0, 1 << 31, R - R // 2)
    starts = np.concatenate([his, los])
    lp = 160
    cg = np.zeros((R, lp), np.uint8)
    for i, st in enumerate(starts):
        c = codes[st:st + L]
        cg[i, :L] = (3 - c[::-1]) if i % 3 == 0 else c
    dg = np.zeros((R, lp), bool)
    lengths = np.full(R, L, np.int64)
    del ref

    t0 = time.time()
    sh = shard_ref_index(idx, 4)
    out["shard_s"] = round(time.time() - t0, 1)
    out["pos_per_shard"] = int(sh["positions"].shape[1])
    del idx, codes
    import gc
    gc.collect()

    mesh = make_mesh(8, ctx_shards=4)
    t0 = time.time()
    m, pos, rev, mm = index_sharded_aligner(mesh, sh)(p, cg, dg, lengths)
    m = np.asarray(m)
    pos = np.asarray(pos).astype(np.uint32).astype(np.int64)
    out["align_s"] = round(time.time() - t0, 1)
    out["mapped"] = int(m.sum())
    exact = bool(m.all()) and bool((pos == starts).all())
    out["coords_exact"] = exact
    out["above_2g31_mapped"] = int(m[:R // 2].sum())
    out["above_2g31_exact"] = bool((pos[:R // 2] == starts[:R // 2]).all())
    out["peak_rss_gb"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024 / 1024, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
