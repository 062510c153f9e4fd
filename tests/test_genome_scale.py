"""Genome-scale aligned validation at unit-test size.

The bench (bench.py "genome" block) runs the 100 Mbp fixture; these tests
run the SAME generator and the same code paths at ~1.5 Mbp so the suite
stays fast: structured-repeat mapping, -q indel mapping, the
sharded-index mesh path on genuinely repetitive data, and the u64
key/position index tier (HashRefIndex64 parity — reference
``HashRefIndex64::initMemory @0x41e8d0``).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from genome_fixture import (  # noqa: E402
    make_genome, sample_reads, write_fasta, write_fastq)

from fastqueeze_tpu.config import CodecParams  # noqa: E402

N_READS = 2500
READ_LEN = 150
INDEL_FRAC = 0.04
CONTAM = 0.02


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("genome")
    codes, bounds = make_genome(1_500_000, seed=99)
    fa = str(tmp / "ref.fa")
    write_fasta(codes, bounds, fa)
    rng = np.random.default_rng(100)
    seqs, quals = sample_reads(codes, N_READS, READ_LEN, rng,
                               indel_frac=INDEL_FRAC, contam_frac=CONTAM)
    fq = str(tmp / "reads.fq")
    write_fastq(seqs, quals, fq)
    return {"codes": codes, "bounds": bounds, "fa": fa, "fq": fq,
            "tmp": tmp}


def test_genome_structure(fixture):
    codes, bounds = fixture["codes"], fixture["bounds"]
    assert len(bounds) == 5 and bounds[-1] == len(codes)
    nfrac = (codes == 4).mean()
    assert 0.0003 < nfrac < 0.03, nfrac
    # repeat content: a meaningful fraction of 14-mers must be
    # non-unique (satellite/SINE/LINE copies) — that is what makes the
    # fixture an aligner test and not a toy
    k = 14
    sl = codes[: 400_000]
    kv = np.zeros(len(sl) - k + 1, np.uint32)
    for j in range(k):
        kv = (kv << np.uint32(2)) | sl[j: j + len(kv)].astype(np.uint32)
    _, counts = np.unique(kv, return_counts=True)
    rep = counts[counts > 1].sum() / counts.sum()
    assert rep > 0.10, f"repeat fraction {rep:.3f}"


def test_hash_tier_roundtrip_and_map_rate(fixture, tmp_path):
    import hashlib

    from fastqueeze_tpu.pipeline.aligned import compress_se_aligned
    from fastqueeze_tpu.pipeline.driver import decompress
    arc = str(tmp_path / "g.fqz")
    s = compress_se_aligned(CodecParams(threads=1), fixture["fa"],
                            fixture["fq"], arc)
    # ceiling = 1 - contamination; errors + indels + satellite N-masking
    # cost a few percent
    assert s["mapped"] / s["reads"] > 0.82, s
    outs = decompress(arc, str(tmp_path / "back"), force=True, threads=1,
                      ref=fixture["fa"])
    assert (hashlib.md5(open(outs[0], "rb").read()).digest()
            == hashlib.md5(open(fixture["fq"], "rb").read()).digest())


def test_q_tier_maps_indel_reads(fixture, tmp_path):
    from fastqueeze_tpu.pipeline.aligned import compress_se_aligned
    arc = str(tmp_path / "q.fqz")
    base = compress_se_aligned(CodecParams(threads=1), fixture["fa"],
                               fixture["fq"], arc)
    arc2 = str(tmp_path / "q2.fqz")
    q = compress_se_aligned(
        CodecParams(threads=1, seed_len=22, max_indel=3), fixture["fa"],
        fixture["fq"], arc2)
    # the indel tier must recover (most of) the INDEL_FRAC gap
    assert q["mapped"] > base["mapped"] + N_READS * INDEL_FRAC * 0.5, \
        (base["mapped"], q["mapped"])


def test_index_sharded_matches_local_on_genome(fixture):
    """index_sharded_aligner on the structured-repeat fixture (not a
    uniform-random toy): same mapping decisions as the local kernel."""
    import jax.numpy as jnp

    from fastqueeze_tpu.align import hash as H
    from fastqueeze_tpu.align.index import build_from_ref
    from fastqueeze_tpu.align.ref import load_fasta
    from fastqueeze_tpu.parallel.mesh import (
        index_sharded_aligner, make_mesh, shard_ref_index)
    ref = load_fasta(fixture["fa"])
    p = CodecParams(seed_max_occ=32)
    idx = build_from_ref(ref, p)
    al = H.Aligner(idx, p)

    rng = np.random.default_rng(3)
    R, L = 64, READ_LEN
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
    lm, lpos, lrev, lmm = H._align_batch(
        cfg1, al._keys, al._offsets, al._positions, al._packed, al._l1,
        jnp.int32(idx.ref_len), jnp.asarray(cg), jnp.asarray(dg),
        jnp.asarray(lengths.astype(np.int32)))
    lm = np.asarray(lm)
    assert lm.sum() > R * 0.8

    mesh = make_mesh(8, ctx_shards=4)
    sh = shard_ref_index(idx, 4)
    m, pos, rev, mm = index_sharded_aligner(mesh, sh)(p, cg, dg, lengths)
    assert np.array_equal(np.asarray(m), lm)
    assert np.array_equal(np.asarray(mm).sum(axis=1),
                          np.asarray(lmm).sum(axis=1))


class _HugeRef:
    """RefSeq stand-in reporting a >4 Gbp length (the codes themselves
    stay small — only the dtype tiers depend on the reported length)."""

    def __init__(self, inner):
        self._i = inner

    def __getattr__(self, name):
        return getattr(self._i, name)

    @property
    def length(self):
        return 5_000_000_000

    def packed(self):
        return self._i.packed()


def test_u64_position_tier(tmp_path):
    """>4 Gbp references take the u64-position index tier
    (align/index.py pos_dtype; HashRefIndex64 parity): build, save/load
    preserving dtype, single-chip aligner refusal, and the sharded-index
    u32-coordinate guard."""
    from fastqueeze_tpu.align import hash as H
    from fastqueeze_tpu.align.index import (
        build_from_ref, load_index_file, save_index)
    from fastqueeze_tpu.align.ref import RefSeq
    from fastqueeze_tpu.parallel.mesh import shard_ref_index
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 30_000).astype(np.uint8)
    inner = RefSeq(codes=codes, amb_mask=np.zeros(len(codes), bool),
                   names=["huge"], bounds=np.array([0, len(codes)]),
                   md5="h")
    p = CodecParams(seed_len=16)        # wide keys (u64 key tier) too
    idx = build_from_ref(_HugeRef(inner), p)
    assert idx.positions.dtype == np.uint64
    assert idx.keys.dtype == np.uint64          # k>15 key tier
    assert idx.ref_len == 5_000_000_000
    path = str(tmp_path / "huge.fqzidx")
    save_index(idx, path)
    idx2 = load_index_file(path)
    assert idx2.positions.dtype == np.uint64
    assert idx2.keys.dtype == np.uint64
    np.testing.assert_array_equal(idx.positions, idx2.positions)
    np.testing.assert_array_equal(idx.keys, idx2.keys)
    assert idx2.ref_len == idx.ref_len
    # the single-chip aligner must refuse and point at the sharded path
    with pytest.raises(ValueError, match="too large"):
        H.Aligner(idx2, p)
    # the sharded index carries u32 coords (4 Gbp max) — clear refusal,
    # not silent truncation
    with pytest.raises(ValueError, match="u32"):
        shard_ref_index(idx2, 4)
