"""ShardedAligner production path: references past the single-device int32
limit compress through the index-sharded mesh kernel (SURVEY.md §2.3
"reference index sharded across devices").  Exercised at toy scale by
monkeypatching SHARD_MIN_POSITIONS (the real >2^31 regime is checked by
tools/bigref_check.py)."""

import hashlib
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from genome_fixture import make_genome, sample_reads, write_fasta, \
    write_fastq  # noqa: E402

from fastqueeze_tpu.align import sharded  # noqa: E402
from fastqueeze_tpu.config import CodecParams  # noqa: E402
from fastqueeze_tpu.pipeline.aligned import compress_se_aligned, \
    prepare_ref  # noqa: E402
from fastqueeze_tpu.pipeline.driver import decompress  # noqa: E402


@pytest.fixture()
def forced_shard(monkeypatch):
    # every index "exceeds" the single-chip limit
    monkeypatch.setattr(sharded, "SHARD_MIN_POSITIONS", 1)
    # fresh aligner per test (the prepare_ref cache would serve the
    # previously built single-chip Aligner otherwise)
    from fastqueeze_tpu.pipeline import aligned
    monkeypatch.setattr(aligned, "_REF_CACHE", {})


def test_sharded_aligner_end_to_end(tmp_path, forced_shard):
    codes, bounds = make_genome(800_000, seed=3)
    fa = str(tmp_path / "ref.fa")
    write_fasta(codes, bounds, fa)
    rng = np.random.default_rng(4)
    seqs, quals = sample_reads(codes, 1500, 150, rng, contam_frac=0.02)
    fq = str(tmp_path / "reads.fq")
    write_fastq(seqs, quals, fq)

    p = CodecParams(threads=1)
    aligner, _ = prepare_ref(p, fa)
    assert isinstance(aligner, sharded.ShardedAligner)
    arc = str(tmp_path / "s.fqz")
    stats = compress_se_aligned(CodecParams(threads=1), fa, fq, arc)
    # gapless multi-seed pass: map rate tracks the hash tier on
    # sub-only reads (no indel tier in the sharded envelope)
    assert stats["mapped"] / stats["reads"] > 0.80, stats
    outs = decompress(arc, str(tmp_path / "back"), force=True, threads=1,
                      ref=fa)
    assert (hashlib.md5(open(outs[0], "rb").read()).digest()
            == hashlib.md5(open(fq, "rb").read()).digest())


def test_sharded_aligner_longreads(tmp_path, forced_shard):
    """The long-read chunk tier rides the sharded aligner transparently
    (chunks are plain reads to it)."""
    codes, bounds = make_genome(400_000, seed=5)
    fa = str(tmp_path / "ref.fa")
    write_fasta(codes, bounds, fa)
    rng = np.random.default_rng(6)
    recs = []
    B = np.frombuffer(b"ACGT", np.uint8)
    for i in range(15):
        L = int(rng.integers(4000, 9000))
        st = int(rng.integers(0, len(codes) - L))
        r = np.minimum(codes[st:st + L], 3)
        recs.append(b"@l.%d\n%s\n+\n%s\n"
                    % (i, B[r].tobytes(), bytes([70]) * L))
    fq = tmp_path / "lr.fq"
    fq.write_bytes(b"".join(recs))
    arc = str(tmp_path / "lr.fqz")
    from fastqueeze_tpu.utils.metrics import DebugInfo
    dbg = DebugInfo()
    compress_se_aligned(CodecParams(threads=1), fa, str(fq), arc, dbg=dbg)
    assert dbg.vals.get("lr_chunks_mapped", 0) > 50
    outs = decompress(arc, str(tmp_path / "lback"), force=True,
                      threads=1, ref=fa)
    assert (hashlib.md5(open(outs[0], "rb").read()).digest()
            == hashlib.md5(fq.read_bytes()).digest())


def test_sharded_aligner_compiles_once_across_batches(monkeypatch):
    """The index shards are placed once per aligner and the batch program
    compiles once: later batches of the same shape compile nothing."""
    import jax

    from fastqueeze_tpu.align.index import build_from_ref
    from fastqueeze_tpu.align.ref import RefSeq
    from genome_fixture import _code_of
    codes, _bounds = make_genome(200_000, seed=7)
    ref = RefSeq(codes=codes, amb_mask=np.zeros(len(codes), bool),
                 names=["c"], bounds=np.array([0, len(codes)]), md5="")
    p = CodecParams(threads=1)
    al = sharded.ShardedAligner(build_from_ref(ref, p), p,
                                devices=jax.devices()[:4])
    monkeypatch.setattr(al, "BATCH", 128)
    seqs, _q = sample_reads(codes, 3 * 128, 150, np.random.default_rng(8))
    lengths = np.full(len(seqs), 150, np.int64)
    read_codes = _code_of(seqs).reshape(-1)
    dege = read_codes > 3
    flat = np.minimum(read_codes, 3)
    compiles = []

    def on_event(event, _secs, **_kw):
        if event == "/jax/core/compile/backend_compile_duration":
            compiles.append(event)

    jax.monitoring.register_event_duration_secs_listener(on_event)
    try:
        first = al.align(flat, dege, lengths)
        n_first = len(compiles)
        again = al.align(flat, dege, lengths)
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)
    assert n_first > 0 and len(compiles) == n_first
    assert first.mapped.mean() > 0.8
    np.testing.assert_array_equal(first.pos, again.pos)


def test_sharded_aligner_needs_mesh(monkeypatch):
    """A big index with one visible device fails with guidance."""
    from fastqueeze_tpu.align.index import RefIndex
    idx = RefIndex(k=14, ref_len=100, ref_md5="x",
                   keys=np.zeros(1, np.uint32),
                   offsets=np.zeros(2, np.uint64),
                   positions=np.zeros(1, np.uint32),
                   packed=np.zeros(8, np.uint32), names=["c"],
                   bounds=np.array([0, 100]))
    import jax
    with pytest.raises(ValueError, match="mesh"):
        sharded.ShardedAligner(idx, CodecParams(), devices=jax.devices()[:1])
