"""Duplicate-read tier (CodecParams.dedup): reads byte-identical to an
earlier read in the same block are coded as back-references (flag +
distance to the first occurrence), sequence and quality independently.
No reference equivalent (SeqArc re-codes every symbol); the real-world
hook is PCR/optical duplicates and replicated inputs."""

import random

import numpy as np
import pytest

from fastqueeze_tpu.config import CodecParams
from fastqueeze_tpu.pipeline.blockcodec import _dup_sources, dup_masks
from fastqueeze_tpu.pipeline.driver import compress_se, decompress

SMALL = dict(slevel=0, lanes_min=16, lanes_max=32, lane_target_symbols=512)


# --- unit: _dup_sources ---------------------------------------------------

def test_dup_sources_first_occurrence():
    lens = np.array([4, 4, 4, 4, 4], np.int64)
    flat = np.frombuffer(b"AAAACCCCAAAACCCCAAAA", np.uint8)
    src = _dup_sources(flat, lens)
    assert src is not None
    # reads 2/4 duplicate read 0; read 3 duplicates read 1
    assert src.tolist() == [-1, -1, 0, 1, 0]


def test_dup_sources_no_dups_returns_none():
    lens = np.array([3, 3, 3], np.int64)
    flat = np.frombuffer(b"AAACCCGGG", np.uint8)
    assert _dup_sources(flat, lens) is None


def test_dup_sources_var_lengths():
    # same prefix bytes, different lengths: never merged
    lens = np.array([3, 4, 3, 4], np.int64)
    flat = np.frombuffer(b"AAAAAAAAAAAAAA", np.uint8)
    src = _dup_sources(flat, lens)
    assert src.tolist() == [-1, -1, 0, 1]


def test_dup_sources_sources_are_never_dups():
    rng = np.random.default_rng(3)
    lens = np.full(200, 20, np.int64)
    pool = rng.integers(0, 4, size=(10, 20)).astype(np.uint8) + ord("A")
    flat = pool[rng.integers(0, 10, 200)].reshape(-1)
    src = _dup_sources(flat, lens)
    dup = src >= 0
    assert dup.sum() == 190                  # 10 uniques
    assert not dup[src[dup]].any()           # sources are first occurrences
    # and content really matches
    mat = flat.reshape(200, 20)
    assert (mat[dup] == mat[src[dup]]).all()


def test_dup_masks_cached_on_block(tmp_path):
    from fastqueeze_tpu.io.fastq import parse_block
    raw = b"@a\nACGT\n+\n!!!!\n@b\nACGT\n+\n####\n"
    blk = parse_block(raw, True)
    m1 = dup_masks(blk)
    assert dup_masks(blk) is m1
    s_src, q_src = m1
    assert s_src.tolist() == [-1, 0]         # seq dup, quals differ
    assert q_src is None


def test_dup_sources_native_numpy_twin():
    # the native one-pass (duphash.cpp) must agree with the numpy mirror
    # exactly, including first-occurrence choice on every group
    from fastqueeze_tpu.io import native
    from fastqueeze_tpu.pipeline.blockcodec import _dup_sources_np
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(17)
    for trial in range(6):
        R = int(rng.integers(5, 400))
        lens = rng.integers(1, 40, R).astype(np.int64)
        if trial % 2:
            lens[:] = lens[0]                   # constant-length fast path
        pool = rng.integers(0, 4, size=(8, 64)).astype(np.uint8)
        flat = np.concatenate([
            pool[rng.integers(0, 8), :L] for L in lens])
        src_c, n_c = native.dup_sources(flat, lens)
        src_py = _dup_sources_np(flat, lens)
        if src_py is None:
            assert n_c == 0
        else:
            assert n_c == int((src_py >= 0).sum())
            assert np.array_equal(src_c, src_py)


# --- end-to-end -----------------------------------------------------------

def _roundtrip(tmp_path, raw, **kw):
    p = CodecParams(**{**SMALL, **kw})
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    arc = str(tmp_path / "out.fqz")
    stats = compress_se(p, str(src), arc)
    outs = decompress(arc, str(tmp_path / "back"), force=True)
    assert open(outs[0], "rb").read() == raw
    return stats


def _pcr_fastq(n_unique=120, dup_factor=3, L=50, seed=5):
    """PCR-duplicate shape: repeated sequences, fresh qualities each time."""
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), L)) for _ in range(n_unique)]
    recs = []
    for i in range(n_unique * dup_factor):
        q = "".join(chr(33 + int(x)) for x in rng.integers(2, 40, L))
        recs.append(f"@p.{i}\n{seqs[i % n_unique]}\n+\n{q}\n")
    return "".join(recs).encode()


def test_replicated_input_dedup_roundtrip_and_ratio(tmp_path):
    rng = np.random.default_rng(9)
    recs = []
    for i in range(200):
        seq = "".join(rng.choice(list("ACGTN"), 60))
        q = "".join(chr(33 + int(x)) for x in rng.integers(0, 40, 60))
        recs.append(f"@r.{i} z\n{seq}\n+\n{q}\n")
    raw = ("".join(recs) * 5).encode()      # 5x replication inside one block
    s_on = _roundtrip(tmp_path, raw)
    s_off = _roundtrip(tmp_path, raw, dedup=0)
    # random quals are near-incompressible: dedup must win big
    assert s_on["compressed"] < 0.45 * s_off["compressed"]


def test_pcr_duplicates_roundtrip(tmp_path):
    # identical sequences + fresh qualities: seq-dup fires, qual-dup doesn't
    _roundtrip(tmp_path, _pcr_fastq())


def test_dedup_with_degenerate_bases(tmp_path):
    # duplicated reads carrying Ns: the dup copy must restore them (dup
    # reads are excluded from the dege streams)
    rng = np.random.default_rng(11)
    recs = []
    for i in range(60):
        seq = list("".join(rng.choice(list("ACGT"), 40)))
        seq[rng.integers(0, 40)] = "N"
        q = "".join(chr(33 + int(x)) for x in rng.integers(0, 40, 40))
        recs.append(f"@d.{i}\n{''.join(seq)}\n+\n{q}\n")
    raw = ("".join(recs) * 3).encode()
    _roundtrip(tmp_path, raw)


def test_dedup_off_param_respected(tmp_path):
    raw = _pcr_fastq(n_unique=40, dup_factor=2)
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    arc = str(tmp_path / "o.fqz")
    compress_se(CodecParams(**SMALL, dedup=0), str(src), arc)
    from fastqueeze_tpu.container.arcfile import ArcReader
    from fastqueeze_tpu.container.encap import iter_tlv
    from fastqueeze_tpu.pipeline.blockcodec import TAG_SDUPF
    with ArcReader(arc) as r:
        assert r.params.dedup == 0
        tags = {t for t, _ in iter_tlv(r.read_block(0))}
    assert TAG_SDUPF not in tags
    outs = decompress(arc, str(tmp_path / "back"), force=True)
    assert open(outs[0], "rb").read() == raw


def test_dedup_aligned_roundtrip(tmp_path):
    # mapped reads and duplicate reads coexist; a duplicate read is coded
    # as a duplicate even when it also maps
    from maprate import synthetic_ref

    from fastqueeze_tpu.io.fastq import parse_block
    from fastqueeze_tpu.pipeline.aligned import compress_se_aligned
    rng = np.random.default_rng(13)
    recs = []
    for i in range(150):
        seq = "".join(rng.choice(list("ACGT"), 64))
        q = "".join(chr(33 + int(x)) for x in rng.integers(0, 40, 64))
        recs.append(f"@a.{i}\n{seq}\n+\n{q}\n")
    raw = ("".join(recs) * 2).encode()
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    fa = synthetic_ref(parse_block("".join(recs).encode(), True))
    p = CodecParams(**SMALL, seed_len=10)
    arc = str(tmp_path / "o.fqz")
    stats = compress_se_aligned(p, fa, str(src), arc)
    assert stats["mapped"] > 0
    outs = decompress(arc, str(tmp_path / "back"), force=True, ref=fa)
    assert open(outs[0], "rb").read() == raw


def test_corrupt_dup_streams_fail_cleanly(tmp_path):
    raw = _pcr_fastq(n_unique=60, dup_factor=4)
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    arc = tmp_path / "o.fqz"
    compress_se(CodecParams(**SMALL), str(src), str(arc))
    blob = arc.read_bytes()
    random.seed(23)
    for _ in range(12):
        b = bytearray(blob)
        i = random.randrange(len(b) // 2, len(b))   # hit the block region
        b[i] ^= random.randrange(1, 256)
        bad = tmp_path / "bad.fqz"
        bad.write_bytes(bytes(b))
        try:
            outs = decompress(str(bad), str(tmp_path / "bk"), force=True)
            assert open(outs[0], "rb").read() == raw   # benign flip only
        except ValueError:
            pass
