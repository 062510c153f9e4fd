"""Long-read aligned tier: reads > align_max_len are anchor-mapped in
longread_chunk pieces (no reference equivalent —
SeqArc codes long reads entropy-only).  HiFi-like fixtures: low error,
mostly substitutions."""

import hashlib
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from genome_fixture import make_genome, write_fasta  # noqa: E402

from fastqueeze_tpu.config import CodecParams  # noqa: E402
from fastqueeze_tpu.pipeline.aligned import compress_se_aligned  # noqa: E402
from fastqueeze_tpu.pipeline.driver import compress_se, decompress  # noqa: E402

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("longread")
    codes, bounds = make_genome(600_000, seed=7)
    fa = str(tmp / "ref.fa")
    write_fasta(codes, bounds, fa)
    rng = np.random.default_rng(8)
    recs = []
    n_long, n_short = 60, 200
    for i in range(n_long):
        L = int(rng.integers(5_000, 20_000))
        st = int(rng.integers(0, len(codes) - L))
        r = codes[st:st + L].copy()
        amb = r == 4
        err = (rng.random(L) < 0.003) & ~amb      # HiFi-like subs
        r[err] ^= rng.integers(1, 4, int(err.sum())).astype(np.uint8)
        if i % 3 == 0:
            r = np.where(r == 4, 4, 3 - np.where(amb, 0, r))[::-1]
        seq = np.frombuffer(b"ACGTN", np.uint8)[r].tobytes()
        q = bytes(33 + 40 for _ in range(L))
        recs.append(b"@L.%d\n%s\n+\n%s\n" % (i, seq, q))
    # one exact duplicate long read (dedup interplay)
    recs.append(recs[0].replace(b"@L.0\n", b"@L.dup\n"))
    for i in range(n_short):
        L = 150
        st = int(rng.integers(0, len(codes) - L))
        r = np.minimum(codes[st:st + L], 3)
        seq = BASES[r].tobytes()
        q = bytes(33 + 37 for _ in range(L))
        recs.append(b"@S.%d\n%s\n+\n%s\n" % (i, seq, q))
    fq = str(tmp / "long.fq")
    with open(fq, "wb") as fh:
        fh.write(b"".join(recs))
    return fa, fq


def _md5(path):
    return hashlib.md5(open(path, "rb").read()).digest()


def test_longread_roundtrip_and_ratio(fixture, tmp_path):
    fa, fq = fixture
    # entropy-only baseline (no reference)
    s0 = compress_se(CodecParams(threads=1), fq,
                     str(tmp_path / "plain.fqz"))
    from fastqueeze_tpu.utils.metrics import DebugInfo
    dbg = DebugInfo()
    arc = str(tmp_path / "lr.fqz")
    s = compress_se_aligned(CodecParams(threads=1), fa, fq, arc, dbg=dbg)
    assert dbg.vals.get("lr_chunks_mapped", 0) > 300, dbg.vals
    # the chunk tier must clearly beat entropy-only on reference data
    assert s["ratio"] > s0["ratio"] * 1.5, (s["ratio"], s0["ratio"])
    outs = decompress(arc, str(tmp_path / "back"), force=True, threads=1,
                      ref=fa)
    assert _md5(outs[0]) == _md5(fq)
    # aligned long-read archives need the reference at decode
    with pytest.raises(ValueError, match="reference"):
        decompress(arc, str(tmp_path / "noref"), force=True, threads=1)


def test_longread_thread_payload_identity(fixture, tmp_path):
    fa, fq = fixture
    a1 = str(tmp_path / "t1.fqz")
    a2 = str(tmp_path / "t2.fqz")
    compress_se_aligned(CodecParams(threads=1), fa, fq, a1)
    compress_se_aligned(CodecParams(threads=3), fa, fq, a2)
    b1 = open(a1, "rb").read()
    b2 = open(a2, "rb").read()
    # PARAM serializes `threads`; block payloads must be identical
    from fastqueeze_tpu.container.arcfile import ArcReader
    with ArcReader(a1) as r1, ArcReader(a2) as r2:
        assert len(r1.blocks) == len(r2.blocks)
        for i in range(len(r1.blocks)):
            assert r1.read_block(i) == r2.read_block(i), f"block {i}"
    assert len(b1) == len(b2)


def test_longread_disable_param(fixture, tmp_path):
    """longread_chunk=0 disables the tier: archive still round-trips
    (long reads entropy-only) and carries no LR streams."""
    fa, fq = fixture
    arc = str(tmp_path / "off.fqz")
    compress_se_aligned(CodecParams(threads=1, longread_chunk=0), fa, fq,
                        arc)
    from fastqueeze_tpu.container.arcfile import ArcReader
    from fastqueeze_tpu.container.encap import iter_tlv
    from fastqueeze_tpu.pipeline.blockcodec import TAG_LRF
    with ArcReader(arc) as r:
        for i in range(len(r.blocks)):
            assert TAG_LRF not in dict(iter_tlv(r.read_block(i)))
    outs = decompress(arc, str(tmp_path / "back_off"), force=True,
                      threads=1, ref=fa)
    assert _md5(outs[0]) == _md5(fq)


def test_longread_extract(fixture, tmp_path):
    """Random access (-X) across a long-read block."""
    from fastqueeze_tpu.pipeline.driver import extract
    fa, fq = fixture
    arc = str(tmp_path / "x.fqz")
    compress_se_aligned(CodecParams(threads=1), fa, fq, arc)
    outs = extract(arc, str(tmp_path / "piece"), 0, 3, ref=fa, force=True)
    raw = open(outs[0], "rb").read()
    want = b"".join(open(fq, "rb").read().split(b"\n@")[0:1])
    assert raw.startswith(b"@L.0\n")
    assert raw.count(b"\n@") == 2           # 3 records


def test_longread_chunk_indels(fixture, tmp_path):
    """Real HiFi carries rare homopolymer indels; chunks an indel lands
    in must map through the longread_indel gap tier (and splice back
    bit-exactly at decode)."""
    import json

    from fastqueeze_tpu.container.arcfile import ArcReader
    from fastqueeze_tpu.container.encap import iter_tlv
    from fastqueeze_tpu.pipeline.blockcodec import TAG_LRCIGF, TAG_META
    fa, _ = fixture
    from fastqueeze_tpu.align.ref import load_fasta
    ref = load_fasta(fa)
    codes = np.minimum(ref.codes, 3)
    rng = np.random.default_rng(77)
    recs = []
    for i in range(30):
        L = int(rng.integers(6000, 12000))
        st = int(rng.integers(0, len(codes) - L - 64))
        r = codes[st:st + L + 32].copy()
        # ~1 indel per 1500 bases (exaggerated HiFi homopolymer rate)
        for _ in range(max(1, L // 1500)):
            at = int(rng.integers(50, L - 50))
            g = int(rng.integers(1, 3))
            if rng.random() < 0.5:
                r = np.concatenate([r[:at], r[at + g:]])
            else:
                r = np.concatenate(
                    [r[:at], rng.integers(0, 4, g).astype(np.uint8),
                     r[at:]])
        r = r[:L]
        err = rng.random(L) < 0.002
        r[err] ^= rng.integers(1, 4, int(err.sum())).astype(np.uint8)
        if i % 3 == 0:
            r = (3 - r)[::-1]
        recs.append(b"@I.%d\n%s\n+\n%s\n"
                    % (i, BASES[r].tobytes(), bytes([73]) * L))
    fq = tmp_path / "indel.fq"
    fq.write_bytes(b"".join(recs))
    arc = str(tmp_path / "indel.fqz")
    p0 = CodecParams(threads=1, longread_indel=0)
    s0 = compress_se_aligned(p0, fa, str(fq), arc)
    p1 = CodecParams(threads=1)                  # longread_indel=3 default
    arc1 = str(tmp_path / "indel1.fqz")
    s1 = compress_se_aligned(p1, fa, str(fq), arc1)
    # the gap tier must recover indel-straddling chunks: better ratio and
    # LRCIG streams present
    assert s1["ratio"] > s0["ratio"] * 1.1, (s0["ratio"], s1["ratio"])
    seen_cig = False
    with ArcReader(arc1) as r1:
        for i in range(len(r1.blocks)):
            secs = dict(iter_tlv(r1.read_block(i)))
            meta = json.loads(secs[TAG_META].decode())
            if TAG_LRCIGF in secs:
                seen_cig = True
                assert meta.get("lrnidl", 0) > 0
    assert seen_cig
    outs = decompress(arc1, str(tmp_path / "iback"), force=True,
                      threads=1, ref=fa)
    assert _md5(outs[0]) == _md5(str(fq))


def test_longread_mesh_payload_identity(fixture, tmp_path):
    """--mesh block-DP over the virtual mesh must produce byte-identical
    LR block payloads (the -t/--mesh invariance extends to the tier)."""
    fa, fq = fixture
    a1 = str(tmp_path / "m1.fqz")
    a2 = str(tmp_path / "m2.fqz")
    compress_se_aligned(CodecParams(threads=1, block_bytes=1 << 19),
                        fa, fq, a1)
    compress_se_aligned(CodecParams(mesh_n=2, block_bytes=1 << 19),
                        fa, fq, a2)
    from fastqueeze_tpu.container.arcfile import ArcReader
    with ArcReader(a1) as r1, ArcReader(a2) as r2:
        assert len(r1.blocks) > 1
        assert len(r1.blocks) == len(r2.blocks)
        for i in range(len(r1.blocks)):
            assert r1.read_block(i) == r2.read_block(i), f"block {i}"
