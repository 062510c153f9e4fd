"""CLI-level feature parity: multi-file archives (-m), archive listing
(-L), developer config file (-D / fastqueeze.config), pipe-out."""

import os
import subprocess
import sys

import numpy as np
import pytest

from fastqueeze_tpu.config import CodecParams
from fastqueeze_tpu.pipeline.driver import compress_multi, decompress

SMALL = dict(slevel=0, lanes_min=16, lanes_max=32, lane_target_symbols=512)


def _mk_fastq(rng, n, L=50, tag="m"):
    recs = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACGT"), L))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 40, L))
        recs.append(f"@{tag}.{i}\n{seq}\n+\n{qual}\n")
    return "".join(recs).encode()


def test_multi_file_roundtrip(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    raws = [_mk_fastq(rng, 60 + 20 * i, tag=f"f{i}") for i in range(3)]
    paths = []
    for i, raw in enumerate(raws):
        pth = tmp_path / f"in{i}.fq"
        pth.write_bytes(raw)
        paths.append(str(pth))
    p = CodecParams(**SMALL)
    arc = str(tmp_path / "multi.fqz")
    stats = compress_multi(p, paths, arc)
    assert stats["files"] == 3
    monkeypatch.chdir(tmp_path)   # restored after the test (a bare
    # os.chdir leaked: later tests spawning `python -c` subprocesses
    # could no longer import fastqueeze_tpu from the cwd)
    outs = decompress(arc, str(tmp_path / "back_m"), force=True)
    assert len(outs) == 3
    for raw, name in zip(raws, outs):
        assert open(name, "rb").read() == raw
        assert os.path.basename(name).startswith("back_m")


def test_multi_file_threaded_decode(tmp_path):
    """Multi-file decode honours -t N (it used to fall into a strictly
    serial loop that ignored both -t and --mesh); outputs must be
    byte-identical to the serial path, blocks interleaved across files."""
    rng = np.random.default_rng(6)
    raws = [_mk_fastq(rng, 120, tag=f"g{i}") for i in range(2)]
    paths = []
    for i, raw in enumerate(raws):
        pth = tmp_path / f"tin{i}.fq"
        pth.write_bytes(raw)
        paths.append(str(pth))
    p = CodecParams(**SMALL, block_bytes=4096)   # several blocks per file
    arc = str(tmp_path / "multi_t.fqz")
    stats = compress_multi(p, paths, arc)
    assert stats["blocks"] > 2
    outs = decompress(arc, str(tmp_path / "tback"), force=True, threads=3)
    assert len(outs) == 2
    for raw, name in zip(raws, outs):
        assert open(name, "rb").read() == raw


def test_config_file_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    p = CodecParams()
    path = p.dump_config_file()
    assert os.path.exists(path)
    q = CodecParams()
    with open(path, "a") as fh:
        fh.write("Slevel:1\nMaxmis:3\n")
    assert q.apply_config_file()
    assert q.slevel == 1 and q.max_mis == 3


def test_cli_list_and_config(tmp_path, monkeypatch):
    from fastqueeze_tpu.cli import main
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(6)
    src = tmp_path / "in.fq"
    src.write_bytes(_mk_fastq(rng, 80))
    assert main(["-D"]) == 0
    assert os.path.exists("fastqueeze.config")
    with open("fastqueeze.config", "a") as fh:
        fh.write("Slevel:0\n")
    arc = str(tmp_path / "x.fqz")
    assert main(["-c", "-1", str(src), "-o", arc, "-f"]) == 0
    from fastqueeze_tpu.container.arcfile import ArcReader
    with ArcReader(arc) as r:
        assert r.params.slevel == 0          # config file applied
    assert main(["-L", arc]) == 0
    assert main(["-d", arc, "-o", str(tmp_path / "back"), "-f"]) == 0
    assert (tmp_path / "back.fastq").read_bytes() == src.read_bytes()


def test_cli_shm_and_orderbin_flags(tmp_path, bundled_pair):
    """-s (mmap-shared index) and -n (reference parity no-op) round-trip."""
    from fastqueeze_tpu.cli import main
    raw = open(bundled_pair[0], "rb").read()
    lines = raw.split(b"\n")
    src = tmp_path / "in.fq"
    src.write_bytes(b"\n".join(lines[:4 * 400]) + b"\n")
    ref = tmp_path / "ref.fa"
    seqs = lines[1:4 * 200:4]
    ref.write_bytes(b">r\n" + b"\n".join(seqs) + b"\n")
    assert main(["-i", str(ref)]) == 0
    out = tmp_path / "o.fqz"
    assert main(["-c", "-s", "-n", str(ref), "-1", str(src),
                 "-o", str(out), "-f"]) == 0
    assert main(["-d", str(ref), str(out), "-o", str(tmp_path / "b"),
                 "-f"]) == 0
    assert (tmp_path / "b.fastq").read_bytes() == src.read_bytes()


def test_extract_random_access(tmp_path):
    """-X START:COUNT decodes only the covering blocks (SE and PE),
    producing exactly those records."""
    import numpy as np

    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.pipeline.driver import compress_se, extract
    from fastqueeze_tpu.pipeline.pe import compress_pe

    rng = np.random.default_rng(3)
    recs = []
    for i in range(900):
        seq = bytes(rng.choice(list(b"ACGT"), size=60).tolist())
        qual = bytes((rng.integers(0, 40, 60) + 33).astype(np.uint8).tolist())
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, qual))
    raw = b"".join(recs)
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    p = CodecParams(slevel=0, lanes_min=16, lanes_max=32,
                    lane_target_symbols=512, block_size_mb=1)
    arc = str(tmp_path / "a.fqz")
    compress_se(p, str(src), arc)
    outs = extract(arc, str(tmp_path / "x"), 5, 3, force=True)
    assert open(outs[0], "rb").read() == b"".join(recs[5:8])

    # multi-block: ~1.2 MB input with 1 MB blocks -> 2 blocks; extract a
    # range that straddles the block boundary, and the tail of an input
    # with NO trailing newline (final_newline must propagate)
    big = recs * 10                       # 9000 records
    big_raw = b"".join(big)[:-1]          # strip the final newline
    src_b = tmp_path / "big.fq"
    src_b.write_bytes(big_raw)
    arc_b = str(tmp_path / "b.fqz")
    stats = compress_se(p, str(src_b), arc_b)
    assert stats["blocks"] >= 2
    from fastqueeze_tpu.container.arcfile import ArcReader
    with ArcReader(arc_b) as r:
        r0 = r.blocks[0].n_reads
        total_b = sum(b.n_reads for b in r.blocks)
    lo = r0 - 2                           # straddles block 0/1 boundary
    outs = extract(arc_b, str(tmp_path / "xb"), lo, 5, force=True)
    assert open(outs[0], "rb").read() == b"".join(big[lo:lo + 5])
    outs = extract(arc_b, str(tmp_path / "xt"), total_b - 2, 2, force=True)
    assert open(outs[0], "rb").read() == b"".join(big[-2:])[:-1]

    # PE pairs
    r2 = [b"@r%d\n%s\n+\n%s\n" % (i, s, q) for i, (s, q) in
          enumerate((bytes(rng.choice(list(b"ACGT"), size=60).tolist()),
                     bytes((rng.integers(0, 40, 60) + 33).astype(
                         np.uint8).tolist())) for _ in range(900))]
    src2 = tmp_path / "in2.fq"
    src2.write_bytes(b"".join(r2))
    pe_arc = str(tmp_path / "pe.fqz")
    p2 = CodecParams(slevel=0, lanes_min=16, lanes_max=32,
                     lane_target_symbols=512, is_pe=1)
    compress_pe(p2, str(src), str(src2), pe_arc)
    outs = extract(pe_arc, str(tmp_path / "px"), 10, 2, force=True)
    assert open(outs[0], "rb").read() == b"".join(recs[10:12])
    assert open(outs[1], "rb").read() == b"".join(r2[10:12])

    # out-of-range rejected
    import pytest
    with pytest.raises(ValueError):
        extract(arc, str(tmp_path / "y"), 899, 5, force=True)


def test_extract_on_aligned_and_selfref_archives(tmp_path):
    """-X on reference-aligned archives (needs the ref to rebuild mapped
    reads) and on self-referential archives (reference rebuilt from the
    block's own reads — no FASTA needed)."""
    import numpy as np

    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.pipeline.aligned import compress_se_aligned
    from fastqueeze_tpu.pipeline.driver import compress_se, extract

    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    BASES = np.frombuffer(b"ACGT", np.uint8)
    fa = tmp_path / "ref.fa"
    fa.write_bytes(b">g\n" + BASES[genome].tobytes() + b"\n")
    recs = []
    for i in range(400):
        pos = int(rng.integers(0, len(genome) - 70))
        r = genome[pos:pos + 70].copy()
        e = rng.random(70) < 0.01
        r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
        q = (rng.integers(30, 41, 70).astype(np.uint8) + 33).tobytes()
        recs.append(b"@x.%d\n" % i + BASES[r].tobytes() + b"\n+\n" + q
                    + b"\n")
    raw = b"".join(recs)
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    small = dict(slevel=0, lanes_min=16, lanes_max=32,
                 lane_target_symbols=512, seed_len=10, seed_max_occ=8,
                 seed_big_occ=32, max_mis=4)

    arc_a = str(tmp_path / "al.fqz")
    stats = compress_se_aligned(CodecParams(**small), str(fa), str(src),
                                arc_a)
    assert stats["mapped"] >= 300
    outs = extract(arc_a, str(tmp_path / "xa"), 100, 7, ref=str(fa),
                   force=True)
    assert open(outs[0], "rb").read() == b"".join(recs[100:107])

    arc_s = str(tmp_path / "sr.fqz")
    compress_se(CodecParams(**small, self_align=1, min_map_ratio=0.0),
                str(src), arc_s)
    outs = extract(arc_s, str(tmp_path / "xs"), 350, 10, force=True)
    assert open(outs[0], "rb").read() == b"".join(recs[350:360])
