"""Golden round-trips on the bundled reference data + edge inputs
(SURVEY.md §4: the reference's implicit test surface is the ERR2755197
pair, stood in for by the seeded ``bundled_pair`` fixture; property tests
cover the edges)."""

import io
import os
import sys

import numpy as np
import pytest

from fastqueeze_tpu.config import CodecParams
from fastqueeze_tpu.pipeline.driver import compress_se, decompress
from fastqueeze_tpu.pipeline.pe import compress_pe

SMALL = dict(slevel=0, lanes_min=16, lanes_max=64, lane_target_symbols=512)


def _slice_reads(path, n):
    lines = open(path, "rb").read().split(b"\n")
    return b"\n".join(lines[:4 * n]) + b"\n"


def test_golden_se_bundled_pair(tmp_path, bundled_pair):
    raw = _slice_reads(bundled_pair[0], 1500)
    src = tmp_path / "g1.fq"
    src.write_bytes(raw)
    p = CodecParams(**SMALL)
    arc = str(tmp_path / "g1.fqz")
    stats = compress_se(p, str(src), arc)
    assert stats["ratio"] > 4.0
    outs = decompress(arc, str(tmp_path / "g1back"), force=True)
    assert open(outs[0], "rb").read() == raw


def test_golden_pe_bundled_pair(tmp_path, bundled_pair):
    raw1 = _slice_reads(bundled_pair[0], 800)
    raw2 = _slice_reads(bundled_pair[1], 800)
    f1, f2 = tmp_path / "p1.fq", tmp_path / "p2.fq"
    f1.write_bytes(raw1)
    f2.write_bytes(raw2)
    p = CodecParams(**SMALL)
    arc = str(tmp_path / "pe.fqz")
    compress_pe(p, str(f1), str(f2), arc)
    outs = decompress(arc, str(tmp_path / "peback"), force=True)
    assert open(outs[0], "rb").read() == raw1
    assert open(outs[1], "rb").read() == raw2


def test_empty_input(tmp_path):
    src = tmp_path / "empty.fq"
    src.write_bytes(b"")
    p = CodecParams(**SMALL)
    arc = str(tmp_path / "empty.fqz")
    stats = compress_se(p, str(src), arc)
    assert stats["blocks"] == 0
    outs = decompress(arc, str(tmp_path / "eback"), force=True)
    assert open(outs[0], "rb").read() == b""


def test_single_read(tmp_path):
    raw = b"@only\nACGTN\n+\n!!!!!\n"
    src = tmp_path / "one.fq"
    src.write_bytes(raw)
    p = CodecParams(**SMALL)
    arc = str(tmp_path / "one.fqz")
    compress_se(p, str(src), arc)
    outs = decompress(arc, str(tmp_path / "oneback"), force=True)
    assert open(outs[0], "rb").read() == raw


def test_pipeout_se(tmp_path, capfdbinary, bundled_pair):
    raw = _slice_reads(bundled_pair[0], 200)
    src = tmp_path / "p.fq"
    src.write_bytes(raw)
    p = CodecParams(**SMALL)
    arc = str(tmp_path / "p.fqz")
    compress_se(p, str(src), arc)
    outs = decompress(arc, None, pipeout=1)
    assert outs == []
    captured = capfdbinary.readouterr()
    assert captured.out == raw


def test_pipeout_pe_interleaved(tmp_path, capfdbinary, bundled_pair):
    raw1 = _slice_reads(bundled_pair[0], 100)
    raw2 = _slice_reads(bundled_pair[1], 100)
    f1, f2 = tmp_path / "i1.fq", tmp_path / "i2.fq"
    f1.write_bytes(raw1)
    f2.write_bytes(raw2)
    p = CodecParams(**SMALL)
    arc = str(tmp_path / "i.fqz")
    compress_pe(p, str(f1), str(f2), arc)
    decompress(arc, None, pipeout=3)
    out = capfdbinary.readouterr().out
    # interleaved stream contains every record of both mates
    assert out.count(b"\n@ERR") + out.startswith(b"@ERR") == 200
    assert len(out) == len(raw1) + len(raw2)


def test_write_interleaved_linear_at_scale():
    """-P 3 interleaving must be O(n): 100k reads/mate stream out in
    seconds (the old per-record np.sum(lengths[:k]) scan was O(R^2) and
    needed ~10^10 element-adds at this size)."""
    import io as _io
    import time

    from fastqueeze_tpu.io.fastq import FastqBlock
    from fastqueeze_tpu.pipeline.pe import _write_interleaved

    R, L = 100_000, 100
    rng = np.random.default_rng(5)

    def mk():
        seq = rng.integers(65, 69, R * L).astype(np.uint8)
        qual = rng.integers(33, 73, R * L).astype(np.uint8)
        return FastqBlock(
            n_reads=R, ids=[b"r%d" % i for i in range(R)],
            plus=[b""] * R, seq_flat=seq, qual_flat=qual,
            lengths=np.full(R, L, np.int64), raw_len=0)

    b1, b2 = mk(), mk()
    out = _io.BytesIO()
    t0 = time.time()
    _write_interleaved(out, b1, b2)
    dt = time.time() - t0
    assert dt < 30, f"interleaved pipe-out too slow: {dt:.1f}s"
    data = out.getvalue()
    assert data.count(b"\n") == 8 * R
    first = data[:data.index(b"\n@", 1)]
    assert first.startswith(b"@r0\n")
