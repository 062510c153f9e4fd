"""Mapping-rate + aligner-speed measurement on the bundled-pair shape
(SURVEY.md §8 protocol: synthetic 500 kb reference = first ~5000 read
sequences concatenated; on the real pair the reference binary mapped
8,050/10,000).  Input: the seeded stand-in from genome_fixture.py.

Usage: python tools/maprate.py  (runs on the default JAX device)
"""
import os
import sys
import tempfile
import time

import numpy as np

from fastqueeze_tpu.align.hash import Aligner
from fastqueeze_tpu.align.index import build_from_ref
from fastqueeze_tpu.align.ref import load_fasta
from fastqueeze_tpu.config import CodecParams
from fastqueeze_tpu.io.fastq import parse_block
from fastqueeze_tpu.pipeline.blockcodec import _BASE_MAP


def synthetic_ref(blk, target=500_000):
    off = np.cumsum(blk.lengths) - blk.lengths
    seqs, tot = [], 0
    for i in range(blk.n_reads):
        s = blk.seq_flat[off[i]:off[i] + blk.lengths[i]]
        seqs.append(s)
        tot += len(s)
        if tot >= target:
            break
    ref_bytes = b"".join(x.tobytes() for x in seqs)
    fa = os.path.join(tempfile.mkdtemp(), "ref.fa")
    with open(fa, "wb") as fh:
        fh.write(b">synthetic\n")
        for i in range(0, len(ref_bytes), 70):
            fh.write(ref_bytes[i:i + 70] + b"\n")
    return fa


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from genome_fixture import bundled_pair
    blk = parse_block(bundled_pair()[0], True)
    fa = synthetic_ref(blk)
    p = CodecParams()
    ref = load_fasta(fa)
    t0 = time.time()
    idx = build_from_ref(ref, p)
    print(f"index build {time.time() - t0:.2f}s  keys {idx.n_keys} "
          f"pos {idx.n_positions} maxcount {idx.max_count}")
    codes = _BASE_MAP[blk.seq_flat].copy()
    dege = codes == 255
    codes[dege] = 0
    al = Aligner(idx, p)
    al.align(codes, dege, blk.lengths)        # compile warm-up
    best = None
    for _ in range(3):
        t0 = time.time()
        res = al.align(codes, dege, blk.lengths)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    print(f"align best-of-3 {best:.2f}s  mapped {int(res.mapped.sum())}"
          f"/{blk.n_reads}")


if __name__ == "__main__":
    main()
