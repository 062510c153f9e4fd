"""Structured synthetic genome + read-set generator for genome-scale
aligned validation, and a stand-in for the reference's bundled test pair.

The bundled test reference is a 500 kb concatenation of read sequences —
trivially mappable.  Real genomes are hard for seed-and-extend aligners
because of REPEATS: interspersed transposon families at 2-25 % divergence
(LINE/SINE/LTR analogues), near-identical satellite arrays, and recent
segmental duplications.  This generator builds a multi-chromosome genome
with all three repeat classes (~45 % repeat content, human-like), plus
N-gaps, and samples reads with a quality-correlated error process
(NovaSeq-style 4-bin qualities), optional small indels, reverse-complement
strands, and a contamination fraction that must stay unmapped.

Everything is deterministic in the seed, vectorized numpy, and sized by
arguments, so the same module drives the 2 Mbp unit tests, the 100 Mbp
bench fixture (bench.py "genome" block) and chip_smoke.py's inputs.

Reference behavior being validated against: SeqArc-1.6 HASH tier
(HashRefIndex64::initMemory @0x41e8d0, Seedlen 14) and -q/BWA tier
(bwt_smem1a @0x437110) on genome-scale references.
"""

from __future__ import annotations

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def _mutate(seq: np.ndarray, rate: float, rng) -> np.ndarray:
    """Substitute a ``rate`` fraction of 2-bit codes (always to a
    DIFFERENT base: xor with 1..3 permutes the 2-bit space)."""
    out = seq.copy()
    m = rng.random(len(seq)) < rate
    n = int(m.sum())
    if n:
        out[m] ^= rng.integers(1, 4, n).astype(np.uint8)
    return out


def _rand_seq(n: int, rng, gc: float = 0.41) -> np.ndarray:
    """Random background with a given GC fraction (A=0 C=1 G=2 T=3)."""
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, n, p=p).astype(np.uint8)


def make_genome(size_bp: int, seed: int = 20260820, n_chrom: int = 4):
    """Returns (codes uint8 0..4 where 4 = N, chrom bounds list).

    Composition per chromosome: background (GC drifts per segment) with
    interspersed LINE copies (6 kb consensus, 5'-truncated to a random
    tail like real L1s, 2-20 % diverged), SINE copies (300 bp, 2-25 %),
    LTR copies (1.5 kb), a central satellite array (171 bp monomer,
    per-copy 1-4 % divergence — the hardest near-identical repeat class),
    one recent segmental duplication (50 kb at 1 % divergence), and a few
    N-gaps.
    """
    rng = np.random.default_rng(seed)
    line_c = _rand_seq(6000, rng)
    sine_c = _rand_seq(300, rng)
    ltr_c = _rand_seq(1500, rng)
    sat_c = _rand_seq(171, rng)
    chroms = []
    per = size_bp // n_chrom
    for _c in range(n_chrom):
        segs = []
        tot = 0
        target = per
        sat_at = target // 2            # centromere position
        sat_done = False
        while tot < target:
            if not sat_done and tot >= sat_at:
                # satellite array: ~1.5 % of the chromosome as tandem
                # near-identical monomer copies
                n_cop = max(1, int(target * 0.015) // len(sat_c))
                arr = [_mutate(sat_c, rng.uniform(0.01, 0.04), rng)
                       for _ in range(n_cop)]
                segs.append(np.concatenate(arr))
                tot += len(segs[-1])
                sat_done = True
                continue
            r = rng.random()
            if r < 0.40:                # background
                s = _rand_seq(int(rng.integers(2000, 14000)), rng,
                              gc=float(rng.uniform(0.33, 0.52)))
            elif r < 0.58:              # LINE copy, 5'-truncated
                keep = int(len(line_c) * rng.uniform(0.15, 1.0))
                s = _mutate(line_c[-keep:], rng.uniform(0.02, 0.20), rng)
                if rng.random() < 0.5:  # either strand
                    s = (3 - s)[::-1]
            elif r < 0.88:              # SINE copy
                s = _mutate(sine_c, rng.uniform(0.02, 0.25), rng)
                if rng.random() < 0.5:
                    s = (3 - s)[::-1]
            elif r < 0.97:              # LTR copy
                s = _mutate(ltr_c, rng.uniform(0.03, 0.15), rng)
            else:                       # N-gap (assembly gap)
                s = np.full(int(rng.integers(50, 500)), 4, np.uint8)
            segs.append(s)
            tot += len(s)
        chrom = np.concatenate(segs)[:target]
        # one recent segmental duplication: 50 kb (or 10 % of a small
        # test chromosome) re-inserted at 1 % divergence
        dl = min(50_000, len(chrom) // 10)
        if dl > 1000:
            src = int(rng.integers(0, len(chrom) - dl))
            dup = chrom[src:src + dl].copy()
            ok = dup != 4
            dup[ok] = _mutate(dup[ok], 0.01, rng)
            at = int(rng.integers(0, len(chrom)))
            chrom = np.concatenate([chrom[:at], dup, chrom[at:]])
        chroms.append(chrom)
    bounds = np.cumsum([0] + [len(c) for c in chroms])
    return np.concatenate(chroms), bounds


def write_fasta(codes: np.ndarray, bounds, path: str, width: int = 70):
    """codes 0..4 (4 = N) -> multi-record FASTA."""
    letters = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as fh:
        for i in range(len(bounds) - 1):
            fh.write(b">chr%d\n" % (i + 1))
            chrom = letters[codes[bounds[i]:bounds[i + 1]]]
            for j in range(0, len(chrom), width):
                fh.write(chrom[j:j + width].tobytes())
                fh.write(b"\n")


# NovaSeq-style 4-bin qualities with per-bin base error rates
_QBINS = np.array([2, 12, 23, 37], np.uint8)
_QPROB = np.array([0.01, 0.03, 0.11, 0.85])
_QERR = np.array([0.25, 0.06, 0.008, 0.0006])


def sample_reads(codes: np.ndarray, n_reads: int, read_len: int, rng,
                 indel_frac: float = 0.0, max_indel: int = 3,
                 contam_frac: float = 0.02):
    """Sample (seqs, quals) uint8 letter arrays of shape (n, L).

    Each read: uniform genome window, RC on a random strand,
    quality-correlated substitution errors; ``indel_frac`` of reads get
    1-2 small indels (insertion = random bases, deletion = window
    extends); ``contam_frac`` are fully random (must stay unmapped).
    N-gap bases come out as 'N' with q=2 (the dege-read path).
    """
    G = len(codes)
    span = read_len + 2 * max_indel + 4
    pos = rng.integers(0, G - span, n_reads)
    win = codes[pos[:, None] + np.arange(span)]
    seqs = np.empty((n_reads, read_len), np.uint8)
    n_ind = int(n_reads * indel_frac)
    # plain reads: straight copy of the window prefix
    seqs[n_ind:] = win[n_ind:, :read_len]
    for i in range(n_ind):             # indel reads (small count)
        w = win[i]
        nops = 1 + (rng.random() < 0.35)
        cuts = np.sort(rng.choice(np.arange(12, read_len - 12, 6), nops,
                                  replace=False))
        parts, wp, prev = [], 0, 0
        for at in cuts:
            seg = int(at) - prev
            g = int(rng.integers(1, max_indel + 1))
            parts.append(w[wp:wp + seg])
            wp += seg
            if rng.random() < 0.5:     # insertion into the read
                parts.append(rng.integers(0, 4, g).astype(np.uint8))
            else:                       # deletion from the read
                wp += g
            prev = int(at)
        parts.append(w[wp:wp + read_len])
        seqs[i] = np.concatenate(parts)[:read_len]
    # contamination tail: random sequence
    n_cont = int(n_reads * contam_frac)
    if n_cont:
        seqs[-n_cont:] = rng.integers(0, 4, (n_cont, read_len)).astype(
            np.uint8)
    # strand: reverse-complement half (N stays N under complement)
    rc = rng.random(n_reads) < 0.5
    sub = seqs[rc]
    comp = np.where(sub == 4, 4, 3 - sub.astype(np.int16)).astype(np.uint8)
    seqs[rc] = comp[:, ::-1]
    amb = seqs == 4
    # qualities + errors
    quals = rng.choice(_QBINS, (n_reads, read_len), p=_QPROB)
    err = rng.random((n_reads, read_len)) < _QERR[
        np.searchsorted(_QBINS, quals)]
    err &= ~amb
    seqs[err] ^= rng.integers(1, 4, int(err.sum())).astype(np.uint8)
    quals[amb] = 2
    letters = np.frombuffer(b"ACGTN", np.uint8)
    return letters[seqs], quals + 33


def write_fastq(seqs: np.ndarray, quals: np.ndarray, path: str,
                tag: bytes = b"g"):
    n, L = seqs.shape
    with open(path, "wb") as fh:
        buf = []
        for i in range(n):
            buf.append(b"@%s.%d\n%s\n+\n%s\n" % (
                tag, i, seqs[i].tobytes(), quals[i].tobytes()))
            if len(buf) >= 4096:
                fh.write(b"".join(buf))
                buf = []
        fh.write(b"".join(buf))


# HiSeq X-style binned qualities (Illumina 1.8+: '#', '-', '7', '<', 'A',
# 'F', 'J'), drawn from a distribution that degrades along the read
_PAIR_QBINS = np.array([2, 12, 22, 27, 32, 37, 41], np.uint8)
_TELO = np.frombuffer(b"TTAGGG", np.uint8)


def bundled_pair(n_pairs: int = 10_000, read_len: int = 100,
                 seed: int = 2755197, telo_frac: float = 0.58):
    """(raw1, raw2) FASTQ bytes shaped like the reference's bundled test
    pair (SURVEY.md §0: 10,000 PE reads x 100 bp per file, IDs
    ``@ERR2755197.N N length=100``, a bare ``+`` line, N bases at
    quality '#', and a large telomeric-repeat share that makes about half
    of the sequences exact duplicates).

    Non-telomeric pairs come from a 2 Mbp structured genome
    (make_genome) with 250-500 bp inserts, mate 2 reverse-complemented;
    telomeric pairs are (TTAGGG)n / (CCCTAA)n at a random phase with a
    few sequencing errors.  Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    codes, _ = make_genome(2_000_000, seed=seed, n_chrom=2)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    comp = np.frombuffer(b"TGCAN", np.uint8)
    n, L = n_pairs, read_len
    ins = rng.integers(250, 500, n)
    pos = rng.integers(0, len(codes) - 500, n)
    win = np.arange(L)
    s1 = letters[codes[pos[:, None] + win]]
    s2 = letters[codes[(pos + ins - L)[:, None] + win]]
    s2 = comp[_code_of(s2)][:, ::-1]
    telo = rng.random(n) < telo_frac
    nt = int(telo.sum())
    ph = rng.integers(0, 6, (2, nt))
    t1 = _TELO[(ph[0][:, None] + win) % 6]
    t2 = comp[_code_of(_TELO)][::-1][(ph[1][:, None] + win) % 6]
    s1[telo], s2[telo] = t1, t2
    seqs = np.concatenate([s1, s2])
    # sequencing errors on ~1 in 6 reads, N calls on ~1 in 50
    err = rng.random(seqs.shape) < 0.002
    seqs[err] = letters[rng.integers(0, 4, int(err.sum()))]
    ncall = (rng.random(seqs.shape) < 0.0002) | (
        (rng.random(len(seqs)) < 0.02)[:, None] & (win == 0))
    seqs[ncall] = ord("N")
    # qualities: per-read level, worse toward the 3' end
    base = rng.normal(5.2, 0.8, (len(seqs), 1)) - win / (1.6 * L)
    lvl = np.clip(np.rint(base + rng.normal(0, 0.7, seqs.shape)), 1, 6)
    quals = _PAIR_QBINS[lvl.astype(np.int64)] + 33
    quals[ncall] = 35                        # '#'
    raws = []
    for m in (0, 1):
        sq, qu = seqs[m * n:(m + 1) * n], quals[m * n:(m + 1) * n]
        buf = []
        for i in range(n):
            name = b"ERR2755197.%d %d length=%d" % (i + 1, i + 1, L)
            buf.append(b"@%s\n%s\n+\n%s\n" % (
                name, sq[i].tobytes(), qu[i].astype(np.uint8).tobytes()))
        raws.append(b"".join(buf))
    return raws[0], raws[1]


def _code_of(letters_arr: np.ndarray) -> np.ndarray:
    """ASCII ACGTN -> 0..4."""
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    return lut[letters_arr]


def write_bundled_pair(out_dir: str, **kw):
    """Write bundled_pair() as ERR2755197_test_{1,2}.fq; returns paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"ERR2755197_test_{m}.fq")
             for m in (1, 2)]
    for path, raw in zip(paths, bundled_pair(**kw)):
        with open(path, "wb") as fh:
            fh.write(raw)
    return paths


def build_fixture(out_dir: str, size_bp: int, n_reads: int,
                  read_len: int = 150, seed: int = 20260820,
                  indel_frac: float = 0.0):
    """Generate ref.fa + reads.fq (cached: reuses existing files)."""
    os.makedirs(out_dir, exist_ok=True)
    fa = os.path.join(out_dir, f"ref_{size_bp // 1_000_000}mbp.fa")
    fq = os.path.join(out_dir, f"reads_{n_reads}.fq")
    if not os.path.exists(fa):
        codes, bounds = make_genome(size_bp, seed)
        write_fasta(codes, bounds, fa)
    else:
        codes = None
    if not os.path.exists(fq):
        if codes is None:
            from fastqueeze_tpu.align.ref import load_fasta
            r = load_fasta(fa)
            codes = np.where(r.amb_mask, np.uint8(4), r.codes)
        rng = np.random.default_rng(seed + 1)
        seqs, quals = sample_reads(codes, n_reads, read_len, rng,
                                   indel_frac=indel_frac)
        write_fastq(seqs, quals, fq)
    return fa, fq


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=int, default=100)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--indel-frac", type=float, default=0.0)
    ap.add_argument("--out-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tmp_genome"))
    a = ap.parse_args()
    fa, fq = build_fixture(a.out_dir, a.mbp * 1_000_000, a.reads,
                           a.read_len, indel_frac=a.indel_frac)
    print(fa, fq)
