"""Fused device aligner: the two-host-sync fused flow
must make BIT-IDENTICAL mapping decisions to the classic per-tier chain
and to the host-native mirror — asserted per-read and at archive-byte
level (the -t/--mesh payload-identity invariant extends to execution
routing)."""

import hashlib
import os

import numpy as np
import pytest

from fastqueeze_tpu.align import hash as H
from fastqueeze_tpu.align.index import build_from_ref
from fastqueeze_tpu.align.ref import RefSeq
from fastqueeze_tpu.config import CodecParams

BASES = np.frombuffer(b"ACGT", np.uint8)


def _mk(rng, glen=20000, R=400, L=100, indel=False):
    ref_codes = rng.integers(0, 4, glen).astype(np.uint8)
    ref = RefSeq(codes=ref_codes, amb_mask=np.zeros(glen, bool),
                 names=["t"], bounds=np.array([0, glen]), md5="x")
    reads = []
    for i in range(R):
        st = int(rng.integers(0, glen - L - 8))
        c = ref_codes[st:st + L + 8].copy()
        nmut = int(rng.integers(0, 6))          # some exceed max_mis
        mp = rng.integers(0, L, nmut)
        c[mp] = (c[mp] + 1) % 4
        if indel and i % 7 == 0:
            at = int(rng.integers(10, L - 10))
            g = int(rng.integers(1, 3))
            if rng.random() < 0.5:
                c = np.concatenate([c[:at], c[at + g:]])
            else:
                c = np.concatenate([c[:at],
                                    rng.integers(0, 4, g).astype(np.uint8),
                                    c[at:]])
        c = c[:L]
        if i % 3 == 0:
            c = 3 - c[::-1]
        if i % 50 == 0:                          # contamination
            c = rng.integers(0, 4, L).astype(np.uint8)
        reads.append(c)
    codes_flat = np.concatenate(reads)
    lengths = np.full(R, L, np.int64)
    return ref, codes_flat, np.zeros_like(codes_flat, bool), lengths


def _run(aligner, codes_flat, dege_flat, lengths, fused: bool):
    os.environ["FASTQUEEZE_ALIGN_EXEC"] = "device"
    os.environ["FASTQUEEZE_FUSED_ALIGN"] = "1" if fused else "0"
    try:
        return aligner.align(codes_flat, dege_flat, lengths)
    finally:
        os.environ.pop("FASTQUEEZE_ALIGN_EXEC", None)
        os.environ.pop("FASTQUEEZE_FUSED_ALIGN", None)


def _assert_same_decisions(a, b, indel=False):
    np.testing.assert_array_equal(a.mapped, b.mapped)
    m = a.mapped
    np.testing.assert_array_equal(a.pos[m], b.pos[m])
    np.testing.assert_array_equal(a.is_rev[m], b.is_rev[m])
    np.testing.assert_array_equal(a.mis_mask[m], b.mis_mask[m])
    if indel:
        for fa, fb in ((a.gap_pos, b.gap_pos), (a.gap_len, b.gap_len),
                       (a.gap_pos2, b.gap_pos2), (a.gap_len2, b.gap_len2)):
            np.testing.assert_array_equal(fa[m], fb[m])


def test_fused_matches_classic_gapless():
    rng = np.random.default_rng(31)
    ref, cf, df, ln = _mk(rng)
    p = CodecParams(seed_max_occ=16, seed_big_occ=128, rescue_seeds=4)
    al = H.Aligner(build_from_ref(ref, p), p)
    classic = _run(al, cf, df, ln, fused=False)
    fused = _run(al, cf, df, ln, fused=True)
    assert classic.mapped.sum() > 300
    _assert_same_decisions(classic, fused)


def test_fused_matches_classic_indel():
    rng = np.random.default_rng(32)
    ref, cf, df, ln = _mk(rng, indel=True)
    p = CodecParams(seed_max_occ=16, seed_big_occ=128, rescue_seeds=4,
                    max_indel=3, indel_ops=2)
    al = H.Aligner(build_from_ref(ref, p), p)
    classic = _run(al, cf, df, ln, fused=False)
    fused = _run(al, cf, df, ln, fused=True)
    _assert_same_decisions(classic, fused, indel=True)
    # the indel tier actually engaged (gap fields non-trivial)
    assert (np.abs(fused.gap_len[fused.mapped]) > 0).any()


def test_fused_matches_host_mirror():
    """Host-native mirror vs fused device flow: identical decisions."""
    from fastqueeze_tpu.io import native
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(33)
    ref, cf, df, ln = _mk(rng)
    p = CodecParams(seed_max_occ=16, seed_big_occ=128, rescue_seeds=4)
    al = H.Aligner(build_from_ref(ref, p), p)
    os.environ["FASTQUEEZE_ALIGN_EXEC"] = "host"
    try:
        host = al.align(cf, df, ln)
    finally:
        os.environ.pop("FASTQUEEZE_ALIGN_EXEC", None)
    fused = _run(al, cf, df, ln, fused=True)
    _assert_same_decisions(host, fused)


def test_fused_archive_byte_identity(tmp_path):
    """compress_se_aligned with the fused device aligner produces the
    byte-identical archive to the host-routed one."""
    from fastqueeze_tpu.pipeline.aligned import compress_se_aligned
    rng = np.random.default_rng(34)
    ref, cf, df, ln = _mk(rng, R=300)
    fa = tmp_path / "r.fa"
    with open(fa, "wb") as fh:
        fh.write(b">c1\n" + BASES[ref.codes].tobytes() + b"\n")
    recs = []
    off = 0
    for i, L in enumerate(ln):
        s = BASES[cf[off:off + L]].tobytes()
        off += L
        q = bytes(33 + 30 for _ in range(L))
        recs.append(b"@r.%d\n%s\n+\n%s\n" % (i, s, q))
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"".join(recs))

    def go(mode, out):
        os.environ["FASTQUEEZE_ALIGN_EXEC"] = mode
        try:
            p = CodecParams(threads=1, seed_max_occ=16, seed_big_occ=128,
                            rescue_seeds=4)
            return compress_se_aligned(p, str(fa), str(fq),
                                       str(tmp_path / out))
        finally:
            os.environ.pop("FASTQUEEZE_ALIGN_EXEC", None)

    s_dev = go("device", "dev.fqz")
    s_host = go("host", "host.fqz")
    assert s_dev["mapped"] == s_host["mapped"]
    d1 = hashlib.md5(open(tmp_path / "dev.fqz", "rb").read()).hexdigest()
    d2 = hashlib.md5(open(tmp_path / "host.fqz", "rb").read()).hexdigest()
    assert d1 == d2
