"""Host-native aligner mirror vs the device kernels.

native/alignhost.cpp re-implements align/hash.py's gapless tiers as tight
scalar code; which backend aligns a block is an execution choice, so every
BITSTREAM-RELEVANT output must agree between them: the mapped flags, and
pos / is_rev / mis_mask for the mapped reads (an unmapped read's position
never reaches the archive — those reads are coded entropy-only, and only
the AMAP flag stream records them).  Reference analogue: HashAlignment
(SURVEY.md §2.2) has a single implementation; here the pair is kept honest
by this cross-check.
"""

import os

import numpy as np
import pytest

from fastqueeze_tpu.align.index import build_from_ref
from fastqueeze_tpu.align.ref import load_fasta
from fastqueeze_tpu.config import CodecParams
from fastqueeze_tpu.io import native

_BASES = np.frombuffer(b"ACGT", np.uint8)


def _mk_ref(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


def _reads_from_ref(rng, ref, n_reads, length, err_rate=0.02, rc_frac=0.3):
    """Reads sampled from ref with point errors; a fraction reverse-
    complemented; plus pure-random (unmappable) reads mixed in."""
    reads = []
    for i in range(n_reads):
        if i % 5 == 4:
            reads.append(rng.integers(0, 4, length).astype(np.uint8))
            continue
        p = int(rng.integers(0, len(ref) - length))
        r = ref[p:p + length].copy()
        errs = rng.random(length) < err_rate
        r[errs] = (r[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
        if rng.random() < rc_frac:
            r = (3 - r)[::-1].copy()
        reads.append(r)
    return reads


@pytest.mark.skipif(native.get_lib() is None
                    or not hasattr(native.get_lib(), "fq_align_batch"),
                    reason="native aligner unavailable")
def test_host_mirror_matches_device(tmp_path):
    from fastqueeze_tpu.align.hash import Aligner

    rng = np.random.default_rng(7)
    ref = _mk_ref(rng, 20000)
    # inject a repeat family so deep candidate lists (the tier-2 rescue
    # path, probe prefilter + top-K) are exercised
    unit = ref[:60]
    for j in range(40):
        p = 8000 + j * 70
        ref[p:p + 60] = unit
    reads = _reads_from_ref(rng, ref, 160, 100)
    # a few reads from inside the repeat region
    for j in range(12):
        p = 8000 + int(rng.integers(0, 35)) * 70 + int(rng.integers(0, 8))
        reads.append(ref[p:p + 100].copy())
    lengths = np.array([len(r) for r in reads], np.int64)
    codes = np.concatenate(reads)
    dege = np.zeros(len(codes), bool)

    fa = tmp_path / "ref.fa"
    fa.write_bytes(b">r\n" + _BASES[ref].tobytes() + b"\n")
    p = CodecParams()
    idx = build_from_ref(load_fasta(str(fa)), p)
    p.aligned = 1
    p.ref_len = len(ref)
    p.seed_len = idx.k

    results = {}
    for mode in ("host", "device"):
        os.environ["FASTQUEEZE_ALIGN_EXEC"] = mode
        try:
            al = Aligner(idx, p)
            results[mode] = al.align(codes, dege, lengths)
        finally:
            del os.environ["FASTQUEEZE_ALIGN_EXEC"]

    rh, rd = results["host"], results["device"]
    assert rh.mapped.sum() > 100          # the fixture actually maps
    np.testing.assert_array_equal(rh.mapped, rd.mapped)
    m = rd.mapped
    np.testing.assert_array_equal(rh.pos[m], rd.pos[m])
    np.testing.assert_array_equal(rh.is_rev[m], rd.is_rev[m])
    np.testing.assert_array_equal(rh.mis_mask[m], rd.mis_mask[m])

@pytest.mark.skipif(native.get_lib() is None,
                    reason="native aligner unavailable")
def test_window_rescue_mirror_matches_device(tmp_path):
    """fq_window_batch (PE mate rescue) vs the device _window_batch:
    mapped flags identical; pos / is_rev / mis_mask identical on the
    mapped reads (an unrescued read's fields never reach the archive)."""
    from fastqueeze_tpu.align.hash import Aligner

    rng = np.random.default_rng(13)
    ref = _mk_ref(rng, 30000)
    # interleaved mates: even reads map cleanly, odd mates sit at a known
    # insert from them with heavier errors (some rescuable, some not)
    reads = []
    for i in range(120):
        p = int(rng.integers(200, len(ref) - 600))
        r1 = ref[p:p + 100].copy()
        ins = int(rng.integers(120, 380))
        r2 = ref[p + ins:p + ins + 100].copy()
        nerr = int(rng.integers(0, 12))       # some exceed max_mis
        at = rng.integers(0, 100, nerr)
        r2[at] = (r2[at] + rng.integers(1, 4, nerr)) % 4
        if rng.random() < 0.5:
            r2 = (3 - r2)[::-1].copy()
        reads += [r1, r2]
    lengths = np.array([len(r) for r in reads], np.int64)
    codes = np.concatenate(reads)
    dege = np.zeros(len(codes), bool)

    fa = tmp_path / "ref.fa"
    fa.write_bytes(b">r\n" + _BASES[ref].tobytes() + b"\n")
    p = CodecParams()
    idx = build_from_ref(load_fasta(str(fa)), p)
    p.aligned = 1
    p.ref_len = len(ref)
    p.seed_len = idx.k

    results = {}
    for mode in ("host", "device"):
        os.environ["FASTQUEEZE_ALIGN_EXEC"] = mode
        try:
            al = Aligner(idx, p)
            res = al.align(codes, dege, lengths)
            results[mode] = al.rescue_mates(codes, dege, lengths, res, 500)
        finally:
            del os.environ["FASTQUEEZE_ALIGN_EXEC"]

    rh, rd = results["host"], results["device"]
    assert rh.mapped.sum() > 150
    np.testing.assert_array_equal(rh.mapped, rd.mapped)
    m = rd.mapped
    np.testing.assert_array_equal(rh.pos[m], rd.pos[m])
    np.testing.assert_array_equal(rh.is_rev[m], rd.is_rev[m])
    np.testing.assert_array_equal(rh.mis_mask[m], rd.mis_mask[m])

@pytest.mark.skipif(native.get_lib() is None,
                    reason="native aligner unavailable")
def test_wide_key_mirror_matches_device(tmp_path):
    """Wide (-q long-seed, k > 15) keys: u64 host search vs the device's
    (hi, lo30) pair-lexicographic search."""
    from fastqueeze_tpu.align.hash import Aligner

    rng = np.random.default_rng(23)
    ref = _mk_ref(rng, 24000)
    unit = ref[:80]
    for j in range(25):
        p = 9000 + j * 95
        ref[p:p + 80] = unit
    reads = _reads_from_ref(rng, ref, 140, 100)
    lengths = np.array([len(r) for r in reads], np.int64)
    codes = np.concatenate(reads)
    dege = np.zeros(len(codes), bool)

    fa = tmp_path / "ref.fa"
    fa.write_bytes(b">r\n" + _BASES[ref].tobytes() + b"\n")
    p = CodecParams(seed_len=22)
    idx = build_from_ref(load_fasta(str(fa)), p)
    assert idx.k == 22
    p.aligned = 1
    p.ref_len = len(ref)
    p.seed_len = idx.k

    results = {}
    for mode in ("host", "device"):
        os.environ["FASTQUEEZE_ALIGN_EXEC"] = mode
        try:
            al = Aligner(idx, p)
            results[mode] = al.align(codes, dege, lengths)
        finally:
            del os.environ["FASTQUEEZE_ALIGN_EXEC"]

    rh, rd = results["host"], results["device"]
    assert rh.mapped.sum() > 90
    np.testing.assert_array_equal(rh.mapped, rd.mapped)
    m = rd.mapped
    np.testing.assert_array_equal(rh.pos[m], rd.pos[m])
    np.testing.assert_array_equal(rh.is_rev[m], rd.is_rev[m])
    np.testing.assert_array_equal(rh.mis_mask[m], rd.mis_mask[m])

@pytest.mark.skipif(native.get_lib() is None,
                    reason="native aligner unavailable")
def test_indel_tier_mirror_matches_device(tmp_path):
    """fq_indel_batch vs the device _indel_batch: found flags identical;
    pos / split / gap / is_rev / mis_mask identical on found reads."""
    from fastqueeze_tpu.align.hash import Aligner

    rng = np.random.default_rng(31)
    ref = _mk_ref(rng, 25000)
    reads = []
    for i in range(100):
        p = int(rng.integers(100, len(ref) - 300))
        r = ref[p:p + 103].copy()
        kind = i % 5
        if kind == 0:      # deletion in the read (skips ref bases)
            g = int(rng.integers(1, 4))
            s = int(rng.integers(20, 80))
            r = np.concatenate([r[:s], r[s + g:]])[:100]
        elif kind == 1:    # insertion in the read
            g = int(rng.integers(1, 4))
            s = int(rng.integers(20, 80))
            ins = rng.integers(0, 4, g).astype(np.uint8)
            r = np.concatenate([r[:s], ins, r[s:]])[:100]
        elif kind == 2:    # heavy point errors (often unmappable)
            r = r[:100]
            at = rng.integers(0, 100, 12)
            r[at] = (r[at] + rng.integers(1, 4, 12)) % 4
        elif kind == 3:    # TWO separated indels (the 2-op pass)
            g = int(rng.integers(1, 3))
            s_a = int(rng.integers(15, 35))
            s_b = int(rng.integers(60, 85))
            r = np.concatenate([r[:s_a], r[s_a + g:]])
            ins = rng.integers(0, 4, g).astype(np.uint8)
            r = np.concatenate([r[:s_b], ins, r[s_b:]])[:100]
        else:              # clean (mapped by the gapless tiers already)
            r = r[:100]
        if rng.random() < 0.4:
            r = (3 - r)[::-1].copy()
        reads.append(r)
    lengths = np.array([len(r) for r in reads], np.int64)
    codes = np.concatenate(reads)
    dege = np.zeros(len(codes), bool)

    fa = tmp_path / "ref.fa"
    fa.write_bytes(b">r\n" + _BASES[ref].tobytes() + b"\n")
    p = CodecParams(max_indel=3)
    idx = build_from_ref(load_fasta(str(fa)), p)
    p.aligned = 1
    p.ref_len = len(ref)
    p.seed_len = idx.k

    results = {}
    for mode in ("host", "device"):
        os.environ["FASTQUEEZE_ALIGN_EXEC"] = mode
        try:
            al = Aligner(idx, p)
            results[mode] = al.align(codes, dege, lengths)
        finally:
            del os.environ["FASTQUEEZE_ALIGN_EXEC"]

    rh, rd = results["host"], results["device"]
    assert rh.mapped.sum() > 60
    assert (rh.gap_len != 0).sum() > 10      # indel tier actually fired
    assert (rh.gap_len2[rh.mapped] != 0).sum() > 5   # 2-op pass fired
    np.testing.assert_array_equal(rh.mapped, rd.mapped)
    m = rd.mapped
    np.testing.assert_array_equal(rh.pos[m], rd.pos[m])
    np.testing.assert_array_equal(rh.gap_pos[m], rd.gap_pos[m])
    np.testing.assert_array_equal(rh.gap_len[m], rd.gap_len[m])
    np.testing.assert_array_equal(rh.gap_pos2[m], rd.gap_pos2[m])
    np.testing.assert_array_equal(rh.gap_len2[m], rd.gap_len2[m])
    np.testing.assert_array_equal(rh.is_rev[m], rd.is_rev[m])
    np.testing.assert_array_equal(rh.mis_mask[m], rd.mis_mask[m])


def test_no_match_seed_at_index_end_stays_in_bounds():
    """A read none of whose seeds is indexed scans a junk CSR slice
    clamped to the END of the positions array; the candidate prefetch
    must honour the same clamp.  positions ends right before a PROT_NONE
    page here, so a read past its end faults instead of passing
    silently."""
    import ctypes
    import mmap

    from fastqueeze_tpu.align.hash import Aligner
    from fastqueeze_tpu.align.ref import RefSeq
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(7)
    # no T anywhere except one TTTTTTTTTTTTTG: the largest indexed key,
    # occurring once, so an all-T read's seeds land past the last key
    codes = rng.integers(0, 3, 4096).astype(np.uint8)
    codes[1000:1014] = [3] * 13 + [2]
    p = CodecParams(seed_len=14)
    ref = RefSeq(codes=codes, amb_mask=np.zeros(len(codes), bool),
                 names=["c"], bounds=np.array([0, len(codes)]), md5="")
    al = Aligner(build_from_ref(ref, p), p)
    pos = al._h_positions
    page = mmap.PAGESIZE
    nb = pos.nbytes
    body = -(-nb // page) * page
    buf = mmap.mmap(-1, body + page)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    libc = ctypes.CDLL(None)
    assert libc.mprotect(ctypes.c_void_p(addr + body), page, 0) == 0
    try:
        guarded = np.frombuffer(buf, np.int32, len(pos), body - nb)
        guarded[:] = pos
        reads = np.full(100, 3, np.uint8)
        out = native.align_batch(
            al._h_keys, al._h_offsets, guarded, al._h_packed, al._h_l1,
            al._l1_shift, al._search_steps, al.ref_len, reads,
            np.zeros(100, bool), np.zeros(1, np.int64),
            np.array([100]), 128, 14, p.seed_stride, 64, p.max_mis, 1, 0,
            16, 0, 0)
        assert not out[0][0]
        del guarded
    finally:
        libc.mprotect(ctypes.c_void_p(addr + body), page, 3)
