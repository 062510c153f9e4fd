"""Rank-chain quality-context scheme (CodecParams.qctx_*): train-time
selection, native/numpy histogram equivalence, device/host context
equivalence, and archive round-trips.  No reference equivalent — this is
a wave-engine scheme enabled by dense rank coding (models/base.py
QualModel docstring)."""

import numpy as np
import pytest

from fastqueeze_tpu.config import CodecParams
from fastqueeze_tpu.io.fastq import parse_block
from fastqueeze_tpu.pipeline.driver import compress_se, decompress
from fastqueeze_tpu.pipeline.frozen import (
    _qctx_candidates, qual_ctx_flat, train_frozen)

SMALL = dict(slevel=0, lanes_min=16, lanes_max=32, lane_target_symbols=512)


def _binned_fastq(rng, n, L=80, bins=(2, 12, 24, 37)):
    """Illumina-binned-style quality data: tiny alphabet, strong q1..qk
    correlation — the regime where the rank chain wins."""
    recs = []
    bins = np.array(bins)
    for i in range(n):
        seq = "".join(rng.choice(list("ACGT"), L))
        # random walk over bin indices -> correlated quality ranks
        idx = np.clip(np.cumsum(rng.integers(-1, 2, L)) + 2, 0,
                      len(bins) - 1)
        qual = "".join(chr(33 + int(bins[j])) for j in idx)
        recs.append(f"@qc.{i}\n{seq}\n+\n{qual}\n")
    return "".join(recs).encode()


def test_qctx_candidates():
    assert _qctx_candidates(1) == []
    assert _qctx_candidates(300) == []
    c4 = _qctx_candidates(4)                 # 4^4 = 256 rows
    assert ((4, 3, 0, 0) in c4 and (4, 0, 3, 0) in c4
            and (4, 3, 3, 0) in c4)
    c36 = _qctx_candidates(36)               # 36^3 = 46656 rows
    assert c36[0] == (3, 0, 0, 0)
    assert (3, 0, 3, 0) in c36               # pos variant fits 2^19 rows
    assert (4, 0, 0, 17) in c36              # hashed deeper chain
    # very deep hashed chains (scored only where the big-table gates /
    # holdout allow them to win)
    assert (5, 0, 0, 18) in c36 and (6, 0, 0, 18) in c36
    assert (8, 0, 0, 20) in c36              # ladder top
    assert all(k <= 8 for k, _, _, _ in c36)
    # ladder must be ordered shallow -> deep so the dry-stop works
    deep = [k for k, _, _, _ in c36 if k >= 5]
    assert deep == sorted(deep)
    c50 = _qctx_candidates(50)               # 50^2 = 2500 rows
    assert c50[0] == (2, 3, 0, 0)
    c4 = _qctx_candidates(4)                 # 4^4 exact fits: no hashing
    assert all(hb == 0 for k4, _, _, hb in c4 if k4 <= 4)


def test_pack_counts_roundtrip():
    """Every packing branch must round-trip exactly: u8/u16 regimes,
    estimate (bz2-only) vs ship (min of bz2/zlib), and the legacy zlib
    encodings archives may still carry."""
    from fastqueeze_tpu.pipeline.frozen import _pack_counts, _unpack_counts
    rng = np.random.default_rng(31)
    for hi in (200, 9000):                   # u8 and u16 regimes
        a = rng.integers(0, hi, (257, 12)).astype(np.int32)
        for est in (False, True):
            pk = _pack_counts(a, estimate=est)
            assert pk["enc"] in ("b", "z", "pb", "p9")
            back = _unpack_counts(pk["blob"], pk["dtype"], pk["enc"])
            assert np.array_equal(back.reshape(pk["shape"]), a)


def test_mant_bucket():
    """Mantissa bucketing: deterministic floor to m significant bits,
    never below 1, identity for counts already within m bits."""
    from fastqueeze_tpu.pipeline.frozen import _mant_bucket
    a = np.array([[1, 2, 3, 4, 5, 6, 7, 8, 9, 255, 8191]], np.int32)
    b2 = _mant_bucket(a, 2)
    assert b2.tolist() == [[1, 2, 3, 4, 4, 6, 6, 8, 8, 192, 6144]]
    b3 = _mant_bucket(a, 3)
    assert b3.tolist() == [[1, 2, 3, 4, 5, 6, 7, 8, 8, 224, 7168]]
    assert (_mant_bucket(a, 16) == a).all()
    assert _mant_bucket(np.zeros((2, 2), np.int32), 2).min() == 1


def test_bucket_ship_prefers_smaller_total_cost():
    """_bucket_ship returns the original table when bucketing would cost
    more stream than it saves in blob (tiny projection), and a bucketed
    one when blob dominates (huge incompressible-ish table, tiny
    stream)."""
    from fastqueeze_tpu.pipeline.frozen import _bucket_ship, _mant_bucket
    rng = np.random.default_rng(5)
    counts = rng.integers(1, 8192, (4096, 16)).astype(np.uint16)
    hist = rng.integers(0, 50, (4096, 16)).astype(np.int64)
    # near-zero projection: blob dominates -> bucketed (fewer values)
    out = _bucket_ship(counts, hist, scale=1e-6)
    assert (out == _mant_bucket(counts, 2).astype(out.dtype)).all()
    # astronomically scaled stream: any NLL penalty loses -> unchanged
    out2 = _bucket_ship(counts, hist, scale=1e9)
    assert (out2 == counts).all()


def test_unpack_counts_legacy_zlib():
    """Archives written before the bz2 serializer carry 'z'/'p9' blobs —
    decode must keep reading them."""
    import zlib as _z
    from fastqueeze_tpu.pipeline.frozen import _unpack_counts
    rng = np.random.default_rng(32)
    a8 = rng.integers(0, 200, (64, 8)).astype(np.uint8)
    back = _unpack_counts(_z.compress(a8.tobytes(), 9), "|u1", "z")
    assert np.array_equal(back.reshape(a8.shape), a8)
    a16 = rng.integers(0, 9000, (64, 8)).astype(np.uint16)
    lo = _z.compress((a16 & 0xFF).astype(np.uint8).tobytes(), 9)
    hb = _z.compress((a16 >> 8).astype(np.uint8).tobytes(), 9)
    blob = len(lo).to_bytes(4, "little") + lo + hb
    back = _unpack_counts(blob, "<u2", "p9")
    assert np.array_equal(back.reshape(a16.shape), a16)


def test_big_table_gate():
    """Candidates whose dense table exceeds _BIG_TABLE entries are only
    admitted when the projected stream amortizes the device upload."""
    from fastqueeze_tpu.pipeline.frozen import (
        _BIG_TABLE, _BIG_TABLE_MIN_SYMS)
    rng = np.random.default_rng(37)
    raw = _binned_fastq(rng, 600, bins=tuple(range(2, 38)))
    block = parse_block(raw, True)
    small = CodecParams(use_model=1, **SMALL)
    train_frozen(small, block, est_total_syms=10 << 20)
    # whatever scheme won at a small projection must respect the gate
    if small.qctx_k >= 2:
        from fastqueeze_tpu.pipeline.frozen import _qual_alphabet
        a_trained = _qual_alphabet(int(block.qual_flat.max()) - 33)
        assert small.qual_nctx() * a_trained <= _BIG_TABLE
    # with the projection large enough the pos variant is at least
    # *considered*; whichever wins must round-trip through serialization
    from fastqueeze_tpu.pipeline.frozen import (
        deserialize_frozen, serialize_frozen)
    big = CodecParams(use_model=1, **SMALL)
    f = train_frozen(big, block, est_total_syms=_BIG_TABLE_MIN_SYMS * 2)
    back = deserialize_frozen(serialize_frozen(f))
    assert np.array_equal(np.asarray(back["qual_counts"]),
                          np.asarray(f["qual_counts"]))
    assert _BIG_TABLE < _BIG_TABLE_MIN_SYMS


def test_native_qctx_hist_matches_host_mirror():
    """fq_qctx_hist must equal a bincount over qual_ctx_flat with the same
    rank-chain model, including stride sampling and the raw->rank LUT."""
    from fastqueeze_tpu.io import native
    from fastqueeze_tpu.models.base import QualModel
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(21)
    lengths = rng.integers(1, 70, 90).astype(np.int64)
    n = int(lengths.sum())
    # raw quality chars from a small set, mapped to dense ranks by lut
    vals = np.array([35, 40, 52, 60, 70], np.uint8)
    raw = vals[rng.integers(0, len(vals), n)]
    lut = np.zeros(256, np.uint8)
    lut[vals] = np.arange(len(vals))
    A = len(vals)
    for k, drop_bits, pos_bits, hb, stride in (
            (2, 0, 0, 0, 1), (3, 3, 0, 0, 1), (4, 3, 2, 0, 1),
            (3, 3, 0, 0, 4), (4, 0, 0, 10, 1), (4, 2, 1, 9, 3)):
        nat = native.qctx_hist(raw, lengths, stride, lut, A, k, A,
                               drop_bits, pos_bits, 5, hash_bits=hb)
        if nat is None:
            pytest.skip("native library unavailable")
        qm = QualModel(alphabet=A, qlevel=2, drop_init=5, k=k, ctx_base=A,
                       drop_bits=drop_bits, pos_bits=pos_bits,
                       hash_bits=hb)
        if stride == 1:
            syms, lens = lut[raw], lengths
        else:
            from fastqueeze_tpu.pipeline.frozen import _sample_keep
            keep = _sample_keep(len(lengths), stride)
            syms = lut[raw[np.repeat(keep, lengths)]]
            lens = lengths[keep]
        ctx = qual_ctx_flat(qm, syms.astype(np.int32), lens)
        ref = np.bincount(ctx * A + syms,
                          minlength=qm.n_ctx * A).reshape(qm.n_ctx, A)
        assert np.array_equal(nat, ref), (k, drop_bits, pos_bits, hb,
                                          stride)


def test_device_context_grids_match_host_flat():
    """QualModel.context_grids (wave grids, device) must walk the same
    rank-chain contexts as qual_ctx_flat (host) — train/encode/decode all
    share these."""
    from fastqueeze_tpu.models.base import QualModel
    from fastqueeze_tpu.ops.engine import train_counts
    from fastqueeze_tpu.pipeline.frozen import _hist_counts
    rng = np.random.default_rng(5)
    p = CodecParams(**SMALL)
    lengths = rng.integers(3, 50, 40)
    quals = rng.integers(0, 6, int(lengths.sum())).astype(np.uint8)
    for k, drop_bits, hb in ((2, 0, 0), (3, 3, 0), (4, 3, 0), (4, 0, 8)):
        qm = QualModel(alphabet=8, init=p.qual_init, inc=p.qual_inc,
                       cap=p.qual_cap, qlevel=p.qlevel,
                       drop_init=p.q_drop_init, k=k, ctx_base=6,
                       drop_bits=drop_bits, hash_bits=hb)
        host = _hist_counts(qm, qual_ctx_flat(qm, quals, lengths), quals)
        dev = np.asarray(train_counts(qm, p, quals, lengths))
        assert np.array_equal(host, dev), (k, drop_bits, hb)


def _markov3_fastq(rng, n, L=80, A=8):
    """Position-independent ORDER-3 quality structure: the next rank is a
    deterministic mix of the previous three (plus 10% noise) — exactly
    what the k>=3 rank chain captures and the fqzcomp formula (q1 + part
    of q2 + pos) cannot."""
    recs = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACGT"), L))
        r = [int(rng.integers(0, A)) for _ in range(3)]
        out = []
        for _ in range(L):
            base = (r[-1] * 3 + r[-2] * 2 + r[-3] * 5) % A
            v = base if rng.random() < 0.9 else int(rng.integers(0, A))
            out.append(v)
            r.append(v)
        qual = "".join(chr(33 + 2 * v) for v in out)
        recs.append(f"@m3.{i}\n{seq}\n+\n{qual}\n")
    return "".join(recs).encode()


def test_auto_qctx_selected_and_roundtrips(tmp_path):
    """On deep-Markov quality data the auto gate should pick the rank
    chain, serialize the scheme in PARAM, and round-trip bit-exact.
    (Unique reads — the dedup tier can't shrink the projected stream, so
    the chain's table decisively pays for itself.)"""
    from fastqueeze_tpu.container.arcfile import ArcReader
    rng = np.random.default_rng(13)
    raw = _markov3_fastq(rng, 4000)          # ~0.7 MB
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    p = CodecParams(use_model=1, model_train_mb=1, **SMALL)
    p.block_size_mb = 1
    arc = str(tmp_path / "out.fqz")
    compress_se(p, str(src), arc)
    assert p.qctx_k >= 2 and p.qctx_base >= 2   # chain chosen on this data
    with ArcReader(arc) as r:
        assert r.params.qctx_k == p.qctx_k
        assert r.params.qctx_base == p.qctx_base
        assert r.params.qctx_drop_bits == p.qctx_drop_bits
    outs = decompress(arc, str(tmp_path / "back"), force=True)
    assert open(outs[0], "rb").read() == raw


def test_qctx_beats_fqz_formula_on_binned_data(tmp_path):
    """The selection must only fire when it helps: on binned data the
    chain archive must be no larger than the formula archive."""
    rng = np.random.default_rng(17)
    raw = _binned_fastq(rng, 500) * 8
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    a_on = str(tmp_path / "on.fqz")
    a_off = str(tmp_path / "off.fqz")
    p_on = CodecParams(use_model=1, model_train_mb=1, **SMALL)
    p_off = CodecParams(use_model=1, model_train_mb=1, qctx_auto=0,
                        **SMALL)
    for p in (p_on, p_off):
        p.block_size_mb = 1
    compress_se(p_on, str(src), a_on)
    compress_se(p_off, str(src), a_off)
    assert p_off.qctx_k == 0
    import os
    assert os.path.getsize(a_on) <= os.path.getsize(a_off)


def test_forced_hashed_scheme_roundtrips(tmp_path):
    """Forcing a hashed big-table scheme (what auto-selection picks only
    at >=64M projected symbols) must produce a valid archive: hashed
    contexts walk identically on encode and decode."""
    rng = np.random.default_rng(41)
    raw = _binned_fastq(rng, 400) * 4
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    p = CodecParams(use_model=1, model_train_mb=1, qctx_k=4,
                    qctx_hash_bits=14, qctx_init=1, qctx_inc=16, **SMALL)
    p.block_size_mb = 1
    arc = str(tmp_path / "out.fqz")
    compress_se(p, str(src), arc)
    assert p.qctx_hash_bits == 14            # forced scheme kept
    outs = decompress(arc, str(tmp_path / "back"), force=True)
    assert open(outs[0], "rb").read() == raw


def test_qctx_off_when_disabled(tmp_path):
    rng = np.random.default_rng(19)
    raw = _binned_fastq(rng, 300) * 4
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    p = CodecParams(use_model=1, model_train_mb=1, qctx_auto=0, **SMALL)
    p.block_size_mb = 1
    arc = str(tmp_path / "out.fqz")
    compress_se(p, str(src), arc)
    assert p.qctx_k == 0
    outs = decompress(arc, str(tmp_path / "back"), force=True)
    assert open(outs[0], "rb").read() == raw


def test_train_frozen_numpy_fallback_path(tmp_path, monkeypatch):
    """With the native lib unavailable the numpy candidate path must pick
    the same scheme and produce the same tables."""
    from fastqueeze_tpu.io import native
    rng = np.random.default_rng(23)
    raw = _binned_fastq(rng, 400)
    block = parse_block(raw, True)
    p_nat = CodecParams(use_model=1, **SMALL)
    f_nat = train_frozen(p_nat, block, est_total_syms=10 << 20)
    monkeypatch.setattr(native, "qctx_hist",
                        lambda *a, **k: None)
    p_np = CodecParams(use_model=1, **SMALL)
    f_np = train_frozen(p_np, block, est_total_syms=10 << 20)
    assert (p_nat.qctx_k, p_nat.qctx_base, p_nat.qctx_drop_bits) == \
           (p_np.qctx_k, p_np.qctx_base, p_np.qctx_drop_bits)
    assert np.array_equal(np.asarray(f_nat["qual_counts"]),
                          np.asarray(f_np["qual_counts"]))


def test_native_holdout_pair_matches_host_mirror():
    """fq_qctx_hist3's odd-parity half must equal the hash-parity
    bincount over qual_ctx_flat for both rank chains and the fqzcomp
    formula — the holdout split drives qctx selection, so a mismatch
    would silently change archives."""
    from fastqueeze_tpu.io import native
    from fastqueeze_tpu.models.base import QualModel
    from fastqueeze_tpu.pipeline.frozen import qual_ctx_flat
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(33)
    lengths = rng.integers(1, 90, 120).astype(np.int64)
    n = int(lengths.sum())
    vals = np.array([35, 40, 52, 60], np.uint8)
    raw = vals[rng.integers(0, len(vals), n)]
    lut = np.zeros(256, np.uint8)
    lut[vals] = np.arange(len(vals))
    A = len(vals)
    models = [QualModel(alphabet=A, qlevel=2, drop_init=5, k=3,
                        ctx_base=A, drop_bits=3),
              QualModel(alphabet=A, qlevel=2, drop_init=5, k=4,
                        ctx_base=A, hash_bits=11),
              QualModel(alphabet=A, qlevel=2, drop_init=5),     # formula
              QualModel(alphabet=A, qlevel=3, drop_init=5)]
    qs = lut[raw].astype(np.int32)
    ridx = np.arange(len(lengths), dtype=np.uint32)
    odd = ((ridx * np.uint32(2654435761)) >> np.uint32(16)) & 1
    mB = np.repeat(odd.astype(bool), lengths)
    for m in models:
        out = native.qctx_hist(raw, lengths, 1, lut, A, m.k,
                               m.ctx_base or 1, m.drop_bits, m.pos_bits,
                               m.drop_init, hash_bits=m.hash_bits,
                               qlevel=m.qlevel, n_ctx=m.n_ctx,
                               holdout=True)
        assert out is not None
        full, half = out
        ctx = qual_ctx_flat(m, qs, lengths)
        nn = m.n_ctx * m.alphabet
        key = ctx * m.alphabet + qs
        ref_full = np.bincount(key, minlength=nn)[:nn].reshape(
            m.n_ctx, m.alphabet)
        ref_half = np.bincount(key[mB], minlength=nn)[:nn].reshape(
            m.n_ctx, m.alphabet)
        np.testing.assert_array_equal(full, ref_full)
        np.testing.assert_array_equal(half, ref_half)
