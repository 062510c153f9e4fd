"""Frozen-model (usemodel) mode: training, serialization, and round-trips
with the model section in the archive (SURVEY.md §3.4)."""

import numpy as np
import pytest

from fastqueeze_tpu.config import CodecParams
from fastqueeze_tpu.io.fastq import parse_block
from fastqueeze_tpu.pipeline.driver import compress_se, decompress
from fastqueeze_tpu.pipeline.frozen import (
    decide_use_model, deserialize_frozen, fit_qual_alphabet,
    serialize_frozen, train_frozen)

SMALL = dict(slevel=0, lanes_min=16, lanes_max=32, lane_target_symbols=512)


def _mk_fastq(rng, n, L=60):
    recs = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACGT"), L))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 40, L))
        recs.append(f"@frz.{i}\n{seq}\n+\n{qual}\n")
    return "".join(recs).encode()


def test_serialize_roundtrip():
    rng = np.random.default_rng(3)
    raw = _mk_fastq(rng, 50)
    p = CodecParams(**SMALL)
    frozen = train_frozen(p, parse_block(raw, True))
    blob = serialize_frozen(frozen)
    back = deserialize_frozen(blob)
    assert back["qmax"] == frozen["qmax"]
    assert np.array_equal(np.asarray(back["seq_counts"]),
                          np.asarray(frozen["seq_counts"]))
    assert np.array_equal(np.asarray(back["qual_counts"]),
                          np.asarray(frozen["qual_counts"]))


def test_decide_gate():
    p = CodecParams(block_size_mb=1)
    assert not decide_use_model(p, 1 << 20)
    assert decide_use_model(p, 5 << 20)
    p.use_model = -1
    assert not decide_use_model(p, 5 << 20)
    p.use_model = 1
    assert decide_use_model(p, 10)
    p.use_model = 0
    p.qlevel = 3
    assert not decide_use_model(p, 5 << 20)


def test_decide_gate_big_single_block():
    """A large input inside ONE default-sized block still gates frozen
    on (measured crossover ~12 MB); small single-block inputs stay
    adaptive."""
    p = CodecParams()                 # 50 MB blocks
    assert not decide_use_model(p, 9 << 20)
    assert decide_use_model(p, 16 << 20)


def test_fit_qual_alphabet():
    import jax.numpy as jnp
    t = jnp.ones((4, 8), jnp.int32)
    assert fit_qual_alphabet(t, 8, 1).shape == (4, 8)
    w = fit_qual_alphabet(t, 16, 5)
    assert w.shape == (4, 16)
    assert int(w[0, 12]) == 5
    with pytest.raises(ValueError):
        fit_qual_alphabet(t, 4, 1)


def test_se_roundtrip_with_frozen_model(tmp_path):
    """Multi-block compress with use_model forced on: archive carries the
    MODEL section; every block decodes from the frozen snapshot."""
    rng = np.random.default_rng(9)
    raw = _mk_fastq(rng, 400)
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    # tiny blocks force >1 block; model trained on ~first block
    p = CodecParams(use_model=1, model_train_mb=1, **SMALL)
    p.block_size_mb = 1
    raw_big = raw * 40           # ~1.1 MB -> several blocks
    src.write_bytes(raw_big)
    arc = str(tmp_path / "out.fqz")
    stats = compress_se(p, str(src), arc)
    assert stats["blocks"] >= 1
    from fastqueeze_tpu.container.arcfile import ArcReader
    with ArcReader(arc) as r:
        assert r.model_blob is not None
    outs = decompress(arc, str(tmp_path / "back"), force=True)
    assert open(outs[0], "rb").read() == raw_big


def test_frozen_shrinks_block_payloads_on_real_data(tmp_path, bundled_pair):
    """On realistic (repetitive) data every block must get smaller when it
    starts from the frozen tables (the blob itself amortizes only at the
    reference's multi-GB usemodel scale, SURVEY.md §2.1)."""
    from fastqueeze_tpu.container.arcfile import ArcReader
    raw1 = open(bundled_pair[0], "rb").read()
    lines = raw1.split(b"\n")
    raw = (b"\n".join(lines[:4 * 3000]) + b"\n") * 4
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    p0 = CodecParams(use_model=-1, **SMALL)
    p0.block_size_mb = 1
    compress_se(p0, str(src), str(tmp_path / "a.fqz"))
    p1 = CodecParams(use_model=1, model_train_mb=1, **SMALL)
    p1.block_size_mb = 1
    compress_se(p1, str(src), str(tmp_path / "b.fqz"))
    with ArcReader(str(tmp_path / "a.fqz")) as ra, \
            ArcReader(str(tmp_path / "b.fqz")) as rb:
        pay_a = sum(b.payload_len for b in ra.blocks)
        pay_b = sum(b.payload_len for b in rb.blocks)
        assert len(ra.blocks) >= 2 and len(rb.blocks) == len(ra.blocks)
    assert pay_b < pay_a


def test_host_trainer_matches_device():
    """train_frozen's host bincount path must produce bit-identical tables
    to the device histogram trainer (engine.train_counts) — same contexts,
    same cap rescale."""
    from fastqueeze_tpu.models.base import QualModel, seq_model_from_params
    from fastqueeze_tpu.ops.engine import train_counts
    from fastqueeze_tpu.pipeline.frozen import (
        _hist_counts, _qual_alphabet, qual_ctx_flat, seq_ctx_flat)

    rng = np.random.default_rng(11)
    for qlevel in (2, 3):
        p = CodecParams(slevel=0, qlevel=qlevel, lanes_min=16, lanes_max=64,
                        lane_target_symbols=512)
        lengths = rng.integers(5, 90, 40)
        codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
        quals = rng.integers(0, 45, int(lengths.sum())).astype(np.uint8)

        sm = seq_model_from_params(p)
        host = _hist_counts(sm, seq_ctx_flat(sm, codes, lengths), codes)
        dev = np.asarray(train_counts(sm, p, codes, lengths))
        assert np.array_equal(host, dev)

        qm = QualModel(alphabet=_qual_alphabet(44), init=p.qual_init,
                       inc=p.qual_inc, cap=p.qual_cap, qlevel=qlevel,
                       drop_init=p.q_drop_init)
        host = _hist_counts(qm, qual_ctx_flat(qm, quals, lengths), quals)
        dev = np.asarray(train_counts(qm, p, quals, lengths))
        assert np.array_equal(host, dev)


def test_native_hist_matches_numpy():
    from fastqueeze_tpu.config import SEQ_CTX_START
    from fastqueeze_tpu.io import native
    from fastqueeze_tpu.models.base import QualModel, seq_model_from_params
    from fastqueeze_tpu.pipeline.frozen import (
        _qual_alphabet, qual_ctx_flat, seq_ctx_flat)
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(7)
    lengths = rng.integers(1, 70, 60)
    codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    quals = rng.integers(0, 50, int(lengths.sum())).astype(np.uint8)
    for slevel in (0, 3):
        p = CodecParams(slevel=slevel)
        sm = seq_model_from_params(p)
        nat = native.seq_hist(codes, lengths, sm.order, SEQ_CTX_START)
        ctx = seq_ctx_flat(sm, codes, lengths)
        ref = np.bincount(ctx * 4 + codes,
                          minlength=sm.n_ctx * 4).reshape(sm.n_ctx, 4)
        assert np.array_equal(nat, ref)
    for qlevel in (1, 2, 3):
        qm = QualModel(alphabet=_qual_alphabet(49), qlevel=qlevel,
                       drop_init=5)
        nat = native.qual_hist(quals, lengths, qlevel, 5, qm.alphabet)
        ctx = qual_ctx_flat(qm, quals, lengths)
        ref = np.bincount(
            ctx * qm.alphabet + quals,
            minlength=qm.n_ctx * qm.alphabet).reshape(qm.n_ctx, qm.alphabet)
        assert np.array_equal(nat, ref)
