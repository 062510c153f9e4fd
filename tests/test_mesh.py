"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from fastqueeze_tpu.models.base import QualModel
from fastqueeze_tpu.ops import engine
from fastqueeze_tpu.parallel.mesh import (
    encode_blocks_sharded, make_mesh, train_counts_sharded)

import __graft_entry__ as graft


def test_devices_available():
    assert len(jax.devices()) == 8


def test_graft_entry_compiles():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    jax.tree_util.tree_map(lambda x: x.block_until_ready(), out)


@pytest.mark.slow
@pytest.mark.parametrize("n", [2, 8])   # 2 = minimal mesh edge; 8 = full
def test_dryrun_multichip(n):
    graft.dryrun_multichip(n)


def _mk_fastq(rng, n, L=100):
    recs = []
    for i in range(n):
        seq = rng.choice(list(b"ACGT"), size=L).astype(np.uint8)
        qual = (np.clip(rng.integers(0, 41, size=L), 0, 40) + 33
                ).astype(np.uint8)
        recs.append(f"@m.{i} {i} length={L}\n{bytes(seq).decode()}\n+\n"
                    f"{bytes(qual).decode()}\n")
    return "".join(recs).encode()


@pytest.mark.slow
def test_mesh_archive_bit_identical_to_single_device(tmp_path):
    """END-TO-END block-DP: compress_se over the 8-device mesh must produce
    the same block payloads as -t 1 on one device, and decode back
    bit-exact (the reference's block-worker scaling, SURVEY.md §2.3,
    delivered as archive production, not a bare kernel)."""
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.container.arcfile import ArcReader
    from fastqueeze_tpu.pipeline.driver import compress_se, decompress

    rng = np.random.default_rng(7)
    raw = _mk_fastq(rng, 600)
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    small = dict(slevel=0, lanes_min=16, lanes_max=32,
                 lane_target_symbols=512, block_bytes=32768)
    s1 = compress_se(CodecParams(**small, threads=1),
                     str(src), str(tmp_path / "a1.fqz"))
    s8 = compress_se(CodecParams(**small, mesh_n=8),
                     str(src), str(tmp_path / "a8.fqz"))
    assert s1["blocks"] == s8["blocks"] > 2
    with ArcReader(str(tmp_path / "a1.fqz")) as r1, \
            ArcReader(str(tmp_path / "a8.fqz")) as r8:
        assert len(r1.blocks) == len(r8.blocks)
        for i in range(len(r1.blocks)):
            assert r1.read_block(i) == r8.read_block(i), f"block {i}"
    outs = decompress(str(tmp_path / "a8.fqz"), str(tmp_path / "back"),
                      force=True)   # inherits mesh_n=8 from the archive
    assert open(outs[0], "rb").read() == raw


@pytest.mark.slow
def test_mesh_pe_archive_bit_identical(tmp_path):
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.container.arcfile import ArcReader
    from fastqueeze_tpu.pipeline.pe import compress_pe

    rng = np.random.default_rng(8)
    raw1, raw2 = _mk_fastq(rng, 300), _mk_fastq(rng, 300)
    (tmp_path / "in1.fq").write_bytes(raw1)
    (tmp_path / "in2.fq").write_bytes(raw2)
    small = dict(slevel=0, lanes_min=16, lanes_max=32,
                 lane_target_symbols=512, block_bytes=32768)
    s1 = compress_pe(CodecParams(**small, threads=1), str(tmp_path / "in1.fq"),
                     str(tmp_path / "in2.fq"), str(tmp_path / "p1.fqz"))
    s4 = compress_pe(CodecParams(**small, mesh_n=4), str(tmp_path / "in1.fq"),
                     str(tmp_path / "in2.fq"), str(tmp_path / "p4.fqz"))
    assert s1["blocks"] == s4["blocks"] > 1
    with ArcReader(str(tmp_path / "p1.fqz")) as r1, \
            ArcReader(str(tmp_path / "p4.fqz")) as r4:
        for i in range(len(r1.blocks)):
            assert r1.read_block(i) == r4.read_block(i), f"block {i}"
    from fastqueeze_tpu.pipeline.driver import decompress
    outs = decompress(str(tmp_path / "p4.fqz"), str(tmp_path / "back"),
                      force=True)
    assert open(outs[0], "rb").read() == raw1
    assert open(outs[1], "rb").read() == raw2


def test_sharded_training_matches_single_device():
    """The mesh-trained frozen table must equal the single-device one."""
    import jax.numpy as jnp
    model = QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=2)
    B, T, L = 4, 64, 32
    syms, valid, pos = graft._example_grids(B=B, T=T, L=L,
                                            qmax=model.alphabet - 1)
    mesh = make_mesh(4, ctx_shards=1)
    sharded = train_counts_sharded(mesh, model, jnp.asarray(syms),
                                   jnp.asarray(valid),
                                   {"pos": jnp.asarray(pos)})
    # single-device reference: flatten blocks into one histogram
    single = engine._train_counts(
        model, jnp.asarray(syms.reshape(B * T, L)),
        jnp.asarray(valid.reshape(B * T, L)),
        {"pos": jnp.asarray(pos.reshape(B * T, L)),
         "start": jnp.asarray(pos.reshape(B * T, L) == 0)})
    np.testing.assert_array_equal(np.asarray(sharded), np.asarray(single))


def test_ctx_sharded_frozen_decode_matches_replicated():
    """Frozen decode fed from ctx-SHARDED tables (TP analogue for models
    too big for one chip's HBM) must walk bit-identically to the
    replicated engine._decode_frozen.  The decode kernel is a
    deterministic function of (table, states, words), so equality on
    random word streams proves the sharded search + psum combine exact."""
    import jax.numpy as jnp

    from fastqueeze_tpu.config import RANS_L
    from fastqueeze_tpu.parallel.mesh import decode_blocks_frozen_sharded

    model = QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=2)
    B, T, L, W = 4, 64, 32, 2048
    rng = np.random.default_rng(33)
    # a trained-looking table: skewed random counts
    counts0 = (rng.integers(1, 50, (model.n_ctx, model.alphabet)) ** 2
               ).astype(np.int32)
    syms, valid, pos = graft._example_grids(B=B, T=T, L=L,
                                            qmax=model.alphabet - 1)
    states = rng.integers(RANS_L, 1 << 31, (B, L)).astype(np.uint32)
    words = rng.integers(0, 1 << 16, (B, W)).astype(np.uint16)

    mesh = make_mesh(8, ctx_shards=4)
    s_syms, s_x = decode_blocks_frozen_sharded(
        mesh, model, jnp.asarray(counts0), jnp.asarray(states),
        jnp.asarray(words), jnp.asarray(valid), jnp.asarray(pos))

    for b in range(B):
        aux = {"pos": jnp.asarray(pos[b]),
               "start": jnp.asarray(pos[b] == 0)}
        r_syms, r_x = engine._decode_frozen(
            model, jnp.asarray(counts0), model.lane_init(L),
            jnp.asarray(states[b]), jnp.asarray(words[b]),
            jnp.asarray(valid[b]), aux)
        np.testing.assert_array_equal(np.asarray(s_syms[b]),
                                      np.asarray(r_syms))
        np.testing.assert_array_equal(np.asarray(s_x[b]), np.asarray(r_x))


def test_index_sharded_alignment_matches_local():
    """Sharded-index lookup (pmin/pmax over 'ctx') + sharded verification
    must map the same reads with the same mismatch counts as the local
    single-device aligner."""
    import numpy as np
    from fastqueeze_tpu.align import hash as H
    from fastqueeze_tpu.align.index import build_from_ref
    from fastqueeze_tpu.align.ref import RefSeq, pack_2bit
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.parallel.mesh import (
        index_sharded_aligner, make_mesh, shard_ref_index)

    rng = np.random.default_rng(21)
    ref_codes = rng.integers(0, 4, 20000).astype(np.uint8)
    ref = RefSeq(codes=ref_codes, amb_mask=np.zeros(20000, bool),
                 names=["t"], bounds=np.array([0, 20000]), md5="x")
    p = CodecParams(seed_len=11, seed_max_occ=32, max_mis=5)
    idx = build_from_ref(ref, p)

    R, L = 64, 80
    starts = rng.integers(0, 20000 - L, R)
    codes = np.zeros((R, L), np.uint8)
    for i, s in enumerate(starts):
        c = ref_codes[s:s + L].copy()
        nmut = rng.integers(0, 4)
        mp = rng.integers(0, L, nmut)
        c[mp] = (c[mp] + 1) % 4
        if i % 3 == 0:
            c = 3 - c[::-1]
        codes[i] = c
    lengths = np.full(R, L, np.int64)
    dege = np.zeros((R, L), bool)

    al = H.Aligner(idx, p)
    import jax.numpy as jnp
    lp = al._lp_bucket(L)
    cfg1 = H.AlignConfig(k=idx.k, stride=p.seed_stride,
                         n_cand=p.seed_max_occ, max_mis=p.max_mis,
                         both_strands=p.both_strands, lp=lp,
                         l1_shift=al._l1_shift,
                         search_steps=al._search_steps, wide=al.wide)
    cg = np.zeros((R, lp), np.uint8)
    cg[:, :L] = codes
    dg = np.zeros((R, lp), bool)
    lm, lpos, lrev, lmm = H._align_batch(
        cfg1, al._keys, al._offsets, al._positions, al._packed, al._l1,
        jnp.int32(idx.ref_len), jnp.asarray(cg), jnp.asarray(dg),
        jnp.asarray(lengths.astype(np.int32)))
    lm = np.asarray(lm)
    assert lm.sum() > R * 0.8

    mesh = make_mesh(8, ctx_shards=4)
    sh = shard_ref_index(idx, 4)
    m, pos, rev, mm = index_sharded_aligner(mesh, sh)(p, cg, dg, lengths)
    m = np.asarray(m)
    assert np.array_equal(m, lm)
    # positions may differ on equal-mismatch ties; mismatch counts and
    # validity must agree
    assert np.array_equal(np.asarray(mm).sum(axis=1),
                          np.asarray(lmm).sum(axis=1))
    pos = np.asarray(pos)
    codes_i = codes
    for i in np.flatnonzero(m):
        w = ref_codes[int(pos[i]):int(pos[i]) + L]
        eff = (3 - codes[i][::-1]) if np.asarray(rev)[i] else codes[i]
        assert (w != eff).sum() <= p.max_mis


def test_sharded_block_coding_matches_single_device():
    """Block-DP coding over the mesh must produce the identical rANS words
    per block as single-device coding (SURVEY.md §4: sharded runs must
    yield the same archives)."""
    import jax.numpy as jnp
    model = QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=2)
    B, T, L = 4, 64, 32
    syms, valid, pos = graft._example_grids(B=B, T=T, L=L,
                                            qmax=model.alphabet - 1)
    counts0 = np.asarray(engine.init_counts(model))
    mesh = make_mesh(4, ctx_shards=1)
    n_halve = engine._n_halve(model, L)
    words, emits, x = encode_blocks_sharded(
        mesh, model, n_halve, jnp.asarray(counts0), jnp.asarray(syms),
        jnp.asarray(valid), jnp.asarray(pos))
    for b in range(B):
        aux = {"pos": jnp.asarray(pos[b]), "start": jnp.asarray(pos[b] == 0)}
        ctx = model.context_grids(jnp.asarray(syms[b]), aux)
        s1, f1, _ = engine._pass1(model, n_halve, jnp.asarray(counts0),
                                  ctx, jnp.asarray(syms[b]),
                                  jnp.asarray(valid[b]))
        w1, e1, x1 = engine._pass2(s1, f1, jnp.asarray(valid[b]))
        np.testing.assert_array_equal(np.asarray(words[b]), np.asarray(w1))
        np.testing.assert_array_equal(np.asarray(emits[b]), np.asarray(e1))
        np.testing.assert_array_equal(np.asarray(x[b]), np.asarray(x1))


def test_ctx_shard_gate_production_decode(tmp_path, monkeypatch):
    """The ctx-sharded frozen decoder runs IN PRODUCTION —
    driver.decompress, gated on (mesh active AND frozen qual table past
    the replication threshold) — and round-trips a real archive with a
    forced deep hashed qctx chain.  The threshold is monkeypatched down
    so the toy table (2^14 rows) takes the sharded path."""
    from fastqueeze_tpu import pipeline
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.parallel import mesh as M
    from fastqueeze_tpu.pipeline import driver
    from fastqueeze_tpu.pipeline.driver import compress_se, decompress

    rng = np.random.default_rng(23)
    raw = _mk_fastq(rng, 800)
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    p = CodecParams(slevel=0, lanes_min=16, lanes_max=32,
                    lane_target_symbols=512, block_bytes=65536,
                    use_model=1, qctx_k=4, qctx_hash_bits=14)
    arc = str(tmp_path / "deep.fqz")
    compress_se(p, str(src), arc)

    monkeypatch.setattr(driver, "CTX_SHARD_MIN_ENTRIES", 1)
    M._SHARD_DECODE_CACHE.clear()
    outs = decompress(arc, str(tmp_path / "back"), force=True, mesh=8)
    assert open(outs[0], "rb").read() == raw
    # the sharded decoder actually ran (compiled fn cached per shape)
    assert len(M._SHARD_DECODE_CACHE) >= 1

    # and without the monkeypatch the replicated path still round-trips
    outs = decompress(arc, str(tmp_path / "back2"), force=True, mesh=8)
    assert open(outs[0], "rb").read() == raw


@pytest.mark.slow
def test_mesh_e2e_realistic_scale(tmp_path):
    """A NON-TOY mesh archive — 50k reads through a trained
    deep hashed-qctx frozen model — with --mesh 8 payloads byte-identical
    to -t 1 and a bit-exact round-trip through the mesh decoder."""
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.container.arcfile import ArcReader
    from fastqueeze_tpu.pipeline.driver import compress_se, decompress

    rng = np.random.default_rng(29)
    raw = _mk_fastq(rng, 50_000)          # 5 M bases
    src = tmp_path / "in.fq"
    src.write_bytes(raw)
    # force usemodel + a deep hashed rank chain (2^17 rows — the ladder's
    # deep-candidate shape) over multiple blocks
    mk = lambda **kw: CodecParams(block_size_mb=2, use_model=1,  # noqa: E731
                                  qctx_k=5, qctx_hash_bits=17, **kw)
    s1 = compress_se(mk(threads=1), str(src), str(tmp_path / "a1.fqz"))
    s8 = compress_se(mk(mesh_n=8), str(src), str(tmp_path / "a8.fqz"))
    assert s1["blocks"] == s8["blocks"] >= 3
    with ArcReader(str(tmp_path / "a1.fqz")) as r1, \
            ArcReader(str(tmp_path / "a8.fqz")) as r8:
        assert r1.model_blob == r8.model_blob
        for i in range(len(r1.blocks)):
            assert r1.read_block(i) == r8.read_block(i), f"block {i}"
    outs = decompress(str(tmp_path / "a8.fqz"), str(tmp_path / "back"),
                      force=True)
    assert open(outs[0], "rb").read() == raw
