"""Multi-device scale-out over a jax.sharding.Mesh.

The reference scales with pthreads over 50 MB blocks on one host
(SURVEY.md §2.3).  The accelerator-native mapping:

* **block axis (data parallel)** — blocks (or block shards of the training
  prefix) are distributed across devices; each device runs the full
  per-block coding pipeline on its shard.  Per-block payloads are
  independent byte strings, gathered host-side into the container — the
  analogue of the reference's mergeFile.
* **ctx axis (tensor parallel analogue)** — the frozen model count tables
  (up to 4^order contexts for the sequence model) can be sharded over their
  context dimension; training reduces with psum_scatter so each device
  keeps only its table shard.

Everything here is shard_map over a Mesh with explicit PartitionSpecs, so
XLA inserts the collectives (NVLink between the GPUs of one host).  The
mesh is shaped by the algorithm only ('block' x 'ctx'), since those GPUs
are linked all to all.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fastqueeze_tpu.config import CodecParams
from fastqueeze_tpu.models.base import CtxModel
from fastqueeze_tpu.ops import engine


def make_mesh(n_devices: Optional[int] = None,
              ctx_shards: int = 1) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    if n % ctx_shards:
        raise ValueError("n_devices must be divisible by ctx_shards")
    arr = np.array(devs[:n]).reshape(n // ctx_shards, ctx_shards)
    return Mesh(arr, ("block", "ctx"))


def block_devices(mesh_n: int, clamp: bool = False):
    """Resolve the block-DP device list for archive production.

    ``mesh_n`` is CodecParams.mesh_n (0 = off, -1 = all devices, N = first
    N).  Returns the devices along the mesh's 'block' axis, or None when
    block-DP is a no-op (<=1 device).  Archive production then round-robins
    whole blocks over these devices — the reference's block workers draining
    a shared pool (SeqArcContext::doReadAndEncode, SURVEY.md §2.3 "**The**
    scaling axis") with chips in place of pthreads.  Payloads are
    device-count invariant (the engine is integer-deterministic), so
    --mesh N archives are byte-identical to -t 1 ones."""
    if not mesh_n:
        return None
    devs = jax.devices()
    n = len(devs) if mesh_n < 0 else mesh_n
    if n > len(devs):
        if not clamp:
            raise ValueError(
                f"--mesh {n}: only {len(devs)} device(s) visible")
        n = len(devs)
    if n <= 1:
        return None
    return list(make_mesh(n).devices.reshape(-1))


def device_cycled(devices, fn):
    """Wrap a per-block work fn so block i runs with device i%N as the
    default device: every jit dispatch and array upload inside lands on
    that chip.  Identity when devices is None (single-device)."""
    if not devices:
        return fn
    n = len(devices)

    def wrapped(i, item):
        with jax.default_device(devices[i % n]):
            return fn(i, item)

    return wrapped


def train_counts_sharded(mesh: Mesh, model: CtxModel,
                         syms: jnp.ndarray, valid: jnp.ndarray,
                         aux: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """Frozen-model training over a mesh.

    syms/valid/aux['pos']: (B, T, L) stacked block grids, sharded over the
    'block' axis.  Each device histograms its blocks, then the tables are
    psum-reduced over 'block' and scattered over 'ctx' — the result is the
    global frozen table, sharded over its context dimension.
    """
    n_ctx_local = model.n_ctx // mesh.shape["ctx"]

    def local_train(s, v, pos):
        # accumulate raw histograms over this device's blocks
        def one(sb, vb, pb):
            ctx = model.context_grids(sb, {"pos": pb, "start": pb == 0})
            flat = ctx.astype(jnp.int32) * model.alphabet + sb.astype(jnp.int32)
            n = model.n_ctx * model.alphabet
            flat = jnp.where(vb, flat, n).reshape(-1)
            hist = jnp.zeros((n + 1,), jnp.int32).at[flat].add(model.inc)
            return hist[:n].reshape(model.n_ctx, model.alphabet)

        hists = jax.vmap(one)(s, v, pos)
        local = hists.sum(axis=0)
        # all-reduce over the block axis; keep only this device's row shard
        # along ctx (reduce-scatter semantics)
        full = jax.lax.psum(local, "block")
        mine = jax.lax.dynamic_slice_in_dim(
            full, jax.lax.axis_index("ctx") * n_ctx_local, n_ctx_local, 0)
        counts = mine + model.init
        for _ in range(24):
            tot = counts.sum(axis=1, keepdims=True)
            counts = jnp.where(tot > model.cap, (counts + 1) >> 1, counts)
        return counts

    fn = shard_map(
        local_train, mesh=mesh,
        in_specs=(P("block"), P("block"), P("block")),
        out_specs=P("ctx"), check_vma=False,
    )
    return jax.jit(fn)(syms, valid, aux["pos"])


def align_blocks_sharded(mesh: Mesh, cfg, keys, offsets, positions, packed,
                         l1, ref_len, codes, dege, lengths):
    """Data-parallel alignment over the mesh: the index arrays are
    replicated across devices (the reference's POSIX-shm index sharing,
    SURVEY.md §2.3, mapped to the devices); read batches shard over the
    'block' axis.  codes/dege: (B, R, Lp) grids, lengths: (B, R)."""
    from fastqueeze_tpu.align import hash as H

    def local(ks, off, pos, pk, l1_, c, d, ln):
        def one(cb, db, lb):
            return H._align_batch(cfg, ks, off, pos, pk, l1_,
                                  jnp.int32(ref_len), cb, db, lb)
        return jax.vmap(one)(c, d, ln)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(),
                  P("block"), P("block"), P("block")),
        out_specs=(P("block"), P("block"), P("block"), P("block")),
        check_vma=False,
    )
    return jax.jit(fn)(keys, offsets, positions, packed, l1,
                       codes, dege, lengths)


def shard_ref_index(idx, n_shards: int) -> Dict[str, np.ndarray]:
    """Partition a RefIndex CSR into equal-key-count range shards.

    For references past one device's int32 coordinates (>2 Gbp; the
    positions array alone is 8+ GB) the CSR is split by key range; shard
    arrays are padded to a common length with an impossible sentinel key
    (u32 max exceeds any valid k-mer / hi-lo pair component) so the
    in-kernel binary search needs no per-shard length.  The 2-bit packed
    reference stays replicated (2 Gbp = 0.5 GB packed).  Positions are
    stored u32 (refs up to 4 G positions)."""
    if idx.ref_len >= (1 << 32):
        # per-shard coords are u32 (plenty for any real genome; human is
        # ~3.1 Gbp) — refuse clearly instead of silently truncating
        raise ValueError(
            f"reference has {idx.ref_len} positions; the sharded index "
            "carries u32 coordinates (supports references up to 4 Gbp)")
    keys = idx.keys.astype(np.uint64)
    nk = len(keys)
    bounds = [(i * nk) // n_shards for i in range(n_shards + 1)]
    kp = max((bounds[i + 1] - bounds[i] for i in range(n_shards)),
             default=1) or 1
    pp = max((int(idx.offsets[bounds[i + 1]] - idx.offsets[bounds[i]])
              for i in range(n_shards)), default=1) or 1
    keys_hi = np.full((n_shards, kp), 0xFFFFFFFF, np.uint32)
    keys_lo = np.full((n_shards, kp), 0xFFFFFFFF, np.uint32)
    offsets = np.zeros((n_shards, kp + 1), np.int32)
    positions = np.zeros((n_shards, pp), np.uint32)
    wide = idx.k > 15
    for s in range(n_shards):
        a, b = bounds[s], bounds[s + 1]
        n = b - a
        ks = keys[a:b]
        if wide:
            keys_hi[s, :n] = (ks >> np.uint64(30)).astype(np.uint32)
            keys_lo[s, :n] = (ks & np.uint64(0x3FFFFFFF)).astype(np.uint32)
        else:
            keys_hi[s, :n] = ks.astype(np.uint32)
        po, pb = int(idx.offsets[a]), int(idx.offsets[b])
        offsets[s, :n + 1] = idx.offsets[a:b + 1] - po
        offsets[s, n + 1:] = offsets[s, n]
        positions[s, :pb - po] = idx.positions[po:pb]
    return {"keys_hi": keys_hi, "keys_lo": keys_lo, "offsets": offsets,
            "positions": positions, "packed": idx.packed.astype(np.uint32),
            "ref_len": idx.ref_len, "k": idx.k, "kp": kp}


def index_sharded_aligner(mesh: Mesh, sh: Dict):
    """Alignment with the k-mer index sharded over the 'ctx' mesh axis and
    reads data-parallel over 'block' (SURVEY.md §2.3 north star: reference
    index sharded across the devices).

    Places the index shards of ``sh`` (shard_ref_index) on the mesh once
    and returns ``align(params, codes, dege, lengths, n_seeds=1,
    excl_bp=0, n_cand=None)``; per call only the reads move, and the
    program compiles once per (AlignConfig, grid shape).  codes/dege:
    (R, Lp) grids; R must divide by the block axis.  Lookups run as local
    binary searches combined with pmin/pmax over 'ctx'; every ctx shard
    then verifies its slice of the candidate list against the replicated
    packed reference (work scales down with shards)."""
    from fastqueeze_tpu.align import hash as H
    import math
    k, ref_len = sh["k"], int(sh["ref_len"])
    search_steps = max(1, math.ceil(math.log2(sh["kp"] + 1)))
    nb = mesh.shape["block"]
    ctx, rep = NamedSharding(mesh, P("ctx")), NamedSharding(mesh, P())
    dev = tuple(jax.device_put(sh[name], ctx) for name in (
        "keys_hi", "keys_lo", "offsets", "positions")) + (
        jax.device_put(sh["packed"], rep),)

    @functools.partial(jax.jit, static_argnums=0)
    def run(cfg, *args):
        def local(kh, kl, off, pos, pk, c, d, ln):
            return H._align_batch.__wrapped__(
                cfg, (kh[0], kl[0]), off[0], pos[0], pk,
                jnp.zeros(1, jnp.int32), jnp.uint32(ref_len), c, d, ln)

        return shard_map(
            local, mesh=mesh,
            in_specs=(P("ctx"), P("ctx"), P("ctx"), P("ctx"), P(),
                      P("block"), P("block"), P("block")),
            out_specs=(P("block"), P("block"), P("block"), P("block")),
            check_vma=False,
        )(*args)

    def align(params: CodecParams, codes: np.ndarray, dege: np.ndarray,
              lengths: np.ndarray, n_seeds: int = 1, excl_bp: int = 0,
              n_cand: Optional[int] = None):
        R, lp = codes.shape
        if R % nb:
            raise ValueError(f"R={R} not divisible by block axis {nb}")
        cfg = H.AlignConfig(
            k=k, stride=params.seed_stride,
            n_cand=n_cand or params.seed_max_occ, max_mis=params.max_mis,
            both_strands=params.both_strands, lp=lp, n_seeds=n_seeds,
            excl_bp=excl_bp, wide=k > 15, search_steps=search_steps,
            shard_axis="ctx")
        return run(cfg, *dev, jnp.asarray(codes), jnp.asarray(dege),
                   jnp.asarray(lengths.astype(np.int32)))

    return align


def decode_blocks_frozen_sharded(mesh: Mesh, model: CtxModel,
                                 counts0: jnp.ndarray, states: jnp.ndarray,
                                 words: jnp.ndarray, valid: jnp.ndarray,
                                 pos: jnp.ndarray):
    """Frozen-model wave decode with the quantized table sharded over the
    'ctx' mesh axis — the TP analogue for models too big to replicate
    (qlevel-3 quality tables: 2^20 contexts; high-order seq models).

    Each ctx shard holds ``n_ctx/D`` whole table rows.  Per wave, the lane
    contexts are computed replicated (the lane-state walk is identical on
    every shard); the shard that owns a lane's context row runs the
    cumulative-frequency search locally and non-owners contribute zeros, so
    one ``psum`` over 'ctx' per wave yields the global (sym, start, freq)
    packed as a single (3, L) vector — collective bytes per wave are tiny
    (~lanes * 12 B).  The rANS arithmetic then advances
    replicated.  Produces bit-identical symbols to the replicated
    ``engine._decode_frozen`` (tests/test_mesh.py asserts equality).

    states/words/valid/pos are (B, ...) stacked blocks sharded over
    'block'; counts0 is the full raw count table (quantized per-shard —
    quantization is row-local, so sharding commutes with it).

    The compiled fn is cached on (mesh devices, model, grid shapes) so
    production per-block calls (driver.decompress ctx-shard gate) pay one
    compile per shape bucket, not per block.
    """
    from fastqueeze_tpu.ops.engine import _quant_full
    key = (tuple(mesh.devices.reshape(-1)), model, states.shape,
           words.shape, valid.shape)
    fn = _SHARD_DECODE_CACHE.get(key)
    if fn is None:
        fn = _SHARD_DECODE_CACHE[key] = _build_frozen_sharded(
            mesh, model, words.shape[-1], valid.shape[-1])
    return fn(_quant_full(counts0), states, words, valid, pos)


_SHARD_DECODE_CACHE: Dict = {}


def _build_frozen_sharded(mesh: Mesh, model: CtxModel, nwords: int, L: int):
    from fastqueeze_tpu.ops.engine import _MASK_M, _freeze_invalid
    from fastqueeze_tpu.config import PROB_BITS, RANS_L, RANS_M
    import math
    A = model.alphabet
    D = mesh.shape["ctx"]
    if model.n_ctx % D:
        raise ValueError(f"n_ctx={model.n_ctx} not divisible by ctx={D}")
    n_ctx_local = model.n_ctx // D
    steps = max(1, math.ceil(math.log2(A)))

    def local(fq, st0, wds, vld, ps):
        ctx0 = jax.lax.axis_index("ctx") * n_ctx_local
        fq_flat = fq.reshape(-1).astype(jnp.int32)

        def one(x0, w, v, p):
            def body(carry, xs):
                st, x, off = carry
                vld_t, pos_t = xs
                aux_t = {"pos": pos_t, "start": pos_t == 0}
                ctx = model.context(st, aux_t).astype(jnp.int32)
                own = (ctx >= ctx0) & (ctx < ctx0 + n_ctx_local)
                base = jnp.where(own, ctx - ctx0, 0) * (A + 1)
                low = (x & _MASK_M).astype(jnp.int32)
                lo = jnp.zeros_like(low)
                hi = jnp.full_like(low, A - 1)
                flo = jnp.zeros_like(low)
                fhi = jnp.full_like(low, RANS_M)
                for _ in range(steps):
                    mid = (lo + hi + 1) >> 1
                    val = fq_flat[base + mid]
                    le = val <= low
                    lo = jnp.where(le, mid, lo)
                    hi = jnp.where(le, hi, mid - 1)
                    flo = jnp.where(le, val, flo)
                    fhi = jnp.where(le, fhi, val)
                res = jnp.where(own, jnp.stack([lo, flo, fhi - flo]), 0)
                res = jax.lax.psum(res, "ctx")
                sym, start, f = res[0], res[1], res[2]
                start = start.astype(jnp.uint32)
                f = f.astype(jnp.uint32)
                xn = f * (x >> PROB_BITS) + (x & _MASK_M) - start
                need = (xn < RANS_L) & vld_t
                rank = (jnp.cumsum(need.astype(jnp.int32))
                        - need.astype(jnp.int32))
                idx = jnp.minimum(off + rank, nwords - 1)
                xn = jnp.where(need, (xn << 16) | w[idx].astype(jnp.uint32),
                               xn)
                x = jnp.where(vld_t, xn, x)
                off = off + jnp.sum(need.astype(jnp.int32))
                st = _freeze_invalid(model.update(st, sym, aux_t), st, vld_t)
                return (st, x, off), sym.astype(jnp.uint8)

            (_, x, _), syms = jax.lax.scan(
                body, (model.lane_init(L), x0, jnp.int32(0)), (v, p))
            return syms, x

        return jax.vmap(one)(st0, wds, vld, ps)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P("ctx"), P("block"), P("block"), P("block"), P("block")),
        out_specs=(P("block"), P("block")), check_vma=False,
    )
    return jax.jit(fn)


def encode_blocks_sharded(mesh: Mesh, model: CtxModel, n_halve: int,
                          counts0: jnp.ndarray,
                          syms: jnp.ndarray, valid: jnp.ndarray,
                          pos: jnp.ndarray):
    """Data-parallel block coding: every device runs pass1+pass2 for its
    shard of blocks against a replicated (frozen or init) model table.
    Returns per-block (start,freq) words/emits/final-states, block-sharded.
    """

    def local(c0, s, v, p):
        def one(sb, vb, pb):
            ctx = model.context_grids(sb, {"pos": pb, "start": pb == 0})
            start, freq, _ = engine._pass1(model, n_halve, c0, ctx, sb, vb)
            words, emits, x_final = engine._pass2(start, freq, vb)
            return words, emits, x_final

        return jax.vmap(one)(s, v, p)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P("block"), P("block"), P("block")),
        out_specs=(P("block"), P("block"), P("block")), check_vma=False,
    )
    return jax.jit(fn)(counts0, syms, valid, pos)
