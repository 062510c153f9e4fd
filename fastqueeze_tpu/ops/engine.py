"""Wave-synchronized adaptive interleaved-rANS engine.

This is the accelerator-native replacement for the reference's serial per-symbol
adaptive range coder (SURVEY.md §2.1, srcfile:EncapFqzComp.cpp: the inlined
64-bit-low range coder in every encode_*/decode_* plus SIMPLE_MODEL<N>
frequency tables).  Design:

* ``L`` independent rANS lanes (32-bit state, 16-bit renormalization words)
  are coded in lockstep over symbol "waves": wave ``t`` codes symbol ``t`` of
  every lane's sequence.
* Model tables (per-context symbol counts) are **shared** across lanes and
  updated once per wave with a batched scatter-add, then deterministically
  rescaled (halved) when a row total exceeds the model cap.  Encode and
  decode replay the identical integer model walk, so the coder is adaptive
  without any serial dependency inside a wave.
* Counts are quantized to frequencies summing to exactly 2^14 by cumulative
  rounding ``F_i = floor(cum_i * M / C)`` — deterministic, guarantees
  ``f_s >= 1`` for every count >= 1 because row totals are capped at
  ``cap <= M``.  Decode then needs only shifts/masks (no division).
* Each lane emits at most one 16-bit word per symbol (single-renorm regime:
  ``L=2^16`` state floor, 16-bit words, 14-bit frequencies).  Words from all
  lanes go to one shared stream in canonical (wave, lane) order, so the only
  per-lane metadata is the 4-byte final state.

Encode is two passes: pass 1 walks the adaptive models forward recording
(start, freq) per symbol; pass 2 runs the pure rANS arithmetic in reverse
(rANS is LIFO).  Decode is a single forward pass.  All passes are
``lax.scan`` over waves, vectorized over lanes — static
shapes, fully inside jit.
"""

from __future__ import annotations

import functools
import math
import struct
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from fastqueeze_tpu.config import PROB_BITS, RANS_L, RANS_M, CodecParams
from fastqueeze_tpu.models.base import CtxModel
from fastqueeze_tpu.ops.lanes import aux_grids, from_grid, make_layout, to_grid

_U32 = jnp.uint32
# wave scans unroll 4 steps per loop iteration (fewer loop trips per
# stream); higher unrolls blow up compile time.  Not tuned on this
# hardware yet.
_UNROLL = 4
_MASK_M = RANS_M - 1


def init_counts(model: CtxModel) -> jnp.ndarray:
    return jnp.full((model.n_ctx, model.alphabet), model.init, jnp.int32)


@jax.jit
def _widen_i32(x):
    return x.astype(jnp.int32)


def counts0_dev(counts0):
    """Frozen tables travel in u8/u16 (a quarter/half of the h2d bytes);
    widen on device."""
    if counts0 is None:
        return None
    c = jnp.asarray(counts0)
    return c if c.dtype == jnp.int32 else _widen_i32(c)


def _n_halve(model: CtxModel, L: int) -> int:
    """Static unroll count: halvings needed to bring any post-wave row total
    (<= cap + inc*L + alphabet rounding) back under cap."""
    worst = model.cap + model.inc * L + model.alphabet
    return max(1, math.ceil(math.log2(worst / model.cap)) + 1)


def _quant(rows: jnp.ndarray) -> jnp.ndarray:
    """(L, A) int32 count rows -> (L, A+1) cumulative freqs summing to M.

    floor(cumz * M / C) via two 7-bit long-division digits: the direct
    int32 product overflows once a row total reaches 2^17 (reachable at
    the validated parameter extremes, e.g. qual_init 2^14 x alphabet 8),
    silently corrupting the device tables while the host mirrors compute
    in int64.  cumz <= C <= 2^22 (init <= 2^14, alphabet <= 256) keeps
    every intermediate below 2^30; jnp int64 is unavailable (x64 off)."""
    cum = jnp.cumsum(rows, axis=1)
    C = cum[:, -1:]
    cumz = jnp.concatenate([jnp.zeros_like(C), cum], axis=1)
    h = PROB_BITS // 2                       # 7
    t1 = cumz << h
    q1 = t1 // C
    r1 = t1 - q1 * C
    return (q1 << (PROB_BITS - h)) + ((r1 << (PROB_BITS - h)) // C)


def _wave_update(counts, ctx, sym, valid, model: CtxModel, n_halve: int):
    """Batched adaptive update: scatter-add increments, rescale over-cap rows.

    Duplicate contexts within a wave accumulate additively (integer adds
    commute); the halving pass re-gathers post-add rows so duplicate
    writers store the identical value.  A scatter with duplicate indices
    writes in no fixed order (on a GPU in particular), which is harmless
    only because of that — deterministic on both encode and decode.
    """
    inc = jnp.where(valid, model.inc, 0).astype(jnp.int32)
    counts = counts.at[ctx, sym].add(inc)
    rows = counts[ctx]
    for _ in range(n_halve):
        tot = rows.sum(axis=1, keepdims=True)
        rows = jnp.where(tot > model.cap, (rows + 1) >> 1, rows)
    return counts.at[ctx].set(rows)


def _freeze_invalid(new_state, old_state, valid):
    return jax.tree_util.tree_map(
        lambda n, o: jnp.where(valid, n, o), new_state, old_state)


# ---------------------------------------------------------------------------
# Pass 1: forward model walk -> (start, freq) per symbol
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("model", "n_halve"))
def _pass1(model: CtxModel, n_halve: int, counts0, ctx_grid, syms, valid):
    """Forward model walk over precomputed contexts.

    ctx_grid/syms/valid: (T, L) grids — contexts are pure functions of
    previous symbols (model.context_grids), so only the adaptive count
    tables walk through the scan.  Returns (start, freq) u16 grids and the
    final counts table."""

    def body(counts, xs):
        ctx, sym, vld = xs
        sym = sym.astype(jnp.int32)
        ctx = ctx.astype(jnp.int32)
        F = _quant(counts[ctx])
        start = jnp.take_along_axis(F, sym[:, None], axis=1)[:, 0]
        end = jnp.take_along_axis(F, sym[:, None] + 1, axis=1)[:, 0]
        counts = _wave_update(counts, ctx, sym, vld, model, n_halve)
        return counts, (start.astype(jnp.uint16),
                        (end - start).astype(jnp.uint16))

    counts, (start, freq) = lax.scan(
        body, counts0, (ctx_grid, syms, valid), unroll=_UNROLL)
    return start, freq, counts


@functools.partial(jax.jit, static_argnames=("model",))
def _ctx_grids(model: CtxModel, syms, aux):
    return model.context_grids(syms, aux)


def _pack2_host(grid: np.ndarray) -> np.ndarray:
    """(T, L) 2-bit symbols -> (T, L//4) packed bytes (a quarter of the
    h2d transfer)."""
    from fastqueeze_tpu.io import native
    out = native.pack_grid(grid, 2)
    if out is not None:
        return out
    T, L = grid.shape
    g = grid.reshape(T, L // 4, 4).astype(np.uint8)
    return (g[:, :, 0] | (g[:, :, 1] << 2) | (g[:, :, 2] << 4)
            | (g[:, :, 3] << 6))


@jax.jit
def _unpack2_dev(packed):
    T, Lq = packed.shape
    parts = jnp.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)], axis=2)
    return parts.reshape(T, Lq * 4)


@jax.jit
def _pack2_dev(grid):
    T, L = grid.shape
    g = grid.reshape(T, L // 4, 4).astype(jnp.uint8)
    return (g[:, :, 0] | (g[:, :, 1] << 2) | (g[:, :, 2] << 4)
            | (g[:, :, 3] << 6))


def _unpack2_host(packed: np.ndarray) -> np.ndarray:
    from fastqueeze_tpu.io import native
    out = native.unpack_grid(packed, 2)
    if out is not None:
        return out
    T, Lq = packed.shape
    parts = np.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)], axis=2)
    return parts.reshape(T, Lq * 4)


def _pack4_host(grid: np.ndarray) -> np.ndarray:
    """(T, L) 4-bit symbols -> (T, L//2) bytes (binned-qual rank streams:
    dense rank coding keeps the alphabet <= 16 for modern data)."""
    T, L = grid.shape
    g = grid.reshape(T, L // 2, 2)
    return g[:, :, 0] | (g[:, :, 1] << 4)


def _unpack4_host(packed: np.ndarray) -> np.ndarray:
    T, Lh = packed.shape
    parts = np.stack([packed & 15, packed >> 4], axis=2)
    return parts.reshape(T, Lh * 2)


@jax.jit
def _unpack4_dev(packed):
    T, Lh = packed.shape
    parts = jnp.stack([packed & 15, packed >> 4], axis=2)
    return parts.reshape(T, Lh * 2)


@jax.jit
def _pack4_dev(grid):
    T, L = grid.shape
    g = grid.reshape(T, L // 2, 2).astype(jnp.uint8)
    return g[:, :, 0] | (g[:, :, 1] << 4)


# --- mode 15: 4-bit nibbles + exception sidecar (encode h2d only) ---
# Dense-rank qual streams are heavily skewed: on typical data the 15
# most frequent ranks carry >= 95% of the symbols, so shipping nibbles
# (nibble k = k-th most frequent symbol of this grid, sentinel 15 = "in
# the sidecar") cuts the qual h2d volume ~28% vs the flat 6-bit pack.
# Whether that pays over PCIe is not measured yet (ROADMAP C3).  The
# sidecar array is [perm(16B) | exceptions]: a
# per-grid frequency permutation (ranks are VALUE-sorted, so the
# frequent symbols are not the low ranks) followed by the raw values of
# every symbol outside the top 15, in grid scan order.  This is purely a
# transfer-layer representation: the unpacked grid (and the archive
# bitstream) is bit-identical to the 6-bit path, and decode d2h is
# untouched (a device-side exception count would cost an extra host
# sync).
_EXC_SYM = 15
# Enable flag for the sentinel packs (tests / the A/B harness set it
# <= 0 to force the flat packs).  Selection itself compares exact byte
# counts in _pack_for_upload, including sidecar padding.
_EXC_FRAC_MAX = 1.0
_EXC_NONE = np.zeros(1, np.uint8)


def _exc_bucket(n: int) -> int:
    """Pad the sidecar to coarse pow-4 buckets: its shape is an input
    of the fused scan kernels, so every distinct size is a full kernel
    recompile — pow-4 keeps the variant
    count tiny.  _pack_for_upload charges this padding when deciding
    whether the sentinel pack is worth it."""
    cap = 1024
    while cap < n:
        cap <<= 2
    return cap


def _pack_sent_host(grid: np.ndarray, top: np.ndarray, sent: int, packer):
    """top: the (< sent) grid symbols mapped to codes 0..sent-1, most
    frequent first; code `sent` = "value is in the sidecar".  Returns
    (packed codes, [perm(16B) | exceptions])."""
    flat = grid.reshape(-1)
    lut = np.full(64, sent, np.uint8)
    lut[top] = np.arange(len(top), dtype=np.uint8)
    nib = lut[flat]
    exc = flat[nib == sent]
    side = np.zeros(16 + _exc_bucket(len(exc)), np.uint8)
    side[:len(top)] = top
    side[16:16 + len(exc)] = exc
    return packer(nib.reshape(grid.shape)), side


def _unpack_sent_dev(flat, side, sent):
    mask = flat == sent
    idx = jnp.cumsum(mask.astype(jnp.int32)) - 1
    vals = side[16 + jnp.clip(idx, 0, side.shape[0] - 17)]
    top = side[jnp.minimum(flat, sent)]   # perm gather (16-entry)
    return jnp.where(mask, vals, top)


@jax.jit
def _unpack15_dev(packed, side):
    nib = _unpack4_dev(packed)
    return _unpack_sent_dev(nib.reshape(-1), side, _EXC_SYM).reshape(
        nib.shape)


@jax.jit
def _unpack23_dev(packed, side):
    cr = _unpack2_dev(packed)
    return _unpack_sent_dev(cr.reshape(-1).astype(jnp.uint8), side,
                            3).reshape(cr.shape)


def _pack6_host(grid: np.ndarray) -> np.ndarray:
    """(T, L) 6-bit symbols -> (T, 3L/4) bytes (4 syms per 24 bits)."""
    from fastqueeze_tpu.io import native
    out = native.pack_grid(grid, 6)
    if out is not None:
        return out
    T, L = grid.shape
    g = grid.reshape(T, L // 4, 4).astype(np.uint32)
    v = g[:, :, 0] | (g[:, :, 1] << 6) | (g[:, :, 2] << 12) | (g[:, :, 3] << 18)
    out = np.empty((T, L // 4, 3), np.uint8)
    out[:, :, 0] = v & 0xFF
    out[:, :, 1] = (v >> 8) & 0xFF
    out[:, :, 2] = (v >> 16) & 0xFF
    return out.reshape(T, (L // 4) * 3)


@jax.jit
def _unpack6_dev(packed):
    T, L3 = packed.shape
    q = L3 // 3
    p3 = packed.reshape(T, q, 3).astype(jnp.uint32)
    v = p3[:, :, 0] | (p3[:, :, 1] << 8) | (p3[:, :, 2] << 16)
    parts = jnp.stack([(v >> s) & 63 for s in (0, 6, 12, 18)], axis=2)
    return parts.reshape(T, q * 4).astype(jnp.uint8)


@jax.jit
def _pack6_dev(grid):
    T, L = grid.shape
    g = grid.reshape(T, L // 4, 4).astype(jnp.uint32)
    v = g[:, :, 0] | (g[:, :, 1] << 6) | (g[:, :, 2] << 12) | (g[:, :, 3] << 18)
    out = jnp.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF],
                    axis=2).astype(jnp.uint8)
    return out.reshape(T, (L // 4) * 3)


def _unpack6_host(packed: np.ndarray) -> np.ndarray:
    from fastqueeze_tpu.io import native
    out = native.unpack_grid(packed, 6)
    if out is not None:
        return out
    T, L3 = packed.shape
    q = L3 // 3
    p3 = packed.reshape(T, q, 3).astype(np.uint32)
    v = p3[:, :, 0] | (p3[:, :, 1] << 8) | (p3[:, :, 2] << 16)
    parts = np.stack([(v >> s) & 63 for s in (0, 6, 12, 18)], axis=2)
    return parts.reshape(T, q * 4).astype(np.uint8)


def _pack_mode(model: CtxModel, L: int) -> int:
    """0 = none, 2 = 2-bit, 6 = 6-bit transfer packing."""
    if L % 4:
        return 0
    if model.alphabet <= 4:
        return 2
    if model.alphabet <= 16:
        return 4
    if model.alphabet <= 64:
        return 6
    return 0


def _pack_host(grid: np.ndarray, mode: int) -> np.ndarray:
    if mode == 2:
        return _pack2_host(grid)
    if mode == 4:
        return _pack4_host(grid)
    if mode == 6:
        return _pack6_host(grid)
    return grid


def _unpack_dev(grid, mode: int, exc=None):
    if mode == 2:
        return _unpack2_dev(grid)
    if mode == 4:
        return _unpack4_dev(grid)
    if mode == 6:
        return _unpack6_dev(grid)
    if mode == 15:
        return _unpack15_dev(grid, exc)
    if mode == 23:
        return _unpack23_dev(grid, exc)
    return grid


def _pack_for_upload(grid: np.ndarray, pmode: int):
    """Encode-side h2d pack: upgrade 4/6-bit grids to a sentinel-coded
    variant (mode 23 = 2-bit + sidecar, mode 15 = 4-bit + sidecar) when
    that ships fewer actual bytes — exact counts including the 16-byte
    perm and the sidecar's pow-4 bucket padding, so a small grid or a
    count just past a bucket edge can never pick a LARGER transfer.
    Returns (effective pmode, packed grid, sidecar array)."""
    if pmode in (4, 6) and _EXC_FRAC_MAX > 0 and grid.size:
        cnt = np.bincount(grid.reshape(-1), minlength=64)[:64]
        order = np.argsort(-cnt, kind="stable")
        csum = np.cumsum(cnt[order])
        base_b = grid.size * (3 if pmode == 6 else 2) // 4   # flat bytes
        n23 = int(grid.size - csum[2])
        b23 = grid.size // 4 + 16 + _exc_bucket(n23)
        if pmode == 6:
            n15 = int(grid.size - csum[14])
            b15 = grid.size // 2 + 16 + _exc_bucket(n15)
        else:
            b15 = base_b
        if min(b23, b15) < base_b:
            sent, nb = (3, 2) if b23 <= b15 else (_EXC_SYM, 4)
            top = order[:sent]
            top = top[cnt[top] > 0].astype(np.uint8)
            packed, side = _pack_sent_host(
                grid, top, sent, _pack2_host if nb == 2 else _pack4_host)
            return (23 if nb == 2 else 15), packed, side
    return pmode, _pack_host(grid, pmode), _EXC_NONE


def _pack_dev(grid, mode: int):
    if mode == 2:
        return _pack2_dev(grid)
    if mode == 4:
        return _pack4_dev(grid)
    if mode == 6:
        return _pack6_dev(grid)
    return grid


def _unpack_host(grid: np.ndarray, mode: int) -> np.ndarray:
    if mode == 2:
        return _unpack2_host(grid)
    if mode == 4:
        return _unpack4_host(grid)
    if mode == 6:
        return _unpack6_host(grid)
    return grid


@functools.partial(jax.jit, static_argnames=("T",))
def _device_aux(T: int, counts_grid):
    """Compute valid / pos / start grids on device from the (J, L) per-slot
    read-length grid (slot (j, l) = read j*L + l, the round-robin layout of
    lanes.make_layout).  Replaces ~4 MB/stream of host-built grids with a
    tiny int32 upload."""
    J, L = counts_grid.shape
    c = counts_grid.astype(jnp.int32)
    lane_len = c.sum(axis=0)
    t_idx = jnp.arange(T, dtype=jnp.int32)[:, None]
    valid = t_idx < lane_len[None, :]
    # read start offsets within the lane: exclusive cumsum down the slots
    s = jnp.cumsum(c, axis=0) - c                       # (J, L)
    lanes = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :], (J, L))
    # scatter each read's start wave into its lane's timeline, then cummax
    # gives "start wave of the read covering t" at every wave t
    marks = jnp.zeros((T, L), jnp.int32)
    # zero-count slots (grid padding / empty reads) and starts beyond the
    # grid must not scatter: route them out of range and drop, matching the
    # host mirror (lanes.aux_grids masks counts > 0).  Clipping instead
    # would land value T on row T-1 and corrupt pos/start at the last wave.
    tgt = jnp.where(c > 0, s, T)
    marks = marks.at[tgt.reshape(-1), lanes.reshape(-1)].max(
        s.reshape(-1), mode="drop")
    run_start = lax.cummax(marks, axis=0)
    # pos must be EXACT (int32): the qual drops baseline (start_t = t_idx -
    # pos in QualModel.context_grids) and the seq ctx-start gating both
    # consume it, and a uint16 wrap at 65536 breaks encode/decode agreement
    # for reads longer than 64k bases (ONT/PacBio)
    pos = t_idx - run_start
    start = (t_idx == run_start)
    return valid, {"start": start & valid, "pos": jnp.where(valid, pos, 0)}


@jax.jit
def _compact_words(words, emits):
    """Device-side stream compaction: scatter emitted 16-bit words into a
    dense prefix (canonical (wave, lane) order).  Host then transfers only
    n_words * 2 bytes instead of the full (T, L) grid + mask."""
    flat_w = words.reshape(-1)
    flat_e = emits.reshape(-1)
    n = flat_w.shape[0]
    idx = jnp.cumsum(flat_e.astype(jnp.int32)) - 1
    tgt = jnp.where(flat_e, idx, n)          # out-of-bounds -> dropped
    out = jnp.zeros((n,), jnp.uint16).at[tgt].set(flat_w, mode="drop")
    return out, flat_e.sum().astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("model",))
def _train_counts(model: CtxModel, syms, valid, aux):
    """Frozen-model training: one-shot histogram of (context, symbol)
    occurrences (batched over every symbol at once — no wave scan), then a
    deterministic cap rescale.  Replaces the reference's serial
    encode_*_formodel pass (SURVEY.md §3.4) with a pure bincount."""
    ctx = model.context_grids(syms, aux)
    flat = ctx.astype(jnp.int32) * model.alphabet + syms.astype(jnp.int32)
    n = model.n_ctx * model.alphabet
    flat = jnp.where(valid, flat, n).reshape(-1)  # invalid -> spill slot
    hist = jnp.zeros((n + 1,), jnp.int32)
    hist = hist.at[flat].add(model.inc)
    counts = hist[:n].reshape(model.n_ctx, model.alphabet) + model.init
    # deterministic rescale: halve rows (rounding up, keeping >=1) until
    # total <= cap; 24 halvings cover any prefix up to cap * 2^24 symbols
    for _ in range(24):
        tot = counts.sum(axis=1, keepdims=True)
        counts = jnp.where(tot > model.cap, (counts + 1) >> 1, counts)
    return counts


@jax.jit
def _quant_full(counts0):
    """(n_ctx, A) -> (n_ctx, A+1) cumulative freq table summing to M."""
    return _quant(counts0)


# ---------------------------------------------------------------------------
# Chunked semi-adaptive walk: the table is requantized every `chunk` waves;
# inside a chunk (start, freq) is a single packed gather from the snapshot
# (frozen-path cost) while raw counts keep accumulating.  The rescale runs
# vectorized over the whole table at each boundary.  Encode and decode
# replay the identical schedule, so the walk stays bit-exact symmetric.
# ---------------------------------------------------------------------------


def _n_halve_chunk(model: CtxModel, L: int, chunk: int) -> int:
    worst = model.cap + model.inc * L * chunk + model.alphabet
    return max(1, math.ceil(math.log2(worst / model.cap)) + 1)


def _snapshot_sf(counts):
    """(n_ctx, A) counts -> flat packed (start | freq << 16) u32 table."""
    F = _quant(counts)
    return (F[:, :-1] + ((F[:, 1:] - F[:, :-1]) << 16)).astype(
        _U32).reshape(-1)


def _rescale_full(counts, cap: int, n_halve: int):
    for _ in range(n_halve):
        tot = counts.sum(axis=1, keepdims=True)
        counts = jnp.where(tot > cap, (counts + 1) >> 1, counts)
    return counts


@functools.partial(jax.jit, static_argnames=("model", "n_halve", "chunk"))
def _pass1_semi(model: CtxModel, n_halve: int, chunk: int,
                counts0, ctx_grid, syms, valid):
    T, L = syms.shape
    A = model.alphabet
    n_out = T // chunk

    def outer(counts, xs):
        SF = _snapshot_sf(counts)

        def inner(counts, xs2):
            ctx, sym, vld = xs2
            ctx = ctx.astype(jnp.int32)
            sym = sym.astype(jnp.int32)
            sf = SF[ctx * A + sym]
            inc = jnp.where(vld, model.inc, 0).astype(jnp.int32)
            counts = counts.at[ctx, sym].add(inc)
            return counts, ((sf & 0xFFFF).astype(jnp.uint16),
                            (sf >> 16).astype(jnp.uint16))

        counts, (s_c, f_c) = lax.scan(inner, counts, xs, unroll=_UNROLL)
        return _rescale_full(counts, model.cap, n_halve), (s_c, f_c)

    shape = (n_out, chunk, L)
    counts, (start, freq) = lax.scan(
        outer, counts0,
        (ctx_grid.reshape(shape), syms.reshape(shape), valid.reshape(shape)))
    return (start.reshape(T, L), freq.reshape(T, L), counts)


@functools.partial(jax.jit, static_argnames=("model", "n_halve", "chunk"))
def _decode_semi(model: CtxModel, n_halve: int, chunk: int, counts0,
                 lane_state0, states, words, valid, aux):
    """Mirror of _pass1_semi: binary-search symbol resolution against the
    chunk snapshot (same gather budget as the frozen decoder) + the same
    accumulate/rescale schedule."""
    A = model.alphabet
    steps = max(1, math.ceil(math.log2(A)))
    nwords = words.shape[0]
    T = valid.shape[0]
    n_out = T // chunk

    def outer(carry, xs):
        counts, st, x, off = carry
        # the packed snapshot's low halves ARE the cumulative starts
        # (F[s] = start of s, F[0] = 0), so the binary search runs on SF
        SF = _snapshot_sf(counts)

        def inner(carry2, xs2):
            counts, st, x, off = carry2
            vld, aux_t = xs2
            ctx = model.context(st, aux_t)
            base = ctx.astype(jnp.int32) * A
            low = (x & _MASK_M).astype(jnp.int32)
            lo = jnp.zeros_like(low)
            hi = jnp.full_like(low, A - 1)
            for _ in range(steps):
                mid = (lo + hi + 1) >> 1
                le = (SF[base + mid] & 0xFFFF).astype(jnp.int32) <= low
                lo = jnp.where(le, mid, lo)
                hi = jnp.where(le, hi, mid - 1)
            sym = lo
            sf = SF[base + sym]
            start = sf & 0xFFFF
            f = sf >> 16
            xn = f * (x >> PROB_BITS) + (x & _MASK_M) - start
            need = (xn < RANS_L) & vld
            rank = jnp.cumsum(need.astype(jnp.int32)) - need.astype(jnp.int32)
            idx = jnp.minimum(off + rank, nwords - 1)
            w = words[idx].astype(_U32)
            xn = jnp.where(need, (xn << 16) | w, xn)
            x = jnp.where(vld, xn, x)
            off = off + jnp.sum(need.astype(jnp.int32))
            inc = jnp.where(vld, model.inc, 0).astype(jnp.int32)
            counts = counts.at[ctx, sym].add(inc)
            st = _freeze_invalid(model.update(st, sym, aux_t), st, vld)
            return (counts, st, x, off), sym.astype(jnp.uint8)

        (counts, st, x, off), syms = lax.scan(inner, carry, xs, unroll=_UNROLL)
        return (_rescale_full(counts, model.cap, n_halve), st, x, off), syms

    aux_r = jax.tree_util.tree_map(
        lambda a: a.reshape((n_out, chunk) + a.shape[1:]), aux)
    (counts, _, x, _), syms = lax.scan(
        outer, (counts0, lane_state0, states, jnp.int32(0)),
        (valid.reshape(n_out, chunk, -1), aux_r))
    return syms.reshape(T, -1), counts, x


@functools.partial(jax.jit, static_argnames=("alphabet",))
def _pass1_frozen(alphabet: int, counts0, ctx_grid, syms):
    """Frozen-model encode walk: no adaptation, so (start, freq) is a pure
    gather from the prequantized table — no wave scan at all.  This is the
    reference's usemodel semantics (SURVEY.md §2.1): blocks are coded
    against the trained snapshot.  Rows are relaid as (F[s] | F[s+1]<<16)
    words so each symbol costs ONE gather, not two adjacent ones."""
    Fq = _quant_full(counts0)
    P = (Fq[:, :-1].astype(_U32)
         | (Fq[:, 1:].astype(_U32) << 16)).reshape(-1)
    v = P[ctx_grid.astype(jnp.int32) * alphabet + syms.astype(jnp.int32)]
    start = v & 0xFFFF
    end = v >> 16
    return start.astype(jnp.uint16), (end - start).astype(jnp.uint16)


@functools.partial(jax.jit, static_argnames=("model",))
def _decode_frozen(model: CtxModel, counts0, lane_state0,
                   states, words, valid, aux):
    """Frozen-model decode: the scan walks only the lane context state and
    the rANS arithmetic; the model table is static (prequantized).

    Symbol resolution is a fixed-step search over the row's cumulative
    frequencies — the scan is gather-bound, so the variant with the
    fewest fetches per symbol wins.  Preferred: ternary descent over an
    implicit complete 3-ary tree whose node words each pack the TWO
    tercile-boundary cumfreqs of that node's (static) symbol range —
    one u32 gather yields a 3-way branch, so ceil(log3 A) fetches vs
    the pair search's ceil(log2(A/2+1)): 5->4 at A=40, 3->2 at A=8,
    6->5 at A=96.  The tree is a decoder-internal relayout of the same
    quantized table; the bitstream is untouched."""
    A = model.alphabet
    Fq = _quant_full(counts0)
    steps = max(1, math.ceil(math.log2(A)))
    H = A // 2
    pair_steps = math.ceil(math.log2(H + 1)) if H else steps
    # pair-packed search: each gather fetches (F[2k+1] | F[2k+2] << 16),
    # so the search runs over H+1 pair slots instead of A symbols — one
    # fewer gather whenever A is not a power of two (the qual alphabets
    # are multiples of 8: 40/48/56/88/96 all win a step)
    use_pairs = (A % 2 == 0) and pair_steps < steps
    tern_d = 1
    while 3 ** tern_d < A:
        tern_d += 1
    use_tern = tern_d < (pair_steps if use_pairs else steps)
    if use_tern:
        # heap-numbered complete ternary tree over the padded leaf space
        # [0, 3^d): node j at level k covers [j*w, (j+1)*w), w=3^(d-k);
        # its word holds (F[lo+w/3], F[lo+2w/3]) with indices clamped to
        # A (F[A] = M, so padded terciles can never win a comparison)
        a_idx, b_idx = [], []
        for k in range(tern_d):
            w = 3 ** (tern_d - k)
            for j in range(3 ** k):
                lo0 = j * w
                a_idx.append(min(lo0 + w // 3, A))
                b_idx.append(min(lo0 + 2 * (w // 3), A))
        n_nodes = len(a_idx)          # (3^d - 1) / 2
        T_flat = (Fq[:, np.array(a_idx)].astype(_U32)
                  | (Fq[:, np.array(b_idx)].astype(_U32) << 16)
                  ).reshape(-1)
    elif use_pairs:
        P_flat = (Fq[:, 1::2].astype(_U32)
                  | (Fq[:, 2::2].astype(_U32) << 16)).reshape(-1)
    else:
        Fq_flat = Fq.astype(jnp.int32).reshape(-1)
    nwords = words.shape[0]

    def body(carry, xs):
        st, x, off = carry
        vld, aux_t = xs
        ctx = model.context(st, aux_t)
        low = (x & _MASK_M).astype(jnp.int32)
        # sym = largest s in [0, A-1] with F[s] <= low (F[0] = 0 <= low
        # always holds).  All variants carry the cumfreq values at their
        # bounds so start/freq need no post-search gather — the scan is
        # gather-bound, every fetch per symbol matters.
        if use_tern:
            base = ctx.astype(jnp.int32) * n_nodes
            t = jnp.zeros_like(low)
            sym0 = jnp.zeros_like(low)
            flo = jnp.zeros_like(low)
            fhi = jnp.full_like(low, RANS_M)   # F[A] == RANS_M by _quant
            for k in range(tern_d):
                w3 = 3 ** (tern_d - k) // 3
                v = T_flat[base + t]
                va = (v & 0xFFFF).astype(jnp.int32)
                vb = (v >> 16).astype(jnp.int32)
                right = low >= vb              # answer in [b, hi)
                midb = (~right) & (low >= va)  # answer in [a, b)
                sym0 = sym0 + jnp.where(right, 2 * w3,
                                        jnp.where(midb, w3, 0))
                flo = jnp.where(right, vb, jnp.where(midb, va, flo))
                fhi = jnp.where(right, fhi, jnp.where(midb, vb, va))
                t = 3 * t + 1 + jnp.where(right, 2,
                                          jnp.where(midb, 1, 0))
            sym = jnp.clip(sym0, 0, A - 1)
            start = flo.astype(_U32)
            f = (fhi - flo).astype(_U32)
        elif use_pairs:
            # search pair index k in [-1, H-1] for the largest with
            # F[2k+1] <= low; the winning fetch holds F[2k+1], F[2k+2]
            # and the failing bound carries fhi = F[2(hi+1)+1]
            base = ctx.astype(jnp.int32) * H
            lo = jnp.full_like(low, -1)
            hi = jnp.full_like(low, H - 1)
            plo = jnp.zeros_like(low).astype(_U32)
            fhi = jnp.full_like(low, RANS_M)   # F[A] == RANS_M by _quant
            for _ in range(pair_steps):
                # clamp: once lo == hi == -1 the midpoint would go
                # negative and clobber the carried bounds; mid = 0 there
                # re-fetches F[1] > low, a no-op update
                mid = jnp.maximum((lo + hi + 1) >> 1, 0)
                v = P_flat[base + mid]
                vlow = (v & 0xFFFF).astype(jnp.int32)
                le = vlow <= low
                lo = jnp.where(le, mid, lo)
                hi = jnp.where(le, hi, mid - 1)
                plo = jnp.where(le, v, plo)
                fhi = jnp.where(le, fhi, vlow)
            f1 = (plo & 0xFFFF).astype(jnp.int32)
            f2 = (plo >> 16).astype(jnp.int32)
            take2 = low >= f2          # lo == -1 lands here (f2 == 0)
            sym = jnp.clip(jnp.where(take2, 2 * lo + 2, 2 * lo + 1),
                           0, A - 1)
            start = jnp.where(take2, f2, f1).astype(_U32)
            f = jnp.where(take2, fhi - f2, f2 - f1).astype(_U32)
        else:
            base = ctx.astype(jnp.int32) * (A + 1)
            lo = jnp.zeros_like(low)
            hi = jnp.full_like(low, A - 1)
            flo = jnp.zeros_like(low)
            fhi = jnp.full_like(low, RANS_M)   # F[A] == RANS_M by _quant
            for _ in range(steps):
                mid = (lo + hi + 1) >> 1
                v = Fq_flat[base + mid]
                le = v <= low
                lo = jnp.where(le, mid, lo)
                hi = jnp.where(le, hi, mid - 1)
                flo = jnp.where(le, v, flo)
                fhi = jnp.where(le, fhi, v)
            sym = lo
            start = flo.astype(_U32)
            f = (fhi - flo).astype(_U32)
        xn = f * (x >> PROB_BITS) + (x & _MASK_M) - start
        need = (xn < RANS_L) & vld
        rank = jnp.cumsum(need.astype(jnp.int32)) - need.astype(jnp.int32)
        idx = jnp.minimum(off + rank, nwords - 1)
        w = words[idx].astype(_U32)
        xn = jnp.where(need, (xn << 16) | w, xn)
        x = jnp.where(vld, xn, x)
        off = off + jnp.sum(need.astype(jnp.int32))
        st = _freeze_invalid(model.update(st, sym, aux_t), st, vld)
        return (st, x, off), sym.astype(jnp.uint8)

    (_, x, _), syms = lax.scan(
        body, (lane_state0, states, jnp.int32(0)), (valid, aux),
        unroll=_UNROLL)
    return syms, x


# ---------------------------------------------------------------------------
# Pass 2: reverse rANS arithmetic (pure, model-free)
# ---------------------------------------------------------------------------

@jax.jit
def _pass2(start, freq, valid):
    """(T, L) u16 grids -> (T, L) u16 word grid + emit mask + final states."""
    L = start.shape[1]
    x0 = jnp.full((L,), RANS_L, _U32)

    def body(x, xs):
        s, f, vld = xs
        s = s.astype(_U32)
        f = f.astype(_U32)
        # renormalize: emit one 16-bit word when x >= f << 18 (computed
        # overflow-free as (x >> 18) >= f)
        emit = ((x >> 18) >= f) & vld
        word = (x & 0xFFFF).astype(jnp.uint16)
        x = jnp.where(emit, x >> 16, x)
        f_safe = jnp.maximum(f, 1)
        q = x // f_safe
        xn = (q << PROB_BITS) + (x - q * f_safe) + s
        return jnp.where(vld, xn, x), (word, emit)

    x_final, (words, emits) = lax.scan(body, x0, (start, freq, valid),
                                       reverse=True, unroll=_UNROLL)
    return words, emits, x_final


# ---------------------------------------------------------------------------
# Decode: single forward pass
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("model", "n_halve"))
def _decode(model: CtxModel, n_halve: int, counts0, lane_state0,
            states, words, valid, aux):
    """words: (W,) u16 padded stream; states: (L,) u32 initial decoder states.
    Returns (T, L) symbol grid and final counts."""
    nwords = words.shape[0]

    def body(carry, xs):
        counts, st, x, off = carry
        vld, aux_t = xs
        ctx = model.context(st, aux_t)
        F = _quant(counts[ctx])
        low = (x & _MASK_M).astype(jnp.int32)
        sym = jnp.sum(F[:, 1:] <= low[:, None], axis=1).astype(jnp.int32)
        start = jnp.take_along_axis(F, sym[:, None], axis=1)[:, 0].astype(_U32)
        end = jnp.take_along_axis(F, sym[:, None] + 1, axis=1)[:, 0].astype(_U32)
        f = end - start
        xn = f * (x >> PROB_BITS) + (x & _MASK_M) - start
        need = (xn < RANS_L) & vld
        rank = jnp.cumsum(need.astype(jnp.int32)) - need.astype(jnp.int32)
        idx = jnp.minimum(off + rank, nwords - 1)
        w = words[idx].astype(_U32)
        xn = jnp.where(need, (xn << 16) | w, xn)
        x = jnp.where(vld, xn, x)
        off = off + jnp.sum(need.astype(jnp.int32))
        counts = _wave_update(counts, ctx, sym, vld, model, n_halve)
        st = _freeze_invalid(model.update(st, sym, aux_t), st, vld)
        return (counts, st, x, off), sym.astype(jnp.uint8)

    (counts, _, x, _), syms = lax.scan(
        body, (counts0, lane_state0, states, jnp.int32(0)), (valid, aux),
        unroll=_UNROLL)
    return syms, counts, x


# ---------------------------------------------------------------------------
# Host-facing stream API
# ---------------------------------------------------------------------------

_HDR = struct.Struct("<IIII")  # T, L, n_words, n_symbols


def _counts_grid(counts_per_read: np.ndarray, L: int) -> np.ndarray:
    """(R,) read lengths -> (ceil(R/L), L) round-robin slot grid (read r at
    slot (r // L, r % L)) — the only per-layout host->device upload."""
    R = len(counts_per_read)
    J = max(1, (R + L - 1) // L)
    pad = np.zeros(J * L, np.int32)
    pad[:R] = counts_per_read
    return pad.reshape(J, L)


def _make_grids(model, params, flat_syms, counts_per_read, extra_aux,
                n_lanes):
    """Common grid setup.  Without extra_aux the valid/pos/start grids are
    computed on device from the tiny counts grid; with extra_aux (caller-
    supplied per-symbol contexts) the host grid path is used."""
    counts_per_read = np.asarray(counts_per_read, np.int64)
    nsym = int(counts_per_read.sum())
    L = n_lanes or params.n_lanes(nsym)
    layout = make_layout(counts_per_read, L)
    if extra_aux:
        valid, aux = aux_grids(layout, with_pos=True)
        for k, v in extra_aux.items():
            aux[k] = to_grid(layout, np.asarray(v))
        valid_dev = jnp.asarray(valid)
        aux_dev = _dev_aux(aux)
    else:
        cg = jnp.asarray(_counts_grid(counts_per_read, L))
        valid_dev, aux_dev = _device_aux(layout.T, cg)
    return layout, nsym, L, valid_dev, aux_dev


@functools.partial(jax.jit,
                   static_argnames=("model", "n_halve", "T", "pmode",
                                    "chunk"))
def _encode_fused_adapt(model: CtxModel, n_halve: int, T: int,
                        pmode: int, c0, syms_in, counts_grid, exc,
                        chunk: int = 0):
    """Single-dispatch encode: aux grids + context build + adaptive model
    walk + rANS + compaction, all fused under one jit.  chunk > 0 uses the
    semi-adaptive walk (snapshot requantized every `chunk` waves)."""
    valid, aux = _device_aux(T, counts_grid)
    syms = _unpack_dev(syms_in, pmode, exc)
    ctx = model.context_grids(syms, aux)
    if chunk:
        start, freq, counts_out = _pass1_semi(model, n_halve, chunk, c0,
                                              ctx, syms, valid)
    else:
        start, freq, counts_out = _pass1(model, n_halve, c0, ctx, syms,
                                         valid)
    words, emits, x_final = _pass2(start, freq, valid)
    wp, nw = _compact_words(words, emits)
    return wp, nw, x_final, counts_out


@functools.partial(jax.jit, static_argnames=("model", "T", "pmode"))
def _encode_fused_frozen(model: CtxModel, T: int, pmode: int,
                         counts0, syms_in, counts_grid, exc):
    valid, aux = _device_aux(T, counts_grid)
    syms = _unpack_dev(syms_in, pmode, exc)
    ctx = model.context_grids(syms, aux)
    start, freq = _pass1_frozen(model.alphabet, counts0, ctx, syms)
    start = jnp.where(valid, start, 0)
    freq = jnp.where(valid, freq, 1)
    words, emits, x_final = _pass2(start, freq, valid)
    wp, nw = _compact_words(words, emits)
    return wp, nw, x_final


def _pack15_dev(syms, valid):
    """Device-side mode-15 d2h pack of a decoded (T, L) grid: frequency
    top-15 -> nibbles, rest -> exception buffer (cap = size/4, overflow
    detected by the returned count).  Invalid (padding) slots are
    rewritten to the most frequent symbol so they cost a nibble, never a
    sidecar entry."""
    counts = jnp.zeros(64, jnp.int32).at[
        jnp.where(valid, syms, 0).astype(jnp.int32).reshape(-1)].add(
        valid.astype(jnp.int32).reshape(-1))
    _, top = lax.top_k(counts, _EXC_SYM)
    top = top.astype(jnp.uint8)
    filled = jnp.where(valid, syms.astype(jnp.uint8), top[0])
    lut = jnp.full(64, _EXC_SYM, jnp.uint8).at[top].set(
        jnp.arange(_EXC_SYM, dtype=jnp.uint8))
    nib = lut[filled]
    mask = (nib == _EXC_SYM).reshape(-1)
    idx = jnp.cumsum(mask.astype(jnp.int32)) - 1
    cap = syms.size // 4
    scat = jnp.where(mask, jnp.minimum(idx, cap), cap)   # cap = dump slot
    exc = jnp.zeros(cap + 1, jnp.uint8).at[scat].set(
        filled.reshape(-1), mode="drop")
    side = jnp.concatenate(
        [jnp.zeros(16, jnp.uint8).at[:_EXC_SYM].set(top), exc[:cap]])
    n_exc = jnp.sum(mask.astype(jnp.int32))
    return _pack4_dev(nib), side, n_exc


def _pack_dev_out(syms, valid, pmode: int):
    """Decode d2h outputs: the plain pack always, plus the sentinel
    variant for 6-bit grids (the host fetches whichever is cheaper —
    XLA dead-code-eliminates nothing here, but the sentinel pack is a
    few elementwise passes, negligible next to the decode scan)."""
    plain = _pack_dev(syms, pmode)
    if pmode != 6:
        return plain, None, None
    nib, side, n_exc = _pack15_dev(syms, valid)
    return plain, (nib, side), n_exc


@functools.partial(jax.jit,
                   static_argnames=("model", "n_halve", "T", "pmode",
                                    "chunk"))
def _decode_fused_adapt(model: CtxModel, n_halve: int, T: int,
                        pmode: int, c0, lane0, states, words,
                        counts_grid, chunk: int = 0):
    valid, aux = _device_aux(T, counts_grid)
    if chunk:
        syms, counts_out, x = _decode_semi(model, n_halve, chunk, c0, lane0,
                                           states, words, valid, aux)
    else:
        syms, counts_out, x = _decode(model, n_halve, c0, lane0, states,
                                      words, valid, aux)
    return _pack_dev_out(syms, valid, pmode), counts_out


@functools.partial(jax.jit, static_argnames=("model", "T", "pmode"))
def _decode_fused_frozen(model: CtxModel, T: int, pmode: int,
                         counts0, lane0, states, words, counts_grid):
    valid, aux = _device_aux(T, counts_grid)
    syms, x = _decode_frozen(model, counts0, lane0, states, words, valid,
                             aux)
    return _pack_dev_out(syms, valid, pmode)


def _chunk_of(params: CodecParams, model: CtxModel, T: int) -> int:
    """Semi-adaptive chunk for the fused path: params.adapt_chunk when it
    divides the wave count, else 0 (legacy per-wave adaptation).  This is
    a pure function of serialized params + layout, so encode and decode
    always agree."""
    c = getattr(params, "adapt_chunk", 0)
    return c if (c and T % c == 0) else 0


# Speculative-fetch estimates: last observed count per stream shape
# (alphabet, n_ctx, T, L).  Blocks of one input are statistically
# alike, so the previous count predicts the next within a few percent;
# two same-shape streams with different entropy sharing a key would
# otherwise ping-pong it into repeated under-fetches, so updates keep a
# slowly-decaying maximum (up instantly, down 10% per block) — an
# over-estimate costs a few spare KB, an under-estimate costs a whole
# extra round-trip.  Used only to size fetches; payload bytes never
# depend on it.
_NWORDS_EST: Dict = {}
_SPEC_HEADROOM = 1.15

# Input epoch: estimates are per-INPUT, not process-global.  A batch CLI
# or server compressing heterogeneous files back-to-back would otherwise
# share shape-keyed estimates across inputs and systematically
# under-fetch after switching to a higher-entropy file.  The pipeline
# drivers bump this at the start of each
# compress/decompress; est keys embed it, and the stores are pruned of
# stale epochs so a long-lived server cannot grow them unboundedly.
_EST_EPOCH = [0]


def new_input_epoch() -> None:
    _EST_EPOCH[0] += 1
    for store in (_NWORDS_EST, _DEXC_EST):
        for k in [k for k in store if k[0] != _EST_EPOCH[0]]:
            del store[k]


def _est_update(store: Dict, key, n: int) -> None:
    prev = store.get(key)
    store[key] = n if prev is None else max(n, int(prev * 0.9))


def _wbucket(n: int, cap: int, q: int = 32768) -> int:
    """Ceil-to-quantum fetch bucket: an exact-length slice is a fresh
    XLA program per distinct stream length (a compile on every block);
    bucketing reuses a handful of programs and wastes at most q units of
    transfer."""
    return min(-(-max(n, 1) // q) * q, cap)


class EncodeJob:
    """Dispatched-but-unfinalized device encode: all device work is queued
    asynchronously; :meth:`finalize` syncs and serializes.  Callers dispatch
    several streams (and do host-side coding in between) before paying the
    host sync once per stream."""

    def __init__(self, T: int, L: int, nsym: int, wpacked, n_words_dev,
                 x_final, counts_out, est_key=None):
        self._T, self._L, self._nsym = T, L, nsym
        self._wpacked = wpacked
        self._n_words = n_words_dev
        self._x_final = x_final
        self._est_key = est_key
        self.counts_out = counts_out

    def finalize(self) -> bytes:
        cap = self._wpacked.shape[0]
        est = _NWORDS_EST.get(self._est_key)
        if est is not None:
            # speculative single-round-trip fetch: ship the count, the
            # final states and (an estimate-sized slice of) the words in
            # one device_get instead of a count sync followed by a fetch
            # — one host sync per stream instead of two.  15% headroom +
            # bucket
            # rounding make an under-fetch rare; when it happens we pay
            # the old two-trip cost.
            bucket = _wbucket(int(est * _SPEC_HEADROOM), cap)
            wd = self._wpacked[:bucket] if bucket < cap else self._wpacked
            nw, words_host, xf = jax.device_get(
                (self._n_words, wd, self._x_final))
            n_words = int(nw)
            if n_words > bucket:
                b2 = _wbucket(n_words, cap)
                words_host = jax.device_get(
                    self._wpacked[:b2] if b2 < cap else self._wpacked)
        else:
            n_words = int(self._n_words)
            bucket = _wbucket(n_words, cap)
            words_dev = (self._wpacked[:bucket] if bucket < cap
                         else self._wpacked)
            words_host, xf = jax.device_get((words_dev, self._x_final))
        if self._est_key is not None:
            _est_update(_NWORDS_EST, self._est_key, n_words)
        return (_HDR.pack(self._T, self._L, n_words, self._nsym)
                + np.asarray(xf).astype("<u4").tobytes()
                + np.asarray(words_host[:n_words]).astype("<u2").tobytes())


def encode_stream_job(model: CtxModel, params: CodecParams,
                      flat_syms: np.ndarray, counts_per_read: np.ndarray,
                      extra_aux: Optional[Dict[str, np.ndarray]] = None,
                      counts0: Optional[jnp.ndarray] = None,
                      n_lanes: Optional[int] = None,
                      adapt: bool = True) -> EncodeJob:
    """Dispatch one stream's encode to the device; returns an EncodeJob."""
    counts0 = counts0_dev(counts0)
    counts_per_read = np.asarray(counts_per_read, np.int64)
    nsym = int(counts_per_read.sum())
    L = n_lanes or params.n_lanes(nsym)

    if not extra_aux:
        # fused single-dispatch path: aux grids computed on device
        layout = make_layout(counts_per_read, L)
        syms = to_grid(layout, np.asarray(flat_syms, np.uint8))
        pmode, syms, exc = _pack_for_upload(syms, _pack_mode(model, L))
        cg = jnp.asarray(_counts_grid(counts_per_read, L))
        syms_dev = jnp.asarray(syms)
        exc_dev = jnp.asarray(exc)
        if adapt:
            c0 = counts0 if counts0 is not None else init_counts(model)
            chunk = _chunk_of(params, model, layout.T)
            nh = (_n_halve_chunk(model, L, chunk) if chunk
                  else _n_halve(model, L))
            wp, nw, xf, counts_out = _encode_fused_adapt(
                model, nh, layout.T, pmode, c0, syms_dev, cg, exc_dev,
                chunk)
        else:
            assert counts0 is not None, "frozen encode needs counts0"
            wp, nw, xf = _encode_fused_frozen(
                model, layout.T, pmode, counts0, syms_dev, cg, exc_dev)
            counts_out = counts0
        est_key = (_EST_EPOCH[0], model.alphabet, model.n_ctx,
                   layout.T, L)
        return EncodeJob(layout.T, L, nsym, wp, nw, xf, counts_out,
                         est_key=est_key)

    layout, nsym, L, valid_dev, aux_dev = _make_grids(
        model, params, flat_syms, counts_per_read, extra_aux, n_lanes)
    syms_dev = jnp.asarray(to_grid(layout, np.asarray(flat_syms, np.uint8)))
    ctx_grid = _ctx_grids(model, syms_dev, aux_dev)

    if adapt:
        c0 = counts0 if counts0 is not None else init_counts(model)
        nh = _n_halve(model, L)
        start, freq, counts_out = _pass1(
            model, nh, c0, ctx_grid, syms_dev, valid_dev)
    else:
        assert counts0 is not None, "frozen encode needs counts0"
        start, freq = _pass1_frozen(model.alphabet, counts0, ctx_grid,
                                    syms_dev)
        start = jnp.where(valid_dev, start, 0)
        freq = jnp.where(valid_dev, freq, 1)
        counts_out = counts0
    words, emits, x_final = _pass2(start, freq, valid_dev)
    wpacked, n_words_dev = _compact_words(words, emits)
    return EncodeJob(layout.T, L, nsym, wpacked, n_words_dev, x_final,
                     counts_out,
                     est_key=(_EST_EPOCH[0], model.alphabet,
                              model.n_ctx, layout.T, L))


def encode_stream(model: CtxModel, params: CodecParams,
                  flat_syms: np.ndarray, counts_per_read: np.ndarray,
                  extra_aux: Optional[Dict[str, np.ndarray]] = None,
                  counts0: Optional[jnp.ndarray] = None,
                  n_lanes: Optional[int] = None,
                  return_counts: bool = False,
                  adapt: bool = True):
    """Encode one logical stream (read-major flat symbols + per-read counts).

    Returns the serialized payload:
        header(T, L, n_words, n_symbols) | L x u32 final states | words u16[]

    adapt=False requires counts0 (a frozen table) and codes every symbol
    against it without updates — the usemodel fast path.
    """
    job = encode_stream_job(model, params, flat_syms, counts_per_read,
                            extra_aux, counts0, n_lanes, adapt)
    payload = job.finalize()
    if return_counts:
        return payload, job.counts_out
    return payload


# last observed sidecar size per decoded stream shape: sizes the
# speculative d2h fetch of the sentinel-packed decode output.
_DEXC_EST: Dict = {}
_DFETCH_Q = 16384          # sidecar fetch-slice quantum (program reuse)


class DecodeJob:
    def __init__(self, layout, syms_dev, counts_out, pmode: int = 0,
                 sent=None, n_exc=None, est_key=None):
        self._layout = layout
        self._syms = syms_dev
        self._pmode = pmode
        self._sent = sent              # (nibbles, side) device arrays
        self._n_exc = n_exc
        self._est_key = est_key
        self.counts_out = counts_out

    def finalize(self) -> np.ndarray:
        if self._sent is not None:
            return from_grid(self._layout, self._fetch_sentinel())
        grid = _unpack_host(np.asarray(self._syms), self._pmode)
        return from_grid(self._layout, grid)

    def _fetch_sentinel(self) -> np.ndarray:
        """d2h fetch of the decoded qual grid via the mode-15 sentinel
        pack when the previous same-shape block says the sidecar is
        small — ~28% less d2h than the plain 6-bit grid.  Cold blocks
        (or dense data, sidecar overflow) fetch the plain pack; both
        reconstruct the identical grid."""
        nib_dev, side_dev = self._sent
        cap = side_dev.shape[0] - 16
        est = _DEXC_EST.get(self._est_key)
        if est is None or est > cap * 0.9:
            n_exc, grid = jax.device_get((self._n_exc, self._syms))
            _est_update(_DEXC_EST, self._est_key, int(n_exc))
            return _unpack_host(np.asarray(grid), self._pmode)
        bucket = _wbucket(int(est * _SPEC_HEADROOM), cap, _DFETCH_Q)
        n_exc, nib, side = jax.device_get(
            (self._n_exc, nib_dev, side_dev[:16 + bucket]))
        n_exc = int(n_exc)
        _est_update(_DEXC_EST, self._est_key, n_exc)
        if n_exc > cap:            # sidecar overflowed on device
            return _unpack_host(
                np.asarray(jax.device_get(self._syms)), self._pmode)
        if n_exc > bucket:         # estimate under-shot: refetch sidecar
            side = jax.device_get(
                side_dev[:16 + _wbucket(n_exc, cap, _DFETCH_Q)])
        side = np.asarray(side)
        perm, exc = side[:16], side[16:]
        nibg = _unpack4_host(np.asarray(nib))
        flat = nibg.reshape(-1)
        mask = flat == _EXC_SYM
        out = perm[np.minimum(flat, _EXC_SYM)]
        out[mask] = exc[np.cumsum(mask)[mask] - 1]
        return out.reshape(nibg.shape)


def decode_stream_job(model: CtxModel, params: CodecParams,
                      payload: bytes, counts_per_read: np.ndarray,
                      extra_aux: Optional[Dict[str, np.ndarray]] = None,
                      counts0: Optional[jnp.ndarray] = None,
                      adapt: bool = True, ctx_shard=None) -> DecodeJob:
    """Dispatch one stream's decode to the device; returns a DecodeJob.

    ctx_shard: device list — frozen decode with the quantized table
    SHARDED over those devices' 'ctx' mesh axis instead of replicated
    (parallel/mesh.decode_blocks_frozen_sharded; bit-identical symbols).
    Production gate in pipeline/driver.decompress: mesh active AND the
    serialized table is past the replication threshold."""
    counts0 = counts0_dev(counts0)
    T, L, n_words, nsym = _HDR.unpack_from(payload, 0)
    off = _HDR.size
    states = np.frombuffer(payload, "<u4", L, off).copy()
    off += 4 * L
    words = np.frombuffer(payload, "<u2", n_words, off).copy()
    counts_per_read = np.asarray(counts_per_read, np.int64)
    if int(counts_per_read.sum()) != nsym:
        raise ValueError(
            f"corrupt stream: symbol count {nsym} in payload header does "
            f"not match length stream total {int(counts_per_read.sum())}")

    # pad the word stream to a power-of-two bucket so the jitted decode is
    # compiled once per bucket, not once per stream length
    bucket = 1024
    while bucket < n_words + 8:
        bucket <<= 1
    words_pad = np.zeros(bucket, np.uint16)
    words_pad[:n_words] = words
    states_dev = jnp.asarray(states, jnp.uint32)
    words_dev = jnp.asarray(words_pad)

    if not extra_aux:
        layout = make_layout(counts_per_read, L)
        if layout.T != T:
            raise ValueError(
                f"corrupt stream: layout T={layout.T} vs payload T={T}")
        if (not adapt and ctx_shard is not None and len(ctx_shard) >= 2
                and model.n_ctx % len(ctx_shard) == 0):
            assert counts0 is not None, "frozen decode needs counts0"
            from fastqueeze_tpu.ops.lanes import aux_grids
            from fastqueeze_tpu.parallel.mesh import (
                Mesh, decode_blocks_frozen_sharded)
            valid, aux = aux_grids(layout, with_pos=True)
            mesh = Mesh(np.array(ctx_shard).reshape(1, -1),
                        ("block", "ctx"))
            syms, _x = decode_blocks_frozen_sharded(
                mesh, model, counts0, states_dev[None], words_dev[None],
                jnp.asarray(valid)[None],
                jnp.asarray(aux["pos"], jnp.int32)[None])
            return DecodeJob(layout, syms[0], counts0)
        pmode = _pack_mode(model, L)
        cg = jnp.asarray(_counts_grid(counts_per_read, L))
        if adapt:
            c0 = counts0 if counts0 is not None else init_counts(model)
            chunk = _chunk_of(params, model, T)
            nh = (_n_halve_chunk(model, L, chunk) if chunk
                  else _n_halve(model, L))
            (syms, sent, n_exc), counts_out = _decode_fused_adapt(
                model, nh, T, pmode, c0,
                model.lane_init(L), states_dev, words_dev, cg, chunk)
        else:
            assert counts0 is not None, "frozen decode needs counts0"
            syms, sent, n_exc = _decode_fused_frozen(
                model, T, pmode, counts0, model.lane_init(L), states_dev,
                words_dev, cg)
            counts_out = counts0
        return DecodeJob(layout, syms, counts_out, pmode=pmode,
                         sent=sent, n_exc=n_exc,
                         est_key=(_EST_EPOCH[0], model.alphabet,
                                  model.n_ctx, T, L))

    layout, nsym2, L2, valid_dev, aux_dev = _make_grids(
        model, params, None, counts_per_read, extra_aux, L)
    if layout.T != T:
        raise ValueError(
            f"corrupt stream: layout T={layout.T} vs payload T={T}")
    if adapt:
        c0 = counts0 if counts0 is not None else init_counts(model)
        nh = _n_halve(model, L)
        syms, counts_out, x_end = _decode(
            model, nh, c0, model.lane_init(L), states_dev, words_dev,
            valid_dev, aux_dev)
    else:
        assert counts0 is not None, "frozen decode needs counts0"
        syms, x_end = _decode_frozen(
            model, counts0, model.lane_init(L), states_dev, words_dev,
            valid_dev, aux_dev)
        counts_out = counts0
    return DecodeJob(layout, syms, counts_out)


def decode_stream(model: CtxModel, params: CodecParams,
                  payload: bytes, counts_per_read: np.ndarray,
                  extra_aux: Optional[Dict[str, np.ndarray]] = None,
                  counts0: Optional[jnp.ndarray] = None,
                  return_counts: bool = False,
                  adapt: bool = True):
    """Inverse of :func:`encode_stream` -> read-major flat symbols."""
    job = decode_stream_job(model, params, payload, counts_per_read,
                            extra_aux, counts0, adapt)
    flat = job.finalize()
    if return_counts:
        return flat, job.counts_out
    return flat


def _dev_aux(aux: Dict[str, np.ndarray]):
    return {k: jnp.asarray(v) for k, v in aux.items()}


@functools.partial(jax.jit, static_argnames=("model", "T", "pmode"))
def _train_fused(model: CtxModel, T: int, pmode: int, syms_in, counts_grid,
                 exc):
    valid, aux = _device_aux(T, counts_grid)
    syms = _unpack_dev(syms_in, pmode, exc)
    return _train_counts(model, syms, valid, aux)


def train_counts(model: CtxModel, params: CodecParams,
                 flat_syms: np.ndarray, counts_per_read: np.ndarray,
                 extra_aux: Optional[Dict[str, np.ndarray]] = None,
                 n_lanes: Optional[int] = None) -> jnp.ndarray:
    """Host-facing frozen-model trainer: histogram a training prefix into a
    capped counts table usable as ``counts0`` by encode/decode."""
    counts_per_read = np.asarray(counts_per_read, np.int64)
    if not extra_aux:
        nsym = int(counts_per_read.sum())
        L = n_lanes or params.n_lanes(nsym)
        layout = make_layout(counts_per_read, L)
        pmode, syms, exc = _pack_for_upload(
            to_grid(layout, np.asarray(flat_syms, np.uint8)),
            _pack_mode(model, L))
        cg = jnp.asarray(_counts_grid(counts_per_read, L))
        return _train_fused(model, layout.T, pmode, jnp.asarray(syms), cg,
                            jnp.asarray(exc))
    layout, _, L, valid_dev, aux_dev = _make_grids(
        model, params, flat_syms, counts_per_read, extra_aux, n_lanes)
    syms = to_grid(layout, np.asarray(flat_syms, np.uint8))
    return _train_counts(model, jnp.asarray(syms), valid_dev, aux_dev)
