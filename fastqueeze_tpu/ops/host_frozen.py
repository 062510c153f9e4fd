"""Host execution of the frozen wave-rANS coder, and the default placement.

The frozen (usemodel) bitstream is a pure function of (symbols, layout,
frozen table) — see ops/engine.py.  native/frozenwave.cpp reproduces it
BIT-IDENTICALLY on the host CPU, so which backend codes a stream is a free
execution choice.  This module holds the placement policy (``auto_host``,
shared by the frozen and adaptive coders and the aligner) plus the thin job
wrappers that present the native coder through the same dispatch/finalize
interface as engine.encode_stream_job / decode_stream_job.

Default placement: streams are coded on the device whenever JAX runs on an
accelerator or a ``--mesh`` is requested; the native coder takes over only
on a CPU backend (tests, ``--cpu``), where it is the faster of two CPU
paths.  ``frozen_exec`` / FASTQUEEZE_FROZEN_EXEC=host|device force either
side.  Archives are byte-identical either way (tests enforce it).
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from fastqueeze_tpu.config import RANS_M, SEQ_CTX_START, CodecParams
from fastqueeze_tpu.io import native
from fastqueeze_tpu.models.base import QualModel, SeqModel
from fastqueeze_tpu.ops.lanes import make_layout

_HDR = struct.Struct("<IIII")  # T, L, n_words, n_symbols (engine._HDR)


def pack_payload(layout_T: int, L: int, words: np.ndarray,
                 states: np.ndarray, nsym: int) -> bytes:
    """Serialize the engine wire format (shared by the frozen and
    adaptive host coders — one definition of the header layout)."""
    return (_HDR.pack(layout_T, L, len(words), nsym)
            + states.astype("<u4").tobytes()
            + words.astype("<u2").tobytes())


def unpack_payload(payload: bytes, counts: np.ndarray):
    """Parse + validate the engine wire header against the length stream;
    returns (states, words, L, layout).  Raises ValueError on the corrupt
    shapes a mangled payload can carry (one definition of these checks
    for both host coders)."""
    from fastqueeze_tpu.ops.lanes import make_layout
    T, L, n_words, nsym = _HDR.unpack_from(payload, 0)
    off = _HDR.size
    states = np.frombuffer(payload, "<u4", L, off)
    off += 4 * L
    words = np.frombuffer(payload, "<u2", n_words, off)
    if int(counts.sum()) != nsym:
        raise ValueError(
            f"corrupt stream: symbol count {nsym} in payload header does "
            f"not match length stream total {int(counts.sum())}")
    layout = make_layout(counts, L)
    if layout.T != T:
        raise ValueError(
            f"corrupt stream: layout T={layout.T} vs payload T={T}")
    return states, words, L, layout


def _spec_of(model):
    """(kind, spec int64 array) for the native walker, or None."""
    if type(model) is SeqModel:
        return 0, np.array([model.mask, SEQ_CTX_START & model.mask],
                           np.int64)
    if type(model) is QualModel:
        if model.k > 8:
            return None
        return 1, np.array([model.k, model.ctx_base, model.hash_bits,
                            model.drop_bits, model.pos_bits, model.qlevel,
                            model.drop_init], np.int64)
    return None


def route(p: CodecParams, model) -> bool:
    """True = code this frozen stream on the host (native).  The choice
    never reaches the bitstream."""
    if native.get_lib() is None:
        return False
    if model.cap > RANS_M:
        # rows past the cap could quantize a count to freq 0; the device
        # search variants resolve such degenerate rows their own way
        return False
    if _spec_of(model) is None:
        return False
    mode = os.environ.get("FASTQUEEZE_FROZEN_EXEC", "")
    if mode == "host":
        return True
    if mode == "device":
        return False
    if p.frozen_exec == 1:
        return True
    if p.frozen_exec == 2:
        return False
    return auto_host(p)


def auto_host(p: CodecParams) -> bool:
    """Default placement of a coder or aligner stage: the native host path
    only on a CPU backend without a mesh request.  Read per call (never at
    import), so ``--cpu`` and tests that switch the backend are honoured."""
    if p.mesh_n:
        return False
    import jax
    return jax.default_backend() == "cpu"


def quantize(counts: np.ndarray) -> np.ndarray:
    """Host-side engine._quant: (n_ctx, A) counts -> (n_ctx, A+1) u16."""
    cum = native.quant_table(np.ascontiguousarray(counts, np.int32))
    if cum is not None:
        return cum
    c = counts.astype(np.int64)
    cs = np.cumsum(c, axis=1)
    C = np.maximum(cs[:, -1:], 1)
    cumz = np.concatenate([np.zeros_like(C), cs], axis=1)
    return ((cumz * RANS_M) // C).astype(np.uint16)


class _HostJob:
    """Same surface as engine.EncodeJob/DecodeJob: .finalize() + .counts_out
    (frozen coding never mutates tables, so counts_out is the input)."""

    def __init__(self, result, counts_out=None):
        self._result = result
        self.counts_out = counts_out

    def finalize(self):
        return self._result


def encode_job(model, p: CodecParams, flat_syms: np.ndarray,
               counts_per_read: np.ndarray, cum: np.ndarray,
               n_lanes: Optional[int] = None) -> Optional[_HostJob]:
    """Native frozen encode -> job whose finalize() yields the serialized
    payload (bit-identical to engine.encode_stream_job(adapt=False))."""
    kind_spec = _spec_of(model)
    if kind_spec is None:
        return None
    kind, spec = kind_spec
    counts = np.ascontiguousarray(counts_per_read, np.int64)
    nsym = int(counts.sum())
    L = n_lanes or p.n_lanes(nsym)
    layout = make_layout(counts, L)
    out = native.frozen_encode(cum, model.alphabet,
                               np.asarray(flat_syms, np.uint8), counts, L,
                               kind, spec)
    if out is None:
        return None
    words, states = out
    return _HostJob(pack_payload(layout.T, L, words, states, nsym))


def decode_job(model, p: CodecParams, payload: bytes,
               counts_per_read: np.ndarray,
               cum: np.ndarray) -> Optional[_HostJob]:
    """Native frozen decode -> job whose finalize() yields read-major flat
    symbols (mirror of engine.decode_stream_job(adapt=False))."""
    kind_spec = _spec_of(model)
    if kind_spec is None:
        return None
    kind, spec = kind_spec
    counts = np.ascontiguousarray(counts_per_read, np.int64)
    states, words, L, layout = unpack_payload(payload, counts)
    nsym = int(counts.sum())
    flat = native.frozen_decode(cum, model.alphabet, states, words, counts,
                                L, kind, spec, nsym)
    if flat is None:
        return None
    return _HostJob(flat)
