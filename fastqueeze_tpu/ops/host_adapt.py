"""Host execution of the ADAPTIVE wave-rANS coder.

The per-wave adaptive bitstream is a pure function of (symbols, layout,
model parameters) — see ops/engine.py (_pass1/_decode with chunk = 0).
native/adaptwave.cpp reproduces it BIT-IDENTICALLY on the host CPU, so
which backend codes a stream is a free execution choice, exactly like
ops/host_frozen.py for the frozen path.

Small inputs (below the frozen-model gate — the reference's usemodel
threshold, SURVEY.md §2.1) are coded with per-block adaptive models.
Placement follows host_frozen.auto_host: the device on an accelerator or
under ``--mesh``, the native coder on a CPU backend.
FASTQUEEZE_ADAPT_EXEC=host|device and ``frozen_exec`` force either side.
Archives are byte-identical either way (tests/test_host_adapt.py enforces
it).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from fastqueeze_tpu.config import RANS_M, CodecParams
from fastqueeze_tpu.io import native
from fastqueeze_tpu.ops.host_frozen import (_HostJob, _spec_of, auto_host,
                                            pack_payload, unpack_payload)
from fastqueeze_tpu.ops.lanes import make_layout


def route(p: CodecParams, model) -> bool:
    """True = code this adaptive stream on the host (native).  The choice
    never reaches the bitstream."""
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "fq_adapt_encode"):
        return False
    if model.cap > RANS_M:
        # rows past the cap could quantize a count to freq 0; the device
        # search resolves such degenerate rows its own way
        return False
    if model.init * model.alphabet > model.cap:
        # over-cap INITIAL rows: the device applies its bounded n_halve
        # passes per wave while the native coder rescales to the fixed
        # point in one flush — bitstreams would diverge (and with
        # cap < alphabet no rescale can ever reach the cap at all).
        # Rows that start <= cap stay <= cap + inc*L + A transiently,
        # which n_halve is sized for, so parity holds below this gate.
        return False
    if getattr(p, "adapt_chunk", 0):
        return False          # semi-adaptive walks stay on the device
    if _spec_of(model) is None:
        return False
    mode = os.environ.get("FASTQUEEZE_ADAPT_EXEC", "")
    if mode == "host":
        return True
    if mode == "device":
        return False
    if p.frozen_exec == 1:    # the coder-backend knob covers both paths
        return True
    if p.frozen_exec == 2:
        return False
    return auto_host(p)


def encode_job(model, p: CodecParams, flat_syms: np.ndarray,
               counts_per_read: np.ndarray,
               n_lanes: Optional[int] = None) -> Optional[_HostJob]:
    """Native adaptive encode -> job whose finalize() yields the serialized
    payload (bit-identical to engine.encode_stream_job(adapt=True,
    counts0=None))."""
    kind_spec = _spec_of(model)
    if kind_spec is None:
        return None
    kind, spec = kind_spec
    counts = np.ascontiguousarray(counts_per_read, np.int64)
    nsym = int(counts.sum())
    L = n_lanes or p.n_lanes(nsym)
    layout = make_layout(counts, L)
    out = native.adapt_encode(model.alphabet, model.n_ctx, model.init,
                              model.inc, model.cap,
                              np.asarray(flat_syms, np.uint8), counts, L,
                              kind, spec)
    if out is None:
        return None
    words, states = out
    return _HostJob(pack_payload(layout.T, L, words, states, nsym))


def decode_job(model, p: CodecParams, payload: bytes,
               counts_per_read: np.ndarray) -> Optional[_HostJob]:
    """Native adaptive decode -> job whose finalize() yields read-major
    flat symbols (mirror of engine.decode_stream_job(adapt=True))."""
    kind_spec = _spec_of(model)
    if kind_spec is None:
        return None
    kind, spec = kind_spec
    counts = np.ascontiguousarray(counts_per_read, np.int64)
    states, words, L, layout = unpack_payload(payload, counts)
    nsym = int(counts.sum())
    flat = native.adapt_decode(model.alphabet, model.n_ctx, model.init,
                               model.inc, model.cap, states, words, counts,
                               L, kind, spec, nsym)
    if flat is None:
        return None
    return _HostJob(flat)
