"""Per-block stream split + entropy coding.

Capability parity with the reference's per-block encode/decode jobs
(SURVEY.md C7/C9/C17: AlignEncodeSEJob::doTask -> EncapFqzComp::doFqzEncode
and DecodeSEJob::decodeData): a block of parsed records is split into
independently coded streams — lengths, read IDs (binned), degenerate
(non-ACGT) bases, 2-bit sequence, quality — each wrapped in a TLV section so
streams are independently seekable inside a block (README.md:12).

All entropy coding runs on-device through the wave-synchronized rANS engine;
ID binning and TLV assembly are host-side (they are tiny).
"""

from __future__ import annotations

import io
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from fastqueeze_tpu.config import CodecParams
from fastqueeze_tpu.container.encap import iter_tlv, write_tlv
from fastqueeze_tpu.models.base import (
    CtxModel, FlatModel, Order1ByteModel, byte_model,
    qual_model_for, seq_model_from_params)
from fastqueeze_tpu.io.fastq import FastqBlock
from fastqueeze_tpu.ops import host_rans
from fastqueeze_tpu.ops.engine import (
    decode_stream, decode_stream_job, encode_stream, encode_stream_job)
from fastqueeze_tpu.pipeline.idproc import (
    IdBinSchema, analyze_ids, reconstruct_ids)

TAG_META = 1
TAG_LEN = 2
TAG_DEGCNT = 3
TAG_DEGPOS = 4
TAG_DEGCHR = 5
TAG_IDSCHEMA = 6
TAG_IDVAR = 7
TAG_IDRAW = 8
TAG_PLUSSCHEMA = 9
TAG_PLUSVAR = 10
TAG_PLUSRAW = 11
TAG_SEQ = 12
TAG_QUAL = 13
TAG_AMAP = 14     # per-read mapped flag
TAG_APOS = 15     # mapped: window start position bytes
TAG_AREV = 16     # mapped: reverse-complement flag
TAG_AMISC = 17    # mapped: mismatch count per read
TAG_AMISP = 18    # mapped: mismatch positions (window coords, delta)
TAG_AMISB = 19    # mapped: substituted bases (2-bit), ctx = ref base
TAG_APDF = 20     # PE -I: delta-coded flag per eligible mate-2
TAG_APD = 21      # PE -I: zigzag insert deltas for flagged mate-2s
TAG_ACIGF = 22    # mapped: has-indel flag (reference CigaL/CigaV parity)
TAG_ACIGS = 23    # indel reads: split position s in the read
TAG_ACIGL = 24    # indel reads: zigzag signed gap size g
TAG_SDUPF = 25    # duplicate tier: per-read seq-duplicate flag
TAG_SDUPD = 26    # seq-dup reads: back-distance (in reads) to the first
                  #   identical earlier read
TAG_QDUPF = 27    # duplicate tier: per-read qual-duplicate flag
TAG_QDUPD = 28    # qual-dup reads: back-distance to the first identical
TAG_ACG2F = 29    # indel reads: has-second-op flag (multi-op CigaL/CigaV)
TAG_ACG2S = 30    # 2-op reads: second split position s2 (>= s1 + |g1<0|)
TAG_ACG2L = 31    # 2-op reads: zigzag signed second gap g2
# long-read tier (reads > align_max_len, chunked anchor mapping; no
# reference equivalent — SeqArc codes long reads entropy-only):
TAG_LRF = 32      # per-chunk mapped flag (chunks of non-seq-dup long reads)
TAG_LRPOS = 33    # mapped chunks: absolute window start (posb bytes)
TAG_LRREV = 34    # mapped chunks: reverse-complement flag
TAG_LRMISC = 35   # mapped chunks: mismatch count per chunk
TAG_LRMISP = 36   # mapped chunks: mismatch positions (delta, lrpb bytes)
TAG_LRMISB = 37   # mapped chunks: substituted bases, ctx = ref base
TAG_LRPA = 38     # mapped chunks: position-anchor flag (first of read /
                  #   strand change / discontiguous); non-anchors code a
                  #   2-byte zigzag residual off the previous chunk
TAG_LRPD = 39     # non-anchor chunks: zigzag pos residual (u16)
# chunk-level indels (longread_indel budget; HiFi homopolymer indels):
# same CigaL/CigaV shapes as the read path, chunk granularity.  (These
# numbers coexist with pe.py's OUTER envelope tags 40/41 — different TLV
# parse context, block payloads are nested inside the PE envelope.)
TAG_LRCIGF = 40   # mapped chunks: has-indel flag
TAG_LRCIGS = 41   # indel chunks: split position s
TAG_LRCIGL = 42   # indel chunks: zigzag signed gap g
TAG_LRCG2F = 43   # indel chunks: has-second-op flag
TAG_LRCG2S = 44   # 2-op chunks: second split s2
TAG_LRCG2L = 45   # 2-op chunks: zigzag signed g2

_VAR_CHUNK = 256  # var byte streams are cut into pseudo-reads for lane ||ism

_BASE_MAP = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _BASE_MAP[_c] = _i
_BASE_INV = np.frombuffer(b"ACGT", np.uint8)

def _lr_grid(lengths: np.ndarray, cap: int, chunk: int,
             tail_min: int = 64):
    """Deterministic chunk grid of the long-read tier: (reads, offs,
    clens) covering every read longer than ``cap`` in ``chunk``-sized
    pieces (final remainder kept as its own chunk when >= tail_min —
    p.longread_tail_min, serialized: it shapes the decode-side grid).
    Encode and decode derive the identical grid from the decoded lengths
    + serialized params — the chunk STRUCTURE costs zero stream bytes."""
    rows = np.flatnonzero(lengths > cap)
    reads, offs, clens = [], [], []
    for r in rows:
        L = int(lengths[r])
        n = L // chunk
        reads += [r] * n
        offs += [j * chunk for j in range(n)]
        clens += [chunk] * n
        rem = L - n * chunk
        if rem >= tail_min:
            reads.append(r)
            offs.append(n * chunk)
            clens.append(rem)
    return (np.asarray(reads, np.int64), np.asarray(offs, np.int64),
            np.asarray(clens, np.int64))


# --- duplicate-read tier (CodecParams.dedup) ---------------------------
# A read byte-identical to an earlier read of the same block is coded as a
# back-reference: flag + distance (in reads) to its FIRST identical earlier
# occurrence.  Sequence and quality are deduplicated independently (PCR
# duplicates share the sequence but not the qualities).  Sources are by
# construction non-duplicates themselves, so decode restores every
# duplicate with one vectorized gather after the unique reads are filled.

_HASH_W = np.zeros(0, np.uint64)


def _row_hash_weights(L: int) -> np.ndarray:
    """Per-byte-position u64 weights: splitmix64(i + 1) | 1.  A pure
    function of the position, identical in numpy and native/duphash.cpp
    (dup decisions must match across backends/threads/processes:
    -t N ≡ -t 1 payload invariance and the native/numpy twin invariant)."""
    global _HASH_W
    if len(_HASH_W) < L:
        i = np.arange(1, L + 1, dtype=np.uint64)
        z = i * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        _HASH_W = (z ^ (z >> np.uint64(31))) | np.uint64(1)
    return _HASH_W[:L]


def _dup_group(mat: np.ndarray, rows: np.ndarray, src: np.ndarray) -> bool:
    """mat: (n, L) uint8 rows (same length); rows: their block read
    indices (ascending).  Writes first-occurrence indices into src for
    verified duplicates; returns True if any were found."""
    n, L = mat.shape
    h = (mat.astype(np.uint64) * _row_hash_weights(L)[None, :]).sum(
        axis=1, dtype=np.uint64)
    order = np.argsort(h, kind="stable")
    hs = h[order]
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = hs[1:] != hs[:-1]
    n_groups = int(new.sum())
    if n_groups == n:
        return False
    gid = np.cumsum(new) - 1
    first = np.full(n_groups, n, np.int64)
    np.minimum.at(first, gid, order)
    cand = np.empty(n, np.int64)
    cand[order] = first[gid]
    dup = cand < np.arange(n)
    d = np.flatnonzero(dup)
    if not len(d):
        return False
    # verify content equality (hash collisions: the colliding read simply
    # stays unique — never a wrong back-reference)
    eq = (mat[d] == mat[cand[d]]).all(axis=1)
    d = d[eq]
    if not len(d):
        return False
    src[rows[d]] = rows[cand[d]]
    return True


def _dup_sources(flat: np.ndarray, lengths: np.ndarray):
    """Per-read index of the first identical earlier read (same length,
    same bytes), or -1.  None when the block has no duplicates.  Native
    one-pass (native/duphash.cpp) with this numpy mirror as fallback —
    bit-identical results (same weights, grouping, and verify rule)."""
    R = len(lengths)
    if R < 2:
        return None
    from fastqueeze_tpu.io import native
    out = native.dup_sources(flat, lengths)
    if out is not None:
        src, n_found = out
        return src if n_found else None
    return _dup_sources_np(flat, lengths)


def _dup_sources_np(flat: np.ndarray, lengths: np.ndarray):
    R = len(lengths)
    src = np.full(R, -1, np.int64)
    offs = np.cumsum(lengths) - lengths
    found = False
    uls = np.unique(lengths)
    for L in uls.tolist():
        if L <= 0:
            continue
        if len(uls) == 1:
            rows = np.arange(R)
            mat = flat[:R * L].reshape(R, L)      # no gather: one length
        else:
            rows = np.flatnonzero(lengths == L)
            if len(rows) < 2:
                continue
            idx = offs[rows][:, None] + np.arange(L, dtype=np.int64)[None, :]
            mat = flat[idx]
        if len(rows) >= 2 and _dup_group(mat, rows, src):
            found = True
    return src if found else None


def dup_masks(block: FastqBlock):
    """(seq_src, qual_src) duplicate back-references for a block, cached on
    the block object (the driver precomputes them for training blocks)."""
    cached = getattr(block, "_dup_masks", None)
    if cached is None:
        cached = (_dup_sources(block.seq_flat, block.lengths),
                  _dup_sources(block.qual_flat, block.lengths))
        block._dup_masks = cached
    return cached


def dedup_training_block(block: FastqBlock, p: CodecParams):
    """(training_block, kept_sym_fraction): `block` with qual-duplicate
    reads removed, chunked at block size — the duplicate tier codes each
    block independently, so a multi-block training prefix must dedup per
    block-sized chunk, not across the whole prefix.  Feeding the trainer
    the deduped sample keeps the qctx cost model honest: the in-sample
    projection (proj = max(est, sample)) otherwise counts duplicate
    symbols the coder will never emit and over-buys big tables."""
    R = block.n_reads
    if not p.dedup or R < 2:
        return block, 1.0
    bs = p.block_bytes or p.block_size_mb * (1 << 20)
    if block.raw_len and block.raw_len > bs:
        n_chunk = max(2, int(R * bs / block.raw_len))
        keep = np.ones(R, bool)
        offs = np.cumsum(block.lengths) - block.lengths
        for s in range(0, R, n_chunk):
            e = min(s + n_chunk, R)
            lo = int(offs[s])
            hi = int(offs[e - 1] + block.lengths[e - 1])
            q = _dup_sources(block.qual_flat[lo:hi], block.lengths[s:e])
            if q is not None:
                keep[s:e] = q < 0
    else:
        _, q = dup_masks(block)      # real block: reuse the cached masks
        if q is None:
            return block, 1.0
        keep = q < 0
    if keep.all():
        return block, 1.0
    sym = np.repeat(keep, block.lengths)
    tb = FastqBlock(
        n_reads=int(keep.sum()), ids=[], plus=[],
        seq_flat=block.seq_flat[sym], qual_flat=block.qual_flat[sym],
        lengths=block.lengths[keep], raw_len=0, final_newline=True)
    frac = int(tb.lengths.sum()) / max(int(block.lengths.sum()), 1)
    return tb, frac


def _intra_of(lens: np.ndarray) -> np.ndarray:
    """Per-symbol position-within-read for concatenated reads of lens."""
    offs = np.cumsum(lens) - lens
    return (np.arange(int(lens.sum()), dtype=np.int64)
            - np.repeat(offs, lens))


def _copy_read_ranges(arr: np.ndarray, src_off: np.ndarray,
                      dst_off: np.ndarray, lens: np.ndarray) -> None:
    """arr[dst_off[i]:+lens[i]] = arr[src_off[i]:+lens[i]] for all i —
    the duplicate-restore copy.  Native gather+scatter when available
    (the numpy fallback pays two big index vectors)."""
    total = int(lens.sum())
    if total == 0:
        return
    from fastqueeze_tpu.io import native
    g = native.gather(arr, src_off, src_off + lens, total)
    if g is not None:
        native.scatter(g, dst_off, lens, arr)
        return
    intra = _intra_of(lens)
    arr[np.repeat(dst_off, lens) + intra] = \
        arr[np.repeat(src_off, lens) + intra]


def _chunk_counts(n: int, chunk: int = _VAR_CHUNK) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.int64)
    full, rem = divmod(n, chunk)
    counts = [chunk] * full + ([rem] if rem else [])
    return np.asarray(counts, np.int64)


def _code_bytes(p: CodecParams, raw: bytes, order1: bool = True) -> bytes:
    """Entropy-code a host byte string.  Marker dispatch: 0 = stored raw,
    1 = device wave-rANS, 2 = host serial range coder.  Streams up to
    p.host_stream_max bytes go to the host coder (the choice is part of
    the format)."""
    if not raw:
        return b"\x00"
    flat = np.frombuffer(raw, np.uint8)
    if len(flat) <= p.host_stream_max:
        if order1:
            blob = host_rans.encode_o1(flat, 256, p.byte_init, p.byte_inc,
                                       p.byte_cap)
        else:
            blob = host_rans.encode_ctx(flat, None, 1, 256, p.byte_init,
                                        p.byte_inc, p.byte_cap)
        payload = b"\x02" + len(raw).to_bytes(4, "little") + blob
    else:
        model = byte_model(p, order1=order1)
        counts = _chunk_counts(len(raw))
        payload = (b"\x01" + len(raw).to_bytes(4, "little")
                   + encode_stream(model, p, flat, counts))
    if len(payload) >= len(raw) + 1:
        return b"\x00" + raw
    return payload


def _decode_bytes(p: CodecParams, blob: bytes, order1: bool = True) -> bytes:
    marker = blob[:1]
    if marker == b"\x00":
        return blob[1:]
    n = int.from_bytes(blob[1:5], "little")
    if marker == b"\x02":
        if order1:
            flat = host_rans.decode_o1(blob[5:], n, 256, p.byte_init,
                                       p.byte_inc, p.byte_cap)
        else:
            flat = host_rans.decode_ctx(blob[5:], n, None, 1, 256,
                                        p.byte_init, p.byte_inc, p.byte_cap)
        return flat.tobytes()
    model = byte_model(p, order1=order1)
    counts = _chunk_counts(n)
    flat = decode_stream(model, p, blob[5:], counts)
    return flat.astype(np.uint8).tobytes()


def _code_lines(p: CodecParams, lines, R: int) -> bytes:
    """Fallback line coder for IDs/plus lines when binning fails
    (reference: encode_name @0x421070, SURVEY.md §2.1 path 2).  Codes the
    lines through the tokenized previous-name diff coder (marker 3) and
    through the generic byte path; the smaller payload wins, so
    unstructured IDs (SRA hashes, instrument coords) land near entropy
    while degenerate inputs keep the raw/order-1 floor."""
    from fastqueeze_tpu.io.fastq import LazyLines
    if R == 0:
        return _code_bytes(p, b"")
    if isinstance(lines, LazyLines):
        cat = np.frombuffer(lines.cat, np.uint8)
        lens = np.diff(lines.offs).astype(np.int32)
    else:
        cat = np.frombuffer(b"".join(lines), np.uint8)
        lens = np.array([len(x) for x in lines], np.int32)
    blob = host_rans.encode_names(cat, lens, p.byte_init, p.byte_inc,
                                  p.byte_cap)
    cand = b"\x03" + len(cat).to_bytes(4, "little") + blob
    alt = _code_bytes(p, b"\n".join(lines) + b"\n")
    return cand if len(cand) < len(alt) else alt


def _decode_lines(p: CodecParams, blob: bytes, R: int) -> List[bytes]:
    if blob[:1] == b"\x03":
        total = int.from_bytes(blob[1:5], "little")
        cat, lens = host_rans.decode_names(blob[5:], R, total, p.byte_init,
                                           p.byte_inc, p.byte_cap)
        offs = np.concatenate(([0], np.cumsum(lens, dtype=np.int64)))
        c = cat.tobytes()
        return [c[offs[i]:offs[i + 1]] for i in range(R)]
    raw = _decode_bytes(p, blob)
    return raw.split(b"\n")[:-1] if raw else []


def _two_byte_stream(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """values -> interleaved (lo, hi) symbols, counts=2/item, ctx=[0,1]."""
    n = len(values)
    syms = np.empty(2 * n, np.uint8)
    syms[0::2] = values & 0xFF
    syms[1::2] = (values >> 8) & 0xFF
    counts = np.full(n, 2, np.int64)
    ctx = np.tile(np.array([0, 1], np.uint8), n)
    return syms, counts, ctx


def _qual_alphabet(qmax: int) -> int:
    return ((qmax + 1 + 7) // 8) * 8


def _width_of(max_val: int) -> int:
    """Byte width tier for little-endian integer streams (the reference's
    encode_len_short/encode_len_long split, generalized to 1/2/4)."""
    if max_val <= 0xFF:
        return 1
    if max_val <= 0xFFFF:
        return 2
    return 4


def _code_flags(p: CodecParams, bits: np.ndarray) -> bytes:
    """Entropy-code a boolean vector through an adaptive binary model
    (marker 1 = device, 2 = host order-1)."""
    b8 = bits.astype(np.uint8)
    if len(bits) <= p.host_stream_max:
        return b"\x02" + host_rans.encode_o1(b8, 2, p.byte_init, p.byte_inc,
                                             p.byte_cap)
    model = CtxModel(alphabet=2, init=p.byte_init, inc=p.byte_inc,
                     cap=p.byte_cap)
    counts = _chunk_counts(len(bits))
    return b"\x01" + encode_stream(model, p, b8, counts)


def _decode_flags(p: CodecParams, blob: bytes, n: int) -> np.ndarray:
    if blob[:1] == b"\x02":
        return host_rans.decode_o1(blob[1:], n, 2, p.byte_init, p.byte_inc,
                                   p.byte_cap).astype(bool)
    model = CtxModel(alphabet=2, init=p.byte_init, inc=p.byte_inc,
                     cap=p.byte_cap)
    counts = _chunk_counts(n)
    return decode_stream(model, p, blob[1:], counts).astype(bool)


def _le_byte_stream(values: np.ndarray, nbytes: int):
    """values -> per-item little-endian bytes, ctx = byte index."""
    n = len(values)
    syms = np.empty(n * nbytes, np.uint8)
    for b in range(nbytes):
        syms[b::nbytes] = (values >> (8 * b)) & 0xFF
    counts = np.full(n, nbytes, np.int64)
    ctx = np.tile(np.arange(nbytes, dtype=np.uint8), n)
    return syms, counts, ctx


def _from_le_bytes(syms: np.ndarray, n: int, nbytes: int) -> np.ndarray:
    vals = np.zeros(n, np.int64)
    for b in range(nbytes):
        vals |= syms[b::nbytes].astype(np.int64) << (8 * b)
    return vals


def _code_syms_ctx(p: CodecParams, syms: np.ndarray, ctx: np.ndarray,
                   n_ctx: int, alphabet: int) -> bytes:
    """Generic precomputed-context symbol stream (marker 1/2 dispatch)."""
    if len(syms) <= p.host_stream_max:
        return b"\x02" + host_rans.encode_ctx(
            syms, ctx.astype(np.uint32), n_ctx, alphabet, p.byte_init,
            p.byte_inc, p.byte_cap)
    model = FlatModel(alphabet=alphabet, init=p.byte_init, inc=p.byte_inc,
                      cap=p.byte_cap, n_ctx=n_ctx)
    return b"\x01" + encode_stream(model, p, syms, _chunk_counts(len(syms)),
                                   extra_aux={"ctx": ctx})


def _decode_syms_ctx(p: CodecParams, blob: bytes, n: int, ctx: np.ndarray,
                     n_ctx: int, alphabet: int) -> np.ndarray:
    if blob[:1] == b"\x02":
        return host_rans.decode_ctx(blob[1:], n, ctx.astype(np.uint32),
                                    n_ctx, alphabet, p.byte_init,
                                    p.byte_inc, p.byte_cap)
    model = FlatModel(alphabet=alphabet, init=p.byte_init, inc=p.byte_inc,
                      cap=p.byte_cap, n_ctx=n_ctx)
    return decode_stream(model, p, blob[1:], _chunk_counts(n),
                         extra_aux={"ctx": ctx})


def _code_le(p: CodecParams, values: np.ndarray, nbytes: int) -> bytes:
    syms, counts, ctx = _le_byte_stream(values.astype(np.int64), nbytes)
    if len(syms) <= p.host_stream_max:
        return b"\x02" + host_rans.encode_ctx(
            syms, ctx.astype(np.uint32), nbytes, 256, p.byte_init,
            p.byte_inc, p.byte_cap)
    model = FlatModel(alphabet=256, init=p.byte_init, inc=p.byte_inc,
                      cap=p.byte_cap, n_ctx=nbytes)
    return b"\x01" + encode_stream(model, p, syms, counts,
                                   extra_aux={"ctx": ctx})


def _decode_le(p: CodecParams, blob: bytes, n: int, nbytes: int) -> np.ndarray:
    ctx = np.tile(np.arange(nbytes, dtype=np.uint8), n)
    if blob[:1] == b"\x02":
        syms = host_rans.decode_ctx(blob[1:], n * nbytes,
                                    ctx.astype(np.uint32), nbytes, 256,
                                    p.byte_init, p.byte_inc, p.byte_cap)
        return _from_le_bytes(syms, n, nbytes)
    model = FlatModel(alphabet=256, init=p.byte_init, inc=p.byte_inc,
                      cap=p.byte_cap, n_ctx=nbytes)
    counts = np.full(n, nbytes, np.int64)
    syms = decode_stream(model, p, blob[1:], counts, extra_aux={"ctx": ctx})
    return _from_le_bytes(syms, n, nbytes)


def encode_block(p: CodecParams, block: FastqBlock,
                 frozen: Optional[Dict] = None,
                 align=None, ref_codes: Optional[np.ndarray] = None,
                 dbg=None, self_ref: bool = False) -> bytes:
    """align: AlignResult over this block's reads (or None for entropy-only);
    ref_codes: the reference 2-bit code array (required with align).
    self_ref: ref_codes is the block's own unmapped-read concatenation
    (pipeline/selfref.py) — decode rebuilds it, no FASTA involved."""
    return encode_block_job(p, block, frozen, align, ref_codes, dbg,
                            self_ref)()


def encode_block_job(p: CodecParams, block: FastqBlock,
                     frozen: Optional[Dict] = None,
                     align=None, ref_codes: Optional[np.ndarray] = None,
                     dbg=None, self_ref: bool = False):
    """Dispatch phase of encode_block: device streams are queued and host
    streams coded; the returned thunk syncs the device and assembles the
    block TLV.  Drivers keep the next block's host work running while the
    device crunches this one (reference analogue: ReadBufPool pipelining,
    SURVEY.md C5/C6)."""
    R = block.n_reads
    lengths = block.lengths
    out = io.BytesIO()

    # --- duplicate-read tier: seq/qual back-references to the first
    #     identical earlier read in this block (CodecParams.dedup) ---
    sdup = qdup = None
    s_src = q_src = None
    if p.dedup and R > 1:
        s_src, q_src = dup_masks(block)
    if s_src is not None:
        sdup = s_src >= 0
    if q_src is not None:
        qdup = q_src >= 0
    n_sd = int(sdup.sum()) if sdup is not None else 0
    n_qd = int(qdup.sum()) if qdup is not None else 0
    sdup_sym = np.repeat(sdup, lengths) if n_sd else None

    # --- degenerate (non-ACGT) bases (reference: NDege*/Dege* streams) ---
    codes = _BASE_MAP[block.seq_flat]
    dege_mask = codes == 255
    if n_sd:
        # a seq-dup read is restored by copying its source read wholesale;
        # its degenerate bases must not double-code
        dege_mask &= ~sdup_sym
    n_dege = int(dege_mask.sum())
    dege_cnt = np.zeros(R, np.int64)
    dege_pos = np.zeros(0, np.int64)       # in-read positions of dege bases
    if n_dege:
        # per-degenerate-symbol coordinates via searchsorted over the few
        # dege positions (full (N,)-sized repeat arrays cost ~0.1 s/block)
        read_starts = np.cumsum(lengths) - lengths
        dege_idx = np.flatnonzero(dege_mask)
        dege_read = np.searchsorted(read_starts, dege_idx, side="right") - 1
        dege_pos = dege_idx - read_starts[dege_read]
        dege_cnt = np.bincount(dege_read, minlength=R).astype(np.int64)

    # --- quality vocabulary for this block (dense rank coding) ---
    from fastqueeze_tpu.pipeline.frozen import qual_lut, qual_vocab
    block_qvals, _ = qual_vocab(block.qual_flat)   # validates char range
    if frozen is not None:
        # rank space fixed by the trained tables; values unseen in
        # training get fresh ranks appended (fit_qual_alphabet pads the
        # frozen table with init rows for them)
        base = np.asarray(frozen["qvals"], np.uint8)
        extra = np.setdiff1d(block_qvals, base)
        qvals = np.concatenate([base, extra]) if len(extra) else base
    else:
        qvals = block_qvals
    lut = qual_lut(qvals)
    qsyms = lut[block.qual_flat]
    qmax = max(len(qvals) - 1, 0)

    mapped = align.mapped if align is not None else np.zeros(R, bool)
    if n_sd:
        # dedup beats the aligned streams on cost (a back-distance vs
        # pos+rev+mis streams); a read that is both stays a duplicate
        mapped = mapped & ~sdup
    n_mapped = int(mapped.sum())

    # --- long-read tier: mapped chunks of reads > align_max_len are
    #     reconstructed from the reference; their bases leave the
    #     residual seq stream (chunk grid is a pure function of lengths
    #     + params, so it costs zero structure bytes) ---
    lr = align.chunks if align is not None else None
    lr_sub = np.zeros(R, np.int64)        # mapped-chunk bases per read
    lr_cm = lr_keep = lr_excl = None
    if lr is not None and len(lr[0]) and not self_ref:
        lr_reads, lr_offs, lr_clens, lr_res = lr
        lr_keep = ~sdup[lr_reads] if n_sd else np.ones(len(lr_reads), bool)
        lr_cm = lr_res.mapped & lr_keep
        if lr_cm.any():
            np.add.at(lr_sub, lr_reads[lr_cm], lr_clens[lr_cm])
            rs = np.cumsum(lengths) - lengths
            cl = lr_clens[lr_cm]
            lr_excl = (np.repeat(rs[lr_reads[lr_cm]] + lr_offs[lr_cm], cl)
                       + _intra_of(cl))
        else:
            lr = None
    else:
        lr = None
    const_len = int(lengths[0]) if R and (lengths == lengths[0]).all() else None
    meta = {
        "R": R,
        "clen": const_len,
        "fnl": block.final_newline,
        "qmax": qmax,
        "qv": qvals.tolist(),
        "nd": n_dege,
        "nm": n_mapped,
    }
    if self_ref and n_mapped:
        meta["sref"] = 1

    # --- dispatch the big device streams first (seq + qual); host streams
    #     are coded while the device crunches, then the jobs are finalized
    adapt = frozen is None or bool(p.frozen_adapt)
    seq_keep = ~mapped & ~sdup if n_sd else ~mapped
    seq_counts = (lengths - dege_cnt - lr_sub)[seq_keep]
    seq_model = seq_model_from_params(p)
    qmodel = qual_model_for(p, _qual_alphabet(qmax))
    seq_sel = ~dege_mask
    if n_mapped:
        seq_sel &= ~np.repeat(mapped, lengths)
    if n_sd:
        seq_sel &= ~sdup_sym
    if lr_excl is not None:
        seq_sel[lr_excl] = False       # mapped chunks ride the ref
    seq_syms = codes[seq_sel]
    if n_qd:
        qsyms = qsyms[np.repeat(~qdup, lengths)]
        qlens = lengths[~qdup]
    else:
        qlens = lengths
    seq_job = qual_job = None
    if frozen is not None and not adapt:
        # host-native frozen coder (bit-identical bitstream; routing is an
        # execution choice — see ops/host_frozen.py)
        from fastqueeze_tpu.ops import host_frozen
        route_s = host_frozen.route(p, seq_model)
        route_q = host_frozen.route(p, qmodel)
        if route_s or route_q:
            from fastqueeze_tpu.pipeline.frozen import frozen_host_cums
            sc_cum, qc_cum = frozen_host_cums(frozen, qmodel.alphabet,
                                              p.qctx_eff_init())
            if route_s:
                seq_job = host_frozen.encode_job(seq_model, p, seq_syms,
                                                 seq_counts, sc_cum)
            if route_q:
                qual_job = host_frozen.encode_job(qmodel, p, qsyms,
                                                  qlens, qc_cum)
    if (seq_job is None or qual_job is None) and adapt and frozen is None:
        # host-native adaptive coder (bit-identical bitstream; routing is
        # an execution choice — see ops/host_adapt.py)
        from fastqueeze_tpu.ops import host_adapt
        if seq_job is None and host_adapt.route(p, seq_model):
            seq_job = host_adapt.encode_job(seq_model, p, seq_syms,
                                            seq_counts)
        if qual_job is None and host_adapt.route(p, qmodel):
            qual_job = host_adapt.encode_job(qmodel, p, qsyms, qlens)
    if seq_job is None or qual_job is None:
        sc0 = qc0 = None
        if frozen is not None:
            from fastqueeze_tpu.pipeline.frozen import frozen_dev_tables
            sc0, qc0 = frozen_dev_tables(frozen, qmodel.alphabet,
                                         p.qctx_eff_init())
        if seq_job is None:
            seq_job = encode_stream_job(seq_model, p, seq_syms, seq_counts,
                                        counts0=sc0, adapt=adapt)
        if qual_job is None:
            qual_job = encode_stream_job(qmodel, p, qsyms, qlens,
                                         counts0=qc0, adapt=adapt)

    # --- lengths (reference: encode_len_short/encode_len_long, SURVEY.md
    #     §2.1 — variable-width tiers; long reads (ONT/PacBio) take the
    #     4-byte tier instead of hard-failing) ---
    len_payload = None
    if const_len is None and R:
        lenb = _width_of(int(lengths.max()))
        if lenb != 2:
            meta["lenb"] = lenb
        len_payload = _code_le(p, lengths, lenb)

    # --- IDs (host binning; var fields coded on-device) ---
    schema, var_payload = analyze_ids(block.ids)
    id_sections = []
    if schema is not None:
        id_sections.append((TAG_IDSCHEMA, schema.to_json()))
        if var_payload:
            id_sections.append((TAG_IDVAR, _code_bytes(p, var_payload)))
    else:
        id_sections.append((TAG_IDRAW, _code_lines(p, block.ids, R)))

    # --- plus lines ---
    from fastqueeze_tpu.io.fastq import any_content
    plus_sections = []
    if any_content(block.plus):
        pschema, pvar = analyze_ids(block.plus)
        if pschema is not None:
            plus_sections.append((TAG_PLUSSCHEMA, pschema.to_json()))
            if pvar:
                plus_sections.append((TAG_PLUSVAR, _code_bytes(p, pvar)))
        else:
            plus_sections.append((TAG_PLUSRAW,
                                  _code_lines(p, block.plus, R)))

    # --- duplicate-tier streams ---
    def _dup_dist(d):
        """Distance payload: absolute or consecutive-delta (zigzag),
        whichever codes smaller — replicated inputs give near-constant
        distances whose deltas are ~all zero."""
        w_abs = _width_of(int(d.max()))
        pay_abs = _code_le(p, d, w_abs)
        dd = np.diff(d, prepend=0)
        zz = np.where(dd >= 0, 2 * dd, -2 * dd - 1)
        w_dl = _width_of(int(zz.max()))
        pay_dl = _code_le(p, zz, w_dl)
        if len(pay_dl) < len(pay_abs):
            return pay_dl, w_dl, 1
        return pay_abs, w_abs, 0

    dup_sections = []
    if n_sd:
        pay, w, dl = _dup_dist((np.arange(R, dtype=np.int64) - s_src)[sdup])
        meta["nsd"] = n_sd
        meta["sdb"] = w
        if dl:
            meta["sdd"] = 1
        dup_sections += [(TAG_SDUPF, _code_flags(p, sdup)),
                         (TAG_SDUPD, pay)]
    if n_qd:
        pay, w, dl = _dup_dist((np.arange(R, dtype=np.int64) - q_src)[qdup])
        meta["nqd"] = n_qd
        meta["qdb"] = w
        if dl:
            meta["qdd"] = 1
        dup_sections += [(TAG_QDUPF, _code_flags(p, qdup)),
                         (TAG_QDUPD, pay)]

    # --- degenerate streams ---
    dege_sections = []
    if n_dege:
        if int(dege_cnt.max()) > 0xFF:
            meta["degcb"] = _width_of(int(dege_cnt.max()))
            cnt_payload = _code_le(p, dege_cnt, meta["degcb"])
        else:
            cnt_payload = _code_bytes(
                p, dege_cnt.astype(np.uint8).tobytes(), order1=False)
        degpb = _width_of(int(dege_pos.max()) if len(dege_pos) else 0)
        degpb = max(degpb, 2)       # 2 is the historical default width
        if degpb != 2:
            meta["degpb"] = degpb
        pos_payload = _code_le(p, dege_pos, degpb)
        chr_payload = _code_bytes(
            p, block.seq_flat[dege_mask].tobytes(), order1=False)
        dege_sections = [(TAG_DEGCNT, cnt_payload), (TAG_DEGPOS, pos_payload),
                         (TAG_DEGCHR, chr_payload)]

    # --- alignment streams (reference: decomposeAlignInfo @0x433860,
    #     AlignInfoProcess @0x4118b0 — pos/rev/misCnt/misPos/misChar) ---
    align_sections = []
    if n_mapped:
        assert ref_codes is not None, "aligned encode needs ref_codes"
        align_sections = _encode_align_streams(
            p, block, align, ref_codes, mapped, meta)
    if align is not None:
        align_sections.insert(0, (TAG_AMAP, _code_flags(p, mapped)))
    if lr is not None:
        assert ref_codes is not None, "long-read tier needs ref_codes"
        align_sections += _encode_lr_streams(
            p, block, lr_reads, lr_offs, lr_clens, lr_res, lr_keep, lr_cm,
            ref_codes, meta)

    def finalize() -> bytes:
        # --- collect the device streams, assemble TLV ---
        seq_payload = seq_job.finalize()
        qual_payload = qual_job.finalize()
        out.write(write_tlv(TAG_META, json.dumps(meta).encode()))
        if len_payload is not None:
            out.write(write_tlv(TAG_LEN, len_payload))
        for tag, payload in (dup_sections + dege_sections + id_sections
                             + plus_sections + align_sections):
            out.write(write_tlv(tag, payload))
        out.write(write_tlv(TAG_SEQ, seq_payload))
        out.write(write_tlv(TAG_QUAL, qual_payload))
        if dbg is not None:
            # per-stream size table (reference printEncodeDebugInfo parity)
            nsym = int(lengths.sum())
            dbg.add("sz_seq", len(seq_payload))
            dbg.add("sz_qual", len(qual_payload))
            dbg.add("sz_len", len(len_payload) if len_payload else 0)
            dbg.add("sz_id", sum(len(x) for _, x in id_sections))
            dbg.add("sz_plus", sum(len(x) for _, x in plus_sections))
            dbg.add("sz_dege", sum(len(x) for _, x in dege_sections))
            dbg.add("sz_align", sum(len(x) for _, x in align_sections))
            dbg.add("sz_dup", sum(len(x) for _, x in dup_sections))
            dbg.add("dup_seq_reads", n_sd)
            dbg.add("dup_qual_reads", n_qd)
            dbg.add("raw_seq", nsym)
            dbg.add("raw_qual", nsym)
            cat = getattr(block.ids, "cat", None)   # LazyLines fast path:
            dbg.add("raw_id", len(cat) if cat is not None   # don't force R
                    else sum(len(i) for i in block.ids))    # bytes objects
        return out.getvalue()

    return finalize


def _encode_align_streams(p: CodecParams, block: FastqBlock, align,
                          ref_codes: np.ndarray, mapped: np.ndarray,
                          meta: Dict) -> list:
    """Mapped reads -> pos / rev / mis-count / mis-pos / mis-char streams."""
    lengths = block.lengths
    mlens = lengths[mapped]
    posb = max(1, (int(ref_codes.size).bit_length() + 7) // 8)
    mposb = _width_of(int(mlens.max()) if len(mlens) else 0)
    meta["posb"] = posb
    meta["mposb"] = mposb

    pos = align.pos[mapped]
    rev = align.is_rev[mapped]
    mm = align.mis_mask[mapped]                      # (M, lp) window coords
    mis_cnt = mm.sum(axis=1).astype(np.int64)

    # PE -I mode (reference: -I maxinsr, "mate position encoded as an
    # insert-bounded delta" — broken in the reference binary, SURVEY.md §6;
    # implemented correctly here): a mapped mate-2 whose mate-1 is mapped
    # and within max_insr is coded as a zigzag delta off mate-1's position.
    pe_sections = []
    abs_mask_m = np.ones(len(pos), bool)     # mapped reads coded absolutely
    R = block.n_reads
    if p.is_pe and p.max_insr > 0 and R:
        idx = np.arange(R)
        m1_mapped = np.zeros(R, bool)
        m1_mapped[1::2] = mapped[0::2]
        cand = mapped & (idx % 2 == 1) & m1_mapped
        pos1_of = np.zeros(R, np.int64)
        pos1_of[1::2] = align.pos[0::2]
        delta = align.pos - pos1_of
        ok = cand & (np.abs(delta) <= p.max_insr)
        if cand.any():
            cand_m = cand[mapped]
            ok_m = ok[mapped]
            pe_sections.append((TAG_APDF, _code_flags(p, ok_m[cand_m])))
            if ok.any():
                zz = delta[ok]
                zz = np.where(zz >= 0, 2 * zz, -2 * zz - 1)
                insb = max(1, (int(2 * p.max_insr + 1).bit_length() + 7)
                           // 8)
                meta["insb"] = insb
                pe_sections.append((TAG_APD, _code_le(p, zz, insb)))
            abs_mask_m = ~ok_m
    meta["nabs"] = int(abs_mask_m.sum())
    if mis_cnt.max(initial=0) > 255:
        raise ValueError(">255 mismatches in one read")

    # mismatch (read, window-col) pairs, row-major = per-read ascending
    rows, cols = np.nonzero(mm)
    # delta within read (first mismatch absolute)
    prev = np.empty_like(cols)
    prev[0:1] = 0
    prev[1:] = cols[:-1]
    first = np.empty(len(rows), bool)
    first[0:1] = True
    first[1:] = rows[1:] != rows[:-1]
    deltas = np.where(first, cols, cols - prev)

    # indel cigar streams (reference compressAlignInfo_CigaL/CigaV,
    # SURVEY.md §2.1): split s + signed gap g per flagged read, plus an
    # optional second op (s2, g2) — the reference BWA path's multi-op
    # stream generality.  Mismatch positions/chars stay in spliced-window
    # coords so those streams are untouched.
    g_m = s_m = g2_m = s2_m = None
    if align.gap_len is not None:
        g_all = align.gap_len[mapped].astype(np.int64)
        if (g_all != 0).any():
            g_m = g_all
            s_m = align.gap_pos[mapped].astype(np.int64)
            if align.gap_len2 is not None and (align.gap_len2 != 0).any():
                g2_m = align.gap_len2[mapped].astype(np.int64)
                s2_m = align.gap_pos2[mapped].astype(np.int64)

    # substituted base = effective-strand read base at the window col;
    # context = the spliced reference base it replaced (filler 0 under
    # insertions — mirrors the decode-side window build exactly)
    moffs = (np.cumsum(lengths) - lengths)[mapped]
    eff_col = np.where(rev[rows], mlens[rows] - 1 - cols, cols)
    read_base = _BASE_MAP[block.seq_flat[moffs[rows] + eff_col]]
    sub_base = np.where(rev[rows], 3 - read_base, read_base).astype(np.uint8)
    if g_m is None:
        # clip like the decode-side window build: self-ref windows may
        # overhang the reference end by up to max_mis force-masked bases
        # (every clipped base is flagged, so contexts stay bit-identical)
        ref_base = ref_codes[np.clip(pos[rows] + cols, 0,
                                     max(ref_codes.size - 1, 0))]
    else:
        shift = np.where(cols >= s_m[rows], g_m[rows], 0)
        ins = ((g_m[rows] < 0) & (cols >= s_m[rows])
               & (cols < s_m[rows] - g_m[rows]))
        if g2_m is not None:
            # second op: cumulative shift past s2, its own insertion filler
            shift = shift + np.where(cols >= s2_m[rows], g2_m[rows], 0)
            ins |= ((g2_m[rows] < 0) & (cols >= s2_m[rows])
                    & (cols < s2_m[rows] - g2_m[rows]))
        ridx = np.clip(pos[rows] + cols + shift, 0, ref_codes.size - 1)
        ref_base = np.where(ins, 0, ref_codes[ridx])

    sections = pe_sections + [
        (TAG_APOS, _code_le(p, pos[abs_mask_m], posb)),
        (TAG_AREV, _code_flags(p, rev)),
        (TAG_AMISC, _code_bytes(p, mis_cnt.astype(np.uint8).tobytes(),
                                order1=False)),
    ]
    if len(rows):
        sections.append((TAG_AMISP, _code_le(p, deltas, mposb)))
        sections.append((TAG_AMISB, _code_syms_ctx(
            p, sub_base, ref_base.astype(np.uint8), 4, 4)))
    if g_m is not None:
        has = g_m != 0
        meta["nidl"] = int(has.sum())
        gb = 1 if p.max_indel <= 127 else 2
        sections.append((TAG_ACIGF, _code_flags(p, has)))
        sections.append((TAG_ACIGS, _code_le(p, s_m[has], mposb)))
        zz = np.where(g_m[has] >= 0, 2 * g_m[has], -2 * g_m[has] - 1)
        # zigzag range is 2*max_indel; 1 byte only holds max_indel <= 127
        sections.append((TAG_ACIGL, _code_le(p, zz, gb)))
        if g2_m is not None and (g2_m[has] != 0).any():
            # second op streams, nested under the indel reads (pass 2
            # only ever extends a pass-1 indel, so g2 != 0 => g1 != 0)
            has2 = g2_m[has] != 0
            meta["nidl2"] = int(has2.sum())
            sections.append((TAG_ACG2F, _code_flags(p, has2)))
            sections.append((TAG_ACG2S, _code_le(p, s2_m[has][has2],
                                                 mposb)))
            z2 = np.where(g2_m[has][has2] >= 0, 2 * g2_m[has][has2],
                          -2 * g2_m[has][has2] - 1)
            sections.append((TAG_ACG2L, _code_le(p, z2, gb)))
    return sections


def _encode_lr_streams(p: CodecParams, block: FastqBlock, reads, offs,
                       clens, res, keep, cm, ref_codes: np.ndarray,
                       meta: Dict) -> list:
    """Long-read tier streams: mapped chunks -> flag / pos / rev /
    mismatch streams (the read-level stream shapes applied at chunk
    granularity; gap-free by construction — allow_indel=False)."""
    posb = max(1, (int(ref_codes.size).bit_length() + 7) // 8)
    pos = res.pos[cm]
    rev = res.is_rev[cm]
    mm = res.mis_mask[cm]
    cl = clens[cm]
    mis_cnt = mm.sum(axis=1).astype(np.int64)
    if mis_cnt.max(initial=0) > 255:
        raise ValueError(">255 mismatches in one chunk")
    mposb = _width_of(int(cl.max()) if len(cl) else 0)
    meta["lrm"] = int(cm.sum())
    meta["lrn"] = int(keep.sum())
    meta["lrposb"] = posb
    meta["lrpb"] = mposb

    rows, cols = np.nonzero(mm)
    prev = np.empty_like(cols)
    prev[0:1] = 0
    prev[1:] = cols[:-1]
    first = np.empty(len(rows), bool)
    first[0:1] = True
    first[1:] = rows[1:] != rows[:-1]
    deltas = np.where(first, cols, cols - prev)

    # chunk indels (longread_indel): same CigaL/CigaV shapes as the
    # read path, chunk granularity; mismatch coords stay in spliced-
    # window space
    g_m = s_m = g2_m = s2_m = None
    if res.gap_len is not None:
        g_all = res.gap_len[cm].astype(np.int64)
        if (g_all != 0).any():
            g_m = g_all
            s_m = res.gap_pos[cm].astype(np.int64)
            if (res.gap_len2 is not None
                    and (res.gap_len2[cm] != 0).any()):
                g2_m = res.gap_len2[cm].astype(np.int64)
                s2_m = res.gap_pos2[cm].astype(np.int64)

    rs = np.cumsum(block.lengths) - block.lengths
    coffs = (rs[reads] + offs)[cm]
    eff_col = np.where(rev[rows], cl[rows] - 1 - cols, cols)
    read_base = _BASE_MAP[block.seq_flat[coffs[rows] + eff_col]]
    sub_base = np.where(rev[rows], 3 - read_base,
                        read_base).astype(np.uint8)
    if g_m is None:
        ref_base = ref_codes[np.clip(pos[rows] + cols, 0,
                                     max(ref_codes.size - 1, 0))]
    else:
        shift = np.where(cols >= s_m[rows], g_m[rows], 0)
        ins = ((g_m[rows] < 0) & (cols >= s_m[rows])
               & (cols < s_m[rows] - g_m[rows]))
        if g2_m is not None:
            shift = shift + np.where(cols >= s2_m[rows], g2_m[rows], 0)
            ins |= ((g2_m[rows] < 0) & (cols >= s2_m[rows])
                    & (cols < s2_m[rows] - g2_m[rows]))
        ridx = np.clip(pos[rows] + cols + shift, 0, ref_codes.size - 1)
        ref_base = np.where(ins, 0, ref_codes[ridx])
    # position coding: consecutive mapped chunks of one read are nearly
    # contiguous in the reference (pos_j ~ pos_{j-1} +- (off_j -
    # off_{j-1}), sign by strand), so non-anchor chunks code a 2-byte
    # zigzag residual instead of a posb-byte absolute (the position
    # stream was ~40% of a HiFi long-read archive)
    M = len(pos)
    r_m = reads[cm]
    off_m = offs[cm]
    sgn = np.where(rev, -1, 1).astype(np.int64)
    prev_pos = np.zeros(M, np.int64)
    prev_off = np.zeros(M, np.int64)
    prev_rev = np.zeros(M, bool)
    same = np.zeros(M, bool)
    if M > 1:
        prev_pos[1:] = pos[:-1]
        prev_off[1:] = off_m[:-1]
        prev_rev[1:] = rev[:-1]
        same[1:] = r_m[1:] == r_m[:-1]
    step = sgn * (off_m - prev_off)
    delta = pos - (prev_pos + step)
    anchor = ~(same & (rev == prev_rev) & (np.abs(delta) < (1 << 15)))
    meta["lrna"] = int(anchor.sum())
    zz = delta[~anchor]
    zz = np.where(zz >= 0, 2 * zz, -2 * zz - 1)
    sections = [
        (TAG_LRF, _code_flags(p, cm[keep])),
        (TAG_LRPA, _code_flags(p, anchor)),
        (TAG_LRPOS, _code_le(p, pos[anchor], posb)),
        (TAG_LRREV, _code_flags(p, rev)),
        (TAG_LRMISC, _code_bytes(p, mis_cnt.astype(np.uint8).tobytes(),
                                 order1=False)),
    ]
    if (~anchor).any():
        sections.append((TAG_LRPD, _code_le(p, zz, 2)))
    if len(rows):
        sections.append((TAG_LRMISP, _code_le(p, deltas, mposb)))
        sections.append((TAG_LRMISB, _code_syms_ctx(
            p, sub_base, ref_base.astype(np.uint8), 4, 4)))
    if g_m is not None:
        has = g_m != 0
        meta["lrnidl"] = int(has.sum())
        gb = 1 if p.longread_indel <= 127 else 2
        sections.append((TAG_LRCIGF, _code_flags(p, has)))
        sections.append((TAG_LRCIGS, _code_le(p, s_m[has], mposb)))
        zzg = np.where(g_m[has] >= 0, 2 * g_m[has], -2 * g_m[has] - 1)
        sections.append((TAG_LRCIGL, _code_le(p, zzg, gb)))
        if g2_m is not None and (g2_m[has] != 0).any():
            has2 = g2_m[has] != 0
            meta["lrnidl2"] = int(has2.sum())
            sections.append((TAG_LRCG2F, _code_flags(p, has2)))
            sections.append((TAG_LRCG2S, _code_le(p, s2_m[has][has2],
                                                  mposb)))
            z2 = np.where(g2_m[has][has2] >= 0, 2 * g2_m[has][has2],
                          -2 * g2_m[has][has2] - 1)
            sections.append((TAG_LRCG2L, _code_le(p, z2, gb)))
    return sections


def _decode_lr_streams(p: CodecParams, sections: Dict, meta: Dict,
                       reads, offs, clens, cm, read_off,
                       ref_codes: np.ndarray, seq_flat: np.ndarray) -> None:
    """Reconstruct mapped long-read chunks from the reference (the
    chunk-level BitbufProcess analogue), writing ACGT bytes into
    seq_flat in place."""
    M = int(cm.sum())
    if not M:
        return
    posb = meta["lrposb"]
    mposb = meta["lrpb"]
    cl = clens[cm]
    coffs = (read_off[reads] + offs)[cm]
    rev = _decode_flags(p, sections[TAG_LRREV], M)
    # positions: anchors absolute, the rest per-segment residual cumsum
    # (inverse of the encoder's contiguity model)
    anchor = _decode_flags(p, sections[TAG_LRPA], M)
    n_anchor = int(anchor.sum())
    if n_anchor != meta.get("lrna", n_anchor) or (M and not anchor[0]):
        raise ValueError("corrupt block payload: LR pos anchors")
    pa = _decode_le(p, sections[TAG_LRPOS], n_anchor, posb)
    delta = np.zeros(M, np.int64)
    if n_anchor < M:
        zz = _decode_le(p, sections[TAG_LRPD], M - n_anchor, 2)
        delta[~anchor] = np.where(zz % 2 == 0, zz // 2, -((zz + 1) // 2))
    off_m = offs[cm]
    sgn = np.where(rev, -1, 1).astype(np.int64)
    step = np.zeros(M, np.int64)
    if M > 1:
        step[1:] = sgn[1:] * (off_m[1:] - off_m[:-1])
    inc = np.where(anchor, 0, step + delta)
    seg = np.cumsum(anchor) - 1                  # segment id per chunk
    cs = np.cumsum(inc)
    seg_first = np.flatnonzero(anchor)
    pos = pa[seg] + cs - cs[seg_first[seg]]
    cnt_raw = _decode_bytes(p, sections[TAG_LRMISC], order1=False)
    mis_cnt = np.frombuffer(cnt_raw, np.uint8).astype(np.int64)
    if len(mis_cnt) != M:
        raise ValueError("corrupt block payload: LR mismatch counts")
    n_mis = int(mis_cnt.sum())

    total = int(cl.sum())
    win_off = np.cumsum(cl) - cl
    sym_c = np.repeat(np.arange(M), cl)
    intra = np.arange(total, dtype=np.int64) - np.repeat(win_off, cl)
    if TAG_LRCIGF in sections:
        # chunk indels: spliced window (see _decode_align_streams)
        g_r = np.zeros(M, np.int64)
        s_r = np.zeros(M, np.int64)
        g2_r = np.zeros(M, np.int64)
        s2_r = np.zeros(M, np.int64)
        has = _decode_flags(p, sections[TAG_LRCIGF], M)
        nidl = int(has.sum())
        gb = 1 if p.longread_indel <= 127 else 2
        if nidl:
            s_r[has] = _decode_le(p, sections[TAG_LRCIGS], nidl, mposb)
            zzg = _decode_le(p, sections[TAG_LRCIGL], nidl, gb)
            g_r[has] = np.where(zzg % 2 == 0, zzg // 2,
                                -((zzg + 1) // 2))
            if TAG_LRCG2F in sections:
                has2_i = _decode_flags(p, sections[TAG_LRCG2F], nidl)
                nidl2 = int(has2_i.sum())
                has2 = np.zeros(M, bool)
                has2[np.flatnonzero(has)[has2_i]] = True
                s2_r[has2] = _decode_le(p, sections[TAG_LRCG2S], nidl2,
                                        mposb)
                z2 = _decode_le(p, sections[TAG_LRCG2L], nidl2, gb)
                g2_r[has2] = np.where(z2 % 2 == 0, z2 // 2,
                                      -((z2 + 1) // 2))
        g_sym, s_sym = g_r[sym_c], s_r[sym_c]
        g2_sym, s2_sym = g2_r[sym_c], s2_r[sym_c]
        shift = (np.where(intra >= s_sym, g_sym, 0)
                 + np.where(intra >= s2_sym, g2_sym, 0))
        widx = np.clip(np.repeat(pos, cl) + intra + shift, 0,
                       max(ref_codes.size - 1, 0))
        win = ref_codes[widx].copy()
        win[((g_sym < 0) & (intra >= s_sym) & (intra < s_sym - g_sym))
            | ((g2_sym < 0) & (intra >= s2_sym)
               & (intra < s2_sym - g2_sym))] = 0
    else:
        win = ref_codes[np.clip(np.repeat(pos, cl) + intra, 0,
                                max(ref_codes.size - 1, 0))].copy()
    if n_mis:
        deltas = _decode_le(p, sections[TAG_LRMISP], n_mis, mposb)
        rows = np.repeat(np.arange(M), mis_cnt)
        first_of = (np.cumsum(mis_cnt) - mis_cnt)[rows]
        cs = np.cumsum(deltas)
        seg = np.zeros(n_mis, np.int64)
        nz = first_of > 0
        seg[nz] = cs[first_of[nz] - 1]
        cols = cs - seg
        if (cols >= cl[rows]).any():
            raise ValueError("corrupt block payload: LR mismatch cols")
        ref_base = win[win_off[rows] + cols].copy()
        sub = _decode_syms_ctx(p, sections[TAG_LRMISB], n_mis,
                               ref_base.astype(np.uint8), 4, 4)
        win[win_off[rows] + cols] = sub
    src_intra = np.where(rev[sym_c], cl[sym_c] - 1 - intra, intra)
    val = win[win_off[sym_c] + src_intra]
    val = np.where(rev[sym_c], 3 - val, val)
    seq_flat[coffs[sym_c] + intra] = _BASE_INV[val]


def decode_block(p: CodecParams, payload: bytes,
                 frozen: Optional[Dict] = None,
                 ref_codes: Optional[np.ndarray] = None,
                 ctx_shard=None) -> FastqBlock:
    """Decode one block payload.  Any structural damage a corrupt payload
    can cause downstream (bad lengths -> out-of-range indexing, mangled
    meta JSON, impossible stream sizes) is converted to ValueError — the
    whole-block MD5 then reports it like every other corruption path.

    ctx_shard: device list — frozen qual decode runs with its table
    sharded over these devices (driver.decompress big-table mesh gate)."""
    try:
        return _decode_block_impl(p, payload, frozen, ref_codes, ctx_shard)
    except ValueError:
        raise
    except (IndexError, KeyError, OverflowError, TypeError,
            json.JSONDecodeError) as e:
        raise ValueError(f"corrupt block payload: {e!r}") from e


def _decode_block_impl(p: CodecParams, payload: bytes,
                       frozen: Optional[Dict],
                       ref_codes: Optional[np.ndarray],
                       ctx_shard=None) -> FastqBlock:
    sections = dict(iter_tlv(payload))
    meta = json.loads(sections[TAG_META].decode())
    R = meta["R"]
    n_dege = meta["nd"]
    qmax = meta["qmax"]
    n_mapped = meta.get("nm", 0)
    self_ref = bool(meta.get("sref", 0))
    if n_mapped and ref_codes is None and not self_ref:
        raise ValueError("archive was reference-aligned: decode needs the "
                         "reference FASTA")
    if meta.get("lrm", 0) and ref_codes is None:
        raise ValueError("archive has reference-mapped long-read chunks: "
                         "decode needs the reference FASTA")

    # --- lengths ---
    if meta["clen"] is not None:
        lengths = np.full(R, meta["clen"], np.int64)
    elif R:
        lengths = _decode_le(p, sections[TAG_LEN], R, meta.get("lenb", 2))
    else:
        lengths = np.zeros(0, np.int64)
    if R and (lengths.min() < 0 or int(lengths.sum()) > (1 << 33)):
        raise ValueError("corrupt block payload: implausible read lengths")

    # --- degenerate streams ---
    dege_cnt = np.zeros(R, np.int64)
    if n_dege:
        if "degcb" in meta:
            dege_cnt = _decode_le(p, sections[TAG_DEGCNT], R, meta["degcb"])
        else:
            cnt_raw = _decode_bytes(p, sections[TAG_DEGCNT], order1=False)
            dege_cnt = np.frombuffer(cnt_raw, np.uint8).astype(np.int64)
        dpos = _decode_le(p, sections[TAG_DEGPOS], n_dege,
                          meta.get("degpb", 2))
        dchr = np.frombuffer(
            _decode_bytes(p, sections[TAG_DEGCHR], order1=False), np.uint8)

    # --- map flags ---
    mapped = np.zeros(R, bool)
    if TAG_AMAP in sections:
        mapped = _decode_flags(p, sections[TAG_AMAP], R)

    # --- duplicate-tier back-references ---
    def _dup_refs(tag_f, tag_d, n_dup, width, delta):
        flags = _decode_flags(p, sections[tag_f], R)
        rows = np.flatnonzero(flags)
        if len(rows) != n_dup:
            raise ValueError("corrupt block payload: dup flag count")
        d = _decode_le(p, sections[tag_d], n_dup, width)
        if delta:
            dd = np.where(d % 2 == 0, d // 2, -((d + 1) // 2))
            d = np.cumsum(dd)
        src = rows - d
        if ((d <= 0).any() or (src < 0).any() or flags[src].any()
                or (lengths[src] != lengths[rows]).any()):
            raise ValueError("corrupt block payload: bad dup back-refs")
        return flags, rows, src

    n_sd = meta.get("nsd", 0)
    n_qd = meta.get("nqd", 0)
    sdup = np.zeros(R, bool)
    if n_sd:
        sdup, sd_rows, sd_src = _dup_refs(TAG_SDUPF, TAG_SDUPD, n_sd,
                                          meta["sdb"], meta.get("sdd", 0))
    qdup = np.zeros(R, bool)
    if n_qd:
        qdup, qd_rows, qd_src = _dup_refs(TAG_QDUPF, TAG_QDUPD, n_qd,
                                          meta["qdb"], meta.get("qdd", 0))

    # --- long-read tier: chunk grid + mapped-chunk flags (needed before
    #     the seq dispatch: mapped chunks' bases are not in the stream) ---
    lr_reads = lr_offs = lr_clens = lr_cm = None
    lr_sub = np.zeros(R, np.int64)
    if TAG_LRF in sections and p.longread_chunk and R:
        C = min(p.longread_chunk, p.align_max_len)
        lr_reads, lr_offs, lr_clens = _lr_grid(lengths, p.align_max_len, C,
                                               p.longread_tail_min)
        gkeep = ~sdup[lr_reads] if n_sd else np.ones(len(lr_reads), bool)
        nk = int(gkeep.sum())
        if nk != meta.get("lrn", nk):
            raise ValueError("corrupt block payload: LR chunk grid")
        flags = _decode_flags(p, sections[TAG_LRF], nk)
        lr_cm = np.zeros(len(lr_reads), bool)
        lr_cm[gkeep] = flags
        if int(lr_cm.sum()) != meta.get("lrm", -1):
            raise ValueError("corrupt block payload: LR mapped count")
        np.add.at(lr_sub, lr_reads[lr_cm], lr_clens[lr_cm])

    # --- dispatch device streams (seq + qual), then do host work ---
    adapt = frozen is None or bool(p.frozen_adapt)
    seq_counts = (lengths - dege_cnt - lr_sub)[~mapped & ~sdup]
    qlens = lengths[~qdup] if n_qd else lengths
    seq_model = seq_model_from_params(p)
    qmodel = qual_model_for(p, _qual_alphabet(qmax))
    seq_job = qual_job = None
    if frozen is not None and not adapt:
        from fastqueeze_tpu.ops import host_frozen
        route_s = host_frozen.route(p, seq_model)
        route_q = host_frozen.route(p, qmodel)
        if route_s or route_q:
            from fastqueeze_tpu.pipeline.frozen import frozen_host_cums
            sc_cum, qc_cum = frozen_host_cums(frozen, qmodel.alphabet,
                                              p.qctx_eff_init())
            if route_s:
                seq_job = host_frozen.decode_job(
                    seq_model, p, sections[TAG_SEQ], seq_counts, sc_cum)
            if route_q:
                qual_job = host_frozen.decode_job(
                    qmodel, p, sections[TAG_QUAL], qlens, qc_cum)
    if (seq_job is None or qual_job is None) and adapt and frozen is None:
        from fastqueeze_tpu.ops import host_adapt
        if seq_job is None and host_adapt.route(p, seq_model):
            seq_job = host_adapt.decode_job(seq_model, p, sections[TAG_SEQ],
                                            seq_counts)
        if qual_job is None and host_adapt.route(p, qmodel):
            qual_job = host_adapt.decode_job(qmodel, p, sections[TAG_QUAL],
                                             qlens)
    if seq_job is None or qual_job is None:
        sc0 = qc0 = None
        if frozen is not None:
            from fastqueeze_tpu.pipeline.frozen import frozen_dev_tables
            sc0, qc0 = frozen_dev_tables(frozen, qmodel.alphabet,
                                         p.qctx_eff_init())
        if seq_job is None:
            seq_job = decode_stream_job(
                seq_model, p, sections[TAG_SEQ], seq_counts,
                counts0=sc0, adapt=adapt)
        if qual_job is None:
            qual_job = decode_stream_job(qmodel, p, sections[TAG_QUAL],
                                         qlens, counts0=qc0, adapt=adapt,
                                         ctx_shard=ctx_shard)

    # --- sequence assembly (host) ---
    seq_flat = np.empty(int(lengths.sum()), np.uint8)
    read_off = np.cumsum(lengths) - lengths
    fill = np.zeros(len(seq_flat), bool)   # True where a byte is written
    if n_dege:
        dege_abs = np.repeat(read_off, dege_cnt) + dpos
        seq_flat[dege_abs] = dchr
        fill[dege_abs] = True
    if n_mapped:
        fill |= np.repeat(mapped, lengths)
    if n_sd:
        fill |= np.repeat(sdup, lengths)
    if lr_cm is not None and lr_cm.any():
        cl = lr_clens[lr_cm]
        spans = (read_off[lr_reads[lr_cm]] + lr_offs[lr_cm])
        fill[np.repeat(spans, cl) + _intra_of(cl)] = True
    acgt = seq_job.finalize()
    seq_flat[~fill] = _BASE_INV[acgt]
    if n_mapped:
        if self_ref:
            # rebuild the block's self-reference from the (now filled)
            # unmapped reads — identical to the encoder's construction
            # (pipeline/selfref.ref_eligible; zero side data)
            from fastqueeze_tpu.pipeline.selfref import ref_eligible
            rows = np.flatnonzero(ref_eligible(mapped, sdup, dege_cnt,
                                               lengths, p.seed_len))
            lr = lengths[rows]
            sel = np.repeat(read_off[rows], lr) + _intra_of(lr)
            # clip: eligible reads are ACGT in valid archives; corrupt
            # payloads must not drive out-of-range model contexts
            ref_codes = np.minimum(_BASE_MAP[seq_flat[sel]], 3)
        _decode_align_streams(p, sections, meta, mapped, lengths, read_off,
                              ref_codes, seq_flat)
    if lr_cm is not None and lr_cm.any():
        _decode_lr_streams(p, sections, meta, lr_reads, lr_offs, lr_clens,
                           lr_cm, read_off, ref_codes, seq_flat)
    if n_sd:
        # duplicate reads: one range copy from their (non-duplicate,
        # already filled) first occurrences
        _copy_read_ranges(seq_flat, read_off[sd_src], read_off[sd_rows],
                          lengths[sd_rows])

    # --- quality (ranks -> phred values via the block's vocabulary) ---
    qsyms = qual_job.finalize()
    if "qv" in meta and len(meta["qv"]):
        qv_chars = np.asarray(meta["qv"], np.uint8) + 33
        # clamp: a corrupt stream can decode the alphabet's round-up
        # padding ranks — garbage bytes here get caught by the block MD5
        qvals_dec = qv_chars[np.minimum(qsyms, len(qv_chars) - 1)]
    else:
        qvals_dec = (qsyms.astype(np.uint8) + 33)
    if n_qd:
        from fastqueeze_tpu.io import native
        qual_flat = np.empty(len(seq_flat), np.uint8)
        # unique reads' quals land at their read offsets (contiguous per
        # read), then duplicates copy from their first occurrences
        if not native.scatter(qvals_dec, read_off[~qdup], qlens, qual_flat):
            qual_flat[~np.repeat(qdup, lengths)] = qvals_dec
        _copy_read_ranges(qual_flat, read_off[qd_src], read_off[qd_rows],
                          lengths[qd_rows])
    else:
        qual_flat = qvals_dec

    # --- IDs ---
    if TAG_IDSCHEMA in sections:
        schema = IdBinSchema.from_json(sections[TAG_IDSCHEMA])
        var = (_decode_bytes(p, sections[TAG_IDVAR])
               if TAG_IDVAR in sections else b"")
        ids = reconstruct_ids(schema, R, var)
    else:
        ids = _decode_lines(p, sections[TAG_IDRAW], R)

    # --- plus lines ---
    if TAG_PLUSSCHEMA in sections:
        pschema = IdBinSchema.from_json(sections[TAG_PLUSSCHEMA])
        pvar = (_decode_bytes(p, sections[TAG_PLUSVAR])
                if TAG_PLUSVAR in sections else b"")
        plus = reconstruct_ids(pschema, R, pvar)
    elif TAG_PLUSRAW in sections:
        plus = _decode_lines(p, sections[TAG_PLUSRAW], R)
    else:
        plus = [b""] * R

    def _tot(lines):
        cat = getattr(lines, "cat", None)
        return len(cat) if cat is not None else sum(len(x) for x in lines)

    raw_len = (int(lengths.sum()) * 2 + _tot(ids) + _tot(plus) + 6 * R
               - (0 if meta["fnl"] else 1))
    return FastqBlock(n_reads=R, ids=ids, plus=plus, seq_flat=seq_flat,
                      qual_flat=qual_flat, lengths=lengths, raw_len=raw_len,
                      final_newline=meta["fnl"])


def _decode_align_streams(p: CodecParams, sections: Dict, meta: Dict,
                          mapped: np.ndarray, lengths: np.ndarray,
                          read_off: np.ndarray, ref_codes: np.ndarray,
                          seq_flat: np.ndarray) -> None:
    """Reconstruct mapped reads from the reference (SURVEY.md C16,
    srcfile:BitbufProcess.cpp decompressBitBufSE -> doGetSeq + RC + patch),
    writing ACGT bytes into seq_flat in place."""
    M = int(mapped.sum())
    posb, mposb = meta["posb"], meta["mposb"]
    mlens = lengths[mapped]
    moffs = read_off[mapped]

    nabs = meta.get("nabs", M)
    pos_abs = _decode_le(p, sections[TAG_APOS], nabs, posb)
    if TAG_APDF in sections:
        # PE -I: reconstruct delta-coded mate-2 positions off mate-1's
        R = len(mapped)
        idx = np.arange(R)
        m1_mapped = np.zeros(R, bool)
        m1_mapped[1::2] = mapped[0::2]
        cand = mapped & (idx % 2 == 1) & m1_mapped
        cand_m = cand[mapped]
        okflags = _decode_flags(p, sections[TAG_APDF], int(cand_m.sum()))
        ok_m = np.zeros(M, bool)
        ok_m[cand_m] = okflags
        m_idx = np.flatnonzero(mapped)
        pos_r = np.zeros(R, np.int64)
        pos_r[m_idx[~ok_m]] = pos_abs
        n_delta = int(ok_m.sum())
        if n_delta:
            zz = _decode_le(p, sections[TAG_APD], n_delta, meta["insb"])
            delta = np.where(zz % 2 == 0, zz // 2, -((zz + 1) // 2))
            ok_reads = m_idx[ok_m]
            pos_r[ok_reads] = pos_r[ok_reads - 1] + delta
        pos = pos_r[mapped]
    else:
        pos = pos_abs
    rev = _decode_flags(p, sections[TAG_AREV], M)
    cnt_raw = _decode_bytes(p, sections[TAG_AMISC], order1=False)
    mis_cnt = np.frombuffer(cnt_raw, np.uint8).astype(np.int64)
    n_mis = int(mis_cnt.sum())

    # fetch window codes (host gather — the doGetSeq equivalent)
    total = int(mlens.sum())
    win_off = np.cumsum(mlens) - mlens
    sym_read = np.repeat(np.arange(M), mlens)
    intra = np.arange(total, dtype=np.int64) - np.repeat(win_off, mlens)
    if TAG_ACIGF in sections:
        # indel reads: spliced window — ref[pos+i] for i < s, then
        # ref[pos+g+i]; filler 0 over inserted read bases (their actual
        # values arrive through the ordinary mismatch patches).  An
        # optional second op (s2, g2) applies the cumulative shift g+g2
        # past s2 with its own insertion filler (multi-op CigaL/CigaV).
        g_r = np.zeros(M, np.int64)
        s_r = np.zeros(M, np.int64)
        g2_r = np.zeros(M, np.int64)
        s2_r = np.zeros(M, np.int64)
        has = _decode_flags(p, sections[TAG_ACIGF], M)
        nidl = int(has.sum())
        gb = 1 if p.max_indel <= 127 else 2
        if nidl:
            s_r[has] = _decode_le(p, sections[TAG_ACIGS], nidl, mposb)
            zz = _decode_le(p, sections[TAG_ACIGL], nidl, gb)
            g_r[has] = np.where(zz % 2 == 0, zz // 2, -((zz + 1) // 2))
            if TAG_ACG2F in sections:
                has2_i = _decode_flags(p, sections[TAG_ACG2F], nidl)
                nidl2 = int(has2_i.sum())
                has2 = np.zeros(M, bool)
                has2[np.flatnonzero(has)[has2_i]] = True
                s2_r[has2] = _decode_le(p, sections[TAG_ACG2S], nidl2,
                                        mposb)
                z2 = _decode_le(p, sections[TAG_ACG2L], nidl2, gb)
                g2_r[has2] = np.where(z2 % 2 == 0, z2 // 2,
                                      -((z2 + 1) // 2))
        g_sym, s_sym = g_r[sym_read], s_r[sym_read]
        g2_sym, s2_sym = g2_r[sym_read], s2_r[sym_read]
        shift = (np.where(intra >= s_sym, g_sym, 0)
                 + np.where(intra >= s2_sym, g2_sym, 0))
        widx = np.clip(np.repeat(pos, mlens) + intra + shift, 0,
                       ref_codes.size - 1)
        win = ref_codes[widx].copy()
        win[((g_sym < 0) & (intra >= s_sym) & (intra < s_sym - g_sym))
            | ((g2_sym < 0) & (intra >= s2_sym)
               & (intra < s2_sym - g2_sym))] = 0
    else:
        # clip like the indel path: self-ref windows may overhang the
        # reference edges by up to max_mis bases (anchored matches with
        # the overhang force-masked — every clipped base is patched)
        win = ref_codes[np.clip(np.repeat(pos, mlens) + intra, 0,
                                max(ref_codes.size - 1, 0))].copy()

    if n_mis:
        deltas = _decode_le(p, sections[TAG_AMISP], n_mis, mposb)
        rows = np.repeat(np.arange(M), mis_cnt)
        # undo within-read delta coding: segmented cumsum of deltas
        first_of_read = (np.cumsum(mis_cnt) - mis_cnt)[rows]
        cs = np.cumsum(deltas)
        seg_start = np.zeros(n_mis, np.int64)
        nz = first_of_read > 0
        seg_start[nz] = cs[first_of_read[nz] - 1]
        cols = cs - seg_start
        ref_base = win[win_off[rows] + cols].copy()
        sub = _decode_syms_ctx(p, sections[TAG_AMISB], n_mis,
                               ref_base.astype(np.uint8), 4, 4)
        win[win_off[rows] + cols] = sub

    # orient: reverse-complement where rev, then place into seq_flat
    src_intra = np.where(rev[sym_read], mlens[sym_read] - 1 - intra, intra)
    val = win[win_off[sym_read] + src_intra]
    val = np.where(rev[sym_read], 3 - val, val)
    seq_flat[moffs[sym_read] + intra] = _BASE_INV[val]
