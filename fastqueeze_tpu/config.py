"""Codec configuration.

The reference (SeqArc v1.6) takes coder-shaping parameters from a developer
config file ``./seqarc.config`` (SURVEY.md §5: BlockSize(M), Slevel, Qlevel,
Seedlen, Maxmis, ...) but — pitfall — never serializes them into the archive,
so decoding with a different config crashes.  Here *every* parameter that
shapes the bitstream is part of :class:`CodecParams` and is written into the
container's PARAM section verbatim; the decoder always codes with the params
read from the archive.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

# rANS numerics — fixed by the format version, not tunable per archive.
PROB_BITS = 14            # quantized frequency precision (total = 2**14)
RANS_M = 1 << PROB_BITS
RANS_L = 1 << 16          # state lower bound; emission unit = 16-bit word
MAGIC = b"FQZTPU01"

# fqzcomp's sequence-context start value (SURVEY.md §2.1, reference
# EncapFqzComp encode_seq @0x421f30 resets ctx to 0x007616C7 & NS_MASK).
SEQ_CTX_START = 0x007616C7


@dataclass
class CodecParams:
    """Everything that shapes the compressed bitstream.

    Mirrors the reference's ``seqarc.config`` keys (SURVEY.md §5) plus the
    wave-engine parameters that have no reference equivalent.
    """

    # --- block pipeline (reference: BlockSize(M):50, -t threads) ---
    block_size_mb: int = 50
    block_bytes: int = 0           # exact block cut in bytes (0 = use MB);
                                   # sub-MB blocks for tests/tuning
    threads: int = 1               # host worker threads (blocks in flight)
    mesh_n: int = 0                # block-DP over a device mesh: 0 = off,
                                   # -1 = all devices, N = first N devices.
                                   # Does NOT shape the bitstream (payloads
                                   # are device-count invariant, like -t)

    # --- duplicate-read tier (no reference equivalent): a read whose
    #     sequence (or quality string) is byte-identical to an earlier
    #     read in the same block is coded as a back-reference instead of
    #     re-coding its symbols.  Real-world hook: PCR/optical duplicates
    #     (identical sequence, usually different qualities) and replicated
    #     inputs.  Per-block and deterministic, so -t/--mesh invariance
    #     holds; costs one hash pass when the block has no duplicates. ---
    dedup: int = 1

    # --- self-referential alignment (-S; no reference equivalent): each
    #     block's mapped reads code against a reference assembled from
    #     the block's OWN unique unmapped reads — decode rebuilds it from
    #     the seq stream, so no FASTA is needed on either side.  SPRING-
    #     class gains on high-coverage / near-duplicate data.
    #     -1 = auto (default): a per-file probe on the first block enables
    #     it only when the projected aligned stream beats the context
    #     model (pipeline/selfref.py auto_self_align); 1 = force on (-S),
    #     0 = force off.  Decode never reads this (per-block sref flag). ---
    self_align: int = -1

    # --- sequence model (reference: Slevel:3 → order = Slevel+7) ---
    slevel: int = 3                 # context order = slevel + 7 (2 bits/base)
    seq_init: int = 3               # per-symbol initial count
    seq_inc: int = 1                # count increment per coded symbol
    seq_cap: int = 253              # halve row when total exceeds cap

    # --- quality model (reference: Qlevel:2, 2^16 contexts) ---
    qlevel: int = 2
    qmax: int = 63                  # alphabet = qmax + 1 (set from data scan)
    qual_init: int = 1
    qual_inc: int = 8
    qual_cap: int = 8192
    q_drop_init: int = 5            # fqzcomp Σdrops starts at 5

    # --- quality context scheme (wave engine; no reference equivalent).
    #     The engine codes dense quality RANKS, so for small trained
    #     alphabets exact conditioning on the last k ranks beats the
    #     fqzcomp bit-mash formula.  Chosen data-driven at frozen-train
    #     time (pipeline/frozen.py _pick_qctx) by comparing trained-table
    #     NLL + serialized-table size; 0 = fqz formula (always used for
    #     adaptive/non-usemodel archives). ---
    qctx_auto: int = 1              # 0 disables the train-time selection
    qctx_k: int = 0                 # rank-chain order (>=2) or 0 = fqz
    qctx_base: int = 0              # rank base B the chain is packed in
    qctx_drop_bits: int = 0         # low bits: min(drops>>3, 2^b - 1)
    qctx_pos_bits: int = 0          # low bits: min(pos>>4, 2^b - 1)
    qctx_hash_bits: int = 0         # >0: Knuth-hash the chain to 2^b rows
                                    # (uint32 wrap, identical on device/C)
    qctx_init: int = 0              # frozen qual-table pseudo-count
                                    # (0 = inherit qual_init); the train-
                                    # time selection tunes this too
    qctx_inc: int = 0               # frozen qual-table count weight
                                    # (0 = inherit qual_inc)

    # --- generic byte / flag models ---
    byte_init: int = 1
    byte_inc: int = 16
    byte_cap: int = 8192

    # --- lossy quality transform (reference: -l FACTOR, R-Block) ---
    lossy_factor: float = 0.0       # 0 = lossless

    # --- alignment (reference: Seedlen:14, Maxmis:7, Bothstrands, Maxinsr) ---
    seed_len: int = 14
    max_mis: int = 7
    both_strands: int = 0
    max_insr: int = 0
    seed_max_occ: int = 64          # tier-1: candidates verified per read
    seed_big_occ: int = 1024        # tier-2 (unmapped rescue) candidate cap
    rescue_seeds: int = 6           # tier-2: spatially diverse seeds tried
    seed_excl_bp: int = 7           # tier-2: +-bp masked around each pick
    seed_drop_occ: int = 65536      # build-time drop: hyper-repetitive seeds
    seed_stride: int = 2            # sample read seeds every N bp
    seed_probe_k: int = 16          # tier-1 probe prefilter: full-verify
                                    # only the K best candidates by 2-word
                                    # probe mismatches (0 = verify all;
                                    # decode never re-aligns, so this only
                                    # trades encode speed vs map rate —
                                    # measured no map-count change at 16 on
                                    # the bundled telomeric data)
    max_indel: int = 0              # one-indel rescue tier: max gap size in
                                    # bp (0 = gapless only, the hash-path
                                    # default; -q enables 3 — the BWA
                                    # path's CigaL/CigaV capability)
    indel_ops: int = 2              # max gap operations per read (1 or 2;
                                    # 2 = greedy second split when one op
                                    # cannot reach max_mis — the reference
                                    # BWA path's multi-op CigaL/CigaV
                                    # stream generality)
    align_max_len: int = 2048       # reads longer than this skip the
                                    # per-read gapless aligner (no
                                    # lp-bucket grid blowup on ONT/PacBio
                                    # inputs); they take the chunked
                                    # long-read tier instead
    longread_chunk: int = 1024      # long-read tier: reads >
                                    # align_max_len are anchor-mapped in
                                    # chunks of this many bases through
                                    # the ordinary aligner (gap-free;
                                    # chunks an indel straddles stay in
                                    # the residual entropy stream).  0
                                    # disables the tier.  No reference
                                    # equivalent (SeqArc is
                                    # short-read-only).
    longread_tail_min: int = 64     # a long read's final remainder chunk
                                    # shorter than this stays in the
                                    # residual stream (shapes the decode-
                                    # side chunk grid, hence serialized)
    longread_indel: int = 3         # gap budget for long-read chunks
                                    # (independent of the read-level -q
                                    # max_indel): real HiFi carries
                                    # ~1e-4/bp homopolymer indels, so a
                                    # 1024-base chunk has ~10% chance of
                                    # one — the <=indel_ops-op tier
                                    # recovers those chunks
    shm_index: int = 0              # -s: mmap the index (page cache shared
                                    # across processes; reference: POSIX shm)
    min_map_ratio: float = 0.25     # block falls back to entropy-only below

    # --- reference-aligned mode (set when compressing with a reference;
    #     decode rejects a wrong/missing reference via these, fixing the
    #     reference's segfault-y behavior) ---
    aligned: int = 0
    ref_md5: str = ""
    ref_len: int = 0

    # --- frozen-model mode (reference: usemodel) ---
    use_model: int = 0              # 0=auto, 1=force on, -1=force off
    model_train_mb: int = 34        # prefix size used to train frozen models
    frozen_adapt: int = 0           # 0 = code against the frozen snapshot
                                    # (reference semantics; no wave scan on
                                    # encode); 1 = keep adapting per block

    # --- stream routing: streams with <= this many symbols are coded by
    #     the native host range coder, bigger ones by the wave-rANS coder.
    #     It picks the coder, so it shapes the bitstream (serialized in
    #     PARAM); the value dates from a slow device link and is not yet
    #     re-measured on a directly attached GPU ---
    host_stream_max: int = 1 << 20

    # --- frozen-coder execution backend (never shapes the bitstream: the
    #     native host coder in native/frozenwave.cpp is bit-identical to
    #     the device kernels).  0 = auto (device on an accelerator backend
    #     or under --mesh, host on a CPU backend; ops/host_frozen.auto_host),
    #     1 = force host, 2 = force device.  Env
    #     FASTQUEEZE_FROZEN_EXEC=host|device overrides. ---
    frozen_exec: int = 0

    # --- semi-adaptive chunking (wave engine; no reference equivalent):
    #     adaptive streams requantize their tables every adapt_chunk waves,
    #     making the per-symbol walk one packed gather (frozen-path cost)
    #     instead of a full model-row gather.  0 = per-wave adaptation
    #     (default; for the big-context seq/qual models the full-table
    #     requant at chunk boundaries is the larger cost). ---
    adapt_chunk: int = 0

    # --- lane policy (wave engine; no reference equivalent).  More lanes =
    #     fewer sequential waves, but 4 B/lane of stored coder state.  The
    #     cap is inherited, not yet tuned for a GPU ---
    lanes_min: int = 64
    lanes_max: int = 4096
    lane_target_symbols: int = 4096  # aim ~this many symbols per lane

    # --- paired-end ---
    is_pe: int = 0

    # --- multi-file archive (reference: -m, SURVEY.md §5) ---
    multi: int = 0

    def seq_order(self) -> int:
        return self.slevel + 7

    def seq_nctx(self) -> int:
        return 1 << (2 * self.seq_order())

    def seq_ctx_mask(self) -> int:
        return self.seq_nctx() - 1

    def qctx_eff_init(self) -> int:
        """Pseudo-count used to train/pad the frozen qual table."""
        return self.qctx_init or self.qual_init

    def qctx_eff_inc(self) -> int:
        return self.qctx_inc or self.qual_inc

    def qual_nctx(self) -> int:
        if self.qctx_k >= 2:
            rows = ((1 << self.qctx_hash_bits) if self.qctx_hash_bits
                    else self.qctx_base ** self.qctx_k)
            return rows << (self.qctx_drop_bits + self.qctx_pos_bits)
        return (1 << 20) if self.qlevel >= 3 else (1 << 16)

    def qual_alphabet(self) -> int:
        return self.qmax + 1

    def n_lanes(self, n_symbols: int) -> int:
        """Per-stream lane count: ~lane_target_symbols per lane, pow2-clamped."""
        want = max(1, n_symbols // self.lane_target_symbols)
        nl = 1
        while nl < want:
            nl <<= 1
        return max(self.lanes_min, min(self.lanes_max, nl))

    # --- developer config file (reference: ./seqarc.config, SURVEY.md §5;
    #     keys below mirror its spelling).  Unlike the reference, every
    #     parameter also lands in the archive, so decoding never needs the
    #     file (the reference crashes without it — fixed pitfall).
    _CONFIG_KEYS = {
        "BlockSize(M)": "block_size_mb",
        "Slevel": "slevel",
        "Qlevel": "qlevel",
        "Seedlen": "seed_len",
        "Maxmis": "max_mis",
        "Bothstrands": "both_strands",
        "Maxinsr": "max_insr",
        "Maxindel": "max_indel",
        "Indelops": "indel_ops",
        "Threads": "threads",
        "Mesh": "mesh_n",
        "SeedMaxOcc": "seed_max_occ",
        "SeedBigOcc": "seed_big_occ",
        "RescueSeeds": "rescue_seeds",
        "SeedExclBp": "seed_excl_bp",
        "SeedStride": "seed_stride",
        "Usemodel": "use_model",
        "Dedup": "dedup",
        "SelfAlign": "self_align",
        "Qctx": "qctx_auto",
        "ModelTrain(M)": "model_train_mb",
        "HostStreamMax": "host_stream_max",
        "AdaptChunk": "adapt_chunk",
    }

    def apply_config_file(self, path: str = "./fastqueeze.config") -> bool:
        import os
        if not os.path.exists(path):
            return False
        with open(path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line or ":" not in line:
                    continue
                key, val = line.split(":", 1)
                attr = self._CONFIG_KEYS.get(key.strip())
                if attr is not None:
                    setattr(self, attr, int(val.strip()))
        return True

    def dump_config_file(self, path: str = "./fastqueeze.config") -> str:
        with open(path, "w") as fh:
            fh.write("# fastqueeze developer config "
                     "(reference: seqarc.config)\n")
            for key, attr in self._CONFIG_KEYS.items():
                fh.write(f"{key}:{getattr(self, attr)}\n")
        return path

    # --- serialization (into the container PARAM section) ---
    def to_bytes(self) -> bytes:
        d = dataclasses.asdict(self)
        return json.dumps(d, sort_keys=True).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "CodecParams":
        d = json.loads(raw.decode())
        known = {f.name for f in dataclasses.fields(cls)}
        p = cls(**{k: v for k, v in d.items() if k in known})
        p.validate_untrusted()
        return p

    # Bounds for every parameter that sizes an allocation or drives a
    # native loop.  An archive's PARAM section is untrusted input: a
    # hostile qctx_hash_bits=40 would otherwise allocate a 2^40-row
    # model table at decode time instead of failing cleanly.
    _BOUNDS = {
        "slevel": (0, 9),           # seq order = slevel + 7 <= 16 (u32 reg)
        "qlevel": (1, 3),
        "qmax": (0, 255),
        "qctx_k": (0, 8),           # native QualM keeps 8 ranks
        "qctx_base": (0, 256),
        "qctx_drop_bits": (0, 8),
        "qctx_pos_bits": (0, 8),
        "qctx_hash_bits": (0, 24),
        "qctx_init": (0, 1 << 14),
        "qctx_inc": (0, 1 << 14),
        "seq_init": (1, 1 << 14),
        "seq_inc": (0, 1 << 14),
        "seq_cap": (4, 1 << 14),    # quantization needs cap <= M = 2^14
        "qual_init": (1, 1 << 14),
        "qual_inc": (0, 1 << 14),
        "qual_cap": (4, 1 << 14),
        "q_drop_init": (0, 1 << 16),
        "byte_init": (1, 1 << 14),
        "byte_inc": (0, 1 << 14),
        "byte_cap": (4, 1 << 14),
        "seed_len": (4, 31),
        "max_mis": (0, 255),
        "max_insr": (0, 1 << 24),
        "max_indel": (0, 255),
        "indel_ops": (1, 2),
        "align_max_len": (32, 1 << 20),
        "longread_chunk": (0, 1 << 16),
        "longread_indel": (0, 127),
        "longread_tail_min": (1, 1 << 16),
        "lanes_min": (1, 1 << 16),
        "lanes_max": (1, 1 << 16),
        "lane_target_symbols": (1, 1 << 30),
        "adapt_chunk": (0, 1 << 20),
        "block_size_mb": (1, 1 << 12),
        "ref_len": (0, (1 << 48)),
    }

    def validate_untrusted(self) -> None:
        """Range-check parameters arriving from an archive (or any other
        untrusted source); raises ValueError naming the bad field."""
        for name, (lo, hi) in self._BOUNDS.items():
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) \
                    or not lo <= v <= hi:
                raise ValueError(
                    f"corrupt archive: parameter {name}={v!r} outside "
                    f"[{lo}, {hi}]")
        if self.qctx_k >= 2 and not 2 <= self.qctx_base <= 256:
            raise ValueError(
                "corrupt archive: qctx_base must be in [2, 256] when a "
                "rank chain is selected")
        if self.qual_nctx() > (1 << 28):
            raise ValueError("corrupt archive: quality model too large")
