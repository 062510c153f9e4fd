"""Host-side serial adaptive range coder for small streams.

Bit-identical twin of native/rangecoder.cpp (role parity: the reference's
per-symbol range coder + SIMPLE_MODEL, SURVEY.md §2.1).  Small per-block
streams (flags, lengths, ID bytes, mismatch metadata) are coded on the host
(CodecParams.host_stream_max picks the coder, so it is part of the
format); big streams go through the wave-rANS engine.

The native C++ implementation is used when available; this module holds the
pure-Python mirror (used as fallback and as the oracle in the cross tests)
plus the dispatch layer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from fastqueeze_tpu.io import native

_TOP = 1 << 24
_M32 = 0xFFFFFFFF


class _Model:
    __slots__ = ("counts", "totals", "A", "inc", "cap")

    def __init__(self, n_ctx: int, alphabet: int, init: int, inc: int,
                 cap: int):
        self.counts = np.full((n_ctx, alphabet), init, np.uint32)
        self.totals = np.full(n_ctx, init * alphabet, np.uint32)
        self.A = alphabet
        self.inc = inc
        self.cap = cap

    def update(self, ctx: int, sym: int) -> None:
        row = self.counts[ctx]
        row[sym] += self.inc
        t = int(self.totals[ctx]) + self.inc
        if t > self.cap:
            np.add(row, 1, out=row)
            np.right_shift(row, 1, out=row)
            t = int(row.sum())
        self.totals[ctx] = t


class _REnc:
    def __init__(self):
        self.low = 0
        self.range = _M32
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self):
        if (self.low & _M32) < 0xFF000000 or (self.low >> 32):
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            self.cache_size -= 1
            while self.cache_size:
                self.out.append((0xFF + carry) & 0xFF)
                self.cache_size -= 1
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & _M32

    def encode(self, start: int, size: int, total: int):
        r = self.range // total
        self.low += start * r
        self.range = size * r
        while self.range < _TOP:
            self._shift_low()
            self.range = (self.range << 8) & _M32

    def flush(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class _RDec:
    def __init__(self, data: bytes):
        self.range = _M32
        self.data = data
        self.pos = 1                      # first encoder byte is always 0
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._get()) & _M32

    def _get(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def decode_freq(self, total: int):
        r = self.range // total
        v = self.code // r
        return (total - 1 if v >= total else v), r

    def decode_update(self, start: int, size: int, r: int):
        self.code = (self.code - start * r) & _M32
        self.range = size * r
        while self.range < _TOP:
            self.code = ((self.code << 8) | self._get()) & _M32
            self.range = (self.range << 8) & _M32


def _py_encode_ctx(syms, ctx, n_ctx, alphabet, init, inc, cap) -> bytes:
    m = _Model(n_ctx, alphabet, init, inc, cap)
    enc = _REnc()
    zero = np.zeros(len(syms), np.uint32)
    cx = ctx if ctx is not None else zero
    for s, c in zip(syms.tolist(), cx.tolist()):
        row = m.counts[c]
        start = int(row[:s].sum())
        enc.encode(start, int(row[s]), int(m.totals[c]))
        m.update(c, s)
    return enc.flush()


def _py_decode_ctx(data, n, ctx, n_ctx, alphabet, init, inc, cap):
    m = _Model(n_ctx, alphabet, init, inc, cap)
    dec = _RDec(data)
    out = np.empty(n, np.uint8)
    cx = ctx if ctx is not None else np.zeros(n, np.uint32)
    for i in range(n):
        c = int(cx[i])
        row = m.counts[c]
        f, r = dec.decode_freq(int(m.totals[c]))
        start = 0
        s = 0
        while start + int(row[s]) <= f:
            start += int(row[s])
            s += 1
        dec.decode_update(start, int(row[s]), r)
        out[i] = s
        m.update(c, s)
    return out


def _py_encode_o1(syms, alphabet, init, inc, cap) -> bytes:
    m = _Model(alphabet, alphabet, init, inc, cap)
    enc = _REnc()
    prev = 0
    for s in syms.tolist():
        row = m.counts[prev]
        start = int(row[:s].sum())
        enc.encode(start, int(row[s]), int(m.totals[prev]))
        m.update(prev, s)
        prev = s
    return enc.flush()


def _py_decode_o1(data, n, alphabet, init, inc, cap):
    m = _Model(alphabet, alphabet, init, inc, cap)
    dec = _RDec(data)
    out = np.empty(n, np.uint8)
    prev = 0
    for i in range(n):
        row = m.counts[prev]
        f, r = dec.decode_freq(int(m.totals[prev]))
        start = 0
        s = 0
        while start + int(row[s]) <= f:
            start += int(row[s])
            s += 1
        dec.decode_update(start, int(row[s]), r)
        out[i] = s
        m.update(prev, s)
        prev = s
    return out


# --- fallback name coder (reference encode_name @0x421070 parity, SURVEY.md
#     §2.1 path 2): fqzcomp-style TOKENIZED diffing vs the previous name.
#     Bit-identical mirror of native rc_encode_names/rc_decode_names; see
#     native/rangecoder.cpp for the full context design. ---
_NAME_TOK_MAX = 32
_NAME_TERM = 10                    # '\n'
_REL_BASE = 0                      # 32*4 relation rows
_DELTA_BASE = _REL_BASE + _NAME_TOK_MAX * 4
_CHAR_BASE = _DELTA_BASE + _NAME_TOK_MAX
_NAME_NCTX = _CHAR_BASE + _NAME_TOK_MAX * 256
_MAX_TOKS = 256


def _is_alnum(c: int) -> bool:
    return 0x30 <= c <= 0x39 or 0x41 <= c <= 0x5A or 0x61 <= c <= 0x7A


def _name_tokenize(s: bytes):
    """-> list of (start, length, is_digit, canon, value).  Tokens are
    maximal ALNUM runs (hash/base36 fields stay single tokens so later
    tokens keep index alignment) or single other-chars; all-digit runs
    carry their value for DELTA coding.  Mirror of native name_tokenize."""
    toks = []
    i, L = 0, len(s)
    while i < L and len(toks) < _MAX_TOKS:
        if _is_alnum(s[i]):
            j = i
            v = 0
            all_digit = True
            while j < L and _is_alnum(s[j]):
                if 0x30 <= s[j] <= 0x39:
                    v = v * 10 + (s[j] - 0x30)
                else:
                    all_digit = False
                j += 1
            ln = j - i
            canon = all_digit and ln <= 18 and (s[i] != 0x30 or ln == 1)
            toks.append((i, ln, all_digit, canon, v if all_digit else 0))
            i = j
        else:
            toks.append((i, 1, False, False, 0))
            i += 1
    if i < L and len(toks) == _MAX_TOKS:
        st = toks[-1][0]
        toks[-1] = (st, L - st, False, False, 0)
    return toks


def _py_encode_names(cat, lens, init, inc, cap) -> bytes:
    m = _Model(_NAME_NCTX, 256, init, inc, cap)
    enc = _REnc()

    def code(cx, s):
        row = m.counts[cx]
        start = int(row[:s].sum())
        enc.encode(start, int(row[s]), int(m.totals[cx]))
        m.update(cx, s)

    prev = b""
    ptoks = []
    off = 0
    cat_b = bytes(cat)
    for L in lens.tolist():
        cur = cat_b[off:off + L]
        off += L
        ctoks = _name_tokenize(cur)
        prel = 0
        for t in range(len(ctoks) + 1):
            ti = min(t, _NAME_TOK_MAX - 1)
            if t == len(ctoks):
                rel = 3
            else:
                st, ln, isd, canon, val = ctoks[t]
                rel = 2
                if t < len(ptoks):
                    pst, pln, pisd, pcanon, pval = ptoks[t]
                    if ln == pln and cur[st:st + ln] == prev[pst:pst + pln]:
                        rel = 0
                    elif (isd and canon and pisd and pcanon
                          and val > pval and val - pval <= 256):
                        rel = 1
            code(_REL_BASE + ti * 4 + prel, rel)
            prel = rel
            if rel == 3:
                break
            if rel == 1:
                code(_DELTA_BASE + ti, ctoks[t][4] - ptoks[t][4] - 1)
            elif rel == 2:
                st, ln = ctoks[t][0], ctoks[t][1]
                pc = 0
                for i in range(ln + 1):
                    s = cur[st + i] if i < ln else _NAME_TERM
                    code(_CHAR_BASE + ti * 256 + pc, s)
                    pc = s
        prev, ptoks = cur, ctoks
    return enc.flush()


def _py_decode_names(data, R, total_len, init, inc, cap):
    m = _Model(_NAME_NCTX, 256, init, inc, cap)
    dec = _RDec(data)

    def code(cx):
        row = m.counts[cx]
        f, rr = dec.decode_freq(int(m.totals[cx]))
        start = 0
        s = 0
        while start + int(row[s]) <= f:
            start += int(row[s])
            s += 1
        dec.decode_update(start, int(row[s]), rr)
        m.update(cx, s)
        return s

    out = bytearray()
    lens = np.empty(R, np.int32)
    prev = b""
    ptoks = []
    for r in range(R):
        cur = bytearray()
        prel = 0
        t = 0
        while True:
            ti = min(t, _NAME_TOK_MAX - 1)
            rel = code(_REL_BASE + ti * 4 + prel)
            prel = rel
            if rel == 3:
                break
            if rel > 3 or (rel <= 1 and t >= len(ptoks)):
                raise ValueError("corrupt name stream")
            if rel == 0:
                pst, pln = ptoks[t][0], ptoks[t][1]
                cur += prev[pst:pst + pln]
            elif rel == 1:
                d = code(_DELTA_BASE + ti)
                cur += str(ptoks[t][4] + d + 1).encode()
            else:
                pc = 0
                while True:
                    s = code(_CHAR_BASE + ti * 256 + pc)
                    pc = s
                    if s == _NAME_TERM:
                        break
                    cur.append(s)
                    # per-char bound (the native decoder checks written
                    # >= total_len each char): a corrupt stream that
                    # never emits the terminator must fail, not spin
                    if len(out) + len(cur) > total_len:
                        raise ValueError("corrupt name stream")
            if len(out) + len(cur) > total_len:
                raise ValueError("corrupt name stream")
            t += 1
            if t > _MAX_TOKS:
                raise ValueError("corrupt name stream")
        lens[r] = len(cur)
        out += cur
        prev = bytes(cur)
        ptoks = _name_tokenize(prev)
    if len(out) != total_len:
        raise ValueError("corrupt name stream (length mismatch)")
    return np.frombuffer(bytes(out), np.uint8), lens


# ---------------------------------------------------------------------------
# Dispatch layer (native when available)
# ---------------------------------------------------------------------------

def encode_ctx(syms: np.ndarray, ctx: Optional[np.ndarray], n_ctx: int,
               alphabet: int, init: int, inc: int, cap: int) -> bytes:
    syms = np.ascontiguousarray(syms, np.uint8)
    cx = (np.ascontiguousarray(ctx, np.uint32)
          if ctx is not None else None)
    blob = native.rc_encode_ctx(syms, cx, n_ctx, alphabet, init, inc, cap)
    if blob is not None:
        return blob
    return _py_encode_ctx(syms, cx, n_ctx, alphabet, init, inc, cap)


def decode_ctx(data: bytes, n: int, ctx: Optional[np.ndarray], n_ctx: int,
               alphabet: int, init: int, inc: int, cap: int) -> np.ndarray:
    cx = (np.ascontiguousarray(ctx, np.uint32)
          if ctx is not None else None)
    out = native.rc_decode_ctx(data, n, cx, n_ctx, alphabet, init, inc, cap)
    if out is not None:
        return out
    return _py_decode_ctx(data, n, cx, n_ctx, alphabet, init, inc, cap)


def encode_o1(syms: np.ndarray, alphabet: int, init: int, inc: int,
              cap: int) -> bytes:
    syms = np.ascontiguousarray(syms, np.uint8)
    blob = native.rc_encode_o1(syms, alphabet, init, inc, cap)
    if blob is not None:
        return blob
    return _py_encode_o1(syms, alphabet, init, inc, cap)


def decode_o1(data: bytes, n: int, alphabet: int, init: int, inc: int,
              cap: int) -> np.ndarray:
    out = native.rc_decode_o1(data, n, alphabet, init, inc, cap)
    if out is not None:
        return out
    return _py_decode_o1(data, n, alphabet, init, inc, cap)


def encode_names(cat: np.ndarray, lens: np.ndarray, init: int, inc: int,
                 cap: int) -> bytes:
    """Fallback name coder over concatenated name bytes + per-name lengths."""
    cat = np.ascontiguousarray(cat, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    blob = native.rc_encode_names(cat, lens, init, inc, cap)
    if blob is not None:
        return blob
    return _py_encode_names(cat, lens, init, inc, cap)


def decode_names(data: bytes, R: int, total_len: int, init: int, inc: int,
                 cap: int):
    """-> (cat bytes (uint8), per-name lengths (int32))."""
    out = native.rc_decode_names(data, R, total_len, init, inc, cap)
    if out is not None:
        return out
    return _py_decode_names(data, R, total_len, init, inc, cap)
