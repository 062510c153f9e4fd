"""Offline probe: adaptive-model code length of the qual stream under
candidate context formulas (numpy only, no coder).

For a context scheme, the exact adaptive arithmetic-code length is
    sum_i -log2( (init + inc*k_i) / (init*A + inc*n_i) )
where k_i = occurrences of (ctx_i, sym_i) before position i and
n_i = occurrences of ctx_i before position i.  (Rescale/cap ignored —
close enough to rank candidate contexts; the winner gets a real A/B.)

Usage: python tools/qual_ctx_probe.py [file.fq ...]
(default input: the seeded bundled-pair stand-in, genome_fixture.py)
"""
import os
import sys
import tempfile

import numpy as np


def _default_paths():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from genome_fixture import write_bundled_pair
    return write_bundled_pair(tempfile.mkdtemp(prefix="fqzpair"))[:1]


def load_quals(path):
    lens, quals = [], []
    with open(path, "rb") as fh:
        for i, line in enumerate(fh):
            if i % 4 == 3:
                q = line.rstrip(b"\n")
                lens.append(len(q))
                quals.append(q)
    flat = np.frombuffer(b"".join(quals), np.uint8).astype(np.int32) - 33
    return flat, np.array(lens, np.int64)


def adaptive_bits(ctx, sym, A, init=8, inc=8):
    """Exact adaptive code length (no rescale) for symbols in stream order."""
    ctx = ctx.astype(np.int64)
    key = ctx * A + sym
    order = np.argsort(key, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    sk = key[order]
    newgrp = np.r_[True, sk[1:] != sk[:-1]]
    grp_start = np.maximum.accumulate(np.where(newgrp, np.arange(len(sk)), 0))
    k = (np.arange(len(sk)) - grp_start)[inv]          # per-(ctx,sym) cumcount

    order2 = np.argsort(ctx, kind="stable")
    inv2 = np.empty_like(order2)
    inv2[order2] = np.arange(len(order2))
    sc = ctx[order2]
    newgrp2 = np.r_[True, sc[1:] != sc[:-1]]
    grp_start2 = np.maximum.accumulate(np.where(newgrp2, np.arange(len(sc)), 0))
    n = (np.arange(len(sc)) - grp_start2)[inv2]        # per-ctx cumcount

    p = (init + inc * k.astype(np.float64)) / (init * A + inc * n.astype(np.float64))
    return -np.log2(p).sum() / 8.0                     # bytes


def features(flat, lens):
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    q = flat
    q1 = np.where(pos >= 1, np.r_[0, q[:-1]], 0)
    q2 = np.where(pos >= 2, np.r_[0, 0, q[:-2]], 0)
    d = np.where(pos >= 1, np.maximum(0, q1 - q), 0)
    cs = np.cumsum(d)
    start = np.cumsum(np.r_[0, lens[:-1]])
    base = np.repeat(cs[start] - d[start], lens)
    drops = np.where(pos >= 1, 5 + np.r_[0, cs[:-1]] - base, 5)
    return pos, q1, q2, drops


def main():
    paths = sys.argv[1:] or _default_paths()
    for path in paths:
        flat, lens = load_quals(path)
        # dense ranks (what the engine codes)
        vals = np.unique(flat)
        rank = np.zeros(flat.max() + 1, np.int32)
        rank[vals] = np.arange(len(vals))
        r = rank[flat]
        A = len(vals)
        pos, q1, q2, drops = features(r, lens)
        total = len(flat)
        print(f"{path}: {total} quals, {A} distinct, {len(lens)} reads")

        def show(name, ctx):
            b = adaptive_bits(ctx, r, A)
            print(f"  {name:42s} {b:12.0f} B  ({total/8/b:6.2f}x vs raw bits, "
                  f"{total/b:5.2f}x vs bytes)  nctx={len(np.unique(ctx))}")

        fq = ((np.maximum(q1, q2) << 6) + q1) & 0xFFF
        ql2 = fq + np.where(q1 == q2, 0x1000, 0) + ((np.minimum(drops, 56) & ~7) << 10)
        show("fqzcomp qlevel2 (current default)", ql2)
        show("qlevel3 (+pos>>3 capped 15)", ql2 + (np.minimum(pos >> 3, 15) << 16))
        show("qlevel2 + full pos>>3", ql2 + ((pos >> 3).astype(np.int32) << 16))
        show("q1,q2 exact", q1 * A + q2)
        show("q1,q2,q3 exact",
             (q1 * A + q2) * A + np.where(pos >= 3, np.r_[0, 0, 0, r[:-3]], 0))
        q3 = np.where(pos >= 3, np.r_[0, 0, 0, r[:-3]], 0)
        show("q1,q2,q3 + drops>>3 (cap 7)",
             ((q1 * A + q2) * A + q3) * 8 + np.minimum(drops >> 3, 7))
        show("q1,q2 + drops>>3 + pos>>4",
             ((q1 * A + q2) * 8 + np.minimum(drops >> 3, 7)) * 8
             + np.minimum(pos >> 4, 7))
        show("q1,q2,q3 + pos>>4 (cap 7)",
             (((q1 * A + q2) * A + q3) * 8 + np.minimum(pos >> 4, 7)))
        q4 = np.where(pos >= 4, np.r_[0, 0, 0, 0, r[:-4]], 0)
        show("q1,q2,q3 + q4cap3 + drops>>3",
             (((q1 * A + q2) * A + q3) * 4 + np.minimum(q4, 3)) * 8
             + np.minimum(drops >> 3, 7))


def frozen_eval(ctx, sym, A, n_rows, init=8, inc=8, cap=0xFFE0):
    """Frozen-mode cost: train dense table on the stream, cap-rescale like
    the engine, report static NLL + zlib'd table (MODEL section) size.

    CAUTION: this is an APPROXIMATION of pipeline/frozen.py — the real
    _cap_rescale / _pack_counts differ in detail (measured a few percent
    better), and in-sample NLL here rewards overfit when the real
    pipeline would train on a sample.  Rank candidates with this, but
    confirm winners through _select_qctx / a real compress run."""
    import zlib
    flat = ctx.astype(np.int64) * A + sym
    hist = np.bincount(flat, minlength=n_rows * A)[:n_rows * A] \
        .reshape(n_rows, A).astype(np.int64)
    counts = hist * inc + init
    for _ in range(24):
        tot = counts.sum(axis=1, keepdims=True)
        over = tot > cap
        if not over.any():
            break
        counts = np.where(over, (counts + 1) >> 1, counts)
    tot = counts.sum(axis=1)
    p = counts[ctx, sym] / tot[ctx]
    nll = -np.log2(p).sum() / 8.0
    hi = counts.max()
    dt = np.uint8 if hi < 0x100 else np.uint16
    blob = len(zlib.compress(np.ascontiguousarray(counts, dt).tobytes(), 1))
    return nll, blob


def main_frozen():
    paths = sys.argv[1:] or _default_paths()
    for path in paths:
        flat, lens = load_quals(path)
        vals = np.unique(flat)
        rank = np.zeros(flat.max() + 1, np.int32)
        rank[vals] = np.arange(len(vals))
        r = rank[flat]
        A = len(vals)
        pos, q1, q2, drops = features(r, lens)
        q3 = np.where(pos >= 3, np.r_[0, 0, 0, r[:-3]], 0)
        total = len(flat)
        print(f"{path}: {total} quals, A={A} (frozen eval)")

        def show(name, ctx, n_rows):
            nll, blob = frozen_eval(ctx, r, A, n_rows)
            print(f"  {name:46s} stream={nll:10.0f}B model={blob:9d}B "
                  f"total={nll+blob:10.0f}B rows={n_rows}")

        fq = ((np.maximum(q1, q2) << 6) + q1) & 0xFFF
        ql2 = fq + np.where(q1 == q2, 0x1000, 0) \
            + ((np.minimum(drops, 56) & ~7) << 10)
        show("fqzcomp qlevel2 (current)", ql2, 1 << 16)
        show("qlevel3 (+pos>>3 cap15)",
             ql2 + (np.minimum(pos >> 3, 15) << 16), 1 << 20)
        show("q1,q2 + drops>>3c7", (q1 * A + q2) * 8
             + np.minimum(drops >> 3, 7), A * A * 8)
        show("q1,q2,q3", (q1 * A + q2) * A + q3, A * A * A)
        show("q1,q2,q3 + pos>>4c7",
             ((q1 * A + q2) * A + q3) * 8 + np.minimum(pos >> 4, 7),
             A * A * A * 8)
        show("q1,q2,q3c8 + drops>>3c7 + pos>>4c7",
             (((q1 * A + q2) * 8 + np.minimum(q3 >> 2, 7)) * 8
              + np.minimum(drops >> 3, 7)) * 8 + np.minimum(pos >> 4, 7),
             A * A * 8 * 8 * 8)
        show("q1,q2,q3 + eq + drops>>3c7",
             (((q1 * A + q2) * A + q3) * 2 + (q1 == q2)) * 8
             + np.minimum(drops >> 3, 7), A * A * A * 2 * 8)


if __name__ == "__main__":
    if "--frozen" in sys.argv:
        sys.argv.remove("--frozen")
        main_frozen()
    else:
        main()
