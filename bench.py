"""Headline benchmark: SE entropy-only encode throughput (reads/s).

Compresses the seeded stand-in for the reference's bundled test pair
(tools/genome_fixture.bundled_pair: 10k x 100 bp, replicated x10, ~23.7 MB)
end to end (parse + encode + container write) with the default placement
and prints one JSON line.  Detail blocks:

  host_route   the same series with every coder and aligner stage forced
               onto the native host code (FASTQUEEZE_*_EXEC=host); its
               archive must be byte-identical to the default one.
  unique_input dup-free fixture at the BASELINE 28.4 MB scale (the x10
               replication inflates ratio/throughput via the duplicate
               tier; this block is the honest coding-quality number).
  aligned      aligned-SE/-q/PE/self-ref throughput incl. aligned DECODE
               timing + round-trip verification.
  genome       tools/genome_bench.run on the 100 Mbp structured genome.

It needs a GPU: on any other backend it exits non-zero unless ``--cpu``
asks for the small validation run on the CPU backend.  The JSON line names
the platform, device kind, device count and the card's name and power
limit.  Any failed block fails the run.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

BASELINE_READS_PER_S = 98_000.0
_TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
_HOST_ROUTE = {"FASTQUEEZE_FROZEN_EXEC": "host",
               "FASTQUEEZE_ADAPT_EXEC": "host",
               "FASTQUEEZE_ALIGN_EXEC": "host"}


def _device_info() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    card's name and power limit from nvidia-smi (absent on the CPU)."""
    import jax
    d = jax.devices()
    card = None
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        card = r.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "card": card}


def _best_of(fn, n_min: int = 3, n_max: int = 14, budget_s: float = 240.0,
             settle: float = 0.05) -> float:
    """Best-of-N wall time with a self-calibrating stop: keep sampling
    while runs still improve the best by > settle; stop after two
    consecutive non-improving samples once n_min are in hand.  No
    hand-maintained capability constants (the box's wall-clock varies
    +-60% between phases; a stale threshold accepted degraded samples)."""
    best = None
    stale = 0
    t_end = time.time() + budget_s
    for k in range(n_max):
        t0 = time.time()
        fn()
        d = time.time() - t0
        if best is None or d < best * (1.0 - settle):
            stale = 0
        else:
            stale += 1
        best = d if best is None else min(best, d)
        if (k + 1 >= n_min and stale >= 2) or time.time() > t_end:
            break
    return best


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def main() -> int:
    # --cpu: validation mode — run the whole bench flow on the CPU backend
    # with a 1x input (numbers NOT comparable to the device run; exercises
    # every code path so a bench-script bug can't eat a chip run)
    cpu_mode = "--cpu" in sys.argv
    import jax
    if cpu_mode:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        print(f"bench.py: needs a GPU backend, JAX found "
              f"{jax.default_backend()!r} (use --cpu for a validation run)",
              file=sys.stderr)
        return 1
    import fastqueeze_tpu
    fastqueeze_tpu.enable_compile_cache()       # off on the CPU backend
    device = _device_info()
    sys.path.insert(0, _TOOLS)
    from genome_fixture import bundled_pair

    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.pipeline.driver import compress_se, decompress

    tmp = tempfile.mkdtemp(prefix="fqzbench")
    src = os.path.join(tmp, "in.fq")
    raw1, raw2 = bundled_pair()
    reps = 1 if cpu_mode else 10
    with open(src, "wb") as fh:
        for _ in range(reps):
            fh.write(raw1)
    n_reads = 10_000 * reps
    src_md5 = _md5(src)

    p = CodecParams(block_size_mb=8, threads=1)

    # warm-up: one full untimed pass compiles every (model, shape) pair
    # (compilations persist in the on-disk XLA cache for later runs)
    stats = compress_se(p, src, os.path.join(tmp, "out.fqz"))
    dt = _best_of(lambda: compress_se(
        CodecParams(block_size_mb=8, threads=1), src,
        os.path.join(tmp, "out.fqz")), budget_s=300)
    reads_per_s = n_reads / dt

    outs_box = {}

    def _dec():
        outs_box["outs"] = decompress(os.path.join(tmp, "out.fqz"),
                                      os.path.join(tmp, "back"), force=True,
                                      threads=1)
    dec_dt = _best_of(_dec, budget_s=240)
    # full-output integrity (interior also rides on per-block MD5s inside
    # decompress; this closes the loop on reassembly)
    ok = _md5(outs_box["outs"][0]) == src_md5

    # --- stage attribution (one instrumented single-thread pass): where
    # the encode wall time lives — host parse, dispatch (host stream
    # coding + device queueing), and device/transfer wait (finalize).
    from fastqueeze_tpu.utils.metrics import DebugInfo
    dbg = DebugInfo()
    t0 = time.time()
    compress_se(CodecParams(block_size_mb=8, threads=1), src,
                os.path.join(tmp, "stg.fqz"), dbg=dbg)
    stage_wall = time.time() - t0
    stages = {
        "wall_s": round(stage_wall, 3),
        "parse_host_s": round(dbg.vals.get("parse_s", 0.0), 3),
        "dispatch_host_s": round(dbg.vals.get("dispatch_s", 0.0), 3),
        "device_wait_s": round(dbg.vals.get("encode_s", 0.0), 3),
        "train_s": round(dbg.vals.get("train_s", 0.0), 3),
    }

    # --- the same series on the native host route (archive must match) ---
    host = _bench_host_route(tmp, src, n_reads, src_md5,
                             os.path.join(tmp, "out.fqz"))

    # --- dup-free honest fixture at the BASELINE 28.4 MB scale ---
    unique = _bench_unique(tmp, raw1, cpu_mode)

    # --- aligned-SE benchmark (BASELINE.md: reference ~40k reads/s with
    # the synthetic 500 kb ref, 8,050/10,000 mapped) ---
    aligned = _bench_aligned(tmp, raw1, raw2)

    # --- genome-scale aligned validation: 100 Mbp structured-repeat
    # reference, in this process (one process per card) ---
    from genome_bench import run as genome_run
    genome = (genome_run(4, 20000, tempfile.mkdtemp(prefix="fqzgen"))
              if cpu_mode else genome_run(100, 300_000,
                                          os.path.join(tmp, "genome")))

    print(json.dumps({
        "metric": "se_encode_reads_per_s",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 3),
        "detail": {
            "input_bytes": stats["raw"],
            "compressed_bytes": stats["compressed"],
            "ratio": round(stats["ratio"], 3),
            "replicated_x10": True,
            "blocks": stats["blocks"],
            "wall_s": round(dt, 3),
            "decode_reads_per_s": round(n_reads / dec_dt, 1),
            "decode_ok": bool(ok),
            "stages": stages,
            "host_route": host,
            "unique_input": unique,
            "aligned": aligned,
            "genome": genome,
        },
        "device": device,
    }))
    checks = [ok, host["payload_identical"], host["dec_ok"],
              unique["dec_ok"], unique["cli_defaults"]["dec_ok"],
              unique["pe"]["dec_ok"], aligned["decode_ok"],
              genome["hash"]["dec_ok"], genome["q_mode"]["dec_ok"],
              genome["longread"]["dec_ok"]]
    return 0 if all(checks) else 1


def _bench_host_route(tmp: str, src: str, n_reads: int, src_md5: str,
                      default_arc: str) -> dict:
    """The headline series with every stage forced onto the native host
    code.  Archives must be byte-identical to the default-placement one
    (same params), and decode bit-exact."""
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.pipeline.driver import compress_se, decompress
    old = {k: os.environ.get(k) for k in _HOST_ROUTE}
    os.environ.update(_HOST_ROUTE)
    try:
        arc = os.path.join(tmp, "host.fqz")
        mk = lambda: CodecParams(block_size_mb=8, threads=1)  # noqa: E731
        compress_se(mk(), src, arc)             # warm
        dt = _best_of(lambda: compress_se(mk(), src, arc), budget_s=300)
        box = {}

        def _dec():
            box["o"] = decompress(arc, os.path.join(tmp, "hback"),
                                  force=True, threads=1)
        _dec()
        ddt = _best_of(_dec, budget_s=240)
        return {"enc_reads_per_s": round(n_reads / dt, 1),
                "dec_reads_per_s": round(n_reads / ddt, 1),
                "payload_identical": _md5(arc) == _md5(default_arc),
                "dec_ok": _md5(box["o"][0]) == src_md5}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _unique_fixture(tmp: str, raw1: bytes, reps: int) -> str:
    """Dup-free fixture at the BASELINE 28.4 MB scale: the bundled 10k
    reads replicated, every copy per-read mutated (>=1 forced base
    substitution, >=1 forced quality-byte change) so NO exact sequence or
    quality duplicates exist — the duplicate tier contributes nothing and
    the numbers measure pure coding quality.  Deterministic (fixed seed).
    """
    import numpy as np
    lines = raw1.split(b"\n")
    n = len(lines) // 4
    seq = np.frombuffer(b"".join(lines[1::4]), np.uint8).reshape(n, -1)
    qul = np.frombuffer(b"".join(lines[3::4]), np.uint8).reshape(n, -1)
    L = seq.shape[1]
    rng = np.random.default_rng(20260819)
    BASES = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for rep in range(reps):
        s = seq.copy()
        q = qul.copy()
        # forced substitution at one random position per read + ~1 extra
        nmut = 1 + rng.poisson(1.0, n)
        for k in range(int(nmut.max())):
            rows = np.nonzero(nmut > k)[0]
            cols = rng.integers(0, L, rows.size)
            cur = s[rows, cols]
            nb = BASES[rng.integers(0, 4, rows.size)]
            # guarantee a change: bump to the next base when equal
            same = nb == cur
            nb[same] = BASES[(np.searchsorted(BASES, cur[same]) + 1) % 4]
            s[rows, cols] = nb
        # forced quality change: -1 where >33 else +1 (always changes)
        cols = rng.integers(0, L, n)
        rows = np.arange(n)
        cq = q[rows, cols]
        q[rows, cols] = np.where(cq > 33, cq - 1, cq + 1)
        ids = np.char.add("@u.%d." % rep,
                          np.arange(n).astype(str)).astype(bytes)
        body = [b"%s length=%d\n%s\n+\n%s\n" % (
            ids[i], L, s[i].tobytes(), q[i].tobytes()) for i in range(n)]
        recs.append(b"".join(body))
    path = os.path.join(tmp, "uniq.fq")
    with open(path, "wb") as fh:
        fh.write(b"".join(recs))
    return path


def _bench_unique_pe(tmp: str, src: str) -> dict:
    """One-shot PE entropy-only ratio on the dup-free fixture (BASELINE.md
    PE row: reference 5.76x on the bundled pair): even reads -> mate 1,
    odd -> mate 2, same coders as the CLI -1/-2 path."""
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.pipeline.driver import decompress
    from fastqueeze_tpu.pipeline.pe import compress_pe
    lines = open(src, "rb").read().split(b"\n")
    recs = [b"\n".join(lines[i:i + 4]) + b"\n"
            for i in range(0, len(lines) - 3, 4)]
    p1, p2 = os.path.join(tmp, "pe_1.fq"), os.path.join(tmp, "pe_2.fq")
    with open(p1, "wb") as f:
        f.write(b"".join(recs[0::2]))
    with open(p2, "wb") as f:
        f.write(b"".join(recs[1::2]))
    arc = os.path.join(tmp, "pe.fqz")
    stats = compress_pe(CodecParams(threads=1), p1, p2, arc)
    outs = decompress(arc, os.path.join(tmp, "peback"), force=True,
                      threads=1)
    ok = (_md5(outs[0]) == _md5(p1) and _md5(outs[1]) == _md5(p2))
    return {"ratio": round(stats["ratio"], 3), "dec_ok": ok}


def _bench_unique(tmp: str, raw1: bytes, cpu_mode: bool) -> dict:
    """Honest coding-quality block: no exact duplicates, BASELINE scale
    (28.4 MB, 120k reads)."""
    import numpy as np  # noqa: F401

    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.pipeline.driver import compress_se, decompress
    reps = 2 if cpu_mode else 12
    src = _unique_fixture(tmp, raw1, reps)
    n_reads = 10_000 * reps
    in_bytes = os.path.getsize(src)
    src_md5 = _md5(src)
    arc = os.path.join(tmp, "uniq.fqz")
    # throughput series: 8 MB blocks (block pipelining engaged, the
    # BASELINE.md 4 MB-block protocol's spirit); the defaults ratio
    # (50 MB blocks -> one block, the CLI experience) is reported
    # separately below — both archives round-trip-verified
    mk = lambda: CodecParams(block_size_mb=8, threads=1)  # noqa: E731
    stats = compress_se(mk(), src, arc)                   # warm
    dt = _best_of(lambda: compress_se(mk(), src, arc), budget_s=240)
    box = {}

    def _dec():
        box["o"] = decompress(arc, os.path.join(tmp, "uback"), force=True,
                              threads=1)
    decompress(arc, os.path.join(tmp, "uback"), force=True, threads=1)
    ddt = _best_of(_dec, budget_s=180)
    arc_d = os.path.join(tmp, "uniq_def.fqz")
    stats_d = compress_se(CodecParams(threads=1), src, arc_d)
    outs_d = decompress(arc_d, os.path.join(tmp, "uback_def"), force=True,
                        threads=1)
    out = {
        "input_bytes": in_bytes,
        "reads": n_reads,
        "ratio": round(stats["ratio"], 3),
        "enc_reads_per_s": round(n_reads / dt, 1),
        "dec_reads_per_s": round(n_reads / ddt, 1),
        "dec_ok": _md5(box["o"][0]) == src_md5,
        "cli_defaults": {
            "ratio": round(stats_d["ratio"], 3),
            "dec_ok": _md5(outs_d[0]) == src_md5,
        },
        "pe": _bench_unique_pe(tmp, src),
    }
    return out


def _bench_aligned(tmp: str, raw1: bytes, raw2: bytes) -> dict:
    """Aligned-SE throughput on the synthetic 500 kb reference (the
    BASELINE.md protocol: reference binary ~40k reads/s, 8,050/10k mapped,
    ratio 5.96x).  Measures the full pipeline: parse + align + encode,
    plus aligned DECODE timing + round-trip (reference decode: 0.22 s)."""
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.io.fastq import parse_block
    from fastqueeze_tpu.pipeline.aligned import compress_se_aligned
    from fastqueeze_tpu.pipeline.driver import decompress
    from maprate import synthetic_ref
    src1 = os.path.join(tmp, "in1.fq")
    with open(src1, "wb") as fh:
        fh.write(raw1)
    src1_md5 = _md5(src1)
    fa = synthetic_ref(parse_block(raw1, True))
    arc = os.path.join(tmp, "al.fqz")
    sbox = {}

    def _enc():
        sbox["s"] = compress_se_aligned(
            CodecParams(block_size_mb=8, threads=1), fa, src1, arc)
    _enc()                                                # warm
    dt = _best_of(_enc, budget_s=240)
    stats = sbox["s"]
    obox = {}

    def _dec():
        obox["o"] = decompress(arc, os.path.join(tmp, "alback"),
                               force=True, threads=1, ref=fa)
    _dec()                                                # warm
    al_ddt = _best_of(_dec, budget_s=120)
    out = {
        "reads_per_s": round(stats["reads"] / dt, 1),
        "vs_baseline_40k": round(stats["reads"] / dt / 40_000.0, 3),
        "mapped": stats["mapped"],
        "reads": stats["reads"],
        "ratio": round(stats["ratio"], 3),
        "wall_s": round(dt, 3),
        "decode_reads_per_s": round(stats["reads"] / al_ddt, 1),
        "decode_ok": _md5(obox["o"][0]) == src1_md5,
    }

    # --- -q long-seed mode (wide 44-bit seeds + one-indel rescue;
    # reference BWA-backed ratio 6.16x, BASELINE.md) ---
    qbox = {}

    def _encq():
        qbox["s"] = compress_se_aligned(
            CodecParams(block_size_mb=8, threads=1, seed_len=22,
                        max_indel=3), fa, src1, os.path.join(tmp, "q.fqz"))
    _encq()                                               # warm
    dq = _best_of(_encq, n_min=2, n_max=8, budget_s=120)
    sq = qbox["s"]
    out["q_mode"] = {"reads_per_s": round(sq["reads"] / dq, 1),
                     "mapped": sq["mapped"], "ratio": round(sq["ratio"], 3)}

    # --- self-referential alignment (-S, no reference equivalent):
    # synthetic 20x-coverage reads, where the block's own unmapped reads
    # act as the reference (decode rebuilds it from the seq stream) ---
    out["self_ref"] = _bench_selfref(tmp)

    # --- PE aligned (on the real pair the reference binary wrote 5.53x,
    # 12,607/20k mapped) ---
    from fastqueeze_tpu.pipeline.aligned import compress_pe_aligned
    r2 = os.path.join(tmp, "in2.fq")
    with open(r2, "wb") as fh:
        fh.write(raw2)
    pbox = {}

    def _encp():
        pbox["s"] = compress_pe_aligned(
            CodecParams(block_size_mb=8, threads=1), fa, src1, r2,
            os.path.join(tmp, "pe.fqz"))
    _encp()                                               # warm
    dp = _best_of(_encp, n_min=2, n_max=6, budget_s=120)
    sp = pbox["s"]
    out["pe_aligned"] = {"reads_per_s": round(sp["reads"] / dp, 1),
                         "mapped": sp["mapped"],
                         "ratio": round(sp["ratio"], 3)}
    return out


def _bench_selfref(tmp: str) -> dict:
    import numpy as np

    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.pipeline.driver import compress_se
    rng = np.random.default_rng(42)
    genome = rng.integers(0, 4, 60000).astype(np.uint8)
    BASES = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(12000):
        pos = int(rng.integers(0, 60000 - 100))
        r = genome[pos:pos + 100].copy()
        e = rng.random(100) < 0.005
        r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
        if rng.random() < 0.5:
            r = 3 - r[::-1]
        q = (rng.integers(30, 41, 100).astype(np.uint8) + 33).tobytes()
        recs.append(b"@r.%d\n" % i + BASES[r].tobytes() + b"\n+\n" + q
                    + b"\n")
    src = os.path.join(tmp, "cov.fq")
    with open(src, "wb") as fh:
        fh.write(b"".join(recs))
    s0 = compress_se(CodecParams(block_size_mb=8, threads=1, self_align=0),
                     src, os.path.join(tmp, "cov0.fqz"))
    p = CodecParams(block_size_mb=8, threads=1, self_align=1)
    t0 = time.time()
    s1 = compress_se(p, src, os.path.join(tmp, "covS.fqz"))
    dt = time.time() - t0
    # auto gate (self_align=-1, the default): must pick -S here (high
    # coverage) and skip it on the telomeric bundled data
    pa = CodecParams(block_size_mb=8, threads=1)
    auto_on = pa.self_align == -1 and compress_se(
        pa, src, os.path.join(tmp, "covA.fqz"))["ratio"] > (
        s0["ratio"] + s1["ratio"]) / 2
    return {"ratio": round(s1["ratio"], 3),
            "plain_ratio": round(s0["ratio"], 3),
            "reads_per_s": round(12000 / dt, 1),
            "auto_picks_selfref": bool(auto_on)}


if __name__ == "__main__":
    sys.exit(main())
