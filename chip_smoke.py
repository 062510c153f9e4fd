"""One-process smoke run of the compressor's device path on NVIDIA GPUs.

Drives the user entry points (``fastqueeze_tpu.cli.main`` and
``fastqueeze_tpu.api``) in this process over FASTQ/FASTA generated from a
seed (tools/genome_fixture.py: NovaSeq-style 150 bp reads with 4-bin
qualities from a repeat-structured genome), and checks in every phase that

* the archive written with the default placement (the device, on a GPU)
  is byte-identical to the one the native host route writes with the same
  parameters (FASTQUEEZE_{FROZEN,ADAPT,ALIGN}_EXEC=host) — the C++ coders
  and aligner are the plain reference of every device program, and the
  tolerance is zero;
* every archive decodes bit-exact;
* device programs ran: every phase counts, through jax.monitoring, the
  programs XLA compiled or loaded from the persistent compile cache on
  the device route, and fails at zero.

One card (the default):
  a  SE entropy-only, usemodel path: 1,000,000 x 150 bp (~314 MB, 6 blocks
     of 50 MiB): compress, decompress, -X extract of 1,000 middle reads
  b  adaptive path: the first 20,000 of those reads (below the gate)
  c  PE: 2 x 250,000 mates
  d  aligned SE: -i index of a 100 Mbp genome, 500,000 reads against it,
     decompress with the reference; once more with
     FASTQUEEZE_FUSED_ALIGN=1, which must write the same archive

``--cards 4`` runs only the multi-card paths and what each is compared
with: a --mesh 4 compress of (a)'s input (block payloads equal to the
one-card archive, mesh decode bit-exact), a frozen decode with the qual
table sharded over the cards, and the sharded-index aligner on (d)'s
index (bit-exact round trip, mapped count beside the one-card Aligner's).

Every operation is timed cold (first call, compiles included) and warm,
on the device route and then on the host route.  ``--scale F`` cuts the
read counts (never the genome); each cut is printed.  Without a GPU the
script exits non-zero before printing any result.  The last stdout line
is one JSON object naming the device.

Usage: python chip_smoke.py [--cards 4] [--scale F]
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "tmp_smoke")

GENOME_BP = 100_000_000
READ_LEN = 150
N_SE, N_ADAPT, N_PE, N_ALIGN = 1_000_000, 20_000, 250_000, 500_000
N_EXTRACT = 1_000
SEED = 20260820

_ROUTES = ("FASTQUEEZE_FROZEN_EXEC", "FASTQUEEZE_ADAPT_EXEC",
           "FASTQUEEZE_ALIGN_EXEC")
HOST_ROUTE = {k: "host" for k in _ROUTES}
DEFAULT_ROUTE = {k: None for k in _ROUTES}      # None: unset the variable
FORCED_DEVICE_ROUTE = {k: "device" for k in _ROUTES}
_BACKEND_COMPILE = "/jax/core/compile/backend_compile_duration"
_CACHE_HIT = "/jax/compilation_cache/cache_hits"
_PROGRAMS = [0]       # programs compiled or loaded from the compile cache
_LISTENING = []


def _on_duration(event, _secs, **_kw):
    if event == _BACKEND_COMPILE:
        _PROGRAMS[0] += 1


def _on_event(event, **_kw):
    if event == _CACHE_HIT:
        _PROGRAMS[0] += 1


def _listen() -> None:
    import jax
    if not _LISTENING:
        jax.monitoring.register_event_duration_secs_listener(_on_duration)
        jax.monitoring.register_event_listener(_on_event)
        _LISTENING.append(True)


def _dev_stat(key: str):
    """Sum of one memory_stats() counter over the local devices, or None
    where the backend keeps no allocator statistics (the CPU)."""
    import jax
    total = None
    for d in jax.local_devices():
        st = d.memory_stats()
        if st and key in st:
            total = (total or 0) + int(st[key])
    return total


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().replace("\n", " | ") or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e!r}"


@contextlib.contextmanager
def _env(overrides):
    old = {k: os.environ.get(k) for k in overrides}
    for k, v in overrides.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _cli(argv) -> None:
    from fastqueeze_tpu.cli import main
    rc = main(list(argv))
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)} exited {rc}")


def _timed(label: str, fn, n_reads: int, rec: dict):
    """Run fn once; print and record wall time, reads/s and the device
    programs compiled or loaded from the compile cache during the call."""
    c0 = _PROGRAMS[0]
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    r = {"s": dt, "reads_per_s": n_reads / dt, "programs": _PROGRAMS[0] - c0}
    rec[label] = r
    print(f"  {label}: {dt:.3f} s, {r['reads_per_s']:,.0f} reads/s, "
          f"programs compiled or loaded {r['programs']}", flush=True)
    return out


def _record_slices(path: str, start: int, count: int) -> bytes:
    """Bytes of FASTQ records [start, start+count) of a 4-line file."""
    import numpy as np
    data = open(path, "rb").read()
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    a = 0 if start == 0 else int(nl[4 * start - 1]) + 1
    b = int(nl[4 * (start + count) - 1]) + 1
    return data[a:b]


def _check_device_ran(phase: str, rec: dict) -> None:
    n = sum(r["programs"] for k, r in rec.items() if k.startswith("device"))
    print(f"  {phase}: device programs compiled or loaded on the device "
          f"route: {n}", flush=True)
    if n <= 0:
        raise RuntimeError(f"phase {phase}: no device program ran")


def _peak(phase: str) -> None:
    print(f"  {phase}: peak device bytes in use "
          f"{_dev_stat('peak_bytes_in_use')}", flush=True)


def phase_codec(name: str, inputs, work: str, n_reads: int, routes=None,
                extract: bool = False, flags=()) -> dict:
    """Compress / decompress (/ extract) an SE or PE input through the CLI
    and api on each route, cold and warm; archives must match byte for
    byte across routes and decode bit-exact."""
    from fastqueeze_tpu import api
    routes = routes or {"device": DEFAULT_ROUTE, "host": HOST_ROUTE}
    inputs = list(inputs)
    raw = sum(os.path.getsize(p) for p in inputs)
    want = [_md5(p) for p in inputs]
    mid = n_reads // 2
    want_x = (_record_slices(inputs[0], mid, min(N_EXTRACT, n_reads - mid))
              if extract else None)
    print(f"phase {name}: {n_reads:,} reads, {raw:,} B input", flush=True)
    rec, arc_md5 = {}, {}
    src = ["-1", inputs[0]] + (["-2", inputs[1]] if len(inputs) > 1 else [])
    for route, env in routes.items():
        arc = os.path.join(work, f"{name}_{route}.fqz")
        with _env(env):
            for run in ("cold", "warm"):
                _timed(f"{route} compress {run}", lambda: _cli(
                    ["-c", *src, "-o", arc, "-f", *flags]), n_reads, rec)
            arc_md5[route] = _md5(arc)
            print(f"  {route} ratio {raw / os.path.getsize(arc):.4f} "
                  f"({os.path.getsize(arc):,} B)", flush=True)
            for run in ("cold", "warm"):
                outs = _timed(f"{route} decompress {run}", lambda: api.decompress(
                    arc, os.path.join(work, f"{name}_{route}_back")),
                    n_reads, rec)
                if [_md5(p) for p in outs] != want:
                    raise RuntimeError(f"phase {name}: {route} round trip "
                                       "is not bit-exact")
                for p in outs:
                    os.remove(p)
            if extract:
                for run in ("cold", "warm"):
                    outs = _timed(f"{route} extract {run}", lambda: api.extract(
                        arc, mid, N_EXTRACT,
                        os.path.join(work, f"{name}_{route}_x")),
                        min(N_EXTRACT, n_reads - mid), rec)
                    if open(outs[0], "rb").read() != want_x:
                        raise RuntimeError(f"phase {name}: {route} -X "
                                           "extract differs from the input")
    if len(set(arc_md5.values())) != 1:
        raise RuntimeError(f"phase {name}: archives differ across routes "
                           f"{arc_md5}")
    print(f"  {name}: archives byte-identical across routes, round trips "
          "bit-exact", flush=True)
    _check_device_ran(name, rec)
    _peak(name)
    return rec


def phase_aligned(fa: str, fq: str, work: str, n_reads: int,
                  routes=None) -> dict:
    """-i index build, aligned compress on each route (cold, warm),
    decompress with the reference; the opt-in fused device aligner must
    write the same archive."""
    from fastqueeze_tpu import api
    from fastqueeze_tpu.pipeline import aligned
    routes = routes or {"device": DEFAULT_ROUTE, "host": HOST_ROUTE}
    raw = os.path.getsize(fq)
    want = _md5(fq)
    print(f"phase d: {n_reads:,} reads against {os.path.getsize(fa):,} B "
          "of FASTA", flush=True)
    rec, arc_md5 = {}, {}
    _timed("index build", lambda: _cli(["-i", fa]), n_reads, rec)
    for route, env in routes.items():
        arc = os.path.join(work, f"d_{route}.fqz")
        with _env(env):
            for run in ("cold", "warm"):
                st = _timed(f"{route} compress {run}", lambda: api.compress(
                    fq, arc, reference=fa), n_reads, rec)
            arc_md5[route] = _md5(arc)
            print(f"  {route} mapped {st['mapped']:,}/{n_reads:,}, ratio "
                  f"{raw / os.path.getsize(arc):.4f}", flush=True)
            for run in ("cold", "warm"):
                outs = _timed(f"{route} decompress {run}", lambda: api.decompress(
                    arc, os.path.join(work, f"d_{route}_back"),
                    reference=fa), n_reads, rec)
                if _md5(outs[0]) != want:
                    raise RuntimeError(f"phase d: {route} round trip is not "
                                       "bit-exact")
                os.remove(outs[0])
        if route == "device":
            al = [a for a, _ref in aligned._REF_CACHE.values()]
            if not any(getattr(a, "_dev_cache", None) is not None
                       for a in al):
                raise RuntimeError("phase d: the device route never "
                                   "uploaded the index (aligner ran on "
                                   "the host)")
    arc = os.path.join(work, "d_fused.fqz")
    with _env({**routes["device"], "FASTQUEEZE_FUSED_ALIGN": "1"}):
        _timed("device compress fused-align", lambda: api.compress(
            fq, arc, reference=fa), n_reads, rec)
    arc_md5["fused"] = _md5(arc)
    if len(set(arc_md5.values())) != 1:
        raise RuntimeError(f"phase d: archives differ {arc_md5}")
    print("  d: archives byte-identical across routes and the fused "
          "aligner, round trips bit-exact", flush=True)
    _check_device_ran("d", rec)
    _peak("d")
    return rec


def phase_mesh(fq: str, work: str, n_reads: int, cards: int,
               flags=()) -> dict:
    """--mesh N compress: block payloads equal the one-card archive's;
    mesh decode bit-exact; then a frozen decode with the qual table
    sharded over the cards ('ctx' axis) through the production gate."""
    from fastqueeze_tpu.container.arcfile import ArcReader
    from fastqueeze_tpu.parallel import mesh as M
    from fastqueeze_tpu.pipeline import driver
    rec = {}
    want = _md5(fq)
    arc1 = os.path.join(work, "m_1.fqz")
    arcn = os.path.join(work, f"m_{cards}.fqz")
    print(f"phase mesh: {n_reads:,} reads over {cards} cards", flush=True)
    _timed("device compress one-card", lambda: _cli(
        ["-c", "-1", fq, "-o", arc1, "-f", *flags]), n_reads, rec)
    for run in ("cold", "warm"):
        _timed(f"device compress mesh {run}", lambda: _cli(
            ["-c", "-1", fq, "-o", arcn, "-f", "--mesh", str(cards),
             *flags]), n_reads, rec)
    with ArcReader(arc1) as r1, ArcReader(arcn) as rn:
        if len(r1.blocks) != len(rn.blocks):
            raise RuntimeError("mesh archive has another block count")
        for i in range(len(r1.blocks)):
            if r1.read_block(i) != rn.read_block(i):
                raise RuntimeError(f"mesh block {i} payload differs from "
                                   "the one-card archive")
        n_blocks = len(r1.blocks)
    print(f"  mesh: {n_blocks} block payloads equal to the one-card run",
          flush=True)
    back = os.path.join(work, "m_back")
    for run in ("cold", "warm"):
        _timed(f"device decompress mesh {run}", lambda: _cli(
            ["-d", arcn, "-o", back, "-f", "--mesh", str(cards)]),
            n_reads, rec)
        if _md5(back + ".fastq") != want:
            raise RuntimeError("mesh decode is not bit-exact")
    old = driver.CTX_SHARD_MIN_ENTRIES
    driver.CTX_SHARD_MIN_ENTRIES = 1
    M._SHARD_DECODE_CACHE.clear()
    try:
        _timed("device decompress ctx-sharded", lambda: _cli(
            ["-d", arc1, "-o", back, "-f", "--mesh", str(cards)]),
            n_reads, rec)
    finally:
        driver.CTX_SHARD_MIN_ENTRIES = old
    if not M._SHARD_DECODE_CACHE:
        raise RuntimeError("the ctx-shard decode gate did not fire")
    if _md5(back + ".fastq") != want:
        raise RuntimeError("ctx-sharded decode is not bit-exact")
    os.remove(back + ".fastq")
    print("  mesh: mesh decode and ctx-sharded decode bit-exact",
          flush=True)
    _check_device_ran("mesh", rec)
    _peak("mesh")
    return rec


def phase_sharded_index(fa: str, fq: str, work: str, n_reads: int) -> dict:
    """Sharded-index aligner (the >= 2^31-position route) forced onto a
    100 Mbp index: bit-exact round trip; mapped count printed beside the
    one-card Aligner's on the same reads."""
    from fastqueeze_tpu import api
    from fastqueeze_tpu.align import sharded
    from fastqueeze_tpu.pipeline import aligned
    rec = {}
    want = _md5(fq)
    print(f"phase sharded-index: {n_reads:,} reads", flush=True)
    _timed("index build", lambda: _cli(["-i", fa]), n_reads, rec)
    one = _timed("device compress one-card Aligner", lambda: api.compress(
        fq, os.path.join(work, "s_1.fqz"), reference=fa), n_reads, rec)
    old = sharded.SHARD_MIN_POSITIONS
    sharded.SHARD_MIN_POSITIONS = 1
    aligned._REF_CACHE.clear()
    arc = os.path.join(work, "s_n.fqz")
    try:
        for run in ("cold", "warm"):
            st = _timed(f"device compress sharded {run}", lambda: api.compress(
                fq, arc, reference=fa), n_reads, rec)
        if not any(isinstance(a, sharded.ShardedAligner)
                   for a, _r in aligned._REF_CACHE.values()):
            raise RuntimeError("the sharded-index aligner did not run")
        outs = _timed("device decompress sharded", lambda: api.decompress(
            arc, os.path.join(work, "s_back"), reference=fa), n_reads, rec)
    finally:
        sharded.SHARD_MIN_POSITIONS = old
        aligned._REF_CACHE.clear()
    if _md5(outs[0]) != want:
        raise RuntimeError("sharded-index round trip is not bit-exact")
    print(f"  sharded-index: mapped {st['mapped']:,} vs one-card Aligner "
          f"{one['mapped']:,} of {n_reads:,}; round trip bit-exact",
          flush=True)
    _check_device_ran("sharded-index", rec)
    _peak("sharded-index")
    return rec


def make_inputs(work: str, genome_bp: int, n_se: int, n_pe: int = 0,
                n_adapt: int = 0, n_align: int = 0) -> dict:
    """Seeded genome + FASTQ files for the phases (tools/genome_fixture)."""
    import numpy as np
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from genome_fixture import (make_genome, sample_reads, write_fasta,
                                write_fastq)
    t0 = time.perf_counter()
    codes, bounds = make_genome(genome_bp, SEED)
    out = {"fa": os.path.join(work, "ref.fa")}
    write_fasta(codes, bounds, out["fa"])
    seqs, quals = sample_reads(codes, n_se, READ_LEN,
                               np.random.default_rng(SEED + 1))
    for key, n in (("se", n_se), ("adapt", n_adapt), ("align", n_align)):
        if n:
            out[key] = os.path.join(work, f"{key}.fq")
            write_fastq(seqs[:n], quals[:n], out[key])
    if n_pe:
        s2, q2 = sample_reads(codes, 2 * n_pe, READ_LEN,
                              np.random.default_rng(SEED + 2))
        out["pe"] = [os.path.join(work, f"pe_{m}.fq") for m in (1, 2)]
        for m, path in enumerate(out["pe"]):
            write_fastq(s2[m::2], q2[m::2], path, tag=b"p")
    print(f"inputs generated in {time.perf_counter() - t0:.1f} s "
          f"(genome {genome_bp:,} bp, seed {SEED})", flush=True)
    return out


def _counts(scale: float) -> dict:
    n = {"se": N_SE, "adapt": N_ADAPT, "pe": N_PE, "align": N_ALIGN}
    if scale != 1.0:
        for k, v in list(n.items()):
            n[k] = max(1_000, int(v * scale))
            print(f"cut: {k} reads {v:,} -> {n[k]:,} (--scale {scale})",
                  flush=True)
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 = run only the multi-card phases")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every read count (cuts are printed)")
    a = ap.parse_args(argv)

    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU backend, JAX found {backend!r}",
              file=sys.stderr)
        return 1
    devs = jax.devices()
    if len(devs) < a.cards:
        print(f"chip_smoke: --cards {a.cards} but {len(devs)} visible",
              file=sys.stderr)
        return 1
    faulthandler.enable()        # a crash in native code names its caller
    sys.path.insert(0, REPO)
    from fastqueeze_tpu.io import native
    if native.get_lib() is None:
        # without the C++ coders the host route would silently fall back
        # to the device and every comparison would be a tautology
        print("chip_smoke: the native host library did not build",
              file=sys.stderr)
        return 1
    _listen()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}, devices {len(devs)} x "
          f"{devs[0].device_kind}", flush=True)
    n = _counts(a.scale)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t_all = time.perf_counter()
    # placement overrides already in the environment would make the
    # default (device) route another host route
    try:
        with _env(DEFAULT_ROUTE):
            if a.cards == 1:
                inp = make_inputs(WORK, GENOME_BP, n["se"], n["pe"],
                                  n["adapt"], n["align"])
                phase_codec("a", [inp["se"]], WORK, n["se"], extract=True)
                phase_codec("b", [inp["adapt"]], WORK, n["adapt"])
                phase_codec("c", inp["pe"], WORK, n["pe"])
                phase_aligned(inp["fa"], inp["align"], WORK, n["align"])
            else:
                inp = make_inputs(WORK, GENOME_BP, n["se"],
                                  n_align=n["align"])
                phase_mesh(inp["se"], WORK, n["se"], a.cards)
                phase_sharded_index(inp["fa"], inp["align"], WORK,
                                    n["align"])
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s",
          flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
