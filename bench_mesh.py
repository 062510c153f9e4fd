"""Mesh scaling-efficiency benchmark (BASELINE.md target: >= 80 % reads/s
scaling efficiency from 1 device to N, block-data-parallel).

Measures the FULL archive-production path — `driver.compress_se` with
`mesh_n=N` (the real --mesh N code path: host parse, per-device frozen
replicas, stream coding, transfers, container writes) — over meshes of
1, 2, 4, ... N devices with one 1 MB block per device (weak scaling), and
reports reads/s and efficiency (reads_per_s_N / (N * reads_per_s_1)).
A second kernel-only series (encode_blocks_sharded) isolates the
device-compute scaling from the host pipeline.

With --real it runs on the visible accelerators (e.g. the GPUs of one
host).  Without it, the run uses an 8-virtual-device CPU mesh
(xla_force_host_platform_device_count): the virtual devices share the
host's cores, so *wall-clock* efficiency is bounded there; the per-device
work constancy check and the payload-equality invariant
(tests/test_mesh.py) are what the CPU run validates.

Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time


def _bench_archive(n: int, src: str, n_reads_per_block: int) -> dict:
    """Time compress_se over an n-device mesh; input is n blocks."""
    from fastqueeze_tpu.config import CodecParams
    from fastqueeze_tpu.pipeline.driver import compress_se

    out = os.path.join(tempfile.mkdtemp(), "out.fqz")

    def run():
        p = CodecParams(block_bytes=1 << 20,
                        mesh_n=n if n > 1 else 0,
                        threads=n)
        t0 = time.time()
        stats = compress_se(p, src, out)
        return time.time() - t0, stats

    run()                                    # warm-up compile
    best, stats = None, None
    for _ in range(2):
        dt, stats = run()
        best = dt if best is None else min(best, dt)
    reads = n * n_reads_per_block
    return {"devices": n, "wall_s": round(best, 4),
            "reads_per_s": round(reads / best, 1),
            "blocks": stats["blocks"]}


def main() -> None:
    import jax
    if "--real" not in sys.argv:
        # virtual-device CPU mesh by default; pass --real to run on the
        # actual accelerators.  Switch platform via jax.config before the
        # first device query initializes a backend.
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from fastqueeze_tpu.models.base import QualModel
    from fastqueeze_tpu.ops import engine
    from fastqueeze_tpu.parallel.mesh import encode_blocks_sharded, make_mesh

    n_dev = len(jax.devices())

    # --- series 1: full archive production (weak scaling, one 1 MB block
    #     per device; same synthetic 100 bp reads at every mesh size) ---
    rng = np.random.default_rng(0)
    mesh_sizes = []
    n = 1
    while n <= n_dev:
        mesh_sizes.append(n)
        n *= 2
    rec = []
    i = 0
    # ~1 MB of records per block (big enough to amortize dispatch,
    # small enough that the 1-vCPU virtual-mesh run finishes in minutes)
    while sum(len(r) for r in rec) < max(mesh_sizes) * (1 << 20):
        seq = rng.choice(list(b"ACGT"), size=100).astype(np.uint8)
        qv = (rng.integers(0, 41, size=100) + 33).astype(np.uint8)
        rec.append(f"@b.{i}\n{bytes(seq).decode()}\n+\n"
                   f"{bytes(qv).decode()}\n".encode())
        i += 1
    per_block = len(rec) // max(mesh_sizes)
    tmp = tempfile.mkdtemp()
    archive = []
    for n in mesh_sizes:
        src = os.path.join(tmp, f"in{n}.fq")
        with open(src, "wb") as fh:
            fh.write(b"".join(rec[:n * per_block]))
        archive.append(_bench_archive(n, src, per_block))
    base = archive[0]["reads_per_s"]
    for r in archive:
        r["efficiency"] = round(r["reads_per_s"] / (r["devices"] * base), 3)

    # --- series 2: bare coding kernel (device-compute scaling floor) ---
    model = QualModel(alphabet=40, init=1, inc=8, cap=8192, qlevel=2)
    T, L = 256, 256          # 64k symbols per block
    n_halve = engine._n_halve(model, L)
    counts0 = engine.init_counts(model)
    kernel = []
    for n in mesh_sizes:
        mesh = make_mesh(n)
        B = n                # one block per device: weak scaling
        syms = jnp.asarray(
            rng.integers(0, model.alphabet, (B, T, L)).astype(np.uint8))
        valid = jnp.ones((B, T, L), bool)
        pos = jnp.broadcast_to(
            jnp.arange(T, dtype=jnp.int32)[None, :, None], (B, T, L))

        def sync(arr):
            return float(jnp.sum(arr))

        w, e, x = encode_blocks_sharded(mesh, model, n_halve, counts0,
                                        syms, valid, pos)
        sync(x)              # warm-up compile
        best = None
        for _ in range(3):
            t0 = time.time()
            w, e, x = encode_blocks_sharded(mesh, model, n_halve, counts0,
                                            syms, valid, pos)
            sync(x)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        kernel.append({"devices": n, "wall_s": round(best, 4),
                       "syms_per_s": round(B * T * L / best, 1)})
    kbase = kernel[0]["syms_per_s"]
    for r in kernel:
        r["efficiency"] = round(r["syms_per_s"] / (r["devices"] * kbase), 3)

    print(json.dumps({
        "metric": "mesh_block_dp_scaling",
        "value": archive[-1]["efficiency"],
        "unit": "archive_efficiency_at_max_devices",
        "platform": jax.devices()[0].platform,
        "note": ("virtual CPU devices share the host's cores: wall-clock "
                 "efficiency is bounded on this host"
                 if jax.devices()[0].platform == "cpu" else "real mesh"),
        "archive_path": archive,
        "kernel_only": kernel,
    }))


if __name__ == "__main__":
    main()
