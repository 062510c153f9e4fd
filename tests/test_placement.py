"""Default placement of the frozen coder, the adaptive coder and the
aligner (ops/host_frozen.auto_host): the device on an accelerator backend
or under --mesh, the native host code only on a CPU backend; explicit
overrides win.  Also the compile-cache directory rule."""

import os

import jax
import numpy as np
import pytest

import fastqueeze_tpu
from fastqueeze_tpu.align.hash import Aligner
from fastqueeze_tpu.align.index import build_from_ref
from fastqueeze_tpu.align.ref import RefSeq
from fastqueeze_tpu.config import CodecParams
from fastqueeze_tpu.io import native
from fastqueeze_tpu.models.base import QualModel, SeqModel
from fastqueeze_tpu.ops import host_adapt, host_frozen

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native library unavailable")

_ENV = {"frozen": "FASTQUEEZE_FROZEN_EXEC",
        "adapt": "FASTQUEEZE_ADAPT_EXEC",
        "align": "FASTQUEEZE_ALIGN_EXEC"}


def _aligner(p):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 4096).astype(np.uint8)
    ref = RefSeq(codes=codes, amb_mask=np.zeros(4096, bool), names=["c"],
                 bounds=np.array([0, 4096]), md5="")
    return Aligner(build_from_ref(ref, p), p)


def _route(router, p):
    if router == "frozen":
        return host_frozen.route(p, SeqModel(alphabet=4, init=3, inc=1,
                                             cap=253, order=4))
    if router == "adapt":
        return host_adapt.route(p, QualModel(alphabet=8, init=1, inc=8,
                                             cap=8192, qlevel=2))
    al = _aligner(CodecParams(seed_len=10))
    al.params = p
    return al._host_ok(64)


@pytest.mark.parametrize("router", ["frozen", "adapt", "align"])
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("mesh", [0, 2])
@pytest.mark.parametrize("override", ["auto", "env-host", "env-device",
                                      "param-host", "param-device"])
def test_default_placement(monkeypatch, router, backend, mesh, override):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    for var in _ENV.values():
        monkeypatch.delenv(var, raising=False)
    kw = {"mesh_n": mesh}
    if override.startswith("env-"):
        monkeypatch.setenv(_ENV[router], override[4:])
    elif override.startswith("param-"):
        kw["frozen_exec"] = 1 if override == "param-host" else 2
    want = backend == "cpu" and not mesh
    if override in ("env-host", "env-device"):
        want = override == "env-host"
    elif override.startswith("param-") and router != "align":
        # frozen_exec covers both wave coders, not the aligner
        want = override == "param-host"
    assert _route(router, CodecParams(**kw)) is want


@pytest.mark.parametrize("backend,env,want", [
    ("gpu", {"JAX_COMPILATION_CACHE_DIR": "/cache/x"}, "/cache/x"),
    ("gpu", {}, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(fastqueeze_tpu.__file__))), ".jax_cache")),
    ("cpu", {"JAX_COMPILATION_CACHE_DIR": "/cache/x"}, None),
    ("cpu", {}, None),
    ("gpu", {"FASTQUEEZE_NO_COMPILE_CACHE": "1"}, None),
])
def test_compile_cache_dir(backend, env, want):
    """JAX_COMPILATION_CACHE_DIR wins; otherwise a fixed directory inside
    the checkout; a CPU backend keeps the cache off."""
    assert fastqueeze_tpu.compile_cache_dir(backend, env) == want


def test_cli_enables_cache_before_its_first_compile(tmp_path):
    """cli.main decides the cache from the backend before anything
    compiles, so on an accelerator the cache holds the run's programs.
    Run in a child with the backend reported as 'gpu' (the programs still
    compile for the CPU) and the cache pointed into tmp_path."""
    import subprocess
    import sys
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, b"ACGT" * 25, b"F" * 100)
                            for i in range(200)))
    cache = tmp_path / "cache"
    code = (
        "import jax, sys; jax.default_backend = lambda: 'gpu'\n"
        "import fastqueeze_tpu as f\n"
        "decide = f.enable_compile_cache\n"
        "def enable():\n"
        "    decide()   # then keep even sub-second compiles\n"
        "    jax.config.update("
        "'jax_persistent_cache_min_compile_time_secs', 0)\n"
        "f.enable_compile_cache = enable\n"
        "import fastqueeze_tpu.cli as c\n"
        "import fastqueeze_tpu.ops.host_frozen as h\n"
        "h.auto_host = lambda p: False\n"
        "sys.exit(c.main(['-c', '-1', sys.argv[1], '-o', sys.argv[2], "
        "'-f']))\n")
    env = {k: v for k, v in os.environ.items()
           if k != "FASTQUEEZE_NO_COMPILE_CACHE"}
    env["JAX_COMPILATION_CACHE_DIR"] = str(cache)
    r = subprocess.run([sys.executable, "-c", code, str(fq),
                        str(tmp_path / "r.fqz")], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert cache.is_dir() and any(cache.iterdir())
