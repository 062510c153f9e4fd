"""fastqueeze_tpu — an accelerator-native FASTQ compression framework in JAX.

A ground-up JAX/XLA re-design with the capabilities of the reference
SeqArc v1.6 compressor (see SURVEY.md): block-parallel FASTQ compression with
adaptive context models (sequence / quality / name / length / alignment-info
streams), optional reference-based alignment, lossy quality transform, and a
seekable TLV container format.

Key architectural departures from the reference (which is serial, per-symbol
range coding in C++ — SURVEY.md §2.1):

* Entropy coding is an **interleaved rANS** coder over many SIMD lanes, with
  **wave-synchronized adaptive models**: all lanes code symbol ``t`` against
  the model state produced by waves ``< t``, then the model tables are updated
  with the whole wave at once (a batched scatter-add).  Encode and decode
  perform bit-identical integer model walks, so the coder stays adaptive while
  being fully vectorized over lanes.
* Alignment is batched seed-lookup + gapless XOR/popcount extension over a
  2-bit packed reference, instead of a per-read scalar loop.
* Scale-out is block data-parallelism over a ``jax.sharding.Mesh`` instead of
  pthreads.
"""

__version__ = "0.1.0"

import os as _os


_REPO_DIR = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(backend: str, environ=_os.environ):
    """Directory of the persistent XLA compilation cache for a JAX backend,
    or None when the cache stays off.

    The wave coders compile once per (model, T, L) bucket; the cache lets a
    later process start warm.  JAX_COMPILATION_CACHE_DIR wins when set;
    otherwise a fixed directory inside the checkout (never a temp or home
    path: the directory is part of what makes a later run hit).  A CPU
    backend (tests, --cpu, a host without a GPU) never caches: XLA:CPU cache
    entries are AOT machine code stamped with the compiling host's CPU
    features, and loading one whose feature set mismatches the running host
    can SIGILL/SIGSEGV instead of falling back to a recompile."""
    if environ.get("FASTQUEEZE_NO_COMPILE_CACHE") or backend == "cpu":
        return None
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_REPO_DIR, ".jax_cache"))


_CACHE_DECIDED = []


def enable_compile_cache() -> None:
    """Turn the persistent cache on once the backend is known to be an
    accelerator.  The entry points (cli.main, api) call this before their
    first compile; JAX reads the setting at the process's first compile,
    so later calls change nothing."""
    if _CACHE_DECIDED:
        return
    _CACHE_DECIDED.append(True)
    import jax
    cache_dir = compile_cache_dir(jax.default_backend())
    if cache_dir is None:
        return
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_enable_compilation_cache", True)


# no platform query at import: the cache stays off (even where
# JAX_COMPILATION_CACHE_DIR is set) until enable_compile_cache has seen the
# backend
import jax as _jax  # noqa: E402

_jax.config.update("jax_enable_compilation_cache", False)

from fastqueeze_tpu.config import CodecParams  # noqa: F401
from fastqueeze_tpu import api  # noqa: F401  (one-call library surface)
