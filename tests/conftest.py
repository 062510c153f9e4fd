import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
# are exercised without accelerators (SURVEY.md §4.4).  The platform is
# also pinned through jax.config, which wins over whatever platform list
# the environment preselected.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
# XLA:CPU persistent-cache entries are host-ISA-stamped AOT code; loading a
# mismatched entry can SIGILL/ABRT.  Tests always compile fresh.
os.environ["FASTQUEEZE_NO_COMPILE_CACHE"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", jax.default_backend()


import sys  # noqa: E402

import pytest  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))


@pytest.fixture(scope="session")
def bundled_pair(tmp_path_factory):
    """Paths of the seeded stand-in for the reference's bundled test pair
    (tools/genome_fixture.bundled_pair: 10k x 100 bp PE, ERR2755197-style
    names, telomeric-repeat share)."""
    from genome_fixture import write_bundled_pair
    return write_bundled_pair(str(tmp_path_factory.mktemp("bundled")))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    A full-suite run accumulates hundreds of XLA:CPU executables in one
    process; on this box the compile of a fresh kernel after ~120 tests
    segfaulted inside backend_compile_and_load (reproduced 4/4 full-suite
    runs at the same test, never in file-level or isolated runs, and
    MALLOC_CHECK_=3 saw nothing — i.e. late-compile breakage from
    executable accumulation, not heap corruption).  Bounding the live
    program count per module keeps every compile early-ish and cheap.
    """
    yield
    import jax
    jax.clear_caches()
