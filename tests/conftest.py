"""Test configuration: run on CPU with 8 virtual devices.

Multi-device sharding paths (shard_map over the node mesh axis) are
exercised on a simulated 8-device CPU mesh, per the project test strategy
(SURVEY §4). The platform is pinned through the config object as well as
the environment, before any backend initialization. Tests that need the
card carry the ``gpu`` marker and run it in a child process.
"""

import os

# NO persistent XLA cache for the CPU suite: XLA:CPU warns that cached AOT
# results compiled for another machine type could raise SIGILL, and the
# full suite has segfaulted inside compilation_cache get/put (individual
# files never did). GPU runs (CLI, benches) keep the cache.
os.environ["DIP_ADMM_NO_XLA_CACHE"] = "1"

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_default_matmul_precision", "highest")

assert len(jax.devices()) == 8, jax.devices()


import shutil  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless nvidia-smi lists a GPU on this machine (decided when the
    test runs, never at import: workers must collect the same tests)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
        [smi, "-L"], capture_output=True, timeout=60
    ).returncode != 0:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi lists none)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    The full suite compiles several hundred XLA:CPU programs into one
    process; past ~180 tests the NEXT compile (or compilation-cache
    read/write) reproducibly dies with SIGABRT/SIGSEGV inside XLA on this
    host — cumulative JIT-code state, not any single test (every file
    passes in isolation; the crash site moves with cache settings but the
    position doesn't). Dropping jax's executable caches per module bounds
    the live-program count at the cost of some recompilation."""
    yield
    import jax

    jax.clear_caches()
