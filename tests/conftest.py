"""Test configuration: run everything on a virtual 8-device CPU mesh with
float64 enabled so filter numerics can be validated against NumPy oracles.
Must set flags before jax initializes a backend.  Tests that need a GPU
carry the ``gpu`` marker and skip without one (``chip_smoke.py`` runs the
GPU path)."""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from msckf_stereo_c.device import select_platform, setup_compile_cache  # noqa: E402

select_platform("cpu")
jax.config.update("jax_enable_x64", True)
# Compile latency on CPU is high (~0.5-1s per primitive); the persistent
# compilation cache lets repeat test runs skip recompilation.
setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
# XLA can abort() the whole process when compiling/serializing a LARGE
# program late in a session that has accumulated many live executables
# (seven observations, each time on the biggest program that runs late —
# test_recovery, then test_stress_gate, then test_vio_multiseq as each got
# isolated/changed; never when the module runs alone; seen with
# RLIMIT_MEMLOCK pinned at 8 MB).  Two mitigations:
#   * the heaviest full-pipeline modules run in subprocesses
#     (tests/_isolation.py),
#   * live executables are released between modules (below), keeping the
#     in-process accumulation far from the abort threshold.


import subprocess

import pytest


def pytest_configure(config):
    """Build the native runtime the IO tests exercise (``make -C native``),
    once, before any xdist worker starts.  Where it cannot be built, the
    tests that need it skip with the reason."""
    if hasattr(config, "workerinput"):
        return
    native = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
    try:
        subprocess.run(["make", "-s", "-C", native], capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        pass


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided when the test runs, never at
    import: every xdist worker must collect the same tests)."""
    if not any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_executables_between_modules():
    yield
    jax.clear_caches()
