"""Process set-up helpers (msckf_stereo_c/device.py): where the compile
cache lands and the platform choice; the filter defaults every entry point
starts from, and the import-time footprint of the config module."""
import os
import subprocess
import sys

import jax
import pytest

from msckf_stereo_c import device
from msckf_stereo_c.config import FilterConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=full, capture_output=True,
        text=True, timeout=300,
    )


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")
    # The test session itself was set up through the helper.
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        assert jax.config.jax_compilation_cache_dir == os.path.join(ROOT, ".jax_cache")


def test_cache_lands_in_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, a compiled program is cached
    there and nowhere else is configured."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from msckf_stereo_c.device import setup_compile_cache\n"
        "print(setup_compile_cache())\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n"
    )
    cache = tmp_path / "cache"
    out = _run(code, JAX_COMPILATION_CACHE_DIR=str(cache))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(cache)
    assert any(cache.iterdir()), "nothing was cached in JAX_COMPILATION_CACHE_DIR"


def test_select_platform_refuses_unknown():
    with pytest.raises(ValueError):
        device.select_platform("metal")


def test_gpu_request_without_gpu_fails():
    """A GPU run on a machine without one fails; it never falls back."""
    code = (
        "import jax\n"
        "from msckf_stereo_c.device import select_platform\n"
        "select_platform('gpu')\n"
        "print(jax.devices())\n"
    )
    out = _run(code)
    if out.returncode == 0:  # a machine with a GPU
        assert "cuda" in out.stdout.lower(), out.stdout
    else:
        assert out.stdout == "", out.stdout


def test_filter_config_defaults():
    """Exact factorizations and float32 filter matmuls on every platform
    (a tensorfloat32 filter diverges on the GPU's stress run)."""
    cfg = FilterConfig()
    assert (cfg.ns_iters, cfg.matmul_precision) == (0, "float32")


def test_config_import_does_not_need_yaml():
    """PyYAML is imported only by the config-file loaders."""
    code = (
        "import sys\n"
        "import msckf_stereo_c.config as c\n"
        "assert 'yaml' not in sys.modules\n"
        "c.load_camchain('config/camchain-imucam-euroc.yaml')\n"
        "assert 'yaml' in sys.modules\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr[-2000:]
