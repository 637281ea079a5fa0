"""Process set-up shared by every entry point: the persistent compile cache
and the platform choice.

Call ``setup_compile_cache`` before the first compilation and
``select_platform`` before the first ``jax.devices()``.
"""
from __future__ import annotations

import os

# The checkout this package lives in; the default compile cache sits there.
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLATFORMS = ("gpu", "cpu")
_JAX_PLATFORM = {"gpu": "cuda", "cpu": "cpu"}


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the cache key includes it, so a moving one never hits)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``;
    returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def select_platform(platform: str) -> None:
    """Run on ``platform`` ("gpu" or "cpu") only.  A GPU run on a machine
    without one fails at the first ``jax.devices()`` — it never falls back
    to the CPU."""
    import jax

    if platform not in PLATFORMS:
        raise ValueError(f"platform={platform!r} is not one of {PLATFORMS}")
    jax.config.update("jax_platforms", _JAX_PLATFORM[platform])

