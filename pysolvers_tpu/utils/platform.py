"""Platform selection and compile-cache setup for scripts."""
from __future__ import annotations

import os

# <repo>/.jax_cache: a fixed path, so repeated runs of any script from one
# checkout share one persistent compilation cache (the path is part of the
# cache key)
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def ensure_platform(platform: str = None, cpu_devices: int = 0) -> None:
    """Force a JAX platform (call before the first device use)."""
    if not platform:
        return
    import jax

    jax.config.update("jax_platforms", platform)
    if platform == "cpu" and cpu_devices:
        jax.config.update("jax_num_cpu_devices", cpu_devices)


def enable_persistent_cache() -> None:
    """Turn on JAX's persistent compilation cache — the one place the
    program sets it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache and JAX reads it
    itself, so nothing is set here; otherwise the cache is
    ``<repo>/.jax_cache``.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", _REPO_CACHE)


def warmup_device() -> None:
    """Initialize the backend: dispatch a tiny matmul and fetch one scalar
    back, so the first timed call pays no start-up."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    y = jnp.ones((8, 128)) @ jnp.ones((128, 8))
    float(np.asarray(y).ravel()[0])


def add_platform_arg(parser) -> None:
    parser.add_argument("--platform", default=None,
                        choices=["cpu", "gpu"],
                        help="force a JAX platform (cpu runs anywhere)")
