"""Where each phase runs, and where compiled programs are cached.

One rule for the whole package: the CPU backend runs the native C++
host kernels (counting, adjacency/link build, read pathing); any other
backend (the GPU) runs the device forms of those phases.  Plain
``JAX_PLATFORMS`` selects the backend.
"""

from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_path() -> bool:
    """True where the phases that have a device form run on the device;
    False on the CPU backend, which takes the native host path."""
    return jax.default_backend() != "cpu"


def use_compile_cache() -> None:
    """Keep compiled programs in JAX's persistent cache: in
    ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself),
    otherwise in ``<checkout>/.jax_cache``."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir", os.path.join(_CHECKOUT, ".jax_cache")
        )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
