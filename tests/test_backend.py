"""The accelerator rule and the compile-cache rule (backend.py)."""

import os

import jax
import pytest

from w2rap_contigger_tpu import backend


@pytest.mark.parametrize(
    "platform, device", [("cpu", False), ("gpu", True), ("tpu", True)]
)
def test_device_path_follows_backend(monkeypatch, platform, device):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert backend.device_path() is device


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache goes to <checkout>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        backend.use_compile_cache()
        got = jax.config.jax_compilation_cache_dir
        if env_dir is None:
            root = os.path.dirname(os.path.dirname(backend.__file__))
            assert got == os.path.join(root, ".jax_cache")
        else:
            assert got == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
