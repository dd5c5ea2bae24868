"""utils.compile_cache: JAX_COMPILATION_CACHE_DIR wins when set, else the
cache lives at <checkout>/.jax_cache."""

import os

import jax
import pytest

from chad_tsdf_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_set_changes_nothing(monkeypatch, tmp_path,
                                     restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_env_var_unset_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
