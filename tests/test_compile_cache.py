"""The one place the package configures JAX's persistent compile cache."""

import os

import jax

from cudapathtracer_tpu.utils import compile_cache


def _restore(prev_env, prev_cfg):
    if prev_env is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = prev_env
    jax.config.update("jax_compilation_cache_dir", prev_cfg)


def test_env_var_wins(tmp_path):
    prev = (os.environ.get("JAX_COMPILATION_CACHE_DIR"),
            jax.config.jax_compilation_cache_dir)
    try:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        _restore(*prev)


def test_default_is_checkout_cache():
    prev = (os.environ.get("JAX_COMPILATION_CACHE_DIR"),
            jax.config.jax_compilation_cache_dir)
    try:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        path = compile_cache.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        _restore(*prev)
