"""obs/compile_cache: the cache honours JAX_COMPILATION_CACHE_DIR and
otherwise uses a fixed, git-ignored directory inside the checkout."""

import os

import jax

from tpu_icp_slam.obs import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_uses_env_when_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.delenv("TPU_ICP_SLAM_NO_CACHE", raising=False)
    assert compile_cache.cache_dir() == str(tmp_path / "env")
    compile_cache.enable(str(tmp_path / "other"))
    # the variable wins and no other path is set
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "other").exists()


def test_cache_dir_fixed_in_checkout_when_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert compile_cache.cache_dir() == path  # no pid, time or temp name
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split(), "must be git-ignored"


def test_enable_sets_given_path_when_env_unset(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("TPU_ICP_SLAM_NO_CACHE", raising=False)
    try:
        compile_cache.enable(str(tmp_path / "c"))
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
