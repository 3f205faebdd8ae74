"""Process set-up helpers: the compile cache, the GPU gate, the summary."""

import os
import tempfile

import pytest

from learn_nerf_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache setting after the test."""
    import jax

    old = jax.config.jax_compilation_cache_dir
    yield jax.config
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_set_is_left_to_jax(monkeypatch, cache_config):
    before = cache_config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert device.use_compile_cache() == "/some/cache"
    assert cache_config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset_uses_repo_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.use_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert cache_config.jax_compilation_cache_dir == path


def test_compile_cache_path_is_fixed(monkeypatch, cache_config):
    """The path is part of each cache key: it must not come from the pid,
    a temporary name or the time."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = device.use_compile_cache()
    monkeypatch.setattr(os, "getpid", lambda: 999999)
    monkeypatch.setattr(tempfile, "tempdir", "/elsewhere")
    assert device.use_compile_cache() == first
    assert not first.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in first


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        device.require_gpu()


def test_device_summary_names_the_device():
    import jax

    summary = device.device_summary()
    assert summary == dict(
        platform=jax.devices()[0].platform,
        kind=jax.devices()[0].device_kind,
        count=len(jax.devices()),
    )
