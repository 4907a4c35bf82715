"""Process set-up helpers (st_dadk_tpu/utils/platform.py)."""
import subprocess

import jax
import pytest

from st_dadk_tpu.utils import platform


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_env_sets_nothing(monkeypatch, tmp_path,
                                         restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert platform.enable_compile_cache() == str(tmp_path)
    # jax reads the variable itself; the helper names no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.enable_compile_cache()
    assert path == str(platform.REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_apply_platform_env_unset_is_noop(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    platform.apply_platform_env()
    assert jax.default_backend() == "cpu"


def test_apply_platform_env_refuses_other_live_backend(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            platform.apply_platform_env()
    finally:
        jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu"


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        platform.require_gpu()


def test_gpu_name_and_power_limit_queries_nvidia_smi(monkeypatch):
    calls = []

    def fake_run(argv, **kw):
        calls.append(argv)
        return subprocess.CompletedProcess(
            argv, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n", stderr="")
    monkeypatch.setattr(subprocess, "run", fake_run)
    assert (platform.gpu_name_and_power_limit()
            == "NVIDIA H100 80GB HBM3, 700.00 W")
    assert calls == [["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]
