"""The compile-cache setting and the GPU smoke script's refusal to run
without a GPU."""
import os
import subprocess
import sys

import jax
import pytest

from openairinterface5g_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore the two cache settings enable_compile_cache may change."""
    keep = (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", keep[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", keep[1])


def test_cache_leaves_jax_compilation_cache_dir_to_jax(cache_config,
                                                        monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_defaults_to_the_checkout(cache_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == os.path.join(REPO,
                                                                ".jax_cache")


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr
