"""The compile-cache helper: the environment variable wins, otherwise a
fixed directory inside the checkout that .gitignore lists."""

import os

import jax
import pytest

from fmcw_radar_processing_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_is_honoured(monkeypatch, updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert updates == []  # JAX reads the variable itself


def test_default_is_fixed_in_checkout(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert updates == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
