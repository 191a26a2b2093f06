"""The compile-cache helper: JAX's own variable wins; otherwise a fixed
directory inside the checkout — never a temporary, per-process path."""

import os
import tempfile

import jax
import pytest

from aswstereomatch_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_variable_set_leaves_jax_config_alone(monkeypatch,
                                                   restore_cache_dir):
    monkeypatch.setenv(compile_cache.ENV_VAR, "/some/where/else")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == "/some/where/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_env_variable_unset_uses_checkout_dir(monkeypatch,
                                              restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_dir_is_fixed_never_temporary(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    first = compile_cache.enable()
    monkeypatch.setenv("TMPDIR", "/elsewhere")
    assert compile_cache.enable() == first  # no pid, time or tempdir in it
    assert not first.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in first
    assert first == compile_cache.DEFAULT_DIR
