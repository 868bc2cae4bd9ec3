"""Persistent-compilation-cache placement."""

import os

import jax
import pytest

import flowdenoising_tpu.utils.compile_cache as cc


@pytest.fixture(autouse=True)
def _restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_disabled_by_env(monkeypatch, tmp_path):
    monkeypatch.setenv("FDTPU_NO_CACHE", "1")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cc.enable_compilation_cache() is None
    assert not (tmp_path / "c").exists()


def test_first_call_wins_and_creates_dir(monkeypatch, tmp_path):
    """Repeated calls are idempotent: same directory, created once."""
    monkeypatch.delenv("FDTPU_NO_CACHE", raising=False)
    d = str(tmp_path / "one")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    assert cc.enable_compilation_cache() == d
    assert os.path.isdir(d)
    assert cc.enable_compilation_cache() == d
    assert jax.config.jax_compilation_cache_dir == d


def test_env_dir_used(monkeypatch, tmp_path):
    monkeypatch.delenv("FDTPU_NO_CACHE", raising=False)
    d = str(tmp_path / "envdir")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    assert cc.cache_dir() == d
    assert cc.enable_compilation_cache() == d
    assert jax.config.jax_compilation_cache_dir == d


@pytest.mark.parametrize("home", ["/nonexistent/home", None])
def test_unset_env_uses_fixed_checkout_dir(monkeypatch, home):
    """Without the variable the cache sits in the checkout, at a path that
    depends on neither $HOME, $TMPDIR nor the process."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    if home is None:
        monkeypatch.delenv("HOME", raising=False)
    else:
        monkeypatch.setenv("HOME", home)
    monkeypatch.setenv("TMPDIR", "/nonexistent/tmp")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cc.cache_dir() == os.path.join(repo, ".jax_cache")
    assert cc.cache_dir() == cc.CHECKOUT_CACHE_DIR


def test_checkout_cache_dir_is_gitignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert os.path.basename(cc.CHECKOUT_CACHE_DIR) in ignored
