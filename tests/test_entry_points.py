"""Entry-point plumbing that needs no GPU: the compile-cache helper and
chip_smoke.py's refusal to run without a card."""

import os

import jax
import pytest

from nlpartsol.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing and
    reports the variable's directory."""
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "env_cache"))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path / "env_cache")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch, tmp_path, restore_cache_dir):
    """Unset, the cache is the fixed checkout path `.jax_cache` (listed in
    .gitignore), created if missing."""
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    target = str(tmp_path / "repo_cache")
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", target)
    assert compile_cache.enable() == target
    assert os.path.isdir(target)
    assert jax.config.jax_compilation_cache_dir == target


def test_chip_smoke_refuses_cpu(capsys):
    """On the CPU chip_smoke.main() exits non-zero and prints no ok line."""
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out
