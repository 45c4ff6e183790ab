"""utils.cache.compilation_cache: where the persistent cache goes, and that
the entry point leaves JAX's global configuration as it found it."""

import os

import jax
import jax.numpy as jnp

from rsvio_tpu.utils import cache


def _settings():
    return (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs)


def test_honours_jax_compilation_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    with cache.compilation_cache() as d:
        assert d == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == d
        jax.jit(lambda x: x * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
    assert os.listdir(d), "no executable was written to the cache"


def test_default_is_checkout_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with cache.compilation_cache() as d:
        assert d == os.path.join(checkout, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d


def test_global_config_restored_on_exit(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = _settings()
    with cache.compilation_cache():
        assert _settings() != before
    assert _settings() == before


def test_cli_main_leaves_config_unchanged(tmp_path, monkeypatch):
    """An in-process CLI call (as the tests and chip_smoke.py make) does not
    leak the cache settings into the caller's process."""
    from rsvio_tpu.cli.run_euroc import main

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    before = _settings()
    empty = tmp_path / "DS" / "mav0" / "cam0"
    empty.mkdir(parents=True)
    (empty / "data.csv").write_text("#timestamp,filename\n")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("camera:\n  image_width: 64\n  image_height: 48\n"
                   "  left_intrinsics: [50, 50, 32, 24]\n"
                   "  right_intrinsics: [50, 50, 32, 24]\n")
    assert main([str(cfg), str(tmp_path / "DS"), "--quiet"]) == -1
    assert _settings() == before
