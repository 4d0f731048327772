"""utils/compile_cache.py: where the persistent compilation cache lives."""

import os
import subprocess
import sys

import pytest

from dcd_isaac_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_unset_uses_checkout_dir(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    assert compile_cache.cache_dir_from_env() == os.path.join(
        ROOT, '.jax_cache')


def test_set_uses_that_dir_only(monkeypatch, tmp_path):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert compile_cache.cache_dir_from_env() == str(tmp_path)


def test_empty_disables(monkeypatch):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', '')
    assert compile_cache.cache_dir_from_env() is None
    assert compile_cache.enable_persistent_cache() is None


@pytest.mark.parametrize('setting', ['env', 'unset'])
def test_entry_point_writes_where_the_rule_says(tmp_path, setting):
    """A fresh process enables the cache and compiles one program; the
    entry lands in the selected directory."""
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    env['JAX_PLATFORMS'] = 'cpu'
    code = (
        'import jax, jax.numpy as jnp\n'
        'from dcd_isaac_tpu.utils import compile_cache as cc\n'
        'print(cc.enable_persistent_cache())\n'
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        'jax.jit(lambda x: jnp.sin(x) * 3.0 + 0.123456)(jnp.ones(7))'
        '.block_until_ready()\n'
        "print(jax.config.jax_compilation_cache_dir)\n")
    if setting == 'env':
        env['JAX_COMPILATION_CACHE_DIR'] = str(tmp_path / 'cache')
        want = str(tmp_path / 'cache')
    else:
        want = os.path.join(ROOT, '.jax_cache')
    out = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                         env={**env, 'PYTHONPATH': ROOT}, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split()
    assert lines == [want, want]
    assert os.listdir(want)
