"""The persistent compilation cache location shared by the CLI, bench.py
and chip_smoke.py (scema_tpu/utils/compile_cache.py)."""
import os
import subprocess
import sys

import jax

from scema_tpu.utils import compile_cache as CC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(CC.ENV_VAR, str(tmp_path))
    assert CC.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_without_env_var_cache_is_in_checkout(monkeypatch):
    monkeypatch.delenv(CC.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = CC.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cli_run_reports_and_caches_where_env_says(tmp_path):
    """A CLI run names its device, reports set-up, compile and per-step
    seconds, and its compiled programs land in JAX_COMPILATION_CACHE_DIR."""
    cache = tmp_path / "cache"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", CC.ENV_VAR: str(cache),
           "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"}
    r = subprocess.run(
        [sys.executable, "-m", "scema_tpu.cli", "run",
         os.path.join(REPO, "configs", "dogbone_cuboid.json"),
         "--hooke", "--cpu", "--steps", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    for key in ("Device: cpu", "Set-up:", "Compile:",
                "Seconds per macro-step:", "flagged qps 144  md jobs 144"):
        assert key in r.stdout, key
    assert cache.is_dir() and any(cache.iterdir())
