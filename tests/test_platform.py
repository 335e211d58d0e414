"""Platform plumbing: the backend each platform runs, the compile-cache
directory, and chip_smoke.py's refusal to run without a GPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

from raytracer_tpu import backends
from raytracer_tpu.utils import jaxcache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_gpu_backend_runs_cuda_kernel_and_xla_traversal():
    b = backends.for_platform("gpu")
    assert b.fused_target == "cuda"
    assert b.traversal in ("lane", "packets")
    assert b.native_bvh_required


def test_cpu_backend_runs_cpu_target():
    b = backends.for_platform("cpu")
    assert b.fused_target == "cpu" and b.traversal == "packets"
    assert backends.for_platform() == b  # the tests run on the CPU


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no backend for platform"):
        backends.for_platform(platform)


def test_no_interpreter_in_the_package():
    """No code path can fall back to a kernel interpreter."""
    for path in (ROOT / "raytracer_tpu").rglob("*.py"):
        text = path.read_text()
        assert "interpret=" not in text and "pallas" not in text, path


@pytest.fixture
def cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_cache_dir_honours_env(monkeypatch, tmp_path, cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.enable() == str(tmp_path)
    assert jaxcache.cache_dir() == str(tmp_path)
    # JAX reads the variable itself; enable() sets no other directory.
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_dir_default_is_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    expected = str(ROOT / ".jax_cache")
    assert jaxcache.enable() == expected
    assert jax.config.jax_compilation_cache_dir == expected


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_cpu():
    p = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and "needs a GPU" in p.stderr + p.stdout


def test_chip_smoke_refuses_without_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    p = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert p.returncode != 0 and '"ok"' not in p.stdout
