"""Test harness: the CPU with 8 virtual devices, so sharding tests run
without accelerators (SURVEY.md §4 item 4).

`--on-device` keeps JAX's default accelerator instead: chip_smoke.py runs
the card-only tests (marker `gpu`) that way, in its own process. Tests
that need the card take the `gpu` fixture, which skips them elsewhere.
"""

import os

import jax
import pytest


# ---- fast/slow split -------------------------------------------------
# `pytest -m "not slow"` runs the invariant core in a few minutes;
# the full suite (~15 min on this box) stays the CI default. Tests are
# marked by id substring — one maintenance point, measured from
# --durations (everything >= ~13 s of the r2 suite).
_SLOW_IDS = (
    "test_bvh4_matches_brute_force",
    "test_triangle_scene_matches_oracle",
    "test_sharded_2d_rays_spp_matches_single_device",
    "test_sharded_wavefront_matches_single_device",
    "test_wavefront_equals_megakernel_on_triangle_scene",
    "test_spp_batched_render_matches_single_pass",
    "test_sharded_train_step_matches_unsharded",
    "test_wavefront_deep_bounces_matches",
    "test_interior_showcase_brightness",
    "test_training_reduces_loss",
    "test_resume_from_partial_checkpoint",
    "test_wavefront_matches_megakernel",
    "test_native_and_python_builders_agree",
    "test_backends_agree_on_two_level_scene",
    "test_mesh_material_grads_match_finite_difference",
    "test_drain_cascade_bit_exact",
    "test_resumable_render_matches_direct",
    "test_matches_numpy_oracle",
    "test_scaling_report_efficiency_normalization",
    "test_bvh4_leaf_ranges_cover_all_triangles",
    "test_two_process_distributed_render",
    "test_sharded_wavefront_interleave_active",
    "test_fused_sharded_matches_single_device",
)


def pytest_addoption(parser):
    parser.addoption("--on-device", action="store_true",
                     help="run on the default accelerator instead of 8 "
                          "virtual CPU devices (chip_smoke.py)")


def pytest_configure(config):
    if not config.getoption("--on-device"):
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(s in item.nodeid for s in _SLOW_IDS):
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """The 2026-08 jaxlib's CPU backend segfaults inside
    backend_compile_and_load once a single process has accumulated
    ~90+ compiled programs (reproducible at the same suite position,
    passes in isolation — an LLVM JIT state bug, not a test bug).
    Dropping the jit caches between modules keeps the live-program
    count bounded; per-module recompiles cost seconds."""
    yield
    import jax

    jax.clear_caches()
