"""Card-only checks of the CUDA target (marker `gpu`): skipped on the
CPU, run on the card by chip_smoke.py (`pytest -m gpu --on-device`).
chip_smoke.py itself compares the kernel with the XLA wavefront at 2K."""

import jax
import numpy as np
import pytest

from raytracer_tpu import backends
from raytracer_tpu.camera import showcase_camera
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.models.fused import render_image_fused
from raytracer_tpu.ops import fused_kernel
from raytracer_tpu.scene.builder import reference_scene

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def scene():
    return reference_scene(assets_dir="assets/models", build_bvh=True)


def test_gpu_runs_the_cuda_target(gpu):
    assert jax.default_backend() == "gpu"
    assert backends.for_platform().fused_target == "cuda"


@pytest.mark.parametrize("w,h,spp,mb", [(128, 8, 2, 4), (256, 64, 4, 8),
                                        (100, 13, 2, 20)])
def test_cuda_target_matches_cpu_target(gpu, scene, w, h, spp, mb):
    """The same per-lane C++ (native/pathtrace.h) compiled by nvcc for
    the card and by g++ for the host: equal up to float contraction and
    libm differences, which flip a few paths."""
    cfg = RenderConfig(width=w, height=h, spp=spp, max_bounces=mb, rng_impl="ktf")
    cam = showcase_camera(cfg)
    key = jax.random.key(7)
    cuda = np.asarray(render_image_fused(scene, cam, cfg, key))
    assert "cuda" in fused_kernel._registered
    fused_kernel.ensure_registered("cpu")
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        host = np.asarray(render_image_fused(
            jax.device_put(scene, cpu_dev), cam, cfg, key))
    assert np.isfinite(cuda).all()
    agree = (np.abs(cuda - host).max(axis=-1) <= 1e-3).mean()
    assert agree >= 0.99, agree
    np.testing.assert_allclose(cuda.mean(), host.mean(), rtol=1e-3)
