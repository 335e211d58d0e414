"""Wavefront (path-regeneration) integrator ≡ megakernel oracle.

Because RNG is keyed by (pixel, sample, bounce, purpose), both
integrators trace the *same* paths; only the fp accumulation order
differs, so allclose holds at tight tolerance (not just statistically).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.camera import make_camera
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.models.wavefront import render_image_wavefront
from raytracer_tpu.render import render_image
from raytracer_tpu.scene.builder import cornell_spheres_scene


@pytest.fixture(scope="module")
def scene():
    return cornell_spheres_scene()


def _cam(cfg):
    return make_camera(aspect_ratio=cfg.width / cfg.height, fov_degrees=cfg.fov_degrees,
                       aperture=cfg.aperture)


def test_wavefront_matches_megakernel(scene):
    cfg = RenderConfig(width=24, height=24, spp=8, max_bounces=6)
    key = jax.random.key(11)
    a = np.asarray(render_image(scene, _cam(cfg), cfg, key))
    b = np.asarray(render_image_wavefront(scene, _cam(cfg), cfg, key))
    np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-4)


def test_wavefront_deep_bounces_matches(scene):
    """Regeneration across many samples/bounces must not disturb the
    estimator: high spp + deep bounce cap still equals the megakernel."""
    cfg = RenderConfig(width=12, height=12, spp=16, max_bounces=20)
    key = jax.random.key(3)
    a = np.asarray(render_image(scene, _cam(cfg), cfg, key))
    b = np.asarray(render_image_wavefront(scene, _cam(cfg), cfg, key))
    np.testing.assert_allclose(a, b, atol=5e-4, rtol=2e-4)


def test_spp_batched_render_matches_single_pass(scene):
    """render_image_wavefront with spp_per_pass < spp must equal the
    single-dispatch render (sample-offset keying)."""
    cfg1 = RenderConfig(width=16, height=16, spp=8, max_bounces=4, spp_per_pass=8)
    cfg2 = cfg1.replace(spp_per_pass=2)
    key = jax.random.key(5)
    a = np.asarray(render_image_wavefront(scene, _cam(cfg1), cfg1, key))
    b = np.asarray(render_image_wavefront(scene, _cam(cfg2), cfg2, key))
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-5)


def test_drain_cascade_bit_exact(scene):
    """The drain-tail compaction cascade must be BIT-identical to the
    uncompacted (drain_cascade=()) integrator — the invariant the
    config.py comment claims: draws depend only on
    (pixel, sample, bounce) and per-lane fp accumulation order is
    preserved through the pack/unpack."""
    base = RenderConfig(width=24, height=12, spp=8, max_bounces=8)
    key = jax.random.key(17)
    with_cascade = np.asarray(render_image_wavefront(scene, _cam(base), base, key))
    plain = np.asarray(render_image_wavefront(
        scene, _cam(base), base.replace(drain_cascade=()), key))
    np.testing.assert_array_equal(with_cascade, plain)


def test_drain_cascade_bit_exact_sharded(scene):
    """Same invariant under shard_map (each shard runs its own cascade
    over its lane block)."""
    from raytracer_tpu.parallel.sharding import (make_mesh,
                                                 render_image_wavefront_sharded)

    base = RenderConfig(width=24, height=12, spp=4, max_bounces=6)
    key = jax.random.key(19)
    mesh = make_mesh()
    a = np.asarray(render_image_wavefront_sharded(scene, _cam(base), base, key,
                                                  mesh=mesh))
    b = np.asarray(render_image_wavefront_sharded(
        scene, _cam(base), base.replace(drain_cascade=()), key, mesh=mesh))
    np.testing.assert_array_equal(a, b)


def test_tiled_grid_covers_every_pixel():
    from raytracer_tpu.models.wavefront import _tiled_pixel_grid

    cfg = RenderConfig(width=150, height=37)  # non-multiples of 128/8
    px, py, inv = _tiled_pixel_grid(cfg)
    px, py, inv = map(np.asarray, (px, py, inv))
    rows = cfg.height - 1 - py
    flat = rows * cfg.width + px
    # inv maps every image pixel to a lane holding exactly that pixel.
    assert (flat[inv] == np.arange(cfg.width * cfg.height)).all()
