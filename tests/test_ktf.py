"""Kernel-portable counter-based RNG (utils/ktf.py) and the rng_impl
config axis.

The invariant family: within rng_impl="ktf", megakernel ≡ wavefront ≡
the fused path-loop kernel, because all three compute the SAME
threefry2x32 function on the same (pixel, sample, bounce, purpose)
counters. Across rng impls agreement is statistical only.
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
from raytracer_tpu.utils import ktf


@pytest.fixture(scope="module")
def scene():
    return cornell_spheres_scene()


def _cam(cfg):
    return make_camera(aspect_ratio=cfg.width / cfg.height,
                       fov_degrees=cfg.fov_degrees, aperture=cfg.aperture)


def test_threefry_bit_exact_vs_jax_cipher():
    """ktf.threefry2x32 is the same cipher jax.random uses — bit-for-bit
    on the same words (only key derivation differs at the API level)."""
    from jax._src import prng as jprng

    rng = np.random.default_rng(3)
    k = rng.integers(0, 2**32, size=(2,), dtype=np.uint32)
    c = rng.integers(0, 2**32, size=(2, 512), dtype=np.uint32)
    ref = np.asarray(jprng.threefry_2x32(jnp.asarray(k),
                                         jnp.asarray(c).reshape(-1))).reshape(2, 512)
    x0, x1 = ktf.threefry2x32(np.int32(k[0]), np.int32(k[1]),
                              jnp.asarray(c[0].view(np.int32)),
                              jnp.asarray(c[1].view(np.int32)))
    got = np.stack([np.asarray(x0).view(np.uint32), np.asarray(x1).view(np.uint32)])
    np.testing.assert_array_equal(got, ref)


def test_u01_range_and_determinism():
    bits = jnp.asarray(np.random.default_rng(0).integers(
        -2**31, 2**31, size=4096, dtype=np.int32))
    u = np.asarray(ktf.u01(bits))
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_array_equal(u, np.asarray(ktf.u01(bits)))
    # The full 23-bit mantissa range is exercised.
    assert u.max() > 0.99 and u.min() < 0.01


def test_sampler_draw_properties():
    smp = ktf.sampler(jax.random.key(5), jnp.arange(8192), sample=3, bounce=2)
    v = np.asarray(smp.scatter_unit_vector())
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    # Mean of uniform directions ~ 0.
    assert np.abs(v.mean(axis=0)).max() < 0.05
    dx, dy = smp.lens_disk()
    r2 = np.asarray(dx) ** 2 + np.asarray(dy) ** 2
    assert r2.max() <= 1.0 + 1e-6
    u = np.asarray(smp.rr_uniform())
    assert 0.45 < u.mean() < 0.55
    # Distinct purposes decorrelate.
    assert not np.allclose(u, np.asarray(smp.dielectric_uniform()))
    # Distinct bounces decorrelate.
    u2 = np.asarray(smp.at(bounce=3).rr_uniform())
    assert not np.allclose(u, u2)


def test_ktf_megakernel_equals_wavefront(scene):
    """The core invariant the ktf mode exists for: both integrators draw
    identical randoms from the shared counters (fp order tolerance)."""
    cfg = RenderConfig(width=24, height=16, spp=6, max_bounces=6, rng_impl="ktf")
    key = jax.random.key(11)
    a = np.asarray(render_image(scene, _cam(cfg), cfg, key))
    b = np.asarray(render_image_wavefront(scene, _cam(cfg), cfg, key))
    np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-4)


def test_ktf_statistically_matches_jax_mode(scene):
    """Same scene/camera, different RNG family: the estimators agree in
    expectation. Tested via per-channel image means at moderate spp."""
    cfg = RenderConfig(width=32, height=24, spp=48, max_bounces=6)
    key = jax.random.key(7)
    a = np.asarray(render_image_wavefront(scene, _cam(cfg), cfg, key))
    b = np.asarray(render_image_wavefront(scene, _cam(cfg),
                                          cfg.replace(rng_impl="ktf"), key))
    ma, mb = a.mean(axis=(0, 1)), b.mean(axis=(0, 1))
    np.testing.assert_allclose(ma, mb, rtol=0.03)


def test_ktf_chunking_invariance(scene):
    """ktf draws depend only on (pixel, sample, bounce, purpose): the
    spp-batched wavefront render equals the single-pass one."""
    cfg1 = RenderConfig(width=16, height=16, spp=8, max_bounces=4,
                        spp_per_pass=8, rng_impl="ktf")
    cfg2 = cfg1.replace(spp_per_pass=2)
    key = jax.random.key(13)
    a = np.asarray(render_image_wavefront(scene, _cam(cfg1), cfg1, key))
    b = np.asarray(render_image_wavefront(scene, _cam(cfg2), cfg2, key))
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-5)


def test_ktf_sharded_render_bitwise_equal(scene):
    from raytracer_tpu.parallel.sharding import make_mesh, render_image_sharded

    cfg = RenderConfig(width=16, height=16, spp=4, max_bounces=4, rng_impl="ktf")
    key = jax.random.key(123)
    single = np.asarray(render_image(scene, _cam(cfg), cfg, key))
    sharded = np.asarray(render_image_sharded(scene, _cam(cfg), cfg, key,
                                              mesh=make_mesh()))
    np.testing.assert_array_equal(single, sharded)
