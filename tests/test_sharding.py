"""Distributed tests on the virtual 8-device CPU mesh (SURVEY.md §4.4):
sharded render must equal the single-device render bit-for-bit, and the
sharded train step must produce finite psum'd gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.camera import make_camera
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.diff import inverse
from raytracer_tpu.parallel.sharding import make_mesh, render_image_sharded
from raytracer_tpu.render import render_image, render_image_chunked
from raytracer_tpu.scene.builder import cornell_spheres_scene


@pytest.fixture(scope="module")
def scene():
    return cornell_spheres_scene()


def _cam(cfg):
    return make_camera(aspect_ratio=cfg.width / cfg.height, fov_degrees=cfg.fov_degrees,
                       aperture=cfg.aperture)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8
    assert jax.devices()[0].platform == "cpu"


def test_sharded_render_bitwise_equal(scene):
    cfg = RenderConfig(width=16, height=16, spp=4, max_bounces=4)
    key = jax.random.key(123)
    single = np.asarray(render_image(scene, _cam(cfg), cfg, key))
    sharded = np.asarray(render_image_sharded(scene, _cam(cfg), cfg, key, mesh=make_mesh()))
    np.testing.assert_array_equal(single, sharded)


def test_chunked_render_bitwise_equal(scene):
    cfg = RenderConfig(width=16, height=16, spp=8, max_bounces=4,
                       max_rays_per_pass=16 * 4, spp_per_pass=4)
    key = jax.random.key(7)
    whole = np.asarray(render_image(scene, _cam(cfg), cfg, key))
    chunked = np.asarray(render_image_chunked(scene, _cam(cfg), cfg, key))
    # Chunked spp accumulation reorders the mean; allclose at fp32 noise.
    np.testing.assert_allclose(whole, chunked, atol=1e-5, rtol=1e-5)


def test_sharded_train_step_matches_unsharded(scene):
    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3)
    cam = _cam(cfg)
    target = render_image(scene, cam, cfg, jax.random.key(99))

    params = inverse.init_params(scene, key=jax.random.key(1), noise=0.1)
    state = inverse.adam_init(params)

    step_1d = inverse.make_train_step(scene, cam, cfg, target, mesh=None)
    step_8d = inverse.make_train_step(scene, cam, cfg, target, mesh=make_mesh())

    p1, s1, l1 = step_1d(params, state, jax.random.key(5))
    p8, s8, l8 = step_8d(params, state, jax.random.key(5))

    assert np.isfinite(float(l1)) and np.isfinite(float(l8))
    np.testing.assert_allclose(float(l1), float(l8), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(np.asarray(p1[k]), np.asarray(p8[k]), atol=1e-6)


def test_training_reduces_loss(scene):
    cfg = RenderConfig(width=16, height=8, spp=4, max_bounces=3)
    cam = _cam(cfg)
    target = render_image(scene, cam, cfg, jax.random.key(0))
    params = inverse.init_params(scene, fields=("albedo",), key=jax.random.key(2), noise=0.15)
    state = inverse.adam_init(params)
    step = inverse.make_train_step(scene, cam, cfg, target, mesh=make_mesh(), lr=0.05)
    losses = []
    for i in range(8):
        params, state, loss = step(params, state, jax.random.key(0))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses


def test_sharded_wavefront_matches_single_device(scene):
    """The PERF integrator (lane-stable wavefront) under shard_map must
    match the single-device wavefront — lanes are independent and RNG is
    pixel-keyed, so sharding the lane axis changes nothing semantically.
    (Tolerance is 1-ULP: XLA fuses elementwise chains differently inside
    shard_map, so the identical math rounds differently.)"""
    from raytracer_tpu.models.wavefront import render_image_wavefront
    from raytracer_tpu.parallel.sharding import render_image_wavefront_sharded

    cfg = RenderConfig(width=24, height=12, spp=4, max_bounces=4)
    key = jax.random.key(31)
    single = np.asarray(render_image_wavefront(scene, _cam(cfg), cfg, key))
    sharded = np.asarray(
        render_image_wavefront_sharded(scene, _cam(cfg), cfg, key, mesh=make_mesh()))
    np.testing.assert_allclose(single, sharded, rtol=0, atol=5e-7)


def test_interleave_permutation_contract():
    """Helper contract (fast): 16 packets / 8 shards → a real
    (non-identity) permutation — shard s takes packets (s, s+8); with
    g == n_shards round-robin degenerates to the identity, so
    g=2*n_shards is the smallest genuinely-permuting case. 2 packets /
    8 shards → contiguous fallback (unperm None)."""
    from raytracer_tpu.parallel.sharding import _interleave_packets

    px16 = jnp.arange(16 * 1024, dtype=jnp.int32)
    pxp, _, unperm = _interleave_packets(px16, px16, 8)
    assert unperm is not None and not np.array_equal(
        unperm, np.arange(unperm.size))
    np.testing.assert_array_equal(np.asarray(pxp)[unperm], np.asarray(px16))
    px2 = jnp.arange(2 * 1024, dtype=jnp.int32)
    _, _, unperm2 = _interleave_packets(px2, px2, 8)
    assert unperm2 is None


def test_sharded_wavefront_interleave_active(scene):
    """Interleave path EXERCISED in a render: 128x128 → 16
    packets on the 8-device mesh, so g % n_shards == 0 with a
    non-identity permutation (every prior test used g=2 and silently
    fell back to contiguous). Interleaved == contiguous ==
    single-device."""
    from raytracer_tpu.models.wavefront import render_image_wavefront
    from raytracer_tpu.parallel.sharding import render_image_wavefront_sharded

    cfg = RenderConfig(width=128, height=128, spp=1, max_bounces=3)
    key = jax.random.key(17)
    single = np.asarray(render_image_wavefront(scene, _cam(cfg), cfg, key))
    inter = np.asarray(render_image_wavefront_sharded(
        scene, _cam(cfg), cfg, key, mesh=make_mesh(), interleave=True))
    contig = np.asarray(render_image_wavefront_sharded(
        scene, _cam(cfg), cfg, key, mesh=make_mesh(), interleave=False))
    np.testing.assert_allclose(single, inter, rtol=0, atol=5e-7)
    np.testing.assert_allclose(single, contig, rtol=0, atol=5e-7)


def test_rebalanced_drain_matches_single_device(scene):
    """Cross-shard drain rebalancing: pending lanes
    pool over the mesh and re-stripe, so the image must still equal the
    single-device wavefront (pixel-keyed RNG + running-total acc
    migration make the migration invisible), and the per-shard
    post-rebalance drain iteration counts must come back finite."""
    from raytracer_tpu.models.wavefront import render_image_wavefront
    from raytracer_tpu.parallel.sharding import (
        render_image_wavefront_rebalanced)

    cfg = RenderConfig(width=128, height=64, spp=2, max_bounces=6)
    key = jax.random.key(9)
    single = np.asarray(render_image_wavefront(scene, _cam(cfg), cfg, key))
    reb, iters = render_image_wavefront_rebalanced(
        scene, _cam(cfg), cfg, key, mesh=make_mesh(), rebalance_div=8,
        report_iters=True)
    np.testing.assert_allclose(single, np.asarray(reb), rtol=0, atol=5e-7)
    it = np.asarray(iters)
    assert it.shape == (8,)
    assert (it >= 0).all() and (it < cfg.spp * cfg.max_bounces + 8).all()


def test_scaling_report_efficiency_normalization(scene):
    """scaling_report efficiency is ALWAYS normalized to the 1-device
    run — even when the caller's count list starts at 2, the 1-device row
    is measured and added so 1→2 loss can't be silently hidden
"""
    from raytracer_tpu.parallel import multihost

    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3)
    rep = multihost.scaling_report(scene, _cam(cfg), cfg, jax.random.key(3),
                                   device_counts=[2, 4])
    assert set(rep) == {1, 2, 4}
    assert rep[1]["efficiency"] == 1.0
    assert 0.0 < rep[2]["efficiency"] < 10.0
    assert 0.0 < rep[4]["efficiency"] < 10.0


def test_sharded_2d_rays_spp_matches_single_device(scene):
    """The 2D (rays × spp) mesh render — sample windows over the spp
    axis, pmean'd — must match the single-device and 1D-sharded renders
    (RNG is (pixel, sample)-keyed, so window j draws exactly samples
    [j*k, (j+1)*k); only fp summation order differs)."""
    from raytracer_tpu.parallel.sharding import (make_mesh_2d,
                                                 render_image_sharded_2d)

    cfg = RenderConfig(width=16, height=16, spp=8, max_bounces=4)
    key = jax.random.key(77)
    cam = _cam(cfg)
    single = np.asarray(render_image(scene, cam, cfg, key))
    mesh2d = make_mesh_2d(4, 2)
    two_d = np.asarray(render_image_sharded_2d(scene, cam, cfg, key, mesh=mesh2d))
    np.testing.assert_allclose(single, two_d, atol=2e-6, rtol=1e-5)
    one_d = np.asarray(render_image_sharded(scene, cam, cfg, key, mesh=make_mesh()))
    np.testing.assert_allclose(one_d, two_d, atol=2e-6, rtol=1e-5)

    # Wavefront integrator over the same 2D mesh (tile-lane pixel order).
    from raytracer_tpu.models.wavefront import render_image_wavefront

    wf_single = np.asarray(render_image_wavefront(scene, cam, cfg, key))
    wf_2d = np.asarray(render_image_sharded_2d(scene, cam, cfg, key, mesh=mesh2d,
                                               integrator="wavefront"))
    np.testing.assert_allclose(wf_single, wf_2d, atol=2e-6, rtol=1e-5)

    # Non-divisible spp is a loud error, not a silent truncation.
    with pytest.raises(ValueError):
        render_image_sharded_2d(scene, cam, cfg, key, mesh=mesh2d, spp=7)


def test_multihost_helpers_on_local_mesh(scene):
    """multihost.render_image_multihost degrades gracefully to the local
    device mesh and matches the plain render bit-for-bit."""
    from raytracer_tpu.parallel import multihost

    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3)
    cam = _cam(cfg)
    key = jax.random.key(21)
    mesh = multihost.global_mesh()
    assert mesh.devices.size == 8
    img = np.asarray(multihost.render_image_multihost(scene, cam, cfg, key, mesh))
    ref = np.asarray(render_image(scene, cam, cfg, key))
    np.testing.assert_array_equal(img, ref)
