"""Fused path-loop kernel ≡ XLA integrators under rng_impl="ktf".

Both draw from the SAME (pixel, sample, bounce, purpose) Threefry
counters (utils/ktf.py), so they trace the same paths; only float
rounding differs. On the CPU the kernel runs through its CPU target
(native/pathtrace_cpu.cc), the same per-lane code the CUDA target runs;
tests/test_gpu.py repeats the comparison on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.camera import make_camera
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.models.fused import (blocked_pixel_grid, fused_batch,
                                        render_image_fused)
from raytracer_tpu.models.wavefront import (_tiled_pixel_grid,
                                            render_image_wavefront)
from raytracer_tpu.ops import fused_kernel
from raytracer_tpu.ops.bvh import build_lbvh
from raytracer_tpu.ops.bvh4 import build_bvh4
from raytracer_tpu.ops.fused_kernel import render_tiles_fused
from raytracer_tpu.scene.builder import cornell_materials_scene


@pytest.fixture(scope="module")
def scene():
    sc = cornell_materials_scene(assets_dir="assets/models")
    bvh = build_lbvh(sc.mesh)
    return sc.replace(bvh=bvh, bvh4=build_bvh4(sc.mesh, bvh))


def _cam(cfg):
    return make_camera(aspect_ratio=cfg.width / cfg.height,
                       fov_degrees=cfg.fov_degrees, aperture=cfg.aperture,
                       position=(0.0, 0.05, 0.29), pitch=-5.0)


def assert_matches_wavefront(fused, wave):
    """Almost all elements tight + means tight: the kernel and XLA round
    the same formulas differently, so a handful of paths flip a discrete
    decision at an ulp boundary (a bounce lands on the other side of a
    silhouette edge); both sides are unbiased estimators."""
    assert np.isfinite(fused).all()
    bad = np.abs(fused - wave) > (5e-4 + 2e-4 * np.abs(wave))
    assert bad.mean() < 0.005, f"{bad.sum()}/{bad.size} elements diverge"
    np.testing.assert_allclose(fused.mean(axis=(0, 1)), wave.mean(axis=(0, 1)),
                               atol=1e-3, rtol=1e-3)


def test_fused_available(scene):
    assert fused_kernel.fused_megakernel_available(scene)


def test_fused_matches_ktf_wavefront_one_packet(scene):
    cfg = RenderConfig(width=128, height=8, spp=2, max_bounces=4,
                       rng_impl="ktf")
    key = jax.random.key(21)
    fused = np.asarray(render_image_fused(scene, _cam(cfg), cfg, key))
    wave = np.asarray(render_image_wavefront(scene, _cam(cfg), cfg, key))
    assert np.isfinite(fused).all()
    np.testing.assert_allclose(fused, wave, atol=2e-4, rtol=1e-4)


def test_fused_matches_ktf_wavefront_multi_packet_deep(scene):
    """Multiple packets + RR active (max_bounces past min_bounces) +
    spp regeneration: the whole integrator contract."""
    cfg = RenderConfig(width=256, height=16, spp=4, max_bounces=8,
                       rng_impl="ktf")
    key = jax.random.key(5)
    fused = np.asarray(render_image_fused(scene, _cam(cfg), cfg, key))
    wave = np.asarray(render_image_wavefront(scene, _cam(cfg), cfg, key))
    assert_matches_wavefront(fused, wave)


# Lane shapes of the CPU target: one 1024-lane packet, an image that is
# no multiple of any tile (edge padding), many packets in 32x32 blocks,
# and spp split into passes.
SHAPES = {
    "one_packet": dict(width=128, height=8, spp=2, max_bounces=6),
    "padding": dict(width=100, height=13, spp=2, max_bounces=6),
    "multi_packet": dict(width=128, height=64, spp=1, max_bounces=8),
    "spp_split": dict(width=64, height=32, spp=4, max_bounces=6,
                      spp_per_pass=3),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cpu_target_matches_ktf_wavefront(scene, shape):
    cfg = RenderConfig(rng_impl="ktf", **SHAPES[shape])
    key = jax.random.key(31)
    fused = np.asarray(render_image_fused(scene, _cam(cfg), cfg, key))
    wave = np.asarray(render_image_wavefront(scene, _cam(cfg), cfg, key))
    assert fused.shape == (cfg.height, cfg.width, 3)
    assert_matches_wavefront(fused, wave)


def test_fused_sharded_matches_single_device(scene):
    """The fused kernel under shard_map: sharded-fused must equal
    single-device fused. 128x64 → 8 packets on the 8-device mesh, so the
    round-robin interleave permutation is active; interleaved,
    contiguous, and single-device must all agree."""
    from raytracer_tpu.parallel.sharding import (make_mesh,
                                                 render_image_fused_sharded)

    cfg = RenderConfig(width=128, height=64, spp=1, max_bounces=3,
                       rng_impl="ktf")
    key = jax.random.key(13)
    single = np.asarray(render_image_fused(scene, _cam(cfg), cfg, key))
    mesh = make_mesh()
    inter = np.asarray(render_image_fused_sharded(
        scene, _cam(cfg), cfg, key, mesh=mesh, interleave=True))
    contig = np.asarray(render_image_fused_sharded(
        scene, _cam(cfg), cfg, key, mesh=mesh, interleave=False))
    np.testing.assert_array_equal(single, inter)
    np.testing.assert_array_equal(single, contig)


def test_fused_host_chunked_matches_single_dispatch(scene):
    """Lanes are independent: rendering a frame's lanes in separate
    dispatches (here 3 + 3 + 2 packets) equals the one-dispatch render
    EXACTLY."""
    cfg = RenderConfig(width=128, height=64, spp=1, max_bounces=3,
                       rng_impl="ktf")
    key = jax.random.key(4)
    px, py, _ = _tiled_pixel_grid(cfg)
    whole = np.asarray(fused_batch(scene, _cam(cfg), cfg, key, px, py))
    parts = [fused_batch(scene, _cam(cfg), cfg, key, px[lo:lo + 3072],
                         py[lo:lo + 3072])
             for lo in range(0, px.shape[0], 3072)]
    np.testing.assert_array_equal(whole, np.concatenate(parts))


def test_fused_blocked_grid_matches_strip_grid(scene):
    """The 32x32-block lane layout (models/fused._fused_pixel_grid) is a
    pure relabeling: the assembled image equals the strip-layout image
    EXACTLY (pixel-keyed RNG)."""
    cfg = RenderConfig(width=128, height=32, spp=1, max_bounces=3,
                       rng_impl="ktf")
    key = jax.random.key(6)
    px, py, inv = _tiled_pixel_grid(cfg)
    strip = np.asarray(fused_batch(scene, _cam(cfg), cfg, key, px,
                                   py))[np.asarray(inv)]
    px2, py2, inv2 = blocked_pixel_grid(cfg, 32, 32, 8, 16)
    blk = np.asarray(fused_batch(scene, _cam(cfg), cfg, key, px2,
                                 py2))[np.asarray(inv2)]
    np.testing.assert_array_equal(strip, blk)


@pytest.mark.parametrize("w,h", [(128, 32), (100, 40)])
def test_blocked_grid_covers_every_pixel(w, h):
    """Every pixel has a lane, and every 32-lane warp covers an 8x4 tile."""
    cfg = RenderConfig(width=w, height=h)
    px, py, inv = blocked_pixel_grid(cfg, 32, 32, 8, 16)
    px, py, inv = np.asarray(px), np.asarray(py), np.asarray(inv)
    flat = (h - 1 - py) * w + px
    np.testing.assert_array_equal(flat[inv], np.arange(w * h))
    wx = px.reshape(-1, 32)
    wy = py.reshape(-1, 32)
    assert (np.ptp(wx, axis=1) <= 7).all() and (np.ptp(wy, axis=1) <= 3).all()


def test_fused_spp_batched_matches_single_pass(scene):
    """sample_offset keying: spp split across dispatches is invariant."""
    cfg1 = RenderConfig(width=128, height=8, spp=4, max_bounces=4,
                        rng_impl="ktf", spp_per_pass=4)
    cfg2 = cfg1.replace(spp_per_pass=2)
    key = jax.random.key(9)
    a = np.asarray(render_image_fused(scene, _cam(cfg1), cfg1, key))
    b = np.asarray(render_image_fused(scene, _cam(cfg2), cfg2, key))
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-5)


def _reachable_leaves(children):
    """(first, count) of every leaf reachable from the root."""
    leaves, stack, seen = [], [0], set()
    while stack:
        node = stack.pop()
        assert node not in seen, "node reached twice"
        seen.add(node)
        for c in children[node]:
            if c >= 0:
                stack.append(int(c))
            elif c <= -2:
                code = -int(c) - 2
                leaves.append((code >> 3, (code & 7) + 1))
    assert seen == set(range(children.shape[0])), "unreachable nodes"
    return leaves


@pytest.mark.parametrize("width", [4, 8])
def test_gpu_table_layout_round_trip(scene, width):
    """The kernel's tables hold the Bvh4 exactly: int32 child ids, boxes
    transposed per node, triangles (v0, e1, e2) at 4-float strides, and
    leaf ranges that reach every real triangle exactly once."""
    from raytracer_tpu.ops.bvh4 import widen_bvh

    b4 = widen_bvh(scene.bvh4, width) if width > 4 else scene.bvh4
    t = fused_kernel.pack_tables(b4)
    assert t.node_child.dtype == jnp.int32 and t.tri_mat.dtype == jnp.int32
    assert t.node_child.shape == b4.children.shape
    np.testing.assert_array_equal(np.asarray(t.node_box).transpose(0, 2, 1),
                                  np.asarray(b4.bounds))
    tri = np.asarray(t.tri).reshape(-1, 3, 4)
    np.testing.assert_array_equal(tri[:, :, :3].reshape(-1, 9), np.asarray(b4.tri))
    assert (tri[:, :, 3] == 0).all()
    np.testing.assert_array_equal(np.asarray(t.tri_mat), np.asarray(b4.face_mat))

    prim = np.asarray(b4.prim_index)
    hits = np.zeros(prim.shape[0], np.int32)
    for first, count in _reachable_leaves(np.asarray(t.node_child)):
        hits[first:first + count] += 1
    np.testing.assert_array_equal(hits, (prim >= 0).astype(np.int32))
    faces = scene.mesh.faces.shape[0]
    assert sorted(prim[prim >= 0].tolist()) == list(range(faces))


def test_stack_bound_checked(scene):
    """A tree whose stack bound exceeds the per-lane stack is refused
    before launch (the kernel would return NaN lanes)."""
    import dataclasses

    deep = scene.replace(bvh4=dataclasses.replace(
        scene.bvh4, stack_depth=fused_kernel.STACK_CAP + 8))
    assert not fused_kernel.fused_megakernel_available(deep)
    cfg = RenderConfig(width=32, height=8, spp=1, max_bounces=2, rng_impl="ktf")
    px, py, _ = _tiled_pixel_grid(cfg)
    with pytest.raises(ValueError, match="stack bound"):
        render_tiles_fused(deep, _cam(cfg), cfg, jax.random.key(0), px, py)
