"""Two-level acceleration split (builder.partition_brute_faces):
oversized triangles (Cornell walls/boxes/light) are brute-forced while
the BVH covers only the dense mesh. Every traversal backend must agree
exactly, and the split must preserve original face ids/materials."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.ops import intersect as isect
from raytracer_tpu.scene import builder


@pytest.fixture(scope="module")
def scene():
    return builder.reference_scene(assets_dir="assets/models", build_bvh=True)


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(7)
    n = 4096  # >= PACKET_MIN_RAYS so the packet traversal engages
    o = jnp.asarray(rng.uniform(-0.28, 0.28, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, jnp.asarray(d)


def test_partition_selects_cornell_tris(scene):
    b4 = scene.bvh4
    assert b4.brute_tri is not None
    nb = int(np.asarray(b4.brute_prim).shape[0])
    assert nb % 8 == 0 and nb <= 64 + 8
    # Brute prim ids are original Cornell face ids (the first 32 faces
    # of the concatenated mesh are the box; the bunny follows).
    real = np.asarray(b4.brute_prim)[:32]
    assert set(real.tolist()) == set(range(32))
    # Tree prim ids cover exactly the remaining faces.
    tree_ids = set(np.asarray(b4.prim_index).tolist())
    t = np.asarray(scene.mesh.faces).shape[0]
    assert set(range(32, t)).issubset(tree_ids)


def test_backends_agree_on_two_level_scene(scene, rays):
    o, d = rays
    res = {}
    for be in ("lane", "packets"):
        ids = isect.intersect_scene(scene, o, d, 1e-3, backend=be)
        res[be] = (np.asarray(ids.t), np.asarray(ids.prim_id),
                   np.asarray(ids.prim_type))
    t0, p0, y0 = res["lane"]
    assert (t0 < 1e30).mean() > 0.8  # interior rays: nearly all hit
    for be in ("packets",):
        t1, p1, y1 = res[be]
        np.testing.assert_allclose(t1, t0, rtol=1e-5)
        np.testing.assert_array_equal(p1, p0)
        np.testing.assert_array_equal(y1, y0)


def test_lane_traversal_matches_brute_force(scene, rays):
    """The per-lane XLA walk (ops/bvh4.intersect_bvh4, the GPU's wavefront
    traversal) over the two-level scene equals brute force over every
    triangle and sphere."""
    from raytracer_tpu.ops import sphere as sphere_ops
    from raytracer_tpu.ops import triangle as tri_ops

    o, d = rays[0][:512], rays[1][:512]
    ids = isect.intersect_scene(scene, o, d, 1e-3, backend="lane")
    brute = jax.jit(lambda o, d: tri_ops.intersect_tris_brute(
        o, d, scene.mesh.vertices, scene.mesh.faces, 1e-3, isect.BIG))
    parts = [brute(o[i:i + 64], d[i:i + 64]) for i in range(0, 512, 64)]
    tt = np.concatenate([np.asarray(p[0]) for p in parts])
    tid = np.concatenate([np.asarray(p[1]) for p in parts])
    ts, sid = sphere_ops.intersect_spheres(
        o, d, scene.spheres.center, scene.spheres.radius, 1e-3, isect.BIG)
    ts, sid = np.asarray(ts), np.asarray(sid)
    tri_wins = tt < ts
    t_ref = np.where(tri_wins, tt, ts)
    assert (t_ref < 1e30).mean() > 0.8  # interior rays: nearly all hit
    np.testing.assert_allclose(np.asarray(ids.t), t_ref, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(ids.prim_type),
                                  np.where(tri_wins, isect.PRIM_TRI,
                                           isect.PRIM_SPHERE))
    np.testing.assert_array_equal(np.asarray(ids.prim_id),
                                  np.where(tri_wins, tid, sid))


def test_interior_showcase_brightness(scene):
    """End-to-end guard for the headline workload: a tiny interior
    render through the fused kernel must land in a sane radiance band —
    a dark frame means the light/material routing through the kernel
    broke."""
    from raytracer_tpu.camera import showcase_camera
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.models.fused import render_image_fused

    cfg = RenderConfig(width=128, height=40, spp=2, max_bounces=12,
                       rng_impl="ktf")
    cam = showcase_camera(cfg)
    img = np.asarray(render_image_fused(scene, cam, cfg, jax.random.key(0)))
    m = img.mean()
    assert 0.1 < m < 0.8, m
    # Ceiling-light pixels blow out well above the walls.
    assert img.max() > 2.0, img.max()
