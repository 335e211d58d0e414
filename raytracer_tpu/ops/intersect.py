"""Scene-level closest-hit queries over the SoA scene.

Replaces the reference's virtual scene traversal (BVHNode::hit →
object->hit, Core/BVHNode.cuh:115-156) with typed primitive sweeps:
spheres are brute-forced (the reference scene has 2), triangles go
through either a brute-force sweep (tiny meshes / oracle) or the LBVH
traversal kernel (ops/traverse.py). Closest-hit semantics match the
reference: candidate hits valid on [t_min, closest-so-far].

The hit *decision* (which primitive, at what detached t) is
non-differentiable by design; `shade_hit` recomputes hit attributes
differentiably from the winning primitive ids (SURVEY.md §2.3 item 5 —
detached traversal, gradients through shading).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.ops import sphere as sphere_ops
from raytracer_tpu.ops import triangle as tri_ops
from raytracer_tpu.scene.types import Scene

BIG = np.float32(3.0e38)
PRIM_SPHERE = 0
PRIM_TRI = 1
# Wavefronts at least this wide use packetized traversal; smaller batches
# use the per-lane path (cheaper fixed costs).
PACKET_MIN_RAYS = 4096


def _traversal_backend(backend: str | None = None) -> str:
    """'packets' (XLA packet loop) or 'lane' (per-lane XLA loop): the
    platform's choice (raytracer_tpu/backends.py) unless `backend` names
    one."""
    if backend is None:
        from raytracer_tpu import backends

        return backends.for_platform().traversal
    if backend not in ("packets", "lane"):
        raise ValueError(f"unknown traversal backend {backend!r}")
    return backend


class HitIds(NamedTuple):
    hit: jnp.ndarray        # bool[N]
    t: jnp.ndarray          # f32[N] (BIG on miss)
    prim_type: jnp.ndarray  # i32[N]
    prim_id: jnp.ndarray    # i32[N]


class HitAttrs(NamedTuple):
    point: jnp.ndarray      # f32[N,3]
    normal: jnp.ndarray     # f32[N,3] front-facing
    front_face: jnp.ndarray  # bool[N]
    mat_id: jnp.ndarray     # i32[N]
    # Hit U/V (HitInfo.cuh:12-13 — dead fields in the reference, live
    # here): triangle barycentrics / interpolated OBJ vt, sphere lat-lon.
    uv: jnp.ndarray         # f32[N,2]


def intersect_scene(scene: Scene, origins, dirs, t_min, t_max=BIG,
                    backend: str | None = None) -> HitIds:
    """Closest hit over spheres and triangles. `backend` picks the BVH
    traversal ('packets' or 'lane'); by default the platform's."""
    # The hit DECISION is detached by design (SURVEY.md §2.3 item 5):
    # gradients route through shade_hit's differentiable recomputation.
    origins = jax.lax.stop_gradient(origins)
    dirs = jax.lax.stop_gradient(dirs)
    scene = jax.lax.stop_gradient(scene)
    ts, sid = sphere_ops.intersect_spheres(
        origins, dirs, scene.spheres.center, scene.spheres.radius, t_min, t_max
    )
    if scene.bvh4 is not None:
        # Two-level split: brute-test the large triangles first; the
        # primed t_max culls most tree traversals.
        t_cap = jnp.minimum(ts, t_max)
        tb = None
        if scene.bvh4.brute_tri is not None:
            tb, bslot = tri_ops.intersect_packed_brute(
                origins, dirs, scene.bvh4.brute_tri, t_min, t_cap)
            bprim = scene.bvh4.brute_prim[bslot]
            t_cap = jnp.minimum(t_cap, tb)
        if (_traversal_backend(backend) == "packets"
                and origins.shape[0] >= PACKET_MIN_RAYS):
            from raytracer_tpu.ops import packets

            tt, tid = packets.intersect_bvh4_packets(
                origins, dirs, scene.bvh4, t_min, t_cap
            )
        else:
            from raytracer_tpu.ops import bvh4 as bvh4_ops

            tt, tid = bvh4_ops.intersect_bvh4(
                origins, dirs, scene.bvh4, t_min, t_cap
            )
        if tb is not None:
            brute_wins = tb < tt
            tt = jnp.where(brute_wins, tb, tt)
            tid = jnp.where(brute_wins, bprim, tid)
    elif scene.bvh is not None:
        from raytracer_tpu.ops import traverse as trav

        tt, tid = trav.intersect_bvh(
            origins, dirs, scene.mesh, scene.bvh, t_min, jnp.minimum(ts, t_max)
        )
    else:
        tt, tid = tri_ops.intersect_tris_brute(
            origins, dirs, scene.mesh.vertices, scene.mesh.faces, t_min, t_max
        )
    tri_wins = tt < ts
    t = jnp.where(tri_wins, tt, ts)
    return HitIds(
        hit=t < BIG,
        t=t,
        prim_type=jnp.where(tri_wins, PRIM_TRI, PRIM_SPHERE).astype(jnp.int32),
        prim_id=jnp.where(tri_wins, tid, sid).astype(jnp.int32),
    )


def shade_hit(scene: Scene, origins, dirs, ids: HitIds) -> HitAttrs:
    """Differentiable hit attributes from detached hit ids."""
    pid = jax.lax.stop_gradient(ids.prim_id)
    is_tri = ids.prim_type == PRIM_TRI

    # Sphere branch: recompute the root differentiably for the chosen
    # sphere (pick near/far by proximity to the detached traversal t).
    sid = jnp.where(is_tri, 0, pid)
    c = scene.spheres.center[sid]
    r = scene.spheres.radius[sid]
    oc = origins - c
    a = jnp.sum(dirs * dirs, axis=-1)
    half_b = jnp.sum(oc * dirs, axis=-1)
    cc = jnp.sum(oc * oc, axis=-1) - r * r
    # Floor at a positive value: miss lanes (disc ≤ 0) are masked out
    # downstream, but sqrt'(0)=inf would leak NaN into gradients.
    disc = jnp.maximum(half_b * half_b - a * cc, 1e-12)
    sq = jnp.sqrt(disc)
    t_near = (-half_b - sq) / a
    t_far = (-half_b + sq) / a
    t_detached = jax.lax.stop_gradient(ids.t)
    use_near = jnp.abs(t_near - t_detached) <= jnp.abs(t_far - t_detached)
    t_sph = jnp.where(use_near, t_near, t_far)
    sp_point, sp_normal, sp_front, sp_mat, sp_uv = sphere_ops.sphere_shade(
        origins, dirs, t_sph, sid, scene.spheres.center, scene.spheres.radius, scene.spheres.mat_id
    )

    # Triangle branch.
    tid = jnp.where(is_tri, pid, 0)
    _, tr_point, tr_normal, tr_front, tr_mat, tr_uv = tri_ops.tri_shade(
        origins, dirs, tid, scene.mesh.vertices, scene.mesh.faces,
        scene.mesh.face_mat, face_uvs=scene.mesh.uvs
    )

    sel = is_tri[:, None]
    return HitAttrs(
        point=jnp.where(sel, tr_point, sp_point),
        normal=jnp.where(sel, tr_normal, sp_normal),
        front_face=jnp.where(is_tri, tr_front, sp_front),
        mat_id=jnp.where(is_tri, tr_mat, sp_mat),
        uv=jnp.where(sel, tr_uv, sp_uv),
    )
