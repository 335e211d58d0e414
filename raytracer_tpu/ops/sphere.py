"""Batched ray–sphere intersection.

Same quadratic + near-then-far root selection as the reference
(Core/Sphere.cuh:18-47), vectorized over an [N]-ray wavefront × [S]
spheres. Root validity uses the reference's Interval::outOfInterval
semantics (`t < t_min || t > t_max` is invalid, Core/Interval.cuh:33-35).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from raytracer_tpu.utils import vecmath as vm

BIG = np.float32(3.0e38)


def intersect_spheres(origins, dirs, centers, radii, t_min, t_max):
    """Closest valid sphere hit per ray.

    origins/dirs: f32[N,3]; centers: f32[S,3]; radii: f32[S].
    t_min scalar; t_max: scalar or f32[N].
    Returns (t f32[N] (BIG when miss), sphere_id i32[N]).

    Unrolled over the (small, static) sphere list with [N]-shaped math,
    which fuses into one elementwise program for the reference's handful
    of spheres.
    """
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), origins.shape[:1])
    a = vm.dot(dirs, dirs, keepdims=False)                    # [N]

    t_best = jnp.full(origins.shape[:1], BIG, jnp.float32)
    id_best = jnp.zeros(origins.shape[:1], jnp.int32)
    s_count = centers.shape[0]
    for s in range(s_count):
        oc = origins - centers[s]
        half_b = jnp.sum(oc * dirs, axis=-1)
        c = jnp.sum(oc * oc, axis=-1) - radii[s] * radii[s]
        disc = half_b * half_b - a * c
        ok = disc >= 0.0
        sqrtd = jnp.sqrt(jnp.maximum(disc, 0.0))
        root_near = (-half_b - sqrtd) / a
        root_far = (-half_b + sqrtd) / a
        near_ok = (root_near >= t_min) & (root_near <= t_max)
        far_ok = (root_far >= t_min) & (root_far <= t_max)
        root = jnp.where(near_ok, root_near, root_far)
        valid = ok & (near_ok | far_ok)
        t_s = jnp.where(valid, root, BIG)
        better = t_s < t_best
        t_best = jnp.where(better, t_s, t_best)
        id_best = jnp.where(better, s, id_best)
    return t_best, id_best


def sphere_shade(origins, dirs, t, sphere_id, centers, radii, mat_ids):
    """Differentiable hit attributes for chosen spheres.

    Recomputes point and outward normal from the (detached) hit ids so
    gradients flow to sphere params; normal is flipped to face the ray
    (HitInfo::setFaceNormal, Core/HitInfo.cuh:15-18). The hit UV is the
    standard sphere latitude/longitude parameterization (the reference's
    HitInfo U/V fields are declared but never written — Texture.cuh is
    dead; this fills them the conventional way for the texture hook).
    Returns (point f32[N,3], normal f32[N,3], front_face bool[N],
    mat i32[N], uv f32[N,2]).
    """
    center = centers[sphere_id]
    # Guard against the zero-radius sentinel sphere: its lanes are masked
    # out downstream, but a 0-divide here would leak NaNs through where().
    radius = jnp.where(radii[sphere_id] != 0.0, radii[sphere_id], 1.0)
    point = origins + t[:, None] * dirs
    outward = (point - center) / radius[:, None]
    front = vm.dot(dirs, outward, keepdims=False) < 0.0
    normal = jnp.where(front[:, None], outward, -outward)
    ox, oy, oz = outward[:, 0], outward[:, 1], outward[:, 2]
    theta = jnp.arccos(jnp.clip(-oy, -1.0, 1.0))
    phi = jnp.arctan2(-oz, ox) + jnp.pi
    uv = jnp.stack([phi / (2.0 * jnp.pi), theta / jnp.pi], axis=-1)
    return point, normal, front, mat_ids[sphere_id], uv
