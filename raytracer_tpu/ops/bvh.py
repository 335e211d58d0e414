"""LBVH construction in pure data-parallel XLA.

The reference builds its per-mesh BVH with a single CUDA thread doing a
top-down SAH build (Core/Mesh.cuh:121-219) and its scene BVH with a
median split (Core/BVHNode.cuh:21-84) — both `<<<1,1>>>` sequential
kernels. Here we build a *linear BVH* instead (SURVEY.md §2.1 "Mesh"
row; acceleration structure is output-invariant as long as closest-hit
semantics hold):

  1. Morton-encode triangle centroids (30-bit),
  2. sort with `lax.sort` (ties broken by primitive index),
  3. Karras 2012 parallel hierarchy emission — every internal node's
     range/split found independently with bit tricks, fully vectorized,
  4. bottom-up AABB refit as a fix-point sweep (converges in tree-depth
     passes; `lax.while_loop` with a convergence check).

Everything is jittable; the build is a one-time cost per scene.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from raytracer_tpu.scene.types import Bvh, TriMesh


def _clz32(x: jnp.ndarray) -> jnp.ndarray:
    """Count leading zeros of uint32 via smear + popcount."""
    x = x.astype(jnp.uint32)
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return (32 - jax.lax.population_count(x).astype(jnp.int32)).astype(jnp.int32)


def _expand_bits(v: jnp.ndarray) -> jnp.ndarray:
    """Spread 10 bits to every 3rd position (standard Morton magic)."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton3d(points01: jnp.ndarray) -> jnp.ndarray:
    """30-bit Morton codes for points in [0,1]^3."""
    q = jnp.clip(points01 * 1024.0, 0.0, 1023.0).astype(jnp.uint32)
    return (
        (_expand_bits(q[:, 0]) << 2)
        | (_expand_bits(q[:, 1]) << 1)
        | _expand_bits(q[:, 2])
    )


@jax.jit
def build_lbvh(mesh: TriMesh) -> Bvh:
    verts, faces = mesh.vertices, mesh.faces
    T = faces.shape[0]
    if T == 1:
        # Degenerate: root is the single leaf; one dummy internal node
        # pointing at it twice keeps traversal uniform.
        v = verts[faces[0]]
        mn = jnp.min(v, axis=0)[None, :]
        mx = jnp.max(v, axis=0)[None, :]
        pad = jnp.where((mx - mn) < 1e-6, 5e-7, 0.0)
        mn, mx = mn - pad, mx + pad
        return Bvh(
            left=jnp.asarray([1], jnp.int32),
            right=jnp.asarray([1], jnp.int32),
            node_min=jnp.concatenate([mn, mn]),
            node_max=jnp.concatenate([mx, mx]),
            prim_index=jnp.asarray([0], jnp.int32),
        )

    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    tri_min = jnp.minimum(jnp.minimum(v0, v1), v2)
    tri_max = jnp.maximum(jnp.maximum(v0, v1), v2)
    centroid = (v0 + v1 + v2) / 3.0

    lo = jnp.min(centroid, axis=0)
    hi = jnp.max(centroid, axis=0)
    extent = jnp.maximum(hi - lo, 1e-12)
    codes = morton3d((centroid - lo) / extent)

    idx = jnp.arange(T, dtype=jnp.int32)
    codes_sorted, prim_index = jax.lax.sort((codes, idx), num_keys=1)

    n_int = T - 1
    i = jnp.arange(n_int, dtype=jnp.int32)

    def delta(a, b):
        """Longest-common-prefix metric between sorted leaves a and b
        (Karras §4); ties on equal codes broken by leaf index. -1 when b
        is out of range. a must be in range."""
        valid = (b >= 0) & (b < T)
        bc = jnp.clip(b, 0, T - 1)
        ca, cb = codes_sorted[a], codes_sorted[bc]
        d = jnp.where(
            ca == cb,
            32 + _clz32((a.astype(jnp.uint32) ^ bc.astype(jnp.uint32))),
            _clz32(ca ^ cb),
        )
        return jnp.where(valid, d, -1)

    # Direction: toward the longer common-prefix neighbor.
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Exponential upper bound for the range length.
    l_max = jnp.full((n_int,), 2, jnp.int32)
    for _ in range(32):
        grow = delta(i, i + l_max * d) > delta_min
        l_max = jnp.where(grow, l_max * 2, l_max)

    # Binary search for the exact other end j.
    l = jnp.zeros((n_int,), jnp.int32)
    t = l_max // 2
    for _ in range(32):
        take = (t > 0) & (delta(i, i + (l + t) * d) > delta_min)
        l = jnp.where(take, l + t, l)
        t = t // 2
    j = i + l * d

    # Binary search for the split position (Karras §4 findSplit).
    delta_node = delta(i, j)
    s = jnp.zeros((n_int,), jnp.int32)
    div = jnp.full((n_int,), 2, jnp.int32)
    for _ in range(32):
        t = (l + div - 1) // div  # ceil(l / div)
        take = (t > 0) & (delta(i, i + (s + t) * d) > delta_node)
        s = jnp.where(take, s + t, s)
        div = div * 2
    gamma = i + s * d + jnp.minimum(d, 0)

    lo_ij = jnp.minimum(i, j)
    hi_ij = jnp.maximum(i, j)
    leaf_base = n_int  # leaf k ↔ node id n_int + k
    left = jnp.where(lo_ij == gamma, leaf_base + gamma, gamma).astype(jnp.int32)
    right = jnp.where(hi_ij == gamma + 1, leaf_base + gamma + 1, gamma + 1).astype(jnp.int32)

    # AABBs: leaves in sorted order, then fix-point refit for internals.
    # Degenerate (flat) boxes are padded like the reference's
    # AABB::padToMinimums (Core/AABB.cuh:181-186): the strict slab test
    # (tmax > tmin) would otherwise always miss zero-thickness boxes —
    # e.g. every axis-aligned Cornell wall.
    pad = jnp.where((tri_max - tri_min) < 1e-6, 5e-7, 0.0)
    tri_min = tri_min - pad
    tri_max = tri_max + pad
    leaf_min = tri_min[prim_index]
    leaf_max = tri_max[prim_index]
    node_min = jnp.concatenate([jnp.full((n_int, 3), jnp.inf, jnp.float32), leaf_min])
    node_max = jnp.concatenate([jnp.full((n_int, 3), -jnp.inf, jnp.float32), leaf_max])

    def refit_cond(state):
        node_min, node_max, changed, it = state
        return changed & (it < 256)

    def refit_body(state):
        node_min, node_max, _, it = state
        new_int_min = jnp.minimum(node_min[left], node_min[right])
        new_int_max = jnp.maximum(node_max[left], node_max[right])
        nmin = node_min.at[:n_int].set(new_int_min)
        nmax = node_max.at[:n_int].set(new_int_max)
        changed = jnp.any(nmin[:n_int] != node_min[:n_int]) | jnp.any(
            nmax[:n_int] != node_max[:n_int]
        )
        return nmin, nmax, changed, it + 1

    node_min, node_max, _, _ = jax.lax.while_loop(
        refit_cond, refit_body, (node_min, node_max, jnp.asarray(True), jnp.asarray(0))
    )

    return Bvh(left=left, right=right, node_min=node_min, node_max=node_max, prim_index=prim_index)
