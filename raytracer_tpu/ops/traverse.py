"""Wavefront BVH traversal.

The reference traverses per-thread with an explicit stack and divergent
control flow (Core/Mesh.cuh:55-110, Core/BVHNode.cuh:115-156). This
formulation keeps the *whole ray wavefront* advancing in lockstep inside
one `lax.while_loop`: each step, every active lane either tests its
current internal node's two child AABBs (near-child-first, far pushed)
or intersects its current leaf triangle, exactly preserving the
reference's closest-hit semantics (candidate interval [t_min,
closest-so-far], slab test hit iff tmax > tmax-clamped tmin,
Core/AABB.cuh:123-146).

This is the pure-XLA path over the binary LBVH; ops/bvh4.py and
ops/packets.py walk the wider BVH4/BVH8.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.ops import triangle as tri_ops
from raytracer_tpu.scene.types import Bvh, TriMesh

BIG = np.float32(3.0e38)
STACK_DEPTH = 64
SENTINEL = np.int32(-1)


def _slab(origins, inv_d, node_min, node_max, t_lo, t_hi):
    """Batched AABB slab test (Core/AABB.cuh:123-146).
    Returns (hit bool[N], tmin f32[N])."""
    t0 = (node_min - origins) * inv_d
    t1 = (node_max - origins) * inv_d
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    tmin = jnp.maximum(tmin, t_lo)
    tmax = jnp.minimum(tmax, t_hi)
    return tmax > tmin, tmin


def intersect_bvh(origins, dirs, mesh: TriMesh, bvh: Bvh, t_min, t_max):
    """Closest triangle hit via LBVH.

    origins/dirs: f32[N,3]; t_max: scalar or f32[N] (pre-pruned, e.g. by
    the sphere pass). Returns (t f32[N] (BIG on miss), tri_id i32[N] in
    ORIGINAL face order).
    """
    n = origins.shape[0]
    n_int = bvh.left.shape[0]
    leaf_base = n_int

    inv_d = 1.0 / dirs  # ±inf on zero components, as in the reference
    t_hi0 = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    v0_all = mesh.vertices[mesh.faces[:, 0]]
    e1_all = mesh.vertices[mesh.faces[:, 1]] - v0_all
    e2_all = mesh.vertices[mesh.faces[:, 2]] - v0_all

    # Root prune: rays missing the scene box never enter the loop.
    root_hit, _ = _slab(origins, inv_d, bvh.node_min[0], bvh.node_max[0], t_min, t_hi0)

    def cond(state):
        return jnp.any(state["active"])

    def body(state):
        node = state["node"]
        active = state["active"]
        t_best = state["t_best"]

        is_leaf = node >= leaf_base
        # --- Internal: test both children (gathers are masked via clip).
        ni = jnp.where(is_leaf, 0, node)
        lc = bvh.left[ni]
        rc = bvh.right[ni]
        lhit, lt = _slab(origins, inv_d, bvh.node_min[lc], bvh.node_max[lc], t_min, t_best)
        rhit, rt = _slab(origins, inv_d, bvh.node_min[rc], bvh.node_max[rc], t_min, t_best)
        # Near child first (the reference goes left-then-right,
        # Core/Mesh.cuh:73-74; near-first is output-invariant and prunes more).
        l_near = jnp.where(rhit & lhit, lt <= rt, lhit)
        near = jnp.where(l_near, lc, rc)
        far = jnp.where(l_near, rc, lc)
        both = lhit & rhit
        one = lhit ^ rhit
        next_internal = jnp.where(both | one, near, SENTINEL)

        # --- Leaf: single-triangle test.
        prim = bvh.prim_index[jnp.where(is_leaf, node - leaf_base, 0)]
        ok, t_tri = tri_ops.intersect_tri_single(
            origins, dirs, v0_all[prim], e1_all[prim], e2_all[prim], t_min, t_best
        )
        leaf_improve = is_leaf & active & ok & (t_tri < t_best)
        t_best = jnp.where(leaf_improve, t_tri, t_best)
        best_prim = jnp.where(leaf_improve, prim, state["best_prim"])

        # --- Stack ops.
        sp = state["sp"]
        push = active & ~is_leaf & both
        stack = state["stack"]
        stack = stack.at[jnp.arange(n), jnp.clip(sp, 0, STACK_DEPTH - 1)].set(
            jnp.where(push, far, stack[jnp.arange(n), jnp.clip(sp, 0, STACK_DEPTH - 1)])
        )
        sp = jnp.where(push, sp + 1, sp)

        # Next node: internal descend, else pop.
        next_node = jnp.where(active & ~is_leaf, next_internal, SENTINEL)
        can_pop = sp > 0
        popped = stack[jnp.arange(n), jnp.clip(sp - 1, 0, STACK_DEPTH - 1)]
        do_pop = (next_node == SENTINEL) & active & can_pop
        next_node = jnp.where(do_pop, popped, next_node)
        sp = jnp.where(do_pop, sp - 1, sp)
        active = active & (next_node != SENTINEL)

        return {
            "node": jnp.where(active, next_node, 0),
            "sp": sp,
            "stack": stack,
            "t_best": t_best,
            "best_prim": best_prim,
            "active": active,
        }

    state = {
        "node": jnp.zeros((n,), jnp.int32),
        "sp": jnp.zeros((n,), jnp.int32),
        "stack": jnp.zeros((n, STACK_DEPTH), jnp.int32),
        "t_best": t_hi0,
        "best_prim": jnp.full((n,), -1, jnp.int32),
        "active": root_hit,
    }
    state = jax.lax.while_loop(cond, body, state)

    found = state["best_prim"] >= 0
    t = jnp.where(found, state["t_best"], BIG)
    return t, jnp.where(found, state["best_prim"], 0)
