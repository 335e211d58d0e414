"""Packet BVH4 traversal in XLA — the wavefront's traversal.

Classic *packet traversal* expressed as dense XLA ops:

  * rays are sorted by a coherence key (direction octant + origin
    Morton code) and grouped into packets of P rays,
  * each packet traverses the BVH4 with ONE shared traversal state —
    the per-step node reads are [G]-indexed gathers (G = N/P packets),
    and all intersection math is dense [G, P] vector work at full lane
    occupancy,
  * a packet descends into a child iff ANY of its rays hits the child
    box (closest-hit stays exact per ray via per-ray t_best pruning),
  * results are scattered back through the inverse permutation.

On the GPU this measured faster under the 2K wavefront than the
per-lane walk of ops/bvh4.py (CHANGES.md), so it is the default there.

Coherent camera packets visit nearly the per-ray optimal node set;
incoherent bounce packets visit the union of their rays' node sets —
the sort keeps that union small. Exactness: every ray still tests every
leaf it can intersect with the same Möller–Trumbore + slab semantics as
ops/bvh4.py (equivalence-tested against brute force).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.ops.bvh import morton3d
from raytracer_tpu.ops.bvh4 import MAX_LEAF, Bvh4

BIG = np.float32(3.0e38)
EPSILON = 1e-8


def _coherence_keys(origins, dirs, scene_lo, scene_inv_extent):
    """u32 sort key: 3-bit direction octant, then 27 bits of origin
    Morton code — bounces from nearby points in similar directions land
    in the same packet."""
    octant = (
        (dirs[:, 0] < 0).astype(jnp.uint32)
        | ((dirs[:, 1] < 0).astype(jnp.uint32) << 1)
        | ((dirs[:, 2] < 0).astype(jnp.uint32) << 2)
    )
    o01 = jnp.clip((origins - scene_lo) * scene_inv_extent, 0.0, 1.0)
    code = morton3d(o01)  # 30 bits
    return (octant << 29) | (code >> 1)


def intersect_bvh4_packets(
    origins, dirs, bvh4: Bvh4, t_min, t_max, packet_size: int = 64, sort: bool = True
):
    """Closest triangle hit via packetized BVH4 traversal.

    origins/dirs: f32[N,3]; t_max scalar or f32[N]. Returns
    (t f32[N] (BIG on miss), tri_id i32[N] in ORIGINAL face order).
    N is padded internally to a multiple of packet_size.
    """
    n = origins.shape[0]
    P = int(packet_size)
    pad = (-n) % P
    t_hi = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    root_lo = jnp.min(bvh4.bounds[0, :, 0:3], axis=0)
    root_hi_b = jnp.where(jnp.isfinite(bvh4.bounds[0, :, 3:6]), bvh4.bounds[0, :, 3:6], -BIG)
    root_hi = jnp.max(root_hi_b, axis=0)

    if sort:
        inv_extent = 1.0 / jnp.maximum(root_hi - root_lo, 1e-12)
        keys = _coherence_keys(origins, dirs, root_lo, inv_extent)
        perm = jnp.argsort(keys).astype(jnp.int32)
    else:
        perm = jnp.arange(n, dtype=jnp.int32)

    if pad:
        perm_p = jnp.concatenate([perm, jnp.zeros((pad,), jnp.int32)])
        valid = jnp.concatenate([jnp.ones((n,), bool), jnp.zeros((pad,), bool)])
    else:
        perm_p = perm
        valid = jnp.ones((n,), bool)

    o = origins[perm_p].reshape(-1, P, 3)
    d = dirs[perm_p].reshape(-1, P, 3)
    th = jnp.where(valid, t_hi[perm_p], -1.0).reshape(-1, P)  # padded rays dead
    G = o.shape[0]
    groups = jnp.arange(G)

    inv_d = 1.0 / d
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    ix, iy, iz = inv_d[..., 0], inv_d[..., 1], inv_d[..., 2]

    def slab(blo_x, blo_y, blo_z, bhi_x, bhi_y, bhi_z, t_best):
        """Per-ray slab test vs one box per group; b* are [G,1]."""
        t0x = (blo_x - ox) * ix
        t1x = (bhi_x - ox) * ix
        t0y = (blo_y - oy) * iy
        t1y = (bhi_y - oy) * iy
        t0z = (blo_z - oz) * iz
        t1z = (bhi_z - oz) * iz
        tmin = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.maximum(jnp.minimum(t0z, t1z), t_min),
        )
        tmax = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.minimum(jnp.maximum(t0z, t1z), t_best),
        )
        return tmax > tmin, tmin  # [G,P]

    # Root prune.
    rhit, _ = slab(root_lo[0], root_lo[1], root_lo[2], root_hi[0], root_hi[1], root_hi[2],
                   th)
    th = jnp.where(rhit, th, -1.0)
    g_active0 = jnp.any(th > 0.0, axis=1)

    NONE = jnp.int32(-1)
    stack_cap = bvh4.stack_depth

    def cond(s):
        return jnp.any(s["active"])

    def body(s):
        task = s["task"]
        active = s["active"]
        t_best = s["t_best"]
        best = s["best"]
        sp = s["sp"]
        stack = s["stack"]

        is_internal = active & (task >= 0)
        is_leaf = active & (task <= -2)

        # ---- Internal: K child boxes, shared per group. ----
        K = bvh4.children.shape[1]
        ni = jnp.where(is_internal, task, 0)
        b = bvh4.bounds[ni]       # [G,K,6] — G-sized gather
        ch = bvh4.children[ni]    # [G,K]

        gmin = jnp.full((G, K), BIG, jnp.float32)
        for k in range(K):
            hit_k, tmin_k = slab(
                b[:, k, 0:1], b[:, k, 1:2], b[:, k, 2:3],
                b[:, k, 3:4], b[:, k, 4:5], b[:, k, 5:6], t_best,
            )
            hit_k = hit_k & is_internal[:, None] & (ch[:, k:k+1] != NONE)
            any_k = jnp.any(hit_k, axis=1)
            gmin = gmin.at[:, k].set(
                jnp.where(any_k, jnp.min(jnp.where(hit_k, tmin_k, BIG), axis=1), BIG)
            )

        # Order children by the packet's nearest entry (shared net sort).
        from raytracer_tpu.ops.bvh4 import sort_by_key

        tm, cc = sort_by_key(gmin, ch)
        nhit = jnp.sum((tm < BIG).astype(jnp.int32), axis=1)  # [G]

        next_from_internal = jnp.where(nhit > 0, cc[:, 0], NONE)
        for k in range(K - 1, 0, -1):
            do_push = is_internal & (nhit > k)
            idx = jnp.clip(sp, 0, stack_cap - 1)
            stack = stack.at[groups, idx].set(jnp.where(do_push, cc[:, k], stack[groups, idx]))
            sp = jnp.where(do_push, sp + 1, sp)

        # ---- Leaf range: ≤MAX_LEAF contiguous triangles vs all P rays. ----
        code = jnp.where(is_leaf, -task - 2, 0)
        leaf_lo = code // 8
        leaf_count = (code % 8) + 1
        for k in range(MAX_LEAF):
            slot = jnp.clip(leaf_lo + k, 0, bvh4.tri.shape[0] - 1)
            tri = bvh4.tri[slot]  # [G,9]
            v0 = tri[:, None, 0:3]
            e1 = tri[:, None, 3:6]
            e2 = tri[:, None, 6:9]
            h = jnp.cross(d, e2)
            a = jnp.sum(e1 * h, axis=-1)
            ok = jnp.abs(a) >= EPSILON
            f = 1.0 / jnp.where(ok, a, 1.0)
            sv = o - v0
            u = f * jnp.sum(sv * h, axis=-1)
            ok &= (u >= 0.0) & (u <= 1.0)
            q = jnp.cross(sv, e1)
            v = f * jnp.sum(d * q, axis=-1)
            ok &= (v >= 0.0) & (u + v <= 1.0)
            t = f * jnp.sum(e2 * q, axis=-1)
            ok &= (t >= t_min) & (t < t_best)
            ok &= (is_leaf & (k < leaf_count))[:, None]
            t_best = jnp.where(ok, t, t_best)
            best = jnp.where(ok, bvh4.prim_index[slot][:, None], best)

        # ---- Next task. ----
        next_task = jnp.where(is_internal, next_from_internal, NONE)
        can_pop = sp > 0
        popped = stack[groups, jnp.clip(sp - 1, 0, stack_cap - 1)]
        do_pop = active & (next_task == NONE) & can_pop
        next_task = jnp.where(do_pop, popped, next_task)
        sp = jnp.where(do_pop, sp - 1, sp)
        active = active & (next_task != NONE)

        return {
            "task": jnp.where(active, next_task, 0),
            "sp": sp,
            "stack": stack,
            "t_best": t_best,
            "best": best,
            "active": active,
        }

    state = {
        "task": jnp.zeros((G,), jnp.int32),
        "sp": jnp.zeros((G,), jnp.int32),
        "stack": jnp.zeros((G, stack_cap), jnp.int32),
        "t_best": th,
        "best": jnp.full((G, P), -1, jnp.int32),
        "active": g_active0,
    }
    state = jax.lax.while_loop(cond, body, state)

    t_flat = state["t_best"].reshape(-1)[: n + pad]
    best_flat = state["best"].reshape(-1)[: n + pad]
    # Un-permute: result for original ray perm_p[i] is at padded slot i.
    inv = jnp.argsort(perm_p[: n + pad].at[n:].set(jnp.int32(2**30)) if pad else perm_p)
    if pad:
        inv = inv[:n]
    t_sorted = t_flat[inv]
    best_sorted = best_flat[inv]
    found = best_sorted >= 0
    return jnp.where(found, t_sorted, BIG), jnp.where(found, best_sorted, 0)
