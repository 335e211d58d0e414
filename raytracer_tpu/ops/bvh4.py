"""4-wide BVH (BVH4): collapse of the binary LBVH for wide traversal.

Why: the binary lockstep traversal (ops/traverse.py) pays ~6 scattered
gathers per step and visits ~2x more nodes than a 4-wide tree. A BVH4
step gathers ONE coalesced 24-float bounds row + one 4-int child row,
slab-tests 4 children vectorized, and handles leaves as CONTIGUOUS
sorted-triangle ranges (Karras subtrees cover contiguous sorted leaf
slots), so leaf processing reads consecutive rows instead of scattering.

Child encoding (i32):
    >= 0   → internal BVH4 node index
    == -1  → empty slot
    <= -2  → leaf range: code = -(2 + lo*8 + (count-1)), count ∈ 1..8

The collapse runs host-side in NumPy (one-time per scene, vectorized
level sweep). Traversal preserves the reference's closest-hit semantics
exactly (same slab test and Möller–Trumbore as the binary path).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.ops import triangle as tri_ops
from raytracer_tpu.scene.types import Bvh, TriMesh, _pytree

BIG = np.float32(3.0e38)
STACK_DEPTH = 48
MAX_LEAF = 8  # triangles per leaf range (≤8 encodable; one packed table row)


@_pytree(meta=["stack_depth"])
@dataclasses.dataclass(frozen=True)
class Bvh4:
    bounds: jnp.ndarray    # f32[N4, 4, 6] child boxes (min3, max3); empty slots inf/-inf
    children: jnp.ndarray  # i32[N4, 4] encoded as above
    tri: jnp.ndarray       # f32[T, 9] packed (v0,e1,e2) in SORTED leaf order
    prim_index: jnp.ndarray  # i32[T] sorted-slot → original face id
    face_mat: jnp.ndarray | None = None  # i32[T] material ids in SORTED order
    # Two-level split (scene/builder.partition_brute_faces): a handful of
    # LARGE triangles (Cornell walls/boxes/light) kept OUT of the tree
    # and tested brute-force — a static vectorized pre-pass that primes
    # t_best, after which most interior bounce rays never enter the tree
    # at all (~3x fewer traversal iterations, scripts/divergence_study).
    # Ids are ORIGINAL face indices; padded slots hold degenerate tris.
    brute_tri: jnp.ndarray | None = None   # f32[Tb,9], Tb % 8 == 0
    brute_prim: jnp.ndarray | None = None  # i32[Tb]
    brute_mat: jnp.ndarray | None = None   # i32[Tb]
    stack_depth: int = STACK_DEPTH  # static: exact 3*tree-depth bound


def compute_stack_depth(children: np.ndarray) -> int:
    """Exact worst-case traversal stack bound: ≤(width−1) pushes per
    level on a root-to-leaf chain → (width−1) × tree depth (+ slack),
    rounded up to 8. Width-generic (BVH4 and widened BVH8 trees)."""
    depth = np.zeros(children.shape[0], np.int32)
    maxd = 1
    stack = [0]
    depth[0] = 1
    while stack:
        nid = stack.pop()
        for c in children[nid]:
            if c >= 0:
                depth[c] = depth[nid] + 1
                maxd = max(maxd, int(depth[c]))
                stack.append(int(c))
    bound = (children.shape[1] - 1) * maxd + 4
    return min(int((bound + 7) // 8 * 8), 256)


def _leaf_code(lo: int, count: int) -> int:
    return -(2 + lo * 8 + (count - 1))


def align_leaves_to_rows(children: np.ndarray, tri: np.ndarray,
                         prim_index: np.ndarray, face_mat: np.ndarray):
    """Re-pack sorted triangles so every leaf range starts at a multiple
    of 8, so every leaf starts on an aligned 8-triangle group of the
    triangle table. Padding slots hold degenerate
    triangles (e1=e2=0 -> Möller–Trumbore rejects at the determinant
    epsilon) and are additionally gated by the leaf count.

    Returns (children, tri, prim_index, face_mat) with len(tri) % 8 == 0.
    Works for both the Python LBVH collapse and the native SAH builder
    (leaf ranges are disjoint in both)."""
    ch = children.copy()
    flat = ch.reshape(-1)
    leaf_mask = flat <= -2
    codes = -flat[leaf_mask] - 2
    los = codes // 8
    counts = codes % 8 + 1
    nleaf = los.shape[0]
    order = np.argsort(los, kind="stable")  # preserve sorted-slot locality
    new_tri = np.zeros((8 * nleaf, tri.shape[1]), tri.dtype)
    # Padding slots get prim -1 so consumers (coverage stats, remaps,
    # serialization) can tell them from real primitives; at runtime they
    # are never selected (degenerate triangles self-reject).
    new_prim = np.full((8 * nleaf,), -1, prim_index.dtype)
    new_fmat = np.zeros((8 * nleaf,), face_mat.dtype)
    new_codes = np.empty((nleaf,), np.int64)
    for i in range(nleaf):
        li = int(order[i])
        lo = int(los[li])
        cnt = int(counts[li])
        new_tri[8 * i:8 * i + cnt] = tri[lo:lo + cnt]
        new_prim[8 * i:8 * i + cnt] = prim_index[lo:lo + cnt]
        new_fmat[8 * i:8 * i + cnt] = face_mat[lo:lo + cnt]
        new_codes[li] = _leaf_code(8 * i, cnt)
    flat[leaf_mask] = new_codes.astype(flat.dtype)
    return ch, new_tri, new_prim, new_fmat


# Sorting networks (compare-exchange pair lists) by width: 4 = the
# 5-comparator optimal net, 8 = bitonic (19 comparators).
SORT_PAIRS = {
    4: ((0, 2), (1, 3), (0, 1), (2, 3), (1, 2)),
    8: ((0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6),
        (0, 4), (1, 5), (2, 6), (3, 7),
        (2, 4), (3, 5),
        (1, 2), (3, 4), (5, 6)),
}


def sort_by_key(tm: jnp.ndarray, cc: jnp.ndarray):
    """Vectorized K-element sorting network over the trailing axis
    (K = tm.shape[-1] ∈ SORT_PAIRS): sorts keys ascending, permuting
    payload `cc` alongside. Shared by the per-lane and packet
    traversals (child ordering), width-generic."""

    def cswap(tm, cc, i, j):
        swap = tm[:, i] > tm[:, j]
        ti = jnp.where(swap, tm[:, j], tm[:, i])
        tj = jnp.where(swap, tm[:, i], tm[:, j])
        ci = jnp.where(swap, cc[:, j], cc[:, i])
        cj = jnp.where(swap, cc[:, i], cc[:, j])
        return (tm.at[:, i].set(ti).at[:, j].set(tj),
                cc.at[:, i].set(ci).at[:, j].set(cj))

    for (i, j) in SORT_PAIRS[tm.shape[-1]]:
        tm, cc = cswap(tm, cc, i, j)
    return tm, cc


sort4_by_key = sort_by_key  # back-compat alias


def widen_bvh(b4: Bvh4, width: int = 8) -> Bvh4:
    """Host-side collapse of a BVH4 into a wider tree (default BVH8) by
    greedily absorbing internal children into their parents (largest
    child box first — the biggest subtrees gain the most from the
    extra fanout). Leaf codes and the triangle table are untouched, so
    the result is output-invariant; only visit counts change (fewer,
    wider node visits per ray). Stack bound is recomputed for
    (width−1) pushes per level."""
    ch = np.asarray(b4.children)
    b = np.asarray(b4.bounds)
    kw = ch.shape[1]
    if kw >= width:
        return b4

    def slot_area(bb):
        d = np.maximum(bb[3:6] - bb[0:3], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def expand(node: int):
        slots = [(int(ch[node, k]), b[node, k])
                 for k in range(kw) if ch[node, k] != -1]
        while True:
            best = None
            best_a = -1.0
            for i, (c, bb) in enumerate(slots):
                if c >= 0:
                    nc = int((ch[c] != -1).sum())
                    if len(slots) - 1 + nc <= width:
                        a = slot_area(bb)
                        if a > best_a:
                            best_a = a
                            best = i
            if best is None:
                return slots
            c, _ = slots.pop(best)
            slots.extend((int(ch[c, k]), b[c, k])
                         for k in range(kw) if ch[c, k] != -1)

    kept = {0: 0}
    order = [0]
    rows = {}
    stack = [0]
    while stack:
        node = stack.pop()
        slots = expand(node)
        rows[node] = slots
        for c, _ in slots:
            if c >= 0 and c not in kept:
                kept[c] = len(order)
                order.append(c)
                stack.append(c)

    n = len(order)
    bounds = np.empty((n, width, 6), np.float32)
    bounds[:, :, 0:3] = np.inf
    bounds[:, :, 3:6] = -np.inf
    children = np.full((n, width), -1, np.int32)
    for node in order:
        idx = kept[node]
        for slot, (c, bb) in enumerate(rows[node]):
            bounds[idx, slot] = bb
            children[idx, slot] = kept[c] if c >= 0 else c

    return dataclasses.replace(
        b4,
        bounds=jnp.asarray(bounds),
        children=jnp.asarray(children),
        stack_depth=compute_stack_depth(children),
    )


def build_bvh4(mesh: TriMesh, bvh: Bvh) -> Bvh4:
    """Host-side collapse of the binary LBVH into a BVH4."""
    face_mat_np = np.asarray(mesh.face_mat)
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    node_min = np.asarray(bvh.node_min)
    node_max = np.asarray(bvh.node_max)
    prim_index = np.asarray(bvh.prim_index)
    n_int = left.shape[0]
    t = n_int + 1

    # Leaf-slot ranges per binary node (leaves are contiguous in Karras).
    lo = np.zeros(2 * t - 1, np.int64)
    hi = np.zeros(2 * t - 1, np.int64)
    lo[n_int:] = np.arange(t)
    hi[n_int:] = np.arange(t)
    # Internal ranges via fix-point sweeps (depth-bounded).
    for _ in range(64):
        new_lo = np.minimum(lo[left], lo[right])
        new_hi = np.maximum(hi[left], hi[right])
        if (new_lo == lo[:n_int]).all() and (new_hi == hi[:n_int]).all():
            break
        lo[:n_int] = new_lo
        hi[:n_int] = new_hi
    count = hi - lo + 1

    def expand(node: int) -> list[int]:
        """Binary children, splitting internal children once more → ≤4."""
        out = []
        for c in (left[node], right[node]):
            if c >= n_int or count[c] <= MAX_LEAF:
                out.append(int(c))
            else:
                out.extend((int(left[c]), int(right[c])))
        return out

    # BFS from binary root (0), creating a BVH4 node per visited binary
    # internal node with count > MAX_LEAF.
    bvh4_id: dict[int, int] = {}
    order: list[int] = []

    if count[0] <= MAX_LEAF:
        # Tiny mesh: single root with one leaf-range child.
        bounds = np.full((1, 4, 6), 0, np.float32)
        bounds[:, :, 0:3] = np.inf
        bounds[:, :, 3:6] = -np.inf
        bounds[0, 0, 0:3] = node_min[0]
        bounds[0, 0, 3:6] = node_max[0]
        children = np.full((1, 4), -1, np.int32)
        children[0, 0] = _leaf_code(int(lo[0]), int(count[0]))
    else:
        queue = [0]
        bvh4_id[0] = 0
        order.append(0)
        while queue:
            node = queue.pop()
            for c in expand(node):
                if c < n_int and count[c] > MAX_LEAF and c not in bvh4_id:
                    bvh4_id[c] = len(order)
                    order.append(c)
                    queue.append(c)

        n4 = len(order)
        bounds = np.empty((n4, 4, 6), np.float32)
        bounds[:, :, 0:3] = np.inf
        bounds[:, :, 3:6] = -np.inf
        children = np.full((n4, 4), -1, np.int32)
        for idx, node in enumerate(order):
            for slot, c in enumerate(expand(node)):
                bounds[idx, slot, 0:3] = node_min[c]
                bounds[idx, slot, 3:6] = node_max[c]
                if c >= n_int:
                    children[idx, slot] = _leaf_code(int(lo[c]), 1)
                elif count[c] <= MAX_LEAF:
                    children[idx, slot] = _leaf_code(int(lo[c]), int(count[c]))
                else:
                    children[idx, slot] = bvh4_id[c]

    # Triangle data in sorted leaf order, leaf rows 8-aligned.
    verts = np.asarray(mesh.vertices)
    faces = np.asarray(mesh.faces)[prim_index]
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0

    tri = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)
    children, tri, prim_al, fmat_al = align_leaves_to_rows(
        children, tri, prim_index.astype(np.int32),
        face_mat_np[prim_index].astype(np.int32))
    return Bvh4(
        bounds=jnp.asarray(bounds),
        children=jnp.asarray(children),
        tri=jnp.asarray(tri),
        prim_index=jnp.asarray(prim_al),
        face_mat=jnp.asarray(fmat_al),
        stack_depth=compute_stack_depth(children),
    )


def intersect_bvh4(origins, dirs, bvh4: Bvh4, t_min, t_max):
    """Closest triangle hit; returns (t f32[N] (BIG on miss), tri_id i32[N]
    in ORIGINAL face order). Lockstep wavefront while_loop; each lane's
    step is either one internal-node expansion (4 slab tests) or one
    leaf-range sweep (≤4 contiguous Möller–Trumbore tests)."""
    n = origins.shape[0]
    stack_cap = bvh4.stack_depth
    lanes = jnp.arange(n)
    inv_d = 1.0 / dirs
    t_hi0 = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    root_b = bvh4.bounds[0]  # [4,6] — root's own box is the union
    root_min = jnp.min(root_b[:, 0:3], axis=0)
    root_max = jnp.max(jnp.where(jnp.isfinite(root_b[:, 3:6]), root_b[:, 3:6], -BIG), axis=0)
    rt0 = (root_min - origins) * inv_d
    rt1 = (root_max - origins) * inv_d
    rmin = jnp.maximum(jnp.max(jnp.minimum(rt0, rt1), axis=-1), t_min)
    rmax = jnp.minimum(jnp.min(jnp.maximum(rt0, rt1), axis=-1), t_hi0)
    root_hit = rmax > rmin

    NONE = jnp.int32(-1)

    def cond(state):
        return jnp.any(state["active"])

    def body(state):
        task = state["task"]
        active = state["active"]
        t_best = state["t_best"]
        best = state["best_prim"]
        sp = state["sp"]
        stack = state["stack"]

        is_internal = active & (task >= 0)
        is_leaf = active & (task <= -2)

        # ---- Internal expansion (width-generic: K = children.shape[1]) ----
        K = bvh4.children.shape[1]
        ni = jnp.where(is_internal, task, 0)
        b = bvh4.bounds[ni]                     # [N,K,6]
        ch = bvh4.children[ni]                  # [N,K]
        t0 = (b[:, :, 0:3] - origins[:, None, :]) * inv_d[:, None, :]
        t1 = (b[:, :, 3:6] - origins[:, None, :]) * inv_d[:, None, :]
        tmin = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), t_min)      # [N,K]
        tmax = jnp.minimum(jnp.min(jnp.maximum(t0, t1), axis=-1), t_best[:, None])
        chit = (tmax > tmin) & (ch != NONE) & is_internal[:, None]
        tmin = jnp.where(chit, tmin, BIG)

        # Sort candidates by entry t (shared sorting network).
        tm, cc = sort_by_key(tmin, ch)
        nhit = jnp.sum(chit.astype(jnp.int32), axis=-1)  # [N] sorted-valid prefix

        next_from_internal = jnp.where(nhit > 0, cc[:, 0], NONE)
        # Push the rest far-to-near so nearest pops first.
        for k in range(K - 1, 0, -1):
            do_push = is_internal & (nhit > k)
            idx = jnp.clip(sp, 0, stack_cap - 1)
            stack = stack.at[lanes, idx].set(jnp.where(do_push, cc[:, k], stack[lanes, idx]))
            sp = jnp.where(do_push, sp + 1, sp)

        # ---- Leaf-range sweep ----
        code = jnp.where(is_leaf, -task - 2, 0)
        leaf_lo = code // 8
        leaf_count = (code % 8) + 1
        for k in range(MAX_LEAF):
            slot = jnp.clip(leaf_lo + k, 0, bvh4.tri.shape[0] - 1)
            trik = bvh4.tri[slot]  # [N,9] single coalesced gather
            ok, t_tri = tri_ops.intersect_tri_single(
                origins, dirs, trik[:, 0:3], trik[:, 3:6], trik[:, 6:9],
                t_min, t_best,
            )
            improve = is_leaf & (k < leaf_count) & ok & (t_tri < t_best)
            t_best = jnp.where(improve, t_tri, t_best)
            best = jnp.where(improve, bvh4.prim_index[slot], best)

        # ---- Next task ----
        next_task = jnp.where(is_internal, next_from_internal, NONE)
        can_pop = sp > 0
        popped = stack[lanes, jnp.clip(sp - 1, 0, stack_cap - 1)]
        do_pop = active & (next_task == NONE) & can_pop
        next_task = jnp.where(do_pop, popped, next_task)
        sp = jnp.where(do_pop, sp - 1, sp)
        active = active & (next_task != NONE)

        return {
            "task": jnp.where(active, next_task, 0),
            "sp": sp,
            "stack": stack,
            "t_best": t_best,
            "best_prim": best,
            "active": active,
        }

    state = {
        "task": jnp.zeros((n,), jnp.int32),
        "sp": jnp.zeros((n,), jnp.int32),
        "stack": jnp.zeros((n, stack_cap), jnp.int32),
        "t_best": t_hi0,
        "best_prim": jnp.full((n,), -1, jnp.int32),
        "active": root_hit,
    }
    state = jax.lax.while_loop(cond, body, state)
    found = state["best_prim"] >= 0
    return jnp.where(found, state["t_best"], BIG), jnp.where(found, state["best_prim"], 0)
