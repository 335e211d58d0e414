"""Scene builders for the milestone configs and the reference world.

The reference hardcodes its world inside the `createRandomWorld` device
kernel (CUDAKernels.h:56-84): loaded meshes + a ground sphere
(Lambertian 0.5, center (0,-1000,0), r=999) + a mirror sphere
(Metal (0.7,0.6,0.5) roughness 0, center (0.2,0.2,0), r=0.05). Here
scenes are plain host-side constructors returning SoA pytrees.
"""

from __future__ import annotations

import numpy as np

from raytracer_tpu.scene.types import (
    DIELECTRIC,
    DIFFUSE_LIGHT,
    LAMBERTIAN,
    METAL,
    Materials,
    Scene,
    Spheres,
    TriMesh,
)

# The reference's hardcoded extras (CUDAKernels.h:69-73).
GROUND_SPHERE = dict(center=(0.0, -1000.0, 0.0), radius=999.0, albedo=(0.5, 0.5, 0.5))
MIRROR_SPHERE = dict(center=(0.2, 0.2, 0.0), radius=0.05, albedo=(0.7, 0.6, 0.5))


def cornell_spheres_scene() -> Scene:
    """BASELINE config[0]: Cornell-style lighting with analytic spheres
    only (no mesh/BVH) — exercises all four material types and is small
    enough for the CPU oracle."""
    mats = Materials.from_lists(
        types=[LAMBERTIAN, METAL, LAMBERTIAN, LAMBERTIAN, DIELECTRIC, DIFFUSE_LIGHT, METAL],
        albedos=[
            GROUND_SPHERE["albedo"],  # 0 ground
            MIRROR_SPHERE["albedo"],  # 1 mirror (rough 0)
            (0.65, 0.05, 0.05),       # 2 red diffuse
            (0.12, 0.45, 0.15),       # 3 green diffuse
            (1.0, 1.0, 1.0),          # 4 glass
            (0.0, 0.0, 0.0),          # 5 light
            (0.8, 0.85, 0.88),        # 6 rough metal
        ],
        emissions=[(0, 0, 0)] * 5 + [(15.0, 15.0, 15.0), (0, 0, 0)],
        roughnesses=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.3],
        iors=[1.0, 1.0, 1.0, 1.0, 1.5, 1.0, 1.0],
    )
    spheres = Spheres.from_lists(
        centers=[
            GROUND_SPHERE["center"],
            MIRROR_SPHERE["center"],
            (-0.45, 0.2, -0.3),
            (0.45, 0.15, 0.35),
            (0.0, 0.22, 0.3),
            (0.0, 1.4, 0.0),
            (-0.2, 0.12, 0.55),
        ],
        radii=[GROUND_SPHERE["radius"], MIRROR_SPHERE["radius"], 0.2, 0.15, 0.22, 0.45, 0.12],
        mat_ids=[0, 1, 2, 3, 4, 5, 6],
    )
    return Scene(materials=mats, spheres=spheres, mesh=TriMesh.empty(), name="cornell_spheres")


def fit_light_rect(mesh: TriMesh, materials: Materials):
    """Fit a rectangle to the scene's mesh emitter (faces whose material
    is DiffuseLight) for the edge-aware visibility gradient estimator
    (config.edge_aware_lights; used by models/megakernel.py). Host
    numpy; returns f32[16] = center(3) normal(3) u_axis(3) v_axis(3)
    half_u half_v mat_id pad, or None without a mesh light."""
    if mesh.faces is None or mesh.faces.shape[0] == 0:
        return None
    fm = np.asarray(mesh.face_mat)
    types = np.asarray(materials.type)
    light_faces = np.nonzero(types[fm] == DIFFUSE_LIGHT)[0]
    if light_faces.size == 0:
        return None
    verts = np.asarray(mesh.vertices)
    faces = np.asarray(mesh.faces)
    pts = verts[faces[light_faces]].reshape(-1, 3).astype(np.float64)
    center = pts.mean(axis=0)
    f0 = faces[light_faces[0]]
    n = np.cross(verts[f0[1]] - verts[f0[0]], verts[f0[2]] - verts[f0[0]])
    n = n / max(np.linalg.norm(n), 1e-12)
    # Single-rectangle fit is only sound for one planar emitter: pooling
    # disjoint / non-coplanar DIFFUSE_LIGHT faces would aim the
    # edge-aware gradient term at a fictitious light (forward stays
    # bit-identical either way — the term is exactly zero there). Guard:
    # every light vertex must lie on the first face's plane to within
    # 1e-3 of the emitter's extent.
    plane_res = np.abs((pts - center) @ n).max()
    extent = max(float(np.linalg.norm(pts - center, axis=1).max()), 1e-12)
    if plane_res > 1e-3 * extent:
        import warnings

        warnings.warn(
            "fit_light_rect: DIFFUSE_LIGHT faces are not coplanar "
            f"(plane residual {plane_res:.2e} vs extent {extent:.2e}); "
            "disabling the edge-aware light rectangle for this scene")
        return None
    d = pts - center
    d = d - np.outer(d @ n, n)
    _, v = np.linalg.eigh(d.T @ d)
    u_ax = v[:, -1]
    u_ax = u_ax / max(np.linalg.norm(u_ax), 1e-12)
    v_ax = np.cross(n, u_ax)
    hu = float(np.abs(d @ u_ax).max())
    hv = float(np.abs(d @ v_ax).max())
    rect = np.concatenate([
        center, n, u_ax, v_ax, [hu, hv, float(fm[light_faces[0]]), 0.0]
    ]).astype(np.float32)
    import jax.numpy as jnp

    return jnp.asarray(rect)


def add_reference_extras(
    mesh: TriMesh, materials: Materials, name: str = "scene"
) -> Scene:
    """Wrap a loaded mesh + its material table into the reference world:
    append the hardcoded ground and mirror spheres (CUDAKernels.h:69-73)
    after the OBJ materials, exactly like createRandomWorld's
    addMaterial ordering."""
    # Host-side numpy concatenation: the tables are tiny and built once.
    m = materials.count
    mats = Materials.from_lists(
        types=np.concatenate([np.asarray(materials.type), [LAMBERTIAN, METAL]]),
        albedos=np.concatenate(
            [np.asarray(materials.albedo),
             np.asarray([GROUND_SPHERE["albedo"], MIRROR_SPHERE["albedo"]], np.float32)]),
        emissions=np.concatenate([np.asarray(materials.emission), np.zeros((2, 3), np.float32)]),
        roughnesses=np.concatenate([np.asarray(materials.roughness), np.zeros(2, np.float32)]),
        iors=np.concatenate([np.asarray(materials.ior), np.ones(2, np.float32)]),
    )
    spheres = Spheres.from_lists(
        centers=[GROUND_SPHERE["center"], MIRROR_SPHERE["center"]],
        radii=[GROUND_SPHERE["radius"], MIRROR_SPHERE["radius"]],
        mat_ids=[m, m + 1],
    )
    return Scene(materials=mats, spheres=spheres, mesh=mesh, name=name,
                 light_rect=fit_light_rect(mesh, mats))


def reference_scene(assets_dir: str = "assets/models", with_bunny: bool = True,
                    build_bvh: bool = True) -> Scene:
    """The full reference world (SceneManager.h:101-103 +
    CUDAKernels.h:56-84): CornellBox-Original.obj (+ bunny), jointly
    normalized, plus the hardcoded ground and mirror spheres. Assets are
    procedurally generated if missing (the reference gitignores them)."""
    from raytracer_tpu.scene.assets import ensure_assets
    from raytracer_tpu.scene.obj_io import load_scene_objs

    paths = ensure_assets(assets_dir)
    files = [paths["cornell"]] + ([paths["bunny"]] if with_bunny else [])
    mesh, materials = load_scene_objs(files)
    scene = add_reference_extras(mesh, materials,
                                 name="cornell_bunny" if with_bunny else "cornell")
    if build_bvh:
        scene = scene.replace(bvh4=build_scene_bvh4(mesh))
    return scene


def partition_brute_faces(mesh: TriMesh, area_ratio: float = 100.0,
                          max_brute: int = 64, min_tree: int = 256):
    """Split off a handful of LARGE triangles (Cornell walls/boxes/light)
    to be tested brute-force instead of via the BVH. Large triangles
    both pollute BVH quality and keep every ray entering the tree; with
    them removed, the tree's root box shrinks to the dense mesh (bunny)
    and most interior bounce rays skip traversal entirely after the
    brute pre-pass primes t_best.

    Returns (brute_ids, tree_ids) as int64 arrays of ORIGINAL face ids;
    brute_ids is empty when no triangle dwarfs the median area or the
    mesh is too small to split."""
    import numpy as np

    faces = np.asarray(mesh.faces)
    verts = np.asarray(mesh.vertices)
    t = faces.shape[0]
    all_ids = np.arange(t, dtype=np.int64)
    if t < min_tree + 1:
        return all_ids[:0], all_ids
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    area = np.linalg.norm(np.cross(e1, e2), axis=1)
    med = np.median(area)
    big = np.where(area > area_ratio * max(med, 1e-30))[0]
    if big.size == 0 or big.size > max_brute or t - big.size < min_tree:
        return all_ids[:0], all_ids
    keep = np.ones(t, bool)
    keep[big] = False
    return big.astype(np.int64), all_ids[keep]


def build_scene_bvh4(mesh: TriMesh):
    """Preferred acceleration structure: native binned-SAH BVH4
    (native/scenekit.cpp) over the dense-mesh faces, with oversized
    triangles split off for the kernels' brute-force pre-pass
    (partition_brute_faces). Where the platform allows it
    (raytracer_tpu/backends.py: the CPU), an unavailable native library
    falls back to the pure-XLA LBVH + Python collapse, a different tree;
    on the GPU a failed native build is an error. prim ids in both halves
    are ORIGINAL face indices, so shading is split-agnostic."""
    import numpy as np

    import jax.numpy as jnp

    brute_ids, tree_ids = partition_brute_faces(mesh)
    if brute_ids.size:
        faces = np.asarray(mesh.faces)
        fmat = np.asarray(mesh.face_mat)
        sub = TriMesh(vertices=mesh.vertices,
                      faces=jnp.asarray(faces[tree_ids]),
                      face_mat=jnp.asarray(fmat[tree_ids]))
    else:
        sub = mesh

    from raytracer_tpu import backends
    from raytracer_tpu.scene.native import NativeUnavailable, build_bvh4_native

    try:
        b4 = build_bvh4_native(sub)
    except NativeUnavailable:
        if backends.for_platform().native_bvh_required:
            raise
        from raytracer_tpu.ops.bvh import build_lbvh
        from raytracer_tpu.ops.bvh4 import build_bvh4

        b4 = build_bvh4(sub, build_lbvh(sub))

    # Widening to BVH8 (output-invariant; all backends are width-
    # generic): fewer, wider node visits per ray. Width 8 is the default;
    # RAYTRACER_TPU_BVH_WIDTH=4 keeps the 4-wide tree.
    import os as _os

    width = int(_os.environ.get("RAYTRACER_TPU_BVH_WIDTH", "8"))
    if width > 4:
        from raytracer_tpu.ops.bvh4 import widen_bvh

        b4 = widen_bvh(b4, width)

    if not brute_ids.size:
        return b4

    # Remap sub-mesh prim ids back to original face ids; leaf-alignment
    # padding slots carry -1 and must stay -1 (not alias tree_ids[0]).
    pi = np.asarray(b4.prim_index)
    prim = np.where(pi >= 0, tree_ids[np.maximum(pi, 0)], -1).astype(np.int32)
    verts = np.asarray(mesh.vertices)
    faces = np.asarray(mesh.faces)
    fmat = np.asarray(mesh.face_mat)
    bf = faces[brute_ids]
    v0 = verts[bf[:, 0]]
    bt = np.concatenate([v0, verts[bf[:, 1]] - v0, verts[bf[:, 2]] - v0],
                        axis=1).astype(np.float32)
    bp = brute_ids.astype(np.int32)
    bm = fmat[brute_ids].astype(np.int32)
    pad = (-bt.shape[0]) % 8  # degenerate padding rows (MT self-rejects)
    if pad:
        bt = np.concatenate([bt, np.zeros((pad, 9), np.float32)])
        bp = np.concatenate([bp, np.zeros((pad,), np.int32)])
        bm = np.concatenate([bm, np.zeros((pad,), np.int32)])
    import dataclasses

    return dataclasses.replace(
        b4,
        prim_index=jnp.asarray(prim),
        brute_tri=jnp.asarray(bt),
        brute_prim=jnp.asarray(bp),
        brute_mat=jnp.asarray(bm),
    )


def cornell_materials_scene(assets_dir: str = "assets/models") -> Scene:
    """BASELINE config[1]: Cornell triangles + all four material types —
    the Cornell box with a glass sphere and a rough-metal sphere placed
    inside (our showcase variant; the reference's own 512² config)."""
    from raytracer_tpu.scene.assets import ensure_assets
    from raytracer_tpu.scene.obj_io import load_scene_objs

    paths = ensure_assets(assets_dir)
    mesh, materials = load_scene_objs([paths["cornell"]])
    base = add_reference_extras(mesh, materials, name="cornell_materials")
    m = base.materials
    mats = Materials.from_lists(
        types=np.concatenate([np.asarray(m.type), [DIELECTRIC, METAL]]),
        albedos=np.concatenate(
            [np.asarray(m.albedo), np.asarray([(1.0, 1.0, 1.0), (0.8, 0.7, 0.4)], np.float32)]),
        emissions=np.concatenate([np.asarray(m.emission), np.zeros((2, 3), np.float32)]),
        roughnesses=np.concatenate([np.asarray(m.roughness), [0.0, 0.25]]).astype(np.float32),
        iors=np.concatenate([np.asarray(m.ior), [1.5, 1.0]]).astype(np.float32),
    )
    sp = base.spheres
    mcount = m.count
    spheres = Spheres.from_lists(
        centers=np.concatenate(
            [np.asarray(sp.center), np.asarray([(-0.08, -0.21, 0.05), (0.1, -0.23, 0.12)], np.float32)]),
        radii=np.concatenate([np.asarray(sp.radius), [0.09, 0.07]]).astype(np.float32),
        mat_ids=np.concatenate([np.asarray(sp.mat_id), [mcount, mcount + 1]]).astype(np.int32),
    )
    return Scene(materials=mats, spheres=spheres, mesh=base.mesh,
                 name="cornell_materials", light_rect=base.light_rect)
