"""SoA scene representation.

The reference builds an object graph of device-virtual Hittables inside
`<<<1,1>>>` construction kernels (CUDAKernels.h:56-100, HittableList.cuh).
Here there is no virtual dispatch: the scene is a pytree of flat arrays
— a material table, a sphere list, and one merged triangle soup — all
first-class jit inputs, replicated across devices, and differentiable.

Material type tags follow the reference enum order
(Core/Material.cuh:8-14): Lambertian=0, Metal=1, Dielectric=2,
DiffuseLight=3.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3


def _pytree(cls=None, *, meta=()):
    def wrap(c):
        fields = [f.name for f in dataclasses.fields(c)]
        data = [f for f in fields if f not in meta]
        return partial(
            jax.tree_util.register_dataclass,
            data_fields=data,
            meta_fields=list(meta),
        )(c)

    return wrap(cls) if cls is not None else wrap


@_pytree
@dataclasses.dataclass(frozen=True)
class Materials:
    """Material table (reference MaterialData, Core/Material.cuh:16-47)."""

    type: jnp.ndarray       # i32[M]
    albedo: jnp.ndarray     # f32[M,3]
    emission: jnp.ndarray   # f32[M,3]
    roughness: jnp.ndarray  # f32[M]
    ior: jnp.ndarray        # f32[M]

    @staticmethod
    def from_lists(types, albedos, emissions=None, roughnesses=None, iors=None) -> "Materials":
        m = len(types)
        return Materials(
            type=jnp.asarray(types, jnp.int32),
            albedo=jnp.asarray(albedos, jnp.float32).reshape(m, 3),
            emission=jnp.zeros((m, 3), jnp.float32)
            if emissions is None
            else jnp.asarray(emissions, jnp.float32).reshape(m, 3),
            roughness=jnp.zeros((m,), jnp.float32)
            if roughnesses is None
            else jnp.asarray(roughnesses, jnp.float32),
            ior=jnp.ones((m,), jnp.float32) if iors is None else jnp.asarray(iors, jnp.float32),
        )

    @property
    def count(self) -> int:
        return self.type.shape[0]


@_pytree
@dataclasses.dataclass(frozen=True)
class Spheres:
    """Analytic spheres (reference Core/Sphere.cuh)."""

    center: jnp.ndarray  # f32[S,3]
    radius: jnp.ndarray  # f32[S]
    mat_id: jnp.ndarray  # i32[S]

    @staticmethod
    def from_lists(centers, radii, mat_ids) -> "Spheres":
        return Spheres(
            center=jnp.asarray(centers, jnp.float32).reshape(-1, 3),
            radius=jnp.asarray(radii, jnp.float32),
            mat_id=jnp.asarray(mat_ids, jnp.int32),
        )

    @staticmethod
    def empty() -> "Spheres":
        # One far-away degenerate sentinel keeps shapes static and never hits.
        return Spheres(
            center=jnp.asarray([[1e30, 1e30, 1e30]], jnp.float32),
            radius=jnp.zeros((1,), jnp.float32),
            mat_id=jnp.zeros((1,), jnp.int32),
        )

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@_pytree
@dataclasses.dataclass(frozen=True)
class TriMesh:
    """Merged triangle soup.

    The reference keeps per-mesh vertex/index windows into global arrays
    (SceneManager.h:111-149, Mesh.cuh:18-37) and a two-level BVH. Since the
    acceleration structure is not observable in the output (SURVEY.md §2.1
    "Scene BVH" row), we merge all meshes into one soup and build a single
    LBVH over it.
    """

    vertices: jnp.ndarray  # f32[V,3]
    faces: jnp.ndarray     # i32[T,3] vertex indices
    face_mat: jnp.ndarray  # i32[T] material ids (already globally offset)
    # Per-corner shading attributes from the OBJ's vn/vt pools, resolved
    # face-aligned at load time (the reference carries them per-vertex,
    # SceneManager.h:280-289 + Core/Mesh.cuh:5-10, though its shading
    # uses geometric normals — ours does too; these are data plumbing
    # for flag-gated smooth shading / texturing). None when absent.
    normals: Optional[jnp.ndarray] = None  # f32[T,3,3]
    uvs: Optional[jnp.ndarray] = None      # f32[T,3,2]

    @staticmethod
    def from_arrays(vertices, faces, face_mat, normals=None, uvs=None) -> "TriMesh":
        return TriMesh(
            vertices=jnp.asarray(vertices, jnp.float32).reshape(-1, 3),
            faces=jnp.asarray(faces, jnp.int32).reshape(-1, 3),
            face_mat=jnp.asarray(face_mat, jnp.int32),
            normals=None if normals is None
            else jnp.asarray(normals, jnp.float32).reshape(-1, 3, 3),
            uvs=None if uvs is None
            else jnp.asarray(uvs, jnp.float32).reshape(-1, 3, 2),
        )

    @staticmethod
    def empty() -> "TriMesh":
        # Degenerate sentinel triangle: zero area → |det| < ε → never hits.
        return TriMesh(
            vertices=jnp.zeros((3, 3), jnp.float32),
            faces=jnp.asarray([[0, 1, 2]], jnp.int32),
            face_mat=jnp.zeros((1,), jnp.int32),
        )

    @property
    def num_tris(self) -> int:
        return self.faces.shape[0]


@_pytree
@dataclasses.dataclass(frozen=True)
class Bvh:
    """LBVH over the triangle soup (built by ops/bvh.py).

    Node indexing convention: internal nodes are 0..T-2; child index
    c >= T-1 refers to leaf/triangle (c - (T-1)) in *sorted* order;
    `prim_index` maps sorted leaf position → original triangle id.
    """

    left: jnp.ndarray        # i32[T-1]
    right: jnp.ndarray       # i32[T-1]
    node_min: jnp.ndarray    # f32[2T-1,3] (internal then leaves)
    node_max: jnp.ndarray    # f32[2T-1,3]
    prim_index: jnp.ndarray  # i32[T]


@_pytree(meta=["name"])
@dataclasses.dataclass(frozen=True)
class Scene:
    materials: Materials
    spheres: Spheres
    mesh: TriMesh
    bvh: Optional[Bvh] = None
    bvh4: Optional[Any] = None  # ops/bvh4.Bvh4 — preferred traversal structure
    # Fitted rectangle of the (mesh) emitter for the edge-aware
    # visibility gradient estimator (scene/builder.fit_light_rect):
    # f32[16] = center(3) normal(3) u_axis(3) v_axis(3) half_u half_v
    # mat_id(float) pad. None when the scene has no mesh light.
    light_rect: Optional[jnp.ndarray] = None
    name: str = "scene"

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)
