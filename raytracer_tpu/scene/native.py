"""ctypes bindings for the native scenekit library (native/scenekit.cpp).

Mirrors the reference's split: render path on the accelerator, scene
preprocessing in native host code (the reference builds its mesh SAH BVH
natively, Core/Mesh.cuh:121-219). `build_bvh4_native` is a drop-in
producer of ops/bvh4.Bvh4 using a binned-SAH builder — better tree
quality than the XLA LBVH + Python collapse, and ~100x faster collapse.

The shared library is compiled from source at first use
(utils/nativebuild.py); a failed build raises `NativeUnavailable`, which
scene/builder.py turns into the pure-Python path where the platform
allows it.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None


class NativeUnavailable(RuntimeError):
    pass


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    from raytracer_tpu.utils import nativebuild

    src = os.path.join(nativebuild.NATIVE_DIR, "scenekit.cpp")
    try:
        lib_path = nativebuild.build_library(
            "scenekit", [src], ["g++", "-O3", "-shared", "-fPIC"])
    except nativebuild.NativeBuildError as e:
        raise NativeUnavailable(str(e)) from e
    lib = ctypes.CDLL(lib_path)
    lib.scenekit_build_bvh4.restype = ctypes.c_int
    lib.scenekit_build_bvh4.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _LIB = lib
    return lib


def build_bvh4_native(mesh, max_leaf: int | None = None):
    """TriMesh → ops/bvh4.Bvh4 via the native binned-SAH builder."""
    import jax.numpy as jnp

    from raytracer_tpu.ops.bvh4 import MAX_LEAF, Bvh4

    if max_leaf is None:
        max_leaf = MAX_LEAF

    lib = _load()
    verts = np.ascontiguousarray(np.asarray(mesh.vertices), np.float32)
    faces = np.ascontiguousarray(np.asarray(mesh.faces), np.int32)
    t = faces.shape[0]
    bounds = np.empty((t, 4, 6), np.float32)
    children = np.empty((t, 4), np.int32)
    prim = np.empty((t,), np.int32)

    n4 = lib.scenekit_build_bvh4(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), np.int32(verts.shape[0]),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), np.int32(t),
        np.int32(max_leaf),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        children.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        prim.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n4 <= 0:
        raise NativeUnavailable(f"scenekit_build_bvh4 returned {n4}")

    fperm = faces[prim]
    v0 = verts[fperm[:, 0]]
    e1 = verts[fperm[:, 1]] - v0
    e2 = verts[fperm[:, 2]] - v0
    tri = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)
    from raytracer_tpu.ops.bvh4 import align_leaves_to_rows, compute_stack_depth

    face_mat = np.asarray(mesh.face_mat)[prim].astype(np.int32)
    children_al, tri, prim, face_mat = align_leaves_to_rows(
        children[:n4], tri, prim, face_mat)
    return Bvh4(
        bounds=jnp.asarray(bounds[:n4]),
        children=jnp.asarray(children_al),
        tri=jnp.asarray(tri),
        prim_index=jnp.asarray(prim),
        face_mat=jnp.asarray(face_mat),
        stack_depth=compute_stack_depth(children_al),
    )
