"""Fused path loop: the whole integrator in one native kernel launch.

The reference pays its launch overhead once per frame: the sample x
bounce x traversal loop lives in one CUDA kernel (CUDAKernels.h:102-166).
This is the same design. Each lane (pixel) runs its whole path loop in
one thread: camera ray, Russian roulette, sphere sweep, brute-force pass
over the large triangles, BVH traversal with a per-lane stack, the four
reference materials, and accumulation (native/pathtrace.h). A lane that
finishes a sample starts its next one at once, so a warp never waits for
a batch-wide lockstep loop.

The kernel is called through `jax.ffi`. On the GPU it is the CUDA target
(native/pathtrace_cuda.cu, built for sm_90a); on the CPU the same per-lane
code runs through a CPU target (native/pathtrace_cpu.cc) — lowering by
platform, chosen in raytracer_tpu/backends.py. Both are built from source
at first use (utils/nativebuild.py). Forward only: gradients use the XLA
megakernel (models/megakernel.py).

Random numbers are the ktf counter stream (utils/ktf.py), keyed by
(pixel, sample, bounce, purpose), so a render equals the XLA integrators
run with cfg.rng_impl="ktf" up to float rounding (tests/test_fused_megakernel.py).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu import backends
from raytracer_tpu.ops.bvh4 import Bvh4
from raytracer_tpu.utils import ktf, nativebuild

TARGET = "raytracer_path_trace"
STACK_CAP = 128   # per-lane stack entries (kStackCap in native/pathtrace.h)
WIDTHS = (4, 8)   # tree widths the kernel is compiled for
TRI_FLOATS = 12   # v0(3) pad e1(3) pad e2(3) pad

_SOURCES = {"cpu": "pathtrace_cpu.cc", "cuda": "pathtrace_cuda.cu"}
_HEADERS = ("pathtrace.h", "pathtrace_ffi.h")
_SYMBOLS = {"cpu": "PathTraceCpuHandler", "cuda": "PathTraceCudaHandler"}
_FFI_PLATFORMS = {"cpu": "cpu", "cuda": "CUDA"}
_registered: dict[str, ctypes.CDLL] = {}


class GpuTables(NamedTuple):
    """Scene BVH in the kernel's layout: int32 ids, no padding rows."""

    node_box: jnp.ndarray    # f32[N4,6,K]: lo x,y,z, hi x,y,z, each over K children
    node_child: jnp.ndarray  # i32[N4,K]: >=0 node, -1 empty, <=-2 leaf -(2+first*8+count-1)
    tri: jnp.ndarray         # f32[T,12] v0, e1, e2 (each padded to 4 floats)
    tri_mat: jnp.ndarray     # i32[T]
    brute: jnp.ndarray       # f32[Tb,12] large triangles, tested before the tree
    brute_mat: jnp.ndarray   # i32[Tb]


def _tri12(tri9):
    t = tri9.reshape(-1, 3, 3)
    return jnp.concatenate([t, jnp.zeros_like(t[:, :, :1])], axis=2).reshape(-1, TRI_FLOATS)


def pack_tables(bvh4: Bvh4) -> GpuTables:
    """Bvh4 → the kernel's tables (traceable: runs under jit)."""
    if bvh4.brute_tri is not None:
        brute, brute_mat = _tri12(bvh4.brute_tri), bvh4.brute_mat.astype(jnp.int32)
    else:
        brute = jnp.zeros((0, TRI_FLOATS), jnp.float32)
        brute_mat = jnp.zeros((0,), jnp.int32)
    return GpuTables(
        node_box=jnp.transpose(bvh4.bounds, (0, 2, 1)).astype(jnp.float32),
        node_child=bvh4.children.astype(jnp.int32),
        tri=_tri12(bvh4.tri.astype(jnp.float32)),
        tri_mat=bvh4.face_mat.astype(jnp.int32),
        brute=brute,
        brute_mat=brute_mat,
    )


def _compile_command(target: str) -> list[str]:
    include = jax.ffi.include_dir()
    if target == "cpu":
        # Fused multiply-adds as XLA's CPU code uses them, so both round
        # alike (nvcc and XLA's GPU code contract by default).
        return ["g++", "-O3", "-std=c++17", "-march=native", "-ffp-contract=fast",
                "-shared", "-fPIC", "-w", "-I", include, "-I", nativebuild.NATIVE_DIR]
    cc = jax.devices()[0].compute_capability.replace(".", "")
    arch = f"{cc}a" if cc == "90" else cc  # sm_90a: Hopper's own target
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return [nvcc, "-gencode", f"arch=compute_{arch},code=sm_{arch}", "-O3",
            "-std=c++17", "--shared", "-Xcompiler", "-fPIC", "-w",
            "-I", include, "-I", nativebuild.NATIVE_DIR]


def build(target: str) -> str:
    """Build (once) and return the path of the library for `target`."""
    return nativebuild.build_library(
        f"pathtrace_{target}",
        [os.path.join(nativebuild.NATIVE_DIR, _SOURCES[target])],
        _compile_command(target),
        inputs=[os.path.join(nativebuild.NATIVE_DIR, h) for h in _HEADERS])


def ensure_registered(platform: str | None = None) -> None:
    """Build and register the FFI target of `platform` (default: JAX's
    default backend)."""
    target = backends.for_platform(platform).fused_target
    if target in _registered:
        return
    lib = ctypes.cdll.LoadLibrary(build(target))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(getattr(lib, _SYMBOLS[target])),
        platform=_FFI_PLATFORMS[target])
    _registered[target] = lib


def fused_megakernel_available(scene) -> bool:
    """True when the fused kernel can run this scene: a BVH4/BVH8 with
    per-face materials whose stack bound fits the per-lane stack."""
    b = scene.bvh4
    return (b is not None and b.face_mat is not None
            and int(b.children.shape[1]) in WIDTHS
            and b.stack_depth <= STACK_CAP)


def camera_vector(cam) -> jnp.ndarray:
    """f32[19]: lower-left, horizontal, vertical, position, right, up,
    lens radius (camera.camera_basis)."""
    from raytracer_tpu.camera import camera_basis

    b = camera_basis(cam)
    return jnp.concatenate([
        b["lower_left"], b["horizontal"], b["vertical"],
        jnp.asarray(cam.position, jnp.float32).reshape(3),
        b["right"], b["up"], jnp.reshape(b["lens_radius"], (1,)),
    ]).astype(jnp.float32)


def render_tiles_fused(scene, cam, cfg, key, px, py, spp=None,
                       sample_offset=0) -> jnp.ndarray:
    """Mean linear radiance f32[N,3] over `spp` samples for the lanes'
    pixels (px, py: i32[N], py = 0 at the bottom row). `sample_offset`
    shifts the global sample index, so spp-batched calls draw the same
    randoms as one pass."""
    if not fused_megakernel_available(scene):
        raise ValueError(
            "fused kernel needs a BVH4/BVH8 scene with face materials and a "
            f"stack bound <= {STACK_CAP}")
    ensure_registered()
    spp = cfg.spp if spp is None else spp
    n = px.shape[0]
    tables = pack_tables(scene.bvh4)
    sph = scene.spheres
    mats = scene.materials
    k0, k1 = ktf.key_words(key)
    keys = jnp.stack([k0, k1, jnp.asarray(sample_offset, jnp.int32)])
    call = jax.ffi.ffi_call(TARGET, jax.ShapeDtypeStruct((n, 3), jnp.float32))
    return call(
        px.astype(jnp.int32), py.astype(jnp.int32), keys, camera_vector(cam),
        jnp.concatenate([sph.center, sph.radius[:, None]], axis=1).astype(jnp.float32),
        sph.mat_id.astype(jnp.int32),
        jnp.concatenate([mats.albedo, mats.emission, mats.roughness[:, None],
                         mats.ior[:, None]], axis=1).astype(jnp.float32),
        mats.type.astype(jnp.int32),
        *tables,
        width=np.int32(cfg.width), height=np.int32(cfg.height),
        spp=np.int32(spp), max_bounces=np.int32(cfg.max_bounces),
        min_bounces=np.int32(cfg.min_bounces),
        emission_quirk=np.int32(bool(cfg.reference_emission_quirk)),
        rr_max_prob=np.float32(cfg.rr_max_prob), t_min=np.float32(cfg.t_min))
