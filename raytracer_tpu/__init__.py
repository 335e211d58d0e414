"""raytracer_tpu — a differentiable path tracing framework in JAX.

JAX/XLA implementation, with one fused CUDA kernel for the forward path
loop (ops/fused_kernel.py), with the capabilities of the CUDA
reference tracer (Mordentary/RayTracer-Cuda, mounted at /root/reference):
interactive-quality and high-quality path tracing of the Cornell-box +
bunny scene with Lambertian / Metal / Dielectric / DiffuseLight materials,
two-level acceleration (here: a single LBVH over the merged triangle soup +
analytic spheres), thin-lens camera, Russian roulette, sqrt gamma tone map.

Design is functional:
  * SoA scene arrays (no object hierarchy / virtual dispatch;
    cf. reference Core/Hittable.cuh:12-20 which uses device vtables),
  * stateless `jax.random` keys instead of per-pixel curand state
    (cf. reference CUDAKernels.h:18-26),
  * a masked megakernel (`models/megakernel.py`) as the differentiable
    oracle integrator, a wavefront integrator (`models/wavefront.py`) in
    XLA, and the fused path-loop kernel (`models/fused.py`) as the
    production forward path,
  * `shard_map` over a device mesh for multi-chip scaling
    (the reference is single-GPU; see SURVEY.md §2.2).
"""

from raytracer_tpu.config import RenderConfig, PRESETS
from raytracer_tpu.camera import Camera, make_camera, camera_basis, generate_rays
from raytracer_tpu.scene.types import (
    Materials,
    Spheres,
    TriMesh,
    Scene,
    LAMBERTIAN,
    METAL,
    DIELECTRIC,
    DIFFUSE_LIGHT,
)
from raytracer_tpu.render import render_image, render_image_chunked, tone_map_image

__all__ = [
    "RenderConfig",
    "PRESETS",
    "Camera",
    "make_camera",
    "camera_basis",
    "generate_rays",
    "Materials",
    "Spheres",
    "TriMesh",
    "Scene",
    "LAMBERTIAN",
    "METAL",
    "DIELECTRIC",
    "DIFFUSE_LIGHT",
    "render_image",
    "render_image_chunked",
    "tone_map_image",
]

__version__ = "0.1.0"
