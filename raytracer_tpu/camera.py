"""Thin-lens FPS camera.

Replicates the reference camera math exactly (Core/Camera.cuh):
  * yaw/pitch Euler basis with the reference's negated-front convention
    (Core/Camera.cuh:159-169): front = -(cos yaw cos p, sin p, sin yaw cos p),
    initial yaw=-90°, pitch=0 (Core/Camera.cuh:24-25). Note the reference
    *never* aims at the target — the ctor ignores it beyond focus distance
    (Raytracer.h:79-84) — so the default camera at (0,4,4) looks down -Z.
  * viewport: h=tan(fov/2), horizontal/vertical scaled by focus distance,
    lower-left corner = pos - H/2 - V/2 - focusDist*front
    (Core/Camera.cuh:171-181).
  * thin-lens ray: lens-disk offset × lens radius, jittered (u,v)
    (Core/Camera.cuh:32-44). v=0 is the *bottom* image row (the reference
    renders bottom-up and flips at present time, WindowManager.h:88).

The camera is a differentiable param pytree: pixel gradients flow to
position / yaw / pitch / fov / aperture / focus_dist (BASELINE north star).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from raytracer_tpu.utils import rng as rngu
from raytracer_tpu.utils import vecmath as vm


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["position", "yaw", "pitch", "world_up", "fov_degrees", "aperture", "focus_dist"],
    meta_fields=["aspect_ratio"],
)
@dataclasses.dataclass(frozen=True)
class Camera:
    position: jnp.ndarray      # f32[3]
    yaw: jnp.ndarray           # f32[] degrees
    pitch: jnp.ndarray         # f32[] degrees
    world_up: jnp.ndarray      # f32[3]
    fov_degrees: jnp.ndarray   # f32[] vertical FOV
    aperture: jnp.ndarray      # f32[]
    focus_dist: jnp.ndarray    # f32[]
    aspect_ratio: float        # static


def showcase_camera(cfg) -> "Camera":
    """The headline-benchmark framing: just inside the Cornell box's
    opening, matching the reference's published screenshot
    (Screenshots/Cornell-box-with-bunny.jpg — the camera is flown inside
    with WASD before engaging HQ mode). Every pixel hits geometry, so
    this is the honest workload for rays/s comparisons: colored walls,
    pedestal + bunny, ceiling light, mirror sphere."""
    return make_camera(aspect_ratio=cfg.aspect_ratio, fov_degrees=cfg.fov_degrees,
                       aperture=cfg.aperture, position=(0.0, 0.05, 0.29), pitch=-5.0)


def make_camera(
    aspect_ratio: float,
    fov_degrees: float = 80.0,
    position=(0.0, 4.0, 4.0),
    target=(0.0, 0.0, 0.0),
    world_up=(0.0, 1.0, 0.0),
    aperture: float = 1e-6,
    focus_dist: float | None = None,
    yaw: float = -90.0,
    pitch: float = 0.0,
) -> Camera:
    """Defaults reproduce the reference setup (Raytracer.h:77-84,
    EntryPoint.cu:16-20): position (0,4,4), focus distance |pos-target|,
    yaw -90 / pitch 0 regardless of target."""
    import numpy as np

    position = jnp.asarray(position, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    if focus_dist is None:
        # Host-side norm: keeps scene setup free of tiny device programs.
        # Traced positions still work.
        try:
            focus_dist = float(np.linalg.norm(np.asarray(position) - np.asarray(target)))
        except (TypeError, jax.errors.TracerArrayConversionError):
            focus_dist = jnp.linalg.norm(position - target)
    return Camera(
        position=position,
        yaw=jnp.asarray(yaw, jnp.float32),
        pitch=jnp.asarray(pitch, jnp.float32),
        world_up=jnp.asarray(world_up, jnp.float32),
        fov_degrees=jnp.asarray(fov_degrees, jnp.float32),
        aperture=jnp.asarray(aperture, jnp.float32),
        focus_dist=jnp.asarray(focus_dist, jnp.float32),
        aspect_ratio=float(aspect_ratio),
    )


def camera_basis(cam: Camera):
    """Derived frame + viewport (Core/Camera.cuh:159-182).

    Returns dict with front/right/up, horizontal/vertical viewport
    vectors, lower_left_corner, and lens_radius.
    """
    deg = jnp.pi / 180.0
    cy, sy = jnp.cos(cam.yaw * deg), jnp.sin(cam.yaw * deg)
    cp, sp = jnp.cos(cam.pitch * deg), jnp.sin(cam.pitch * deg)
    front = vm.normalize(jnp.stack([-cy * cp, -sp, -sy * cp]))
    right = vm.normalize(vm.cross(front, cam.world_up))
    up = vm.normalize(vm.cross(right, front))

    theta = cam.fov_degrees * deg
    h = jnp.tan(theta / 2.0)
    viewport_h = 2.0 * h
    viewport_w = cam.aspect_ratio * viewport_h

    horizontal = cam.focus_dist * viewport_w * right
    vertical = cam.focus_dist * viewport_h * up
    lower_left = cam.position - horizontal / 2.0 - vertical / 2.0 - cam.focus_dist * front
    return {
        "front": front,
        "right": right,
        "up": up,
        "horizontal": horizontal,
        "vertical": vertical,
        "lower_left": lower_left,
        "lens_radius": cam.aperture / 2.0,
    }


def generate_rays(
    cam: Camera,
    px: jnp.ndarray,   # i32[N] pixel x
    py: jnp.ndarray,   # i32[N] pixel y (0 = bottom row, reference convention)
    width: int,
    height: int,
    keys,              # per-lane key array [N] (utils/rng.py) OR a Sampler
):
    """Batched thin-lens ray generation (Core/Camera.cuh:32-44).

    Returns (origins f32[N,3], directions f32[N,3]); directions are NOT
    normalized, exactly like the reference (intersection math divides by a).
    """
    smp = rngu.as_sampler(keys)
    basis = camera_basis(cam)

    dx, dy = smp.lens_disk()
    rd_x = basis["lens_radius"] * dx
    rd_y = basis["lens_radius"] * dy
    offset = basis["right"] * rd_x[:, None] + basis["up"] * rd_y[:, None]

    ju, jv = smp.jitter_uv()
    u = (px.astype(jnp.float32) + ju) / float(width)
    v = (py.astype(jnp.float32) + jv) / float(height)

    origins = cam.position + offset
    directions = (
        basis["lower_left"]
        + u[:, None] * basis["horizontal"]
        + v[:, None] * basis["vertical"]
        - cam.position
        - offset
    )
    return origins, directions
