"""Camera motion semantics from the reference's interactive controller.

The reference flies the camera with WASD/Space/LCtrl + right-mouse-drag
(Core/Camera.cuh:88-157): movement speed 1.0 units/s along ±front/±right
and ±world-up, mouse sensitivity 0.2°/px with inverted axes and a 0.5
exponential smoothing factor, pitch clamped to ±89°. An accelerator
render is headless, so instead of an event pump these are pure functions — apply a
scripted motion sequence to a Camera to reproduce any reference flight
path (e.g. for animation renders or pose-matched comparisons).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from raytracer_tpu.camera import Camera, camera_basis

MOVEMENT_SPEED = 1.0      # Core/Camera.cuh:26
MOUSE_SENSITIVITY = 0.2   # Core/Camera.cuh:27
SMOOTH_FACTOR = 0.5       # Core/Camera.cuh:95
PITCH_LIMIT = 89.0        # Core/Camera.cuh:127


def move(cam: Camera, keys: str, dt: float) -> Camera:
    """Apply one movement tick. `keys` is a string of held keys from
    {w,s,a,d,space→' ',ctrl→'c'}; W moves along -front (the reference's
    inverted convention, Core/Camera.cuh:140-151)."""
    basis = camera_basis(cam)
    v = MOVEMENT_SPEED * dt
    pos = cam.position
    if "w" in keys:
        pos = pos - basis["front"] * v
    if "s" in keys:
        pos = pos + basis["front"] * v
    if "a" in keys:
        pos = pos - basis["right"] * v
    if "d" in keys:
        pos = pos + basis["right"] * v
    if " " in keys:
        pos = pos + cam.world_up * v
    if "c" in keys:
        pos = pos - cam.world_up * v
    return dataclasses.replace(cam, position=pos)


def rotate(cam: Camera, dx_px: float, dy_px: float) -> Camera:
    """Apply a mouse-drag delta in pixels (already smoothed; use
    `MouseSmoother` for the reference's exponential smoothing). Both
    axes inverted, ×0.2°/px (Core/Camera.cuh:121-127)."""
    yaw = cam.yaw + (-MOUSE_SENSITIVITY) * dx_px
    pitch = jnp.clip(cam.pitch + (-MOUSE_SENSITIVITY) * dy_px, -PITCH_LIMIT, PITCH_LIMIT)
    return dataclasses.replace(cam, yaw=jnp.asarray(yaw, jnp.float32),
                               pitch=jnp.asarray(pitch, jnp.float32))


def adjust_focus(cam: Camera, delta: float) -> Camera:
    """PageUp/PageDown focus adjustment (Core/Camera.cuh:79-83)."""
    fd = jnp.maximum(0.1, cam.focus_dist + delta)
    return dataclasses.replace(cam, focus_dist=jnp.asarray(fd, jnp.float32))


class MouseSmoother:
    """The reference's 0.5-exponential mouse smoothing
    (Core/Camera.cuh:95-119): feed raw cursor positions, get deltas."""

    def __init__(self):
        self.last = None
        self.smooth = None

    def update(self, x: float, y: float):
        if self.last is None:
            self.last = self.smooth = (x, y)
            return 0.0, 0.0
        sx = self.smooth[0] * (1 - SMOOTH_FACTOR) + x * SMOOTH_FACTOR
        sy = self.smooth[1] * (1 - SMOOTH_FACTOR) + y * SMOOTH_FACTOR
        dx, dy = sx - self.last[0], sy - self.last[1]
        self.last = self.smooth = (sx, sy)
        return dx, dy

    def release(self):
        self.last = self.smooth = None
