"""Batched 3-vector math over trailing-axis-3 jnp arrays.

Replacement for the reference's scalar Vec3 class
(reference: CudaRayTracer/src/Core/Vec3.cuh). Everything here operates on
`f32[..., 3]` arrays so the whole ray wavefront is one data-parallel tensor;
all functions are trivially differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp

EPS_NEAR_ZERO = 1e-8  # reference Vec3::nearZero threshold (Core/Vec3.cuh)


def dot(a: jnp.ndarray, b: jnp.ndarray, keepdims: bool = True) -> jnp.ndarray:
    """Dot product over the trailing axis. keepdims=True so results broadcast
    back against [..., 3] operands without reshapes."""
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def length_squared(a: jnp.ndarray, keepdims: bool = True) -> jnp.ndarray:
    return dot(a, a, keepdims=keepdims)


def length(a: jnp.ndarray, keepdims: bool = True) -> jnp.ndarray:
    return jnp.sqrt(length_squared(a, keepdims=keepdims))


def normalize(a: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Unit vector (reference unitVector, Core/Vec3.cuh:213-216). `eps`
    guards the norm for gradient safety when the input can be exactly 0
    — the guard sits INSIDE the sqrt: d/dx sqrt(x) at x=0 is inf, and
    masked-out lanes would leak NaN through jnp.where in the backward
    pass otherwise."""
    if eps:
        n = jnp.sqrt(jnp.maximum(length_squared(a), eps * eps))
    else:
        n = length(a)
    return a / n


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection (reference Core/Vec3.cuh:225-228)."""
    return v - 2.0 * dot(v, n) * n


def refract(uv: jnp.ndarray, n: jnp.ndarray, eta_ratio: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction of unit vector `uv` about normal `n`
    (reference Core/Vec3.cuh:229-234 / Core/Utility.cuh:78-84).

    eta_ratio broadcasts as [..., 1].
    """
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_perp = eta_ratio * (uv + cos_theta * n)
    # 1e-12 floor keeps the sqrt gradient finite at the TIR boundary
    # (lanes there are selected away by the reflect branch anyway).
    r_parallel = -jnp.sqrt(jnp.maximum(jnp.abs(1.0 - length_squared(r_perp)), 1e-12)) * n
    return r_perp + r_parallel


def near_zero(v: jnp.ndarray) -> jnp.ndarray:
    """True where all components are ~0 (reference Vec3::nearZero).
    Returns a [..., 1] bool mask."""
    return jnp.all(jnp.abs(v) < EPS_NEAR_ZERO, axis=-1, keepdims=True)


def where(mask: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Select with a [...] or [..., 1] mask against [..., 3] operands."""
    if mask.ndim == a.ndim - 1:
        mask = mask[..., None]
    return jnp.where(mask, a, b)
