"""Stateless, pixel-keyed RNG discipline.

The reference keeps one mutable curand state per pixel
(CUDAKernels.h:18-26) and draws rejection-sampled points
(Core/Utility.cuh:45-71). This build uses stateless `jax.random`
(threefry) with a *counter-based lane key* scheme:

    lane_key = fold(fold(fold(base, pixel_id), sample), bounce)
    draw     = vmapped threefry on fold(lane_key, purpose)

Every random number is a pure function of (base key, pixel, sample,
bounce, purpose) — independent of lane position, batch size, chunk
boundaries, or device sharding. Consequences (tested):
  * sharded render ≡ single-device render bit-for-bit (SURVEY.md §4.4),
  * wavefront integrator ≡ megakernel integrator up to fp summation
    order, since both see identical per-(pixel,sample,bounce) draws,
  * chunked renders ≡ whole-image renders.

Samplers are closed-form and distribution-equivalent (not bit-equal) to
the reference's rejection loops (SURVEY.md §6.2 item 11).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Purpose tags (distinct constants folded into lane keys).
P_RAYGEN_JITTER_U = 0x11
P_RAYGEN_JITTER_V = 0x12
P_RAYGEN_LENS = 0x13
P_RR = 0x21
P_SCATTER_UNIT = 0x31
P_DIELECTRIC = 0x32

_fold_lanes = jax.vmap(jax.random.fold_in, in_axes=(0, 0))
_fold_lanes_scalar = jax.vmap(jax.random.fold_in, in_axes=(0, None))
_fold_base = jax.vmap(jax.random.fold_in, in_axes=(None, 0))


def lane_keys(base_key: jax.Array, lane_ids: jnp.ndarray) -> jax.Array:
    """key[i] = fold_in(base, lane_ids[i]) — [N] key array."""
    return _fold_base(base_key, lane_ids)


def fold(keys: jax.Array, x) -> jax.Array:
    """Fold a scalar (traced ok) or per-lane i32 array into a key array."""
    if isinstance(x, jnp.ndarray) and x.ndim == 1:
        return _fold_lanes(keys, x)
    return _fold_lanes_scalar(keys, x)


_uniform1 = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))
_normal3 = jax.vmap(lambda k: jax.random.normal(k, (3,), jnp.float32))
_uniform2 = jax.vmap(lambda k: jax.random.uniform(k, (2,), jnp.float32))


def uniform(keys: jax.Array, purpose: int) -> jnp.ndarray:
    """U[0,1) per lane — analog of curand_uniform (Core/Utility.cuh:23-26)."""
    return _uniform1(fold(keys, purpose))


def random_unit_vector(keys: jax.Array, purpose: int) -> jnp.ndarray:
    """Uniform direction on the unit sphere, [N,3].

    Reference rejection-samples the unit ball and normalizes
    (Core/Utility.cuh:73-76); a normalized isotropic Gaussian is the same
    distribution, branch-free."""
    g = _normal3(fold(keys, purpose))
    n = jnp.sqrt(jnp.sum(g * g, axis=-1, keepdims=True))
    return g / jnp.maximum(n, 1e-12)


def random_in_unit_disk(keys: jax.Array, purpose: int) -> jnp.ndarray:
    """Uniform point in the unit disk (z=0), [N,3].

    Reference rejection-samples the square (Core/Utility.cuh:55-62); the
    polar closed form is distribution-equivalent."""
    u = _uniform2(fold(keys, purpose))
    r = jnp.sqrt(u[:, 0])
    theta = 2.0 * jnp.pi * u[:, 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)], axis=-1)


# --- Sampler protocol -------------------------------------------------
# Draw-site-level abstraction shared by the two RNG impls: the default
# jax.random path (this class — results identical to the historical
# fold-chain code) and the kernel-portable counter-based path
# (utils/ktf.KtfSampler, whose spec the fused path-loop kernel
# implements in C++). Integrators construct one per bounce and pass it to
# camera.generate_rays / materials.scatter_params.

from typing import NamedTuple  # noqa: E402


class KeySampler(NamedTuple):
    """jax.random-backed sampler over already-(pixel,sample,bounce)-folded
    per-lane keys. Draw-for-draw identical to the pre-sampler code."""

    keys: jax.Array  # [N] folded key array

    def jitter_uv(self, keys=None):
        k = self.keys if keys is None else keys
        return uniform(k, P_RAYGEN_JITTER_U), uniform(k, P_RAYGEN_JITTER_V)

    def lens_disk(self):
        d = random_in_unit_disk(self.keys, P_RAYGEN_LENS)
        return d[..., 0], d[..., 1]

    def rr_uniform(self):
        return uniform(self.keys, P_RR)

    def scatter_unit_vector(self):
        return random_unit_vector(self.keys, P_SCATTER_UNIT)

    def dielectric_uniform(self):
        return uniform(self.keys, P_DIELECTRIC)


def as_sampler(keys_or_sampler):
    """Back-compat shim: raw folded key arrays become a KeySampler;
    sampler objects (KeySampler / ktf.KtfSampler) pass through."""
    if hasattr(keys_or_sampler, "rr_uniform"):
        return keys_or_sampler
    return KeySampler(keys_or_sampler)
