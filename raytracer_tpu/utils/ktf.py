"""Kernel-portable counter-based RNG — Threefry-2x32 on int32 vector ops.

Why this exists: the fused path-loop kernel (ops/fused_kernel.py,
native/pathtrace.h) draws its randoms inside the kernel, where
`jax.random` is unavailable. This module pins ONE spec — standard
Threefry-2x32 (20 rounds, the same block cipher jax.random uses) with an
explicit (pixel, sample, bounce, purpose) counter layout — implemented in
plain jnp int32 ops (add / xor / shifts), and the kernel implements the
same spec in C++, so:

  * the kernel's draws, and
  * the XLA integrators' draws (megakernel / wavefront with
    cfg.rng_impl="ktf")

are BIT-IDENTICAL. The original `utils/rng.py` jax.random path remains
the default and the oracle; ktf is a parallel RNG mode, statistically
equivalent (same cipher, different key-derivation chain), whose purpose
is to keep the wavefront ≡ megakernel ≡ fused-kernel equality invariants
testable.

Counter layout (one threefry block = 2 u32 draws):
  c0 = pixel_id                      (i32; < 2^31 pixels)
  c1 = (sample << 9) | (bounce << 4) | purpose
       sample < 2^22, bounce < 32, purpose < 16
Key (k0, k1) = jax.random.key_data(user key) — the ktf stream is keyed
by the same user-facing PRNGKey object as the jax path.

Uniform mapping: u01(bits) = f32(bits >> 9) * 2^-23 — exactly the value
jax.random.uniform's mantissa-bitcast trick produces (m * 2^-23 is an
exponent shift of an integer with <= 23 significant bits: exact).

Reference analog: the reference keeps one mutable curand state per pixel
(CUDAKernels.h:18-26); this is the stateless counter-based restatement.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Purpose tags (must stay < 16; see counter layout above).
JITTER = 1      # raygen pixel jitter: (u, v) from one block
LENS = 2        # raygen lens-disk sample: (u1, u2) from one block
RR = 3          # Russian-roulette survival draw
SCATTER = 4     # material unit-vector sample: (u1, u2) from one block
DIELECTRIC = 5  # Schlick reflect-vs-refract draw

MAX_BOUNCE = 32
MAX_PURPOSE = 16

_PARITY = np.int32(np.uint32(0x1BD11BDA))
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _rotl(x, r: int):
    return jax.lax.shift_left(x, np.int32(r)) | jax.lax.shift_right_logical(
        x, np.int32(32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Standard Threefry-2x32, 20 rounds. All args int32 (scalars or
    arrays, broadcastable); wrapping int32 adds == uint32 adds in two's
    complement. Returns (x0, x1) int32.

    Bit-exact with jax._src.prng.threefry2x32 on the same words (same
    cipher); only the key/counter derivation differs from jax.random."""
    k0 = jnp.asarray(k0, jnp.int32)
    k1 = jnp.asarray(k1, jnp.int32)
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = jnp.asarray(c0, jnp.int32) + k0
    x1 = jnp.asarray(c1, jnp.int32) + k1

    def four_rounds(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        return x0, x1

    # Injection schedule: after group i (1-based), x0 += ks[i%3],
    # x1 += ks[(i+1)%3] + i, with ks = [k0, k1, ks2].
    x0, x1 = four_rounds(x0, x1, _ROT_A)
    x0, x1 = x0 + k1, x1 + ks2 + jnp.int32(1)
    x0, x1 = four_rounds(x0, x1, _ROT_B)
    x0, x1 = x0 + ks2, x1 + k0 + jnp.int32(2)
    x0, x1 = four_rounds(x0, x1, _ROT_A)
    x0, x1 = x0 + k0, x1 + k1 + jnp.int32(3)
    x0, x1 = four_rounds(x0, x1, _ROT_B)
    x0, x1 = x0 + k1, x1 + ks2 + jnp.int32(4)
    x0, x1 = four_rounds(x0, x1, _ROT_A)
    x0, x1 = x0 + ks2, x1 + k0 + jnp.int32(5)
    return x0, x1


def u01(bits):
    """i32 random bits → f32 uniform in [0, 1): f32(bits >> 9) * 2^-23
    (exact; matches jax.random.uniform's mantissa construction)."""
    return jax.lax.shift_right_logical(bits, np.int32(9)).astype(jnp.float32) * np.float32(
        2.0 ** -23)


def key_words(key: jax.Array):
    """User PRNGKey → (k0, k1) int32 scalars (host-side helper)."""
    kd = jax.random.key_data(key) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else key
    kd = jnp.asarray(kd).astype(jnp.uint32).astype(jnp.int32).reshape(-1)
    return kd[0], kd[1]


def counter(sample, bounce, purpose: int):
    """c1 word: (sample << 9) | (bounce << 4) | purpose."""
    s = jnp.asarray(sample, jnp.int32)
    b = jnp.asarray(bounce, jnp.int32)
    return jax.lax.shift_left(s, np.int32(9)) | jax.lax.shift_left(
        b, np.int32(4)) | jnp.int32(purpose)


class KtfSampler(NamedTuple):
    """Per-lane draw context: pixel ids + the (sample, bounce) word.
    Works on any array shape. Implements the Sampler protocol
    (utils/rng.py): uniform / uniform_pair / unit_vector / disk."""

    k0: jnp.ndarray      # i32[] key word
    k1: jnp.ndarray      # i32[]
    pixel: jnp.ndarray   # i32[...] pixel ids (c0)
    sample: jnp.ndarray  # i32 scalar or [...] per-lane sample index
    bounce: jnp.ndarray  # i32 scalar or [...] per-lane bounce index

    def _block(self, purpose: int):
        return threefry2x32(self.k0, self.k1, self.pixel,
                            counter(self.sample, self.bounce, purpose))

    def uniform(self, purpose: int):
        a, _ = self._block(purpose)
        return u01(a)

    def uniform_pair(self, purpose: int):
        a, b = self._block(purpose)
        return u01(a), u01(b)

    def unit_vector(self, purpose: int):
        """Uniform direction on the unit sphere from 2 uniforms:
        z = 1-2u1, phi = 2*pi*u2 (same distribution as the reference's
        rejection sampling, Core/Utility.cuh:73-76). Returns components
        stacked on a NEW LAST axis ([...,3])."""
        u1, u2 = self.uniform_pair(purpose)
        z = 1.0 - 2.0 * u1
        r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
        phi = (2.0 * np.pi) * u2
        return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)

    def unit_vector_parts(self, purpose: int):
        """unit_vector as 3 separate arrays (kernel-friendly: no stack)."""
        u1, u2 = self.uniform_pair(purpose)
        z = 1.0 - 2.0 * u1
        r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
        phi = (2.0 * np.pi) * u2
        return r * jnp.cos(phi), r * jnp.sin(phi), z

    def disk(self, purpose: int):
        """Uniform point in the unit z=0 disk (polar closed form;
        distribution-equivalent to Core/Utility.cuh:55-62). [...,3]."""
        u1, u2 = self.uniform_pair(purpose)
        r = jnp.sqrt(u1)
        theta = (2.0 * np.pi) * u2
        return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta),
                          jnp.zeros_like(r)], axis=-1)

    def disk_parts(self, purpose: int):
        u1, u2 = self.uniform_pair(purpose)
        r = jnp.sqrt(u1)
        theta = (2.0 * np.pi) * u2
        return r * jnp.cos(theta), r * jnp.sin(theta)

    # --- Sampler protocol (see utils/rng.KeySampler) ---
    def jitter_uv(self):
        return self.uniform_pair(JITTER)

    def lens_disk(self):
        return self.disk_parts(LENS)

    def rr_uniform(self):
        return self.uniform(RR)

    def scatter_unit_vector(self):
        return self.unit_vector(SCATTER)

    def dielectric_uniform(self):
        return self.uniform(DIELECTRIC)

    def at(self, sample=None, bounce=None) -> "KtfSampler":
        return self._replace(
            sample=self.sample if sample is None else jnp.asarray(sample, jnp.int32),
            bounce=self.bounce if bounce is None else jnp.asarray(bounce, jnp.int32))


def sampler(key: jax.Array, pixel_ids, sample=0, bounce=0) -> KtfSampler:
    k0, k1 = key_words(key)
    return KtfSampler(k0=k0, k1=k1, pixel=jnp.asarray(pixel_ids, jnp.int32),
                      sample=jnp.asarray(sample, jnp.int32),
                      bounce=jnp.asarray(bounce, jnp.int32))
