"""Vectorized material scatter/emit for the four reference materials.

Replaces the reference's device-virtual dispatch
(Core/Material.cuh:49-150) with a branch-free select over the material
type tag: all four scatter candidates are computed for every lane with
shared random draws and the per-ray winner is chosen with `where` —
each branch is a handful of fused elementwise ops, and the select keeps
the whole bounce one data-parallel program.

Sampling semantics match the reference exactly:
  * Lambertian (Core/Material.cuh:66-77): dir = normal + unit_vector,
    degenerate → normal; attenuation = albedo.
  * Metal (Core/Material.cuh:89-96): normalize(reflect(d, n)) +
    roughness·unit_vector; absorbed if the scattered dir leaves the
    hemisphere; attenuation = albedo.
  * Dielectric (Core/Material.cuh:109-137): attenuation = 1, IOR ratio by
    face side, total-internal-reflection, probabilistic Schlick reflect.
  * DiffuseLight (Core/Material.cuh:139-150): never scatters; emits.

Differentiable w.r.t. albedo / roughness / emission (reparameterized
through the sampled directions) and IOR (through the refracted
direction; the discrete reflect/refract pick is detached).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer_tpu.scene.types import DIELECTRIC, DIFFUSE_LIGHT, LAMBERTIAN, METAL, Materials
from raytracer_tpu.utils import rng as rngu
from raytracer_tpu.utils import vecmath as vm


class ScatterResult(NamedTuple):
    direction: jnp.ndarray    # f32[N,3] next ray direction
    attenuation: jnp.ndarray  # f32[N,3]
    scattered: jnp.ndarray    # bool[N] — False = absorbed or light
    is_light: jnp.ndarray     # bool[N]
    emission: jnp.ndarray     # f32[N,3]


class MatParams(NamedTuple):
    """Per-lane material parameters (already looked up)."""

    mtype: jnp.ndarray      # i32[N]
    albedo: jnp.ndarray     # f32[N,3]
    emission: jnp.ndarray   # f32[N,3]
    roughness: jnp.ndarray  # f32[N]
    ior: jnp.ndarray        # f32[N]


def lookup_params(materials: Materials, mat_id: jnp.ndarray) -> MatParams:
    return MatParams(
        materials.type[mat_id],
        materials.albedo[mat_id],
        materials.emission[mat_id],
        materials.roughness[mat_id],
        materials.ior[mat_id],
    )


def scatter(
    keys,                   # per-lane key array [N] OR a Sampler
    in_dir: jnp.ndarray,    # f32[N,3] incoming ray direction (unnormalized, as in reference)
    normal: jnp.ndarray,    # f32[N,3] front-facing shading normal
    front_face: jnp.ndarray,  # bool[N]
    mat_id: jnp.ndarray,    # i32[N]
    materials: Materials,
) -> ScatterResult:
    return scatter_params(keys, in_dir, normal, front_face,
                          lookup_params(materials, mat_id))


def scatter_params(
    keys,                   # per-lane key array [N] OR a Sampler
    in_dir: jnp.ndarray,
    normal: jnp.ndarray,
    front_face: jnp.ndarray,
    params: MatParams,
) -> ScatterResult:
    smp = rngu.as_sampler(keys)
    mtype = params.mtype
    albedo = params.albedo
    emission = params.emission
    roughness = params.roughness[:, None]
    ior = params.ior

    unit_vec = smp.scatter_unit_vector()
    u_dielectric = smp.dielectric_uniform()

    # --- Lambertian ---
    lam_dir = normal + unit_vec
    lam_dir = vm.where(vm.near_zero(lam_dir), normal, lam_dir)

    # --- Metal ---
    reflected = vm.normalize(vm.reflect(in_dir, normal), eps=1e-20) + roughness * unit_vec
    metal_ok = vm.dot(reflected, normal, keepdims=False) > 0.0

    # --- Dielectric ---
    ri = jnp.where(front_face, 1.0 / ior, ior)[:, None]
    unit_in = vm.normalize(in_dir)
    cos_theta = jnp.minimum(vm.dot(-unit_in, normal), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = (ri * sin_theta) > 1.0
    r0 = jnp.square((1.0 - ri) / (1.0 + ri))
    schlick = r0 + (1.0 - r0) * jnp.power(1.0 - cos_theta, 5.0)
    do_reflect = cannot_refract | (schlick > u_dielectric[:, None])
    do_reflect = jax.lax.stop_gradient(do_reflect)  # detach the discrete branch pick
    die_dir = jnp.where(
        do_reflect,
        vm.reflect(unit_in, normal),
        vm.refract(unit_in, normal, ri),
    )

    # --- Select by type tag ---
    is_lam = mtype == LAMBERTIAN
    is_metal = mtype == METAL
    is_die = mtype == DIELECTRIC
    is_light = mtype == DIFFUSE_LIGHT

    direction = jnp.where(is_metal[:, None], reflected, lam_dir)
    direction = jnp.where(is_die[:, None], die_dir, direction)

    attenuation = jnp.where(is_die[:, None], jnp.ones_like(albedo), albedo)

    scattered = is_lam | (is_metal & metal_ok) | is_die
    emission_out = jnp.where(is_light[:, None], emission, jnp.zeros_like(emission))

    return ScatterResult(
        direction=direction,
        attenuation=attenuation,
        scattered=scattered,
        is_light=is_light,
        emission=emission_out,
    )
