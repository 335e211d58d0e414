"""Masked megakernel integrator — the correctness oracle and default path.

This is the data-parallel restatement of the reference's per-thread
`rayColor` loop (CUDAKernels.h:102-145): instead of one divergent CUDA
thread per pixel, the whole ray wavefront advances through a static
`lax.fori_loop` over bounces with per-lane alive masks. Dead lanes ride
along masked — this wastes lanes late in the path (the wavefront
integrator in models/wavefront.py compacts them) but is branch-free,
fully fused by XLA, and reverse-differentiable (fori_loop with a static
trip count lowers to scan).

Exact reference semantics reproduced (SURVEY.md §6.2):
  * Russian roulette from bounce 3: survival = min(max RGB of
    throughput, 0.95), survivors divided by survival (CUDAKernels.h:113-121).
  * Emitters return emission *unattenuated* (CUDAKernels.h:133-134) when
    cfg.reference_emission_quirk is True.
  * Paths exhausting max_bounces contribute black (CUDAKernels.h:105).
  * Miss adds throughput × sky gradient (CUDAKernels.h:137-142).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer_tpu.config import RenderConfig
from raytracer_tpu.ops import intersect as isect
from raytracer_tpu.ops import materials as mat_ops
from raytracer_tpu.ops import tonemap
from raytracer_tpu.scene.types import Scene
from raytracer_tpu.utils import rng as rngu


def _edge_light_term(scene: Scene, cfg: RenderConfig, origins, dirs,
                     throughput, t_detached, alive):
    """Smoothed-boundary light-visibility gradient term (BASELINE north
    star "reparameterized/edge-aware handling for visibility").

    The detached traversal makes the light-hit indicator a step function
    of the ray direction, so parameters that only move DIRECTIONS (metal
    roughness, dielectric IOR, camera) get zero gradient from light
    paths. This term replaces that step's derivative with the derivative
    of a sigmoid-smoothed rectangle indicator of the fitted light
    (scene.light_rect), in control-variate form: the returned value is
    (soft - stop_grad(soft)) * stop_grad(throughput * E_light) — EXACTLY
    0.0 in the forward pass (bit-identical images), with
    d/dθ = dsoft/dθ * throughput * E_light, a smoothed version of the
    true boundary term with the occluded side gated by the detached hit
    distance (no gradient when something nearer blocks the light)."""
    rect = scene.light_rect
    center, n_pl = rect[0:3], rect[3:6]
    u_ax, v_ax = rect[6:9], rect[9:12]
    hu, hv = rect[12], rect[13]
    mat_id = rect[14].astype(jnp.int32)
    sg = jax.lax.stop_gradient

    denom = jnp.sum(dirs * n_pl, axis=-1)
    bad = jnp.abs(denom) < 1e-6
    denom_safe = jnp.where(bad, 1.0, denom)
    t_pl = jnp.sum((center - origins) * n_pl, axis=-1) / denom_safe
    p = origins + t_pl[:, None] * dirs
    du = jnp.sum((p - center) * u_ax, axis=-1)
    dv = jnp.sum((p - center) * v_ax, axis=-1)
    bw = cfg.edge_bandwidth * jnp.minimum(hu, hv)
    soft = (jax.nn.sigmoid((hu - jnp.abs(du)) / bw)
            * jax.nn.sigmoid((hv - jnp.abs(dv)) / bw))
    # Gate (all detached): live lane, non-grazing, plane in front, and
    # nothing strictly nearer than the plane (tolerance covers the
    # light's own hit: t_hit == t_pl there).
    gate = sg(alive & ~bad & (t_pl > cfg.t_min)
              & (t_pl <= t_detached * 1.02))
    soft = jnp.where(gate, soft, 0.0)
    emission = sg(scene.materials.emission[mat_id])
    weight = sg(throughput) * emission[None, :]
    return (soft - sg(soft))[:, None] * weight


def trace_paths(
    scene: Scene,
    origins: jnp.ndarray,  # f32[N,3]
    dirs: jnp.ndarray,     # f32[N,3]
    keys: jax.Array,       # per-lane (pixel,sample) key array [N] (jax mode)
    cfg: RenderConfig,
    sampler=None,          # ktf mode: utils/ktf.KtfSampler with pixel+sample set
) -> jnp.ndarray:
    """Path-traced radiance f32[N,3] for one sample per ray."""
    n = origins.shape[0]
    edge_on = cfg.edge_aware_lights and scene.light_rect is not None

    def bounce_body(bounce, state):
        origins, dirs, throughput, radiance, alive, edge_acc = state
        if sampler is not None:
            smp = sampler.at(bounce=bounce)
        else:
            smp = rngu.KeySampler(rngu.fold(keys, bounce))

        # Russian roulette (CUDAKernels.h:113-121).
        do_rr = bounce >= cfg.min_bounces
        survival = jnp.minimum(jnp.max(throughput, axis=-1), cfg.rr_max_prob)
        u_rr = smp.rr_uniform()
        rr_kill = do_rr & (u_rr > survival)
        alive = alive & ~rr_kill
        rr_scale = jnp.where(do_rr & alive, 1.0 / jnp.maximum(survival, 1e-12), 1.0)
        throughput = throughput * rr_scale[:, None]

        ids = isect.intersect_scene(scene, origins, dirs, cfg.t_min)
        if edge_on:
            # Value-zero smoothed-visibility gradient term for this
            # segment (post-RR throughput — what a light hit would see).
            edge_acc = edge_acc + _edge_light_term(
                scene, cfg, origins, dirs, throughput, ids.t, alive)
        attrs = isect.shade_hit(scene, origins, dirs, ids)
        sc = mat_ops.scatter(smp, dirs, attrs.normal, attrs.front_face, attrs.mat_id, scene.materials)

        hit = ids.hit & alive
        light_hit = hit & sc.is_light
        if cfg.reference_emission_quirk:
            emitted = sc.emission
        else:
            emitted = throughput * sc.emission
        radiance = jnp.where(light_hit[:, None], emitted, radiance)

        miss = alive & ~ids.hit
        radiance = jnp.where(miss[:, None], throughput * tonemap.sky_color(dirs), radiance)

        cont = hit & sc.scattered
        throughput = jnp.where(cont[:, None], throughput * sc.attenuation, throughput)
        origins = jnp.where(cont[:, None], attrs.point, origins)
        dirs = jnp.where(cont[:, None], sc.direction, dirs)
        alive = cont
        return origins, dirs, throughput, radiance, alive, edge_acc

    state = (
        origins,
        dirs,
        jnp.ones((n, 3), jnp.float32),
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n,), bool),
        jnp.zeros((n, 3), jnp.float32),  # edge-term accumulator (≡ 0.0)
    )
    body = jax.checkpoint(bounce_body) if cfg.max_bounces > 8 else bounce_body
    *_, radiance, _, edge_acc = jax.lax.fori_loop(0, cfg.max_bounces, body,
                                                  state, unroll=False)
    # edge_acc is exactly 0.0 everywhere in the forward pass; adding it
    # routes the smoothed-boundary gradients into the pixel value
    # without touching the rendered image (x + 0.0 == x).
    return radiance + edge_acc if edge_on else radiance
