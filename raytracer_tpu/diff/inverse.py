"""Differentiable inverse rendering (BASELINE config[3]).

The reference has no differentiability at all — this is a capability this
build adds per the BASELINE north star: pixel gradients w.r.t.
material albedo / roughness / IOR / emission and camera params flow
through the integrator (detached traversal, reparameterized sampling —
see ops/intersect.py and ops/materials.py), enabling recovery of scene
materials from a target image by gradient descent.

`make_train_step` builds a jitted (optionally mesh-sharded) Adam step:
the pixel axis is sharded with `shard_map`, the loss/grads of the shared
material parameters are `psum`-all-reduced over the mesh — the reference has
no analog (single GPU, no collectives; SURVEY.md §2.2).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from raytracer_tpu.camera import Camera
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.render import render_pixels
from raytracer_tpu.scene.types import Materials, Scene

DEFAULT_FIELDS = ("albedo", "roughness", "emission", "ior")
# Camera-pose entries a params dict may carry alongside material fields
# (BASELINE north star: gradients w.r.t. "camera params"). Applied via
# _apply_cam; material appliers ignore them.
CAM_FIELDS = ("cam_position", "cam_yaw", "cam_pitch", "cam_fov")


class AdamState(NamedTuple):
    step: jnp.ndarray
    mu: dict
    nu: dict


def _apply_params(scene: Scene, params: dict) -> Scene:
    mats = scene.materials
    kw = {f: mats.__dict__[f] for f in ("type", "albedo", "emission", "roughness", "ior")}
    for name, val in params.items():
        if name in CAM_FIELDS:
            continue
        if name in ("albedo",):
            val = jnp.clip(val, 0.0, 1.0)
        if name in ("roughness",):
            val = jnp.clip(val, 0.0, 1.0)
        if name in ("emission",):
            val = jnp.maximum(val, 0.0)
        if name in ("ior",):
            val = jnp.clip(val, 1.0, 3.0)
        kw[name] = val
    return scene.replace(materials=Materials(**kw))


def _apply_cam(cam: Camera, params: dict) -> Camera:
    """Rebuild the camera from any CAM_FIELDS present in params. The
    derived focus distance stays at the base camera's value — with the
    showcase aperture ~0 the lens offset vanishes and focus_dist only
    scales the (unnormalized) ray directions, so it is not an
    identifiable pose parameter."""
    import dataclasses

    kw = {}
    if "cam_position" in params:
        kw["position"] = params["cam_position"]
    if "cam_yaw" in params:
        kw["yaw"] = params["cam_yaw"]
    if "cam_pitch" in params:
        kw["pitch"] = params["cam_pitch"]
    if "cam_fov" in params:
        kw["fov_degrees"] = params["cam_fov"]
    return dataclasses.replace(cam, **kw) if kw else cam


def apply_domains(params: dict, reflect: bool = False) -> dict:
    """Map each field into its render domain (same rules as
    _apply_params). A raw value OUTSIDE the domain renders as the
    boundary but has ZERO gradient through the clip, freezing the
    parameter forever — the r4 roughness-stuck bug: the init noise sent
    the mirror's roughness to −0.19, which rendered as the TRUE value 0
    while the reported raw error stayed 0.189 for 300 steps. Used on
    noised inits (reflect=True: fold at the lower bound so the
    perturbation stays inside the domain but AWAY from a boundary
    truth) and on recovered params before error reporting (clip: the
    clipped value is what actually renders)."""
    out = dict(params)

    def lo_map(x, lo):
        return lo + jnp.abs(x - lo) if reflect else jnp.maximum(x, lo)

    if "albedo" in out:
        out["albedo"] = jnp.minimum(lo_map(out["albedo"], 0.0), 1.0)
    if "roughness" in out:
        out["roughness"] = jnp.minimum(lo_map(out["roughness"], 0.0), 1.0)
    if "emission" in out:
        out["emission"] = lo_map(out["emission"], 0.0)
    if "ior" in out:
        out["ior"] = jnp.minimum(lo_map(out["ior"], 1.0), 3.0)
    return out


def init_params(scene: Scene, fields=DEFAULT_FIELDS, key=None, noise: float = 0.0) -> dict:
    params = {f: scene.materials.__dict__[f] for f in fields}
    if key is not None and noise > 0.0:
        leaves, treedef = jax.tree_util.tree_flatten(params)
        keys = jax.random.split(key, len(leaves))
        leaves = [l + noise * jax.random.normal(k, l.shape) for l, k in zip(leaves, keys)]
        params = jax.tree_util.tree_unflatten(treedef, leaves)
        params = apply_domains(params, reflect=True)
    return params


def adam_init(params: dict) -> AdamState:
    z = jax.tree_util.tree_map(jnp.zeros_like, params)
    return AdamState(step=jnp.zeros((), jnp.int32), mu=z, nu=jax.tree_util.tree_map(jnp.zeros_like, params))


def cosine_lr(lr0: float, total_steps: int, lr_min_frac: float = 0.1):
    """Cosine decay lr0 → lr0*lr_min_frac over total_steps (then flat).
    At constant lr the loss oscillates in a fixed band; decay converts
    that oscillation into convergence."""
    import jax.numpy as jnp

    def fn(step):
        t = jnp.minimum(step.astype(jnp.float32), total_steps) / total_steps
        return lr0 * (lr_min_frac
                      + (1.0 - lr_min_frac) * 0.5 * (1.0 + jnp.cos(jnp.pi * t)))

    return fn


def adam_update(state: AdamState, grads: dict, params: dict, lr=2e-2, b1=0.9, b2=0.999, eps=1e-8,
                lr_scales: dict | None = None):
    """Adam. `lr_scales` maps a param NAME to a multiplier on lr for
    that field — needed when one dict mixes fields whose natural units
    differ by orders of magnitude (Adam's per-parameter normalization
    makes every field step ~lr in ITS OWN units: 0.03 is right for a
    [0,1] albedo, ~10x too big for a world-space camera position in a
    0.6-unit box, and ~3x too small for a yaw in degrees)."""
    step = state.step + 1
    mu = jax.tree_util.tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = jax.tree_util.tree_map(lambda n, g: b2 * n + (1 - b2) * g * g, state.nu, grads)
    t = step.astype(jnp.float32)
    mhat = jax.tree_util.tree_map(lambda m: m / (1 - b1**t), mu)
    nhat = jax.tree_util.tree_map(lambda n: n / (1 - b2**t), nu)
    scale = {k: (lr_scales or {}).get(k, 1.0) for k in params}
    new_params = {
        k: jax.tree_util.tree_map(
            lambda p, m, n, s=scale[k]: p - lr * s * m / (jnp.sqrt(n) + eps),
            params[k], mhat[k], nhat[k])
        for k in params
    }
    return AdamState(step=step, mu=mu, nu=nu), new_params


def make_train_step_multi(
    base_scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    targets: jnp.ndarray,  # f32[K,H,W,3] matched common-random-number targets
    keys: jax.Array,       # [K] key array, keys[j] rendered targets[j]
    lr: float = 2e-2,
    lr_fn=None,
    lr_scales: dict | None = None,
):
    """Jitted Adam step whose gradient AVERAGES over K matched
    (key, target) pairs per step (vmap over the sample axis), instead of
    round-robin through them one at a time. Round-robin makes the loss
    orbit the per-key optima in a fixed band; the averaged objective has the true parameters as its exact optimum and
    a K-fold lower gradient variance. `lr_fn(step)` overrides the
    constant lr (see cosine_lr)."""
    import numpy as np

    h, w = cfg.height, cfg.width
    xs = jnp.asarray(np.tile(np.arange(w, dtype=np.int32), h))
    ys = jnp.asarray(np.repeat(np.arange(h - 1, -1, -1, dtype=np.int32), w))
    tgts = targets.reshape(targets.shape[0], -1, 3)

    def pair_loss(params, key, tgt):
        scene = _apply_params(base_scene, params)
        rgb = render_pixels(scene, _apply_cam(cam, params), xs, ys, cfg, key)
        return jnp.mean(jnp.sum((rgb - tgt) ** 2, axis=-1)) / 3.0

    def loss_fn(params):
        losses = jax.vmap(lambda k, t: pair_loss(params, k, t))(keys, tgts)
        return jnp.mean(losses)

    @jax.jit
    def train_step(params, adam_state, _key_unused=None):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        cur_lr = lr_fn(adam_state.step) if lr_fn is not None else lr
        adam_state, params = adam_update(adam_state, grads, params, lr=cur_lr,
                                         lr_scales=lr_scales)
        return params, adam_state, loss

    return train_step


def make_train_step_accum(
    base_scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    targets: jnp.ndarray,  # f32[K,H,W,3] matched CRN targets
    keys: jax.Array,       # [K]
    chunk: int = 8,
    lr: float = 2e-2,
    lr_fn=None,
    lr_scales: dict | None = None,
):
    """make_train_step_multi semantics at K pairs, but the gradient is
    ACCUMULATED over K/chunk jitted sub-batches instead of one vmap(K)
    graph — the vmap(16) gradient graph of the 128x128/spp32 inverse
    config needs 27.6 GB of HBM against the chip's 15.75 (measured
    OOM); chunked accumulation holds peak memory at the vmap(chunk)
    graph while keeping the K-pair averaged objective exactly (the
    chunks partition the pairs, so the mean of chunk-means with equal
    chunks equals the K-mean). Two dispatches per step at K=16/chunk=8."""
    import numpy as np

    k_total = targets.shape[0]
    assert k_total % chunk == 0, (k_total, chunk)
    n_chunks = k_total // chunk
    h, w = cfg.height, cfg.width
    xs = jnp.asarray(np.tile(np.arange(w, dtype=np.int32), h))
    ys = jnp.asarray(np.repeat(np.arange(h - 1, -1, -1, dtype=np.int32), w))
    tgts = targets.reshape(k_total, -1, 3)

    def pair_loss(params, key, tgt):
        scene = _apply_params(base_scene, params)
        rgb = render_pixels(scene, _apply_cam(cam, params), xs, ys, cfg, key)
        return jnp.mean(jnp.sum((rgb - tgt) ** 2, axis=-1)) / 3.0

    @jax.jit
    def chunk_grad(params, keys_c, tgts_c):
        def loss_fn(params):
            losses = jax.vmap(lambda k, t: pair_loss(params, k, t))(keys_c, tgts_c)
            return jnp.mean(losses)

        return jax.value_and_grad(loss_fn)(params)

    @jax.jit
    def apply_update(params, adam_state, grads, loss):
        cur_lr = lr_fn(adam_state.step) if lr_fn is not None else lr
        adam_state, params = adam_update(adam_state, grads, params, lr=cur_lr,
                                         lr_scales=lr_scales)
        return params, adam_state, loss

    key_chunks = [keys[i * chunk:(i + 1) * chunk] for i in range(n_chunks)]
    tgt_chunks = [tgts[i * chunk:(i + 1) * chunk] for i in range(n_chunks)]

    def train_step(params, adam_state, _key_unused=None):
        loss_sum, grad_sum = None, None
        for kc, tc in zip(key_chunks, tgt_chunks):
            loss_c, grads_c = chunk_grad(params, kc, tc)
            if grad_sum is None:
                loss_sum, grad_sum = loss_c, grads_c
            else:
                loss_sum = loss_sum + loss_c
                grad_sum = jax.tree_util.tree_map(
                    lambda a, b: a + b, grad_sum, grads_c)
        inv = 1.0 / n_chunks
        grads = jax.tree_util.tree_map(lambda g: g * inv, grad_sum)
        return apply_update(params, adam_state, grads, loss_sum * inv)

    return train_step


def make_train_step(
    base_scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    target: jnp.ndarray,  # f32[H,W,3] linear target image
    mesh=None,
    lr: float = 2e-2,
    lr_scales: dict | None = None,
):
    """Returns a jitted train_step: train_step(params, adam_state, key)
    → (params, adam_state, loss). Initialize optimizer state separately
    with adam_init(params). If `mesh` is given, pixels are sharded over
    its first axis and parameter grads are psum-reduced over it."""
    import numpy as np

    h, w = cfg.height, cfg.width
    xs = np.tile(np.arange(w, dtype=np.int32), h)
    ys = np.repeat(np.arange(h - 1, -1, -1, dtype=np.int32), w)
    target_flat = target.reshape(-1, 3)

    def local_loss(params, key, px, py, tgt, weight=None):
        scene = _apply_params(base_scene, params)
        rgb = render_pixels(scene, _apply_cam(cam, params), px, py, cfg, key)
        sq = jnp.sum((rgb - tgt) ** 2, axis=-1)
        if weight is None:
            return jnp.mean(sq) / 3.0
        # Weighted mean: padding lanes (weight 0) must not bias the loss
        # or the psum'd gradients (they render duplicated pixels against
        # a zero target).
        return jnp.sum(sq * weight) / 3.0

    if mesh is None:
        px, py = jnp.asarray(xs), jnp.asarray(ys)
        tgt = jnp.asarray(target_flat)

        @jax.jit
        def train_step(params, adam_state, key):
            loss, grads = jax.value_and_grad(local_loss)(params, key, px, py, tgt)
            adam_state, params = adam_update(adam_state, grads, params, lr=lr,
                                             lr_scales=lr_scales)
            return params, adam_state, loss

        return train_step

    # Sharded variant: pixels split over the mesh; parameter grads psum'd.
    axis = mesh.axis_names[0]
    n_shards = mesh.devices.size
    n = len(xs)
    pad = (-n) % n_shards
    px = jnp.asarray(np.concatenate([xs, np.zeros(pad, np.int32)]))
    py = jnp.asarray(np.concatenate([ys, np.zeros(pad, np.int32)]))
    tgt = jnp.asarray(
        np.concatenate([target_flat, np.zeros((pad, 3), np.float32)]) if pad else target_flat
    )
    # Per-lane weight 1/n_real for real pixels, 0 for padding lanes.
    w = jnp.asarray(
        np.concatenate([np.full(n, 1.0 / n, np.float32), np.zeros(pad, np.float32)]))

    def sharded_grads(params, key, px, py, tgt, w):
        def shard_fn(params, key, px, py, tgt, w):
            # RNG is pixel-keyed; no per-shard decorrelation needed.
            loss, grads = jax.value_and_grad(local_loss)(params, key, px, py, tgt, w)
            # All-reduce over the mesh: shared params, sharded pixels. The
            # weights sum to 1 globally, so psum (not pmean) completes
            # the weighted mean exactly — padding contributes nothing.
            grads = jax.tree_util.tree_map(lambda g: jax.lax.psum(g, axis), grads)
            return jax.lax.psum(loss, axis), grads

        return shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(), P()),
            check_vma=False,
        )(params, key, px, py, tgt, w)

    @jax.jit
    def train_step(params, adam_state, key):
        loss, grads = sharded_grads(params, key, px, py, tgt, w)
        adam_state, params = adam_update(adam_state, grads, params, lr=lr,
                                             lr_scales=lr_scales)
        return params, adam_state, loss

    return train_step
