"""Top-level render API.

Replaces the reference's frame-loop orchestration (Raytracer.h:52-102 +
CUDARenderer.cuh:55-60): a render is one jitted functional call
`(scene, camera, key) → image`, with sample accumulation as a
`lax.fori_loop` (the reference's per-thread spp loop, CUDAKernels.h:158-162)
and optional pixel chunking to bound wavefront memory.

Image convention: returned arrays are [H, W, 3] with row 0 at the TOP.
The reference renders with v=0 at the bottom and flips at present time
(WindowManager.h:88); we bake the flip into pixel-id generation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from raytracer_tpu.camera import Camera, generate_rays
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.models import megakernel
from raytracer_tpu.ops import tonemap
from raytracer_tpu.scene.types import Scene
from raytracer_tpu.utils import rng as rngu


def render_pixels(
    scene: Scene,
    cam: Camera,
    px: jnp.ndarray,  # i32[N]
    py: jnp.ndarray,  # i32[N] (0 = bottom row)
    cfg: RenderConfig,
    key: jax.Array,
    spp: int | None = None,
    sample_offset: int = 0,
) -> jnp.ndarray:
    """Mean linear radiance f32[N,3] over `spp` samples. `sample_offset`
    shifts the global sample indices so spp-batched accumulation draws the
    same randoms as one big pass (render_image_chunked)."""
    spp = cfg.spp if spp is None else spp
    n = px.shape[0]
    # Pixel-identity keys: randomness is a pure function of
    # (base key, global pixel id, sample, bounce, purpose) — invariant to
    # chunking and sharding (utils/rng.py; same property in ktf mode via
    # the explicit (pixel, sample, bounce, purpose) counter, utils/ktf.py).
    pixel_ids = py * cfg.width + px
    if cfg.rng_impl == "ktf":
        from raytracer_tpu.utils import ktf

        base = ktf.sampler(key, pixel_ids)

        def sample_body(s, acc):
            smp = base.at(sample=s + sample_offset, bounce=0)
            origins, dirs = generate_rays(cam, px, py, cfg.width, cfg.height, smp)
            return acc + megakernel.trace_paths(scene, origins, dirs, None, cfg,
                                                sampler=smp)
    else:
        pkeys = rngu.lane_keys(key, pixel_ids)

        def sample_body(s, acc):
            skeys = rngu.fold(pkeys, s + sample_offset)
            origins, dirs = generate_rays(cam, px, py, cfg.width, cfg.height, skeys)
            return acc + megakernel.trace_paths(scene, origins, dirs, skeys, cfg)

    acc = jax.lax.fori_loop(0, spp, sample_body, jnp.zeros((n, 3), jnp.float32))
    return acc / jnp.float32(spp)


def _pixel_grid(cfg: RenderConfig):
    """Pixel ids for a full image, row 0 = top (pre-flipped)."""
    xs = jnp.arange(cfg.width, dtype=jnp.int32)
    ys_top_down = jnp.arange(cfg.height - 1, -1, -1, dtype=jnp.int32)
    px = jnp.tile(xs[None, :], (cfg.height, 1)).reshape(-1)
    py = jnp.repeat(ys_top_down, cfg.width)
    return px, py


@partial(jax.jit, static_argnames=("cfg",))
def render_image(scene: Scene, cam: Camera, cfg: RenderConfig, key: jax.Array) -> jnp.ndarray:
    """Single-pass full-image render → linear f32[H,W,3]."""
    px, py = _pixel_grid(cfg)
    rgb = render_pixels(scene, cam, px, py, cfg, key)
    return rgb.reshape(cfg.height, cfg.width, 3)


@partial(jax.jit, static_argnames=("cfg", "n_rows", "spp", "sample_offset"))
def render_rows(scene, cam, cfg: RenderConfig, row0, n_rows: int, spp: int, key,
                sample_offset: int = 0):
    """Render `n_rows` full-width rows starting at top-down row `row0`
    (dynamic) of the cfg-sized image. The jit cache is keyed on
    (cfg, n_rows, spp) only, so chunked renders compile once."""
    xs = jnp.arange(cfg.width, dtype=jnp.int32)
    rows = row0 + jnp.arange(n_rows, dtype=jnp.int32)
    ys = cfg.height - 1 - rows  # top-down → bottom-up flip
    px = jnp.tile(xs[None, :], (n_rows, 1)).reshape(-1)
    py = jnp.repeat(ys, cfg.width)
    rgb = render_pixels(scene, cam, px, py, cfg, key, spp=spp,
                        sample_offset=sample_offset)
    return rgb.reshape(n_rows, cfg.width, 3)


def iter_spp_accumulation(scene, cam, cfg: RenderConfig, key,
                          integrator: str = "wavefront",
                          spp_per_batch: int | None = None,
                          start_done: int = 0):
    """Shared spp-batched accumulation driver (used by chunked,
    progressive-preview, and resumable renders — one copy of the batch
    sizing / sample-offset arithmetic). Yields (done_spp, batch_sum
    np.f32[H,W,3]) where batch_sum is the SUM of that batch's samples
    (divide the running total by done_spp for the current mean)."""
    import numpy as np

    spp_step = max(1, min(cfg.spp, spp_per_batch or cfg.spp_per_pass))
    h, w = cfg.height, cfg.width
    done = start_done
    if integrator == "fused":
        from raytracer_tpu.models.fused import _fused_pixel_grid, fused_batch

        px, py, inv = _fused_pixel_grid(cfg)
        inv_np = np.asarray(inv)
        while done < cfg.spp:
            s = min(spp_step, cfg.spp - done)
            # Draws are keyed by ABSOLUTE sample index (sample_offset),
            # so batched accumulation reproduces the single-pass image.
            mean = np.asarray(fused_batch(
                scene, cam, cfg, key, px, py, spp=s,
                sample_offset=jnp.int32(done)))[inv_np]
            done += s
            yield done, mean.reshape(h, w, 3) * s
    elif integrator == "wavefront":
        from raytracer_tpu.models.wavefront import _tiled_pixel_grid, wavefront_batch

        px, py, inv = _tiled_pixel_grid(cfg)
        inv_np = np.asarray(inv)
        while done < cfg.spp:
            s = min(spp_step, cfg.spp - done)
            mean = np.asarray(
                wavefront_batch(scene, cam, px, py, cfg, key, spp=s,
                                sample_offset=jnp.int32(done)))[inv_np]
            done += s
            yield done, mean.reshape(h, w, 3) * s
    else:
        rows_per_chunk = max(1, min(h, cfg.max_rays_per_pass // w))
        while done < cfg.spp:
            s = min(spp_step, cfg.spp - done)
            parts = []
            for row0 in range(0, h, rows_per_chunk):
                n_rows = min(rows_per_chunk, h - row0)
                parts.append(np.asarray(
                    render_rows(scene, cam, cfg, row0, n_rows, s, key,
                                sample_offset=done)))
            done += s
            yield done, np.concatenate(parts, axis=0) * s


def render_image_chunked(
    scene: Scene, cam: Camera, cfg: RenderConfig, key: jax.Array
) -> jnp.ndarray:
    """Row-chunked + spp-batched megakernel render — bounds live
    wavefront memory for the 2K/2000spp workload (SURVEY.md §7 'Memory').
    Identical image to render_image (sample-offset keying)."""
    import numpy as np

    acc = np.zeros((cfg.height, cfg.width, 3), np.float32)
    for done, batch_sum in iter_spp_accumulation(scene, cam, cfg, key,
                                                 integrator="megakernel"):
        acc += batch_sum
    return jnp.asarray(acc / cfg.spp)


def tone_map_image(linear_rgb: jnp.ndarray) -> jnp.ndarray:
    """Linear f32[H,W,3] → display u8[H,W,4] (CRTUtility.cuh:21-32)."""
    return tonemap.to_rgba8(linear_rgb)
