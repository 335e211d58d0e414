"""Image driver for the fused path-loop kernel (ops/fused_kernel.py).

One device dispatch per spp pass: the integrator runs entirely inside the
kernel. RNG is the ktf counter family, so results match the XLA
integrators under cfg.rng_impl="ktf" up to float rounding
(tests/test_fused_megakernel.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.camera import Camera
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.models.wavefront import _tiled_pixel_grid
from raytracer_tpu.ops.fused_kernel import render_tiles_fused
from raytracer_tpu.scene.types import Scene


def blocked_pixel_grid(cfg, pkt_w: int, pkt_h: int, sub_w: int, sub_h: int):
    """Pixel ids where each pkt_w x pkt_h screen block is a run of
    consecutive lanes, split into sub_w x sub_h sub-blocks, each a run of
    its own (row-major inside). With 8 x 16 sub-blocks every warp of 32
    consecutive lanes covers an 8 x 4 pixel tile, so its camera rays and
    first bounces stay coherent.

    Returns (px, py [bottom-up], inv) with image.flat[p] = lanes[inv[p]];
    image edges pad with duplicated pixels, dropped by inv (first lane
    wins)."""
    assert pkt_w % sub_w == 0 and pkt_h % sub_h == 0
    w, h = cfg.width, cfg.height
    wp = (w + pkt_w - 1) // pkt_w * pkt_w
    hp = (h + pkt_h - 1) // pkt_h * pkt_h
    rows = np.minimum(np.arange(hp), h - 1)
    cols = np.minimum(np.arange(wp), w - 1)
    r2 = np.broadcast_to(rows[:, None], (hp, wp))
    c2 = np.broadcast_to(cols[None, :], (hp, wp))

    def lanes(a):
        a4 = a.reshape(hp // pkt_h, pkt_h, wp // pkt_w, pkt_w)
        a4 = a4.transpose(0, 2, 1, 3)  # [PBy, PBx, pkt_h, pkt_w]
        a6 = a4.reshape(hp // pkt_h, wp // pkt_w,
                        pkt_h // sub_h, sub_h, pkt_w // sub_w, sub_w)
        return a6.transpose(0, 1, 2, 4, 3, 5).reshape(-1)

    lane_rows = lanes(r2)
    lane_cols = lanes(c2)
    n = lane_rows.size
    flat = lane_rows * w + lane_cols
    inv = np.zeros(h * w, np.int64)
    inv[flat[::-1]] = np.arange(n, dtype=np.int64)[::-1]
    px = jnp.asarray(lane_cols.astype(np.int32))
    py = jnp.asarray((h - 1 - lane_rows).astype(np.int32))
    return px, py, jnp.asarray(inv)


def _fused_pixel_grid(cfg: RenderConfig):
    """Lane layout for the fused kernel: 32x32-pixel blocks of 8x16
    sub-blocks on frames that are whole blocks (each warp an 8x4 tile);
    the 8x128 screen-tile order otherwise, where 32x32 padding would
    inflate the lane count."""
    if cfg.width % 32 == 0 and cfg.height % 32 == 0:
        return blocked_pixel_grid(cfg, 32, 32, 8, 16)
    return _tiled_pixel_grid(cfg)


# Jitted entry, like models/wavefront.wavefront_batch: the camera tables
# are computed inside the same kind of program on one device and under
# shard_map (parallel/sharding.py), so both round alike.
fused_batch = jax.jit(render_tiles_fused, static_argnames=("cfg", "spp"))


def render_image_fused(
    scene: Scene, cam: Camera, cfg: RenderConfig, key: jax.Array,
    spp: int | None = None,
) -> jnp.ndarray:
    """Full-image render through the fused kernel → linear f32[H,W,3].
    spp above cfg.spp_per_pass splits into several dispatches with
    identical results (sample-offset keying, like the wavefront)."""
    px, py, inv = _fused_pixel_grid(cfg)
    spp = cfg.spp if spp is None else spp
    step = max(1, min(spp, cfg.spp_per_pass))
    if step >= spp:
        rgb = fused_batch(scene, cam, cfg, key, px, py, spp=spp)
    else:
        acc = None
        done = 0
        while done < spp:
            s = min(step, spp - done)
            part = fused_batch(scene, cam, cfg, key, px, py, spp=s,
                               sample_offset=jnp.int32(done)) * (s / spp)
            acc = part if acc is None else acc + part
            done += s
        rgb = acc
    return rgb[inv].reshape(cfg.height, cfg.width, 3)
