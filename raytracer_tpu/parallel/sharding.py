"""Multi-chip scaling via `shard_map` over a device mesh.

The reference is strictly single-GPU/single-process (SURVEY.md §2.2: no
NCCL/MPI/sockets anywhere; its only "transport" is PCIe cudaMemcpy).
This framework scales natively:

  * forward rendering shards the RAY/PIXEL axis across the mesh — tiles
    are independent, so the forward pass needs ZERO cross-chip
    collectives; scene/camera params are replicated at setup (the analog
    of the reference's one-time H2D scene upload, SceneManager.h:151-166),
  * the backward pass of the shared scene/material/camera parameters
    all-reduces gradients with `psum` over the mesh (BASELINE north star),
  * multi-host entry uses `jax.distributed.initialize` + the same mesh.

Tested on a virtual 8-device CPU mesh (tests/conftest.py) and dry-run
compiled by __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from raytracer_tpu.camera import Camera
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.render import render_pixels
from raytracer_tpu.scene.types import Scene

RAY_AXIS = "rays"

import logging

_log = logging.getLogger(__name__)


def _interleave_packets(px, py, n_shards: int):
    """Round-robin PACKET→shard permutation (shard s takes packets
    s, s+S, 2S+s, ...): per-shard path cost varies across screen regions
    (light pool vs bunny) and the frame ends at the SLOWEST shard; striding equalizes the mix
    statistically with ZERO collectives. Pixel-keyed RNG keeps the image
    bit-identical (tests/test_sharding.py::test_interleave_permutation_*).

    Returns (px, py, unperm) — unperm is None when the packet count is
    not a multiple of the shard count (contiguous fallback, logged)."""
    import numpy as np

    g = px.shape[0] // 1024
    if g % n_shards:
        _log.info(
            "packet interleave disabled: %d packets not divisible by %d "
            "shards (contiguous assignment)", g, n_shards)
        return px, py, None
    perm = np.concatenate(
        [np.arange(s, g, n_shards) for s in range(n_shards)])
    lanes = (perm[:, None] * 1024 + np.arange(1024)[None, :]).reshape(-1)
    unperm = np.empty_like(lanes)
    unperm[lanes] = np.arange(lanes.size)
    return px[lanes], py[lanes], unperm


def make_mesh(devices=None, axis_name: str = RAY_AXIS) -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(devices, (axis_name,))


def _padded_pixel_grid(cfg: RenderConfig, n_shards: int):
    """Full-image pixel ids (row 0 = top), padded to a multiple of the
    shard count. Padding pixels recompute pixel (0,0); they are sliced
    off after the gather."""
    import numpy as np

    n = cfg.width * cfg.height
    pad = (-n) % n_shards
    xs = np.tile(np.arange(cfg.width, dtype=np.int32), cfg.height)
    ys = np.repeat(np.arange(cfg.height - 1, -1, -1, dtype=np.int32), cfg.width)
    px = np.concatenate([xs, np.zeros(pad, np.int32)])
    py = np.concatenate([ys, np.zeros(pad, np.int32)])
    return jnp.asarray(px), jnp.asarray(py), n


@partial(jax.jit, static_argnames=("cfg", "mesh", "spp"))
def _render_sharded(scene, cam, px, py, cfg, key, mesh, spp):
    def local_render(scene, cam, px, py, key):
        # RNG is pixel-keyed (utils/rng.py), so shards need no
        # decorrelation — the sharded render is bit-identical to the
        # single-device render (tested in tests/test_sharding.py).
        return render_pixels(scene, cam, px, py, cfg, key, spp=spp)

    return shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )(scene, cam, px, py, key)


def render_image_sharded(
    scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    key: jax.Array,
    mesh: Mesh | None = None,
    spp: int | None = None,
) -> jnp.ndarray:
    """Full-image render with the pixel axis sharded over the mesh.
    Forward is collective-free; each device renders its pixel block."""
    mesh = make_mesh() if mesh is None else mesh
    n_shards = mesh.devices.size
    px, py, n = _padded_pixel_grid(cfg, n_shards)
    rgb = _render_sharded(scene, cam, px, py, cfg, key, mesh, spp or cfg.spp)
    return rgb[:n].reshape(cfg.height, cfg.width, 3)


@partial(jax.jit, static_argnames=("cfg", "mesh", "spp"))
def _render_sharded_wavefront(scene, cam, px, py, cfg, key, mesh, spp):
    from raytracer_tpu.models.wavefront import render_pixels_wavefront

    def local_render(scene, cam, px, py, key):
        # Lane-local integrator: each device runs its own while_loop over
        # its pixel block with zero collectives; pixel-keyed RNG makes
        # the result identical to the single-device wavefront
        # (tests/test_sharding.py::test_sharded_wavefront_matches).
        return render_pixels_wavefront(scene, cam, px, py, cfg, key, spp=spp)

    return shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )(scene, cam, px, py, key)


def render_image_wavefront_sharded(
    scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    key: jax.Array,
    mesh: Mesh | None = None,
    spp: int | None = None,
    interleave: bool = True,
) -> jnp.ndarray:
    """Full-image render with the PERF integrator (lane-stable wavefront,
    models/wavefront.py) sharded over the mesh — the path the 2K/2000spp
    multi-host workload (BASELINE config 5) actually runs. Lanes are in
    8x128 screen-tile order (compact 1024-lane packets per shard); the tile
    count is a multiple of 1024 so any power-of-two shard count divides
    it evenly with whole tiles per shard.

    `interleave` assigns PACKETS to shards round-robin (shard s takes
    packets s, s+S, 2S+s, ...) instead of contiguous screen blocks:
    per-shard path cost varies across screen regions
    (light pool vs bunny), and the frame ends
    at the SLOWEST shard. Striding equalizes the mix statistically with
    ZERO collectives; pixel-keyed RNG keeps the image bit-identical
    (tests/test_sharding.py)."""
    from raytracer_tpu.models.wavefront import _tiled_pixel_grid

    mesh = make_mesh() if mesh is None else mesh
    n_shards = mesh.devices.size
    px, py, inv = _tiled_pixel_grid(cfg)
    if px.shape[0] % n_shards:
        raise ValueError(
            f"tile-lane count {px.shape[0]} not divisible by mesh size "
            f"{n_shards}")
    unperm = None
    if interleave:
        px, py, unperm = _interleave_packets(px, py, n_shards)
    rgb = _render_sharded_wavefront(scene, cam, px, py, cfg, key, mesh,
                                    spp or cfg.spp)
    if unperm is not None:
        rgb = rgb[unperm]
    return rgb[inv].reshape(cfg.height, cfg.width, 3)


@partial(jax.jit, static_argnames=("cfg", "mesh", "spp", "rebalance_div",
                                   "report_iters"))
def _render_sharded_wavefront_rebalanced(scene, cam, px, py, cfg, key, mesh,
                                         spp, rebalance_div, report_iters):
    from raytracer_tpu.models.wavefront import (
        render_pixels_wavefront_rebalanced)

    n_shards = mesh.devices.size

    def local_render(scene, cam, px, py, key):
        return render_pixels_wavefront_rebalanced(
            scene, cam, px, py, cfg, key, RAY_AXIS, n_shards, spp=spp,
            rebalance_div=rebalance_div, report_iters=report_iters)

    return shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=(P(RAY_AXIS), P(RAY_AXIS)) if report_iters else P(RAY_AXIS),
        check_vma=False,
    )(scene, cam, px, py, key)


def render_image_wavefront_rebalanced(
    scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    key: jax.Array,
    mesh: Mesh | None = None,
    spp: int | None = None,
    interleave: bool = True,
    rebalance_div: int = 8,
    report_iters: bool = False,
):
    """Sharded wavefront render with the CROSS-SHARD DRAIN REBALANCE
    (models/wavefront.render_pixels_wavefront_rebalanced): once the
    per-shard tails shrink, pending lanes are pooled over the mesh and
    re-striped so every shard drains an equal mix. Bit-identical per
    pixel to the unbalanced render (pixel-keyed RNG; running-total acc
    migration). With report_iters=True also returns the per-shard
    post-rebalance drain iteration counts i32[n_shards] — max/mean of
    which is the balance metric."""
    from raytracer_tpu.models.wavefront import _tiled_pixel_grid

    mesh = make_mesh() if mesh is None else mesh
    n_shards = mesh.devices.size
    px, py, inv = _tiled_pixel_grid(cfg)
    if px.shape[0] % n_shards:
        raise ValueError(
            f"tile-lane count {px.shape[0]} not divisible by mesh size "
            f"{n_shards}")
    unperm = None
    if interleave:
        px, py, unperm = _interleave_packets(px, py, n_shards)
    out = _render_sharded_wavefront_rebalanced(
        scene, cam, px, py, cfg, key, mesh, spp or cfg.spp, rebalance_div,
        report_iters)
    rgb, iters = out if report_iters else (out, None)
    if unperm is not None:
        rgb = rgb[unperm]
    img = rgb[inv].reshape(cfg.height, cfg.width, 3)
    return (img, iters) if report_iters else img


@partial(jax.jit, static_argnames=("cfg", "mesh", "spp"))
def _render_sharded_fused(scene, cam, px, py, cfg, key, mesh, spp):
    from raytracer_tpu.ops.fused_kernel import render_tiles_fused

    def local_render(scene, cam, px, py, key):
        # One fused-kernel dispatch per shard, zero collectives;
        # ktf RNG is (pixel, sample, bounce)-keyed so the sharded image
        # equals the single-device fused render exactly.
        return render_tiles_fused(scene, cam, cfg, key, px, py, spp=spp)

    return shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )(scene, cam, px, py, key)


def render_image_fused_sharded(
    scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    key: jax.Array,
    mesh: Mesh | None = None,
    spp: int | None = None,
    interleave: bool = True,
) -> jnp.ndarray:
    """Full-image render with the PRODUCTION integrator — the fused
    path-loop kernel (ops/fused_kernel.py, one dispatch per shard per
    frame) — sharded over the mesh. Packets of 1024 lanes are
    round-robin interleaved across shards like the sharded wavefront;
    each shard must receive a whole number of packets."""
    from raytracer_tpu.models.fused import _fused_pixel_grid
    from raytracer_tpu.ops.fused_kernel import fused_megakernel_available

    mesh = make_mesh() if mesh is None else mesh
    n_shards = mesh.devices.size
    px, py, inv = _fused_pixel_grid(cfg)
    g = px.shape[0] // 1024
    if g % n_shards:
        raise ValueError(
            f"packet count {g} not divisible by mesh size {n_shards}")
    if not fused_megakernel_available(scene):
        raise ValueError("scene unsupported by the fused kernel "
                         "(see ops/fused_kernel.py)")
    unperm = None
    if interleave:
        px, py, unperm = _interleave_packets(px, py, n_shards)
    rgb = _render_sharded_fused(scene, cam, px, py, cfg, key, mesh,
                                spp or cfg.spp)
    if unperm is not None:
        rgb = rgb[unperm]
    return rgb[inv].reshape(cfg.height, cfg.width, 3)


SPP_AXIS = "spp"


def make_mesh_2d(n_ray_shards: int, n_spp_shards: int, devices=None) -> Mesh:
    """2D (rays × spp) mesh: pixels shard over `rays`, the sample budget
    splits over `spp` (SURVEY §2.2 'sample parallelism' — the parallel
    form of the reference's serial per-thread spp loop,
    CUDAKernels.h:158-162)."""
    import numpy as np

    devices = jax.devices() if devices is None else devices
    need = n_ray_shards * n_spp_shards
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:need]).reshape(n_ray_shards, n_spp_shards),
                (RAY_AXIS, SPP_AXIS))


@partial(jax.jit, static_argnames=("cfg", "mesh", "spp", "integrator"))
def _render_sharded_2d(scene, cam, px, py, cfg, key, mesh, spp, integrator):
    n_spp_shards = mesh.shape[SPP_AXIS]
    shard_spp = spp // n_spp_shards

    def local_render(scene, cam, px, py, key):
        # Each spp-shard renders its own contiguous sample window —
        # RNG is (pixel, sample)-keyed, so window j draws exactly the
        # samples [j*shard_spp, (j+1)*shard_spp) of the single-device
        # pass — and the mean rides a psum (the only collective).
        j = jax.lax.axis_index(SPP_AXIS)
        offset = (j * shard_spp).astype(jnp.int32)
        if integrator == "wavefront":
            from raytracer_tpu.models.wavefront import render_pixels_wavefront

            rgb = render_pixels_wavefront(scene, cam, px, py, cfg, key,
                                          spp=shard_spp, sample_offset=offset)
        else:
            rgb = render_pixels(scene, cam, px, py, cfg, key,
                                spp=shard_spp, sample_offset=offset)
        return jax.lax.pmean(rgb, SPP_AXIS)

    return shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )(scene, cam, px, py, key)


def render_image_sharded_2d(
    scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    key: jax.Array,
    mesh: Mesh,
    spp: int | None = None,
    integrator: str = "megakernel",
) -> jnp.ndarray:
    """Full-image render over a 2D (rays × spp) mesh: pixel blocks shard
    over the `rays` axis, the sample budget splits into contiguous
    windows over the `spp` axis, and the per-window means are pmean'd.
    Equal to the 1D-sharded and single-device renders up to fp summation
    order (same per-(pixel,sample) draws; tests/test_sharding.py).

    `spp` must divide evenly by the spp-axis size (SPMD shards run one
    static program; pad the sample budget if needed)."""
    spp = cfg.spp if spp is None else spp
    n_spp_shards = mesh.shape[SPP_AXIS]
    if spp % n_spp_shards:
        raise ValueError(f"spp={spp} not divisible by spp-axis size {n_spp_shards}")
    n_ray_shards = mesh.shape[RAY_AXIS]
    if integrator == "wavefront":
        from raytracer_tpu.models.wavefront import _tiled_pixel_grid

        px, py, inv = _tiled_pixel_grid(cfg)
        if px.shape[0] % n_ray_shards:
            raise ValueError(
                f"tile-lane count {px.shape[0]} not divisible by ray-axis "
                f"size {n_ray_shards}")
        rgb = _render_sharded_2d(scene, cam, px, py, cfg, key, mesh, spp,
                                 "wavefront")
        return rgb[inv].reshape(cfg.height, cfg.width, 3)
    px, py, n = _padded_pixel_grid(cfg, n_ray_shards)
    rgb = _render_sharded_2d(scene, cam, px, py, cfg, key, mesh, spp,
                             "megakernel")
    return rgb[:n].reshape(cfg.height, cfg.width, 3)


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Place scene params replicated on every device (the analog of the
    reference's scene upload; here it is an explicit sharding)."""
    spec = NamedSharding(mesh, P())
    return jax.device_put(scene, spec)
