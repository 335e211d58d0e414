"""Command-line driver — the analog of the reference's app entry + frame
orchestration (EntryPoint.cu:14-42, Raytracer.h:52-71).

There is no interactive SFML window on a headless accelerator host
(WindowManager.h is presentation-only); instead renders go to PNG/NPY,
with resumable sample accumulation for long HQ renders (the reference's
F-key "high quality mode", Core/Camera.cuh:52-65, becomes --spp).

Usage:
    python -m raytracer_tpu.cli --preset cornell_spheres_256 --out img.png
    python -m raytracer_tpu.cli --scene cornell_bunny --width 2560 \
        --height 1440 --spp 2000 --checkpoint ckpt.npz
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import numpy as np


def build_scene(name: str, assets_dir: str):
    from raytracer_tpu.scene import builder

    if name == "cornell_spheres":
        return builder.cornell_spheres_scene()
    if name == "cornell_materials":
        s = builder.cornell_materials_scene(assets_dir)
        return s.replace(bvh4=builder.build_scene_bvh4(s.mesh))
    if name == "cornell_bunny":
        return builder.reference_scene(assets_dir, with_bunny=True, build_bvh=True)
    if name == "cornell":
        return builder.reference_scene(assets_dir, with_bunny=False, build_bvh=True)
    raise SystemExit(f"unknown scene '{name}'")


def main(argv=None):
    """Render as the arguments say; returns (linear f32[H,W,3], seconds)."""
    from raytracer_tpu.utils import jaxcache

    jaxcache.enable()

    from raytracer_tpu.camera import make_camera
    from raytracer_tpu.config import PRESETS, RenderConfig

    ap = argparse.ArgumentParser(description="JAX path tracer")
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--scene", default="cornell_bunny",
                    choices=["cornell_spheres", "cornell_materials", "cornell", "cornell_bunny"])
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--max-bounces", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--npy", default=None, help="also dump linear f32 image")
    ap.add_argument("--assets", default="assets/models")
    ap.add_argument("--integrator", choices=["wavefront", "megakernel", "fused"],
                    default="wavefront",
                    help="'fused' = whole path loop in one native kernel "
                         "(ops/fused_kernel.py; requires a bvh4 scene)")
    ap.add_argument("--checkpoint", default=None,
                    help="npz accumulation checkpoint for resumable renders")
    ap.add_argument("--camera", default="showcase", choices=["showcase", "reference"],
                    help="'reference' reproduces the CUDA program's initial pose "
                         "(EntryPoint.cu:16-20, Raytracer.h:79-84)")
    ap.add_argument("--sharded", action="store_true", help="shard pixels over all devices")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler device trace to DIR (TensorBoard)")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live auto-refreshing preview at PORT while rendering")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset] if args.preset else RenderConfig(
        width=1024, height=576, spp=64, max_bounces=20)
    overrides = {}
    for field in ("width", "height", "spp"):
        if getattr(args, field) is not None:
            overrides[field] = getattr(args, field)
    if args.max_bounces is not None:
        overrides["max_bounces"] = args.max_bounces
    if overrides:
        cfg = cfg.replace(**overrides)

    scene = build_scene(args.scene, args.assets)
    if args.camera == "reference":
        cam = make_camera(aspect_ratio=cfg.aspect_ratio, fov_degrees=cfg.fov_degrees,
                          aperture=cfg.aperture)
    else:
        from raytracer_tpu.camera import showcase_camera

        cam = showcase_camera(cfg)

    key = jax.random.key(args.seed)
    import contextlib

    from raytracer_tpu.utils.profiling import Meter, log_metrics, trace

    prof = trace(args.profile) if args.profile else contextlib.nullcontext()
    if args.serve is not None:
        import os as _os

        from raytracer_tpu import viewer

        _os.makedirs("preview", exist_ok=True)
        viewer.serve("preview", port=args.serve)
        with prof, Meter(cfg.width, cfg.height, cfg.spp) as meter:
            linear = viewer.progressive_render(scene, cam, cfg, key,
                                               out_path="preview/preview.png")
        log_metrics("render", rays_per_sec=meter.rays_per_sec, seconds=meter.elapsed)
        _write_outputs(args, cfg, linear, meter.elapsed)
        return linear, meter.elapsed

    t0 = time.perf_counter()
    if args.checkpoint:
        from raytracer_tpu.io.checkpoint import render_image_resumable

        linear = render_image_resumable(scene, cam, cfg, key, args.checkpoint,
                                        integrator=args.integrator)
    elif args.sharded:
        from raytracer_tpu.parallel.sharding import render_image_sharded

        linear = render_image_sharded(scene, cam, cfg, key)
    elif args.integrator == "fused":
        from raytracer_tpu.models.fused import render_image_fused
        from raytracer_tpu.ops.fused_kernel import fused_megakernel_available

        if not fused_megakernel_available(scene):
            raise SystemExit("--integrator fused needs a bvh4 scene "
                             "(use cornell_bunny / cornell_materials)")
        linear = render_image_fused(scene, cam, cfg.replace(rng_impl="ktf"), key)
    elif args.integrator == "wavefront":
        from raytracer_tpu.models.wavefront import render_image_wavefront

        linear = render_image_wavefront(scene, cam, cfg, key)
    else:
        from raytracer_tpu.render import render_image_chunked

        linear = render_image_chunked(scene, cam, cfg, key)
    linear.block_until_ready()
    dt = time.perf_counter() - t0
    _write_outputs(args, cfg, linear, dt)
    return linear, dt


def _write_outputs(args, cfg, linear, dt):
    from raytracer_tpu.render import tone_map_image
    from raytracer_tpu.utils.image import write_npy, write_png

    rays = cfg.width * cfg.height * cfg.spp
    print(f"{cfg.width}x{cfg.height} spp={cfg.spp} in {dt:.2f}s "
          f"({rays / dt / 1e6:.2f} M camera rays/s)", file=sys.stderr)
    rgba = np.asarray(tone_map_image(linear))
    write_png(args.out, rgba)
    if args.npy:
        write_npy(args.npy, linear)
    print(args.out)


if __name__ == "__main__":
    main()
