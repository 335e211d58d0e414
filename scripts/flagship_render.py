"""Render the flagship artifact: the reference's headline workload —
2K (2560x1440) Cornell box + bunny, interior showcase camera, 20-bounce
paths — at high spp through the fused path-loop kernel via the
resumable checkpoint driver (16-spp batches, atomic npz accumulator; an
interrupted run loses at most one batch — rerun to resume).

Matches /root/reference/Screenshots/Cornell-box-with-bunny.jpg +
README.md:11-12 ("high quality mode ... 2000 samples per pixel").

Usage: python scripts/flagship_render.py [spp] [out_png] [ckpt]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from raytracer_tpu.utils import jaxcache

jaxcache.enable()

import jax
import numpy as np

from raytracer_tpu.camera import showcase_camera
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.io.checkpoint import render_image_resumable
from raytracer_tpu.scene.builder import reference_scene


def main():
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    out = sys.argv[2] if len(sys.argv) > 2 else "assets/showcase_2k.png"
    ckpt = sys.argv[3] if len(sys.argv) > 3 else "renders/flagship_ckpt.npz"
    os.makedirs("renders", exist_ok=True)
    cfg = RenderConfig(width=2560, height=1440, spp=spp, max_bounces=20,
                       spp_per_pass=16, rng_impl="ktf")
    scene = reference_scene(assets_dir="assets/models", build_bvh=True)
    jax.block_until_ready(scene.bvh4.bounds)
    cam = showcase_camera(cfg)

    t0 = time.perf_counter()
    linear = np.asarray(render_image_resumable(
        scene, cam, cfg, jax.random.key(0), ckpt, integrator="fused"))
    wall = time.perf_counter() - t0

    from raytracer_tpu.ops.tonemap import to_rgba8
    import jax.numpy as jnp

    rgba = np.asarray(to_rgba8(jnp.asarray(linear)))
    try:
        from PIL import Image

        Image.fromarray(rgba, "RGBA").convert("RGB").save(out)
    except Exception:
        import zlib, struct

        # minimal PNG writer fallback
        raw = b"".join(b"\x00" + rgba[y, :, :3].tobytes()
                       for y in range(rgba.shape[0]))
        def chunk(t, d):
            c = t + d
            return struct.pack(">I", len(d)) + c + struct.pack(
                ">I", zlib.crc32(c) & 0xFFFFFFFF)
        png = (b"\x89PNG\r\n\x1a\n"
               + chunk(b"IHDR", struct.pack(">IIBBBBB", rgba.shape[1],
                                            rgba.shape[0], 8, 2, 0, 0, 0))
               + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
        open(out, "wb").write(png)

    stats = {
        "artifact": out,
        "width": cfg.width, "height": cfg.height, "spp": spp,
        "max_bounces": cfg.max_bounces,
        "integrator": "fused (ops/fused_kernel.py)",
        "camera": "showcase (interior, matches reference screenshot)",
        "wall_s_this_run": round(wall, 1),
        "camera_rays": cfg.width * cfg.height * spp,
        "mean_rgb": round(float(linear.mean()), 5),
        "platform": jax.devices()[0].platform,
        "note": "resumable 16-spp batches via io/checkpoint.render_image_"
                "resumable; wall_s_this_run excludes any prior resumed "
                "batches",
    }
    with open(os.environ.get("FLAGSHIP_OUT", "renders/flagship.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
