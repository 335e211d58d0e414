"""Generate assets/expected_preflight.json — the CPU-exact mean radiance
of the pre-flight frame (the known-answer correctness gate that bench.py
and chip_smoke.py check on the card before anything else).

Runs the XLA wavefront integrator on the CPU; the traversal backends and
the fused kernel are equivalence-tested against it, so one expected value
gates every backend.

Usage: python scripts/make_expected_preflight.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")


PREFLIGHT = dict(width=128, height=40, spp=2, max_bounces=12)


def main():
    import bench

    from raytracer_tpu.camera import showcase_camera
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.models.wavefront import render_image_wavefront
    from raytracer_tpu.scene.builder import reference_scene

    p = PREFLIGHT
    cfg = RenderConfig(width=p["width"], height=p["height"], spp=p["spp"],
                       max_bounces=p["max_bounces"], spp_per_pass=p["spp"])
    scene = reference_scene(assets_dir="assets/models", build_bvh=True)
    cam = showcase_camera(cfg)
    img = render_image_wavefront(scene, cam, cfg, jax.random.key(0))
    mean = float(img.mean())
    # Same frame under the kernel-portable counter RNG (utils/ktf.py) —
    # the stream the fused path-loop kernel draws from. A different
    # RNG stream shifts the Monte-Carlo mean slightly, so the fused
    # backend gates against this value instead.
    img_ktf = render_image_wavefront(scene, cam, cfg.replace(rng_impl="ktf"),
                                     jax.random.key(0))
    mean_ktf = float(img_ktf.mean())
    out = {"mean_rgb": mean, "mean_rgb_ktf": mean_ktf, "config": p,
           "note": "CPU-exact preflight mean for the correctness gate of "
                   "bench.py and chip_smoke.py; "
                   "regenerate with scripts/make_expected_preflight.py after "
                   "any semantic change to the integrator/scene/camera."}
    with open(bench.EXPECTED_FILE, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {bench.EXPECTED_FILE}: mean_rgb={mean:.6f} mean_rgb_ktf={mean_ktf:.6f}")


if __name__ == "__main__":
    main()
