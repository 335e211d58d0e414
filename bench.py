"""Benchmark harness.

Prints ONE JSON line:
  {"metric": "camera_rays_per_sec_per_chip", "value": N, "unit": "rays/s",
   "vs_baseline": R, "device": {...}, "card": "<name>, <power limit>", ...}

Workload: the reference's headline scene — Cornell box + bunny-scale
mesh (~82k tris) at 2K (2560×1440), camera INSIDE the box matching the
reference's published screenshot, 8 spp, 20 bounces — rendered by the
production backend of the platform (raytracer_tpu/backends.py): on the
GPU, the fused path-loop CUDA kernel (ops/fused_kernel.py). vs_baseline
is against the 25 M rays/s midpoint of the reference's estimate
(README.md:11: 2K/2000spp "takes several minutes" on an RTX 3050 Ti ⇒
~12-41 M camera rays/s; BASELINE.md).

Before any timing, a small pre-flight frame must match its committed
CPU-exact mean (assets/expected_preflight.json), and the timed frame's
mean must stay in a band around it. It exits non-zero without a GPU, on a
failed check, or when any run fails; nothing is retried or caught.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BASELINE_RAYS_PER_SEC = 25.0e6  # BASELINE.md derived midpoint (12-41 M)
EXPECTED_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "assets", "expected_preflight.json")
PREFLIGHT_RTOL = 0.02   # identical RNG streams; float rounding only
FULL_BAND = 0.15        # full frame vs preflight mean (resolution shift)
EXIT_CORRECTNESS = 3
WIDTH, HEIGHT, SPP, BOUNCES = 2560, 1440, 8, 20
TIMED_RUNS = 4


def main() -> int:
    from raytracer_tpu.utils import jaxcache

    jaxcache.enable()

    import jax

    from raytracer_tpu.camera import showcase_camera
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.models.fused import render_image_fused
    from raytracer_tpu.scene.builder import reference_scene

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"# bench: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    scene = reference_scene(assets_dir="assets/models", build_bvh=True)

    with open(EXPECTED_FILE) as f:
        expected = json.load(f)
    p = expected["config"]
    pf_cfg = RenderConfig(width=p["width"], height=p["height"], spp=p["spp"],
                          max_bounces=p["max_bounces"], rng_impl="ktf")
    pf_mean = float(render_image_fused(scene, showcase_camera(pf_cfg), pf_cfg,
                                       jax.random.key(0)).mean())
    exp_mean = float(expected["mean_rgb_ktf"])
    rel = abs(pf_mean - exp_mean) / exp_mean
    print(f"# preflight mean_rgb={pf_mean:.6f} expected={exp_mean:.6f} "
          f"rel={rel:.4f}", file=sys.stderr, flush=True)
    if rel > PREFLIGHT_RTOL:
        print(f"# CORRECTNESS FAILURE: preflight radiance off by {rel:.1%}",
              file=sys.stderr)
        return EXIT_CORRECTNESS

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=BOUNCES,
                       rng_impl="ktf")
    cam = showcase_camera(cfg)
    float(render_image_fused(scene, cam, cfg, jax.random.key(0)).mean())  # compile
    times = []
    for i in range(1, TIMED_RUNS + 1):
        t0 = time.perf_counter()
        m = float(render_image_fused(scene, cam, cfg, jax.random.key(i)).mean())
        times.append(time.perf_counter() - t0)

    full_rel = abs(m - exp_mean) / exp_mean
    if full_rel > FULL_BAND:
        print(f"# CORRECTNESS FAILURE: full-frame mean {m:.4f} deviates "
              f"{full_rel:.1%} from expected {exp_mean:.4f}", file=sys.stderr)
        return EXIT_CORRECTNESS

    dt = min(times)
    rays_per_sec = WIDTH * HEIGHT * SPP / dt
    print(f"# {WIDTH}x{HEIGHT} spp={SPP} bounces={BOUNCES} best={dt:.3f}s "
          f"times={['%.3f' % t for t in times]} mean_rgb={m:.4f} on {card}",
          file=sys.stderr)
    print(json.dumps({
        "metric": "camera_rays_per_sec_per_chip",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 4),
        "backend": "fused",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "mean_rgb": round(m, 5),
        "preflight_rel_err": round(rel, 5),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
