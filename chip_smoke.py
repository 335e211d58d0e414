"""Proof that the path tracer runs on an NVIDIA GPU: one process, one card.

    python chip_smoke.py            # every one-card phase
    python chip_smoke.py --cards 4  # only the sharded phase, on 4 cards

Phases (one card):
  1. device   — the platform is `gpu`; prints the card and its power limit.
  2. build    — builds the native scene library and the CUDA kernel from
                source and the Cornell + bunny scene, timing each.
  3. kernel   — the fused CUDA kernel against the XLA wavefront on the same
                ktf keys at 2560x1440, 1 spp, 20 bounces (>= 99% of pixels
                within 1e-3, frame means within 1e-3 relative), the known-
                answer preflight frame against assets/expected_preflight.json
                (2%), and the card-only tests (pytest -m gpu).
  4. main     — the CLI in process at 2560x1440 / 8 spp / 20 bounces with
                --integrator fused and wavefront, and __graft_entry__.entry().
  5. gradient — three inverse-rendering train steps at the inverse_render
                preset's shape (finite, decreasing loss) and one
                finite-difference check of an albedo gradient.

Prints the card's name and power limit before the last line, and as the
last line one JSON object {"ok": true, "device": {...}}. Any failed phase
exits non-zero; without a GPU, or without the rest of the repository, it
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PIXEL_ATOL = 1e-3        # per-pixel agreement, kernel vs XLA wavefront
PIXEL_SHARE = 0.99       # share of pixels that must agree
MEAN_RTOL = 1e-3         # frame means, kernel vs XLA wavefront
EXPECTED_RTOL = 0.02     # preflight frame vs the committed CPU value
MAIN_RTOL = 0.02         # 8-spp main-path frames vs the 1-spp XLA frame
FULL = dict(width=2560, height=1440, max_bounces=20)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    """A failed check ends the run with a non-zero exit."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}")
    card = card_line()
    log(f"[device] kind={devs[0].device_kind} count={len(devs)} card={card}")
    return devs, card


def phase_build():
    from raytracer_tpu.ops import fused_kernel
    from raytracer_tpu.scene import native
    from raytracer_tpu.scene.builder import reference_scene

    t0 = time.perf_counter()
    native._load()
    t1 = time.perf_counter()
    fused_kernel.build("cuda")
    t2 = time.perf_counter()
    scene = reference_scene(assets_dir=os.path.join(ROOT, "assets", "models"),
                            build_bvh=True)
    scene.bvh4.bounds.block_until_ready()
    t3 = time.perf_counter()
    log(f"[build] scenekit {t1 - t0:.3f}s, CUDA kernel {t2 - t1:.3f}s, "
        f"Cornell+bunny scene {t3 - t2:.3f}s "
        f"({scene.mesh.faces.shape[0]} triangles, BVH width "
        f"{scene.bvh4.children.shape[1]}, {scene.bvh4.bounds.shape[0]} nodes)")
    return scene


def phase_kernel(scene):
    import jax
    import numpy as np

    from raytracer_tpu.camera import showcase_camera
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.models.fused import render_image_fused
    from raytracer_tpu.models.wavefront import render_image_wavefront

    cfg = RenderConfig(spp=1, rng_impl="ktf", **FULL)
    cam = showcase_camera(cfg)
    key = jax.random.key(0)
    with jax.default_matmul_precision("highest"):
        fused = np.asarray(render_image_fused(scene, cam, cfg, key))
        wave = np.asarray(render_image_wavefront(scene, cam, cfg, key))
    check(fused.shape == wave.shape == (cfg.height, cfg.width, 3), "frame shapes")
    check(np.isfinite(fused).all() and np.isfinite(wave).all(), "finite frames")
    agree = float((np.abs(fused - wave).max(axis=-1) <= PIXEL_ATOL).mean())
    rel = abs(float(fused.mean()) - float(wave.mean())) / float(wave.mean())
    log(f"[kernel] 2560x1440 1spp 20 bounces: pixels within {PIXEL_ATOL}: "
        f"{agree:.6f} (need {PIXEL_SHARE}); mean fused {fused.mean():.6f} "
        f"wavefront {wave.mean():.6f} rel {rel:.2e} (need {MEAN_RTOL})")
    check(agree >= PIXEL_SHARE and rel <= MEAN_RTOL, "kernel vs XLA wavefront")

    with open(os.path.join(ROOT, "assets", "expected_preflight.json")) as f:
        expected = json.load(f)
    p = expected["config"]
    pcfg = RenderConfig(width=p["width"], height=p["height"], spp=p["spp"],
                        max_bounces=p["max_bounces"], rng_impl="ktf")
    pf = float(render_image_fused(scene, showcase_camera(pcfg), pcfg, key).mean())
    prel = abs(pf - expected["mean_rgb_ktf"]) / expected["mean_rgb_ktf"]
    log(f"[kernel] preflight {p}: mean {pf:.6f} expected "
        f"{expected['mean_rgb_ktf']:.6f} rel {prel:.2e} (need {EXPECTED_RTOL})")
    check(prel <= EXPECTED_RTOL, "preflight known answer")

    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "--on-device", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    log(f"[kernel] card-only tests: pytest exit {int(rc)}")
    check(rc == 0, "card-only tests")
    return float(wave.mean())


def phase_main(ref_mean: float, card: str):
    import jax
    import numpy as np

    import __graft_entry__
    from raytracer_tpu import cli

    out_dir = os.path.join(ROOT, "renders")
    os.makedirs(out_dir, exist_ok=True)
    for integrator in ("fused", "wavefront"):
        for run in ("first (compile included)", "second"):
            linear, dt = cli.main([
                "--scene", "cornell_bunny", "--width", "2560", "--height", "1440",
                "--spp", "8", "--max-bounces", "20", "--integrator", integrator,
                "--assets", os.path.join(ROOT, "assets", "models"),
                "--out", os.path.join(out_dir, f"smoke_{integrator}.png")])
            img = np.asarray(linear)
            rel = abs(float(img.mean()) - ref_mean) / ref_mean
            log(f"[main] cli --integrator {integrator} 2560x1440 spp=8 "
                f"bounces=20 {run}: {dt:.3f}s mean {img.mean():.6f} "
                f"(rel {rel:.2e} to the 1-spp frame) on {card}")
            check(img.shape == (1440, 2560, 3) and np.isfinite(img).all(),
                  f"cli {integrator} frame shape and finiteness")
            check(rel <= MAIN_RTOL, f"cli {integrator} frame mean")

    fn, args = __graft_entry__.entry()
    t0 = time.perf_counter()
    out = np.asarray(jax.jit(fn)(*args))
    log(f"[main] __graft_entry__.entry(): shape {out.shape} mean "
        f"{out.mean():.6f} in {time.perf_counter() - t0:.3f}s (compile included)")
    check(np.isfinite(out).all() and out.ndim == 3 and out.mean() > 0,
          "__graft_entry__.entry() frame")


def phase_gradient(scene):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracer_tpu.camera import showcase_camera
    from raytracer_tpu.config import PRESETS
    from raytracer_tpu.diff import inverse
    from raytracer_tpu.render import render_image
    from raytracer_tpu.scene.types import Materials

    cfg = PRESETS["inverse_render"]
    cam = showcase_camera(cfg)
    key = jax.random.key(40)
    with jax.default_matmul_precision("highest"):
        target = render_image(scene, cam, cfg, key)
        params = inverse.init_params(scene, fields=("albedo", "emission"),
                                     key=jax.random.key(41), noise=0.15)
        state = inverse.adam_init(params)
        step = inverse.make_train_step(scene, cam, cfg, target, lr=0.03)
        losses = []
        for i in range(3):
            t0 = time.perf_counter()
            params, state, loss = step(params, state, key)
            losses.append(float(loss))
            log(f"[gradient] train step {i}: loss {losses[-1]:.6e} in "
                f"{time.perf_counter() - t0:.3f}s")
        check(all(np.isfinite(losses)) and losses[2] < losses[0],
              "finite, decreasing train loss")

        # Finite difference of the albedo entry with the largest gradient
        # (fixed key, so the paths stay fixed; tolerance of tests/test_grad.py).
        small = cfg.replace(width=32, height=32, spp=8)
        scam = showcase_camera(small)
        mats = scene.materials

        def loss_of(albedo):
            s = scene.replace(materials=Materials(
                type=mats.type, albedo=albedo, emission=mats.emission,
                roughness=mats.roughness, ior=mats.ior))
            return jnp.mean(render_image(s, scam, small, key))

        # One compiled program gives the gradient and the losses at +-h.
        value_and_grad = jax.jit(jax.value_and_grad(loss_of))
        grads = np.asarray(value_and_grad(mats.albedo)[1])
        m, c = np.unravel_index(np.argmax(np.abs(grads)), grads.shape)
        h = 1e-3
        up = float(value_and_grad(mats.albedo.at[m, c].add(h))[0])
        down = float(value_and_grad(mats.albedo.at[m, c].add(-h))[0])
        fd = (up - down) / (2 * h)
        log(f"[gradient] d mean / d albedo[{m},{c}]: autodiff {grads[m, c]:.6e} "
            f"finite difference {fd:.6e}")
        check(np.isfinite(grads).all(), "finite albedo gradient")
        check(np.isclose(grads[m, c], fd, rtol=0.08, atol=1e-5),
              "albedo gradient vs finite difference")


def phase_cards(n: int):
    """Sharded paths on a 1-D mesh of n devices, each against one device."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from raytracer_tpu.camera import showcase_camera
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.diff import inverse
    from raytracer_tpu.models.fused import render_image_fused
    from raytracer_tpu.parallel import sharding
    from raytracer_tpu.render import render_image
    from raytracer_tpu.scene.builder import reference_scene

    devs = jax.devices()[:n]
    check(len(devs) == n, f"need {n} devices, have {len(jax.devices())}")
    mesh = Mesh(np.asarray(devs), (sharding.RAY_AXIS,))
    scene = reference_scene(assets_dir=os.path.join(ROOT, "assets", "models"),
                            build_bvh=True)
    key = jax.random.key(3)

    def same(name, a, b):
        a, b = np.asarray(a), np.asarray(b)
        ok = a.shape == b.shape and np.isfinite(a).all() and np.array_equal(a, b)
        log(f"[cards] {name}: {n} devices vs one: bitwise equal={ok} "
            f"max|diff|={np.abs(a - b).max():.3e} mean {a.mean():.6f}")
        check(ok, name)

    cfg = RenderConfig(spp=1, rng_impl="ktf", **FULL)
    cam = showcase_camera(cfg)
    same("render_image_fused_sharded 2560x1440 1spp 20 bounces",
         sharding.render_image_fused_sharded(scene, cam, cfg, key, mesh=mesh),
         render_image_fused(scene, cam, cfg, key))

    # The XLA megakernel: XLA fuses (and so rounds) by shape, so a shard's
    # pixels are also rendered on one card at the shard's shape; against
    # the whole frame on one card a few paths may round apart and flip.
    small = RenderConfig(width=640, height=360, spp=2, max_bounces=8)
    scam = showcase_camera(small)
    single = np.asarray(render_image(scene, scam, small, key))
    one = Mesh(np.asarray(devs[:1]), (sharding.RAY_AXIS,))
    px, py, npix = sharding._padded_pixel_grid(small, n)
    m = px.shape[0] // n
    at_shard_shape = np.concatenate([np.asarray(sharding._render_sharded(
        scene, scam, px[i * m:(i + 1) * m], py[i * m:(i + 1) * m], small, key,
        one, small.spp)) for i in range(n)])[:npix].reshape(single.shape)

    def same_xla(name, a):
        a = np.asarray(a)
        bitwise = bool(np.array_equal(a, at_shard_shape))
        equal = float((a == single).all(axis=-1).mean())
        rel = abs(float(a.mean()) - float(single.mean())) / float(single.mean())
        log(f"[cards] {name}: {n} devices vs one card at the shard shape: "
            f"bitwise equal={bitwise}; vs one card's whole frame: "
            f"{equal:.6f} of pixels identical, max|diff| "
            f"{np.abs(a - single).max():.3e}, mean rel {rel:.2e}")
        check(np.isfinite(a).all() and (bitwise or (equal >= 0.999 and rel <= 1e-5)),
              name)

    same_xla("render_image_sharded 640x360 2spp 8 bounces",
             sharding.render_image_sharded(scene, scam, small, key, mesh=mesh))
    same_xla(f"render_image_sharded_2d ({n} rays x 1 spp) 640x360",
             sharding.render_image_sharded_2d(
                 scene, scam, small, key, mesh=sharding.make_mesh_2d(n, 1, devs)))

    # One Adam step: loss within 1e-3 (a flipped path moves one pixel's
    # error), parameters within 1e-5 (a step moves each by ~lr·sign(grad)).
    icfg = RenderConfig(width=128, height=128, spp=4, max_bounces=4)
    icam = showcase_camera(icfg)
    target = render_image(scene, icam, icfg, key)
    params = inverse.init_params(scene, fields=("albedo", "emission"),
                                 key=jax.random.key(2), noise=0.1)
    outs = []
    for mesh_or_none in (None, mesh):
        step = inverse.make_train_step(scene, icam, icfg, target,
                                       mesh=mesh_or_none, lr=0.03)
        p, _, loss = step(params, inverse.adam_init(params), key)
        outs.append((float(loss), p))
    (l1, p1), (ln, pn) = outs
    diffs = [float(np.abs(np.asarray(p1[k]) - np.asarray(pn[k])).max()) for k in p1]
    log(f"[cards] sharded train step: loss one {l1:.6e} {n} devices {ln:.6e}; "
        f"max|param diff| {max(diffs):.3e}")
    check(np.isclose(l1, ln, rtol=1e-3) and max(diffs) <= 1e-5,
          "sharded train step vs one device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the sharded phase on 4 cards")
    args = ap.parse_args(argv)
    try:
        import raytracer_tpu  # noqa: F401
    except ImportError:
        print("chip_smoke: the raytracer_tpu package is not beside this script",
              file=sys.stderr)
        return 1
    from raytracer_tpu.utils import jaxcache

    jaxcache.enable()
    devs, card = phase_device()
    if args.cards > 1:
        phase_cards(args.cards)
    else:
        scene = phase_build()
        ref_mean = phase_kernel(scene)
        phase_main(ref_mean, card)
        phase_gradient(scene)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
