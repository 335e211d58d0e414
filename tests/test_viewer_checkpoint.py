import os

import jax
import numpy as np
import pytest

from raytracer_tpu.camera import make_camera
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.io.checkpoint import (
    load_train_state,
    render_image_resumable,
    save_train_state,
)
from raytracer_tpu.render import render_image
from raytracer_tpu.scene.builder import cornell_spheres_scene
from raytracer_tpu.viewer import progressive_render


@pytest.fixture(scope="module")
def scene():
    return cornell_spheres_scene()


def _cam(cfg):
    return make_camera(aspect_ratio=cfg.width / cfg.height, fov_degrees=cfg.fov_degrees,
                       aperture=cfg.aperture)


def test_resumable_render_matches_direct(scene, tmp_path):
    cfg = RenderConfig(width=16, height=8, spp=8, max_bounces=3, spp_per_pass=4)
    key = jax.random.key(3)
    ckpt = os.path.join(tmp_path, "ck.npz")
    a = np.asarray(render_image_resumable(scene, _cam(cfg), cfg, key, ckpt))
    b = np.asarray(render_image(scene, _cam(cfg), cfg, key))
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-5)
    # Checkpoint says complete; a re-run resumes instantly with same result.
    with np.load(ckpt) as z:
        assert int(z["spp_done"]) == 8
    a2 = np.asarray(render_image_resumable(scene, _cam(cfg), cfg, key, ckpt))
    np.testing.assert_allclose(a2, a, atol=1e-7)


def test_resume_rejects_rng_stream_mismatch(scene, tmp_path):
    """A checkpoint written under one RNG stream must NOT be resumed by
    an integrator drawing a different stream: mixing
    ktf-counter and jax.random samples in one accumulator silently
    breaks the resumed==uninterrupted invariant. The mismatched resume
    restarts the accumulation instead."""
    cfg = RenderConfig(width=16, height=8, spp=4, max_bounces=3,
                       spp_per_pass=2)
    key = jax.random.key(3)
    ckpt = os.path.join(tmp_path, "ck_stream.npz")
    # Write a PARTIAL wavefront ("jax"-stream) checkpoint.
    from raytracer_tpu.render import iter_spp_accumulation

    it = iter_spp_accumulation(scene, _cam(cfg), cfg, key,
                               integrator="wavefront", spp_per_batch=2)
    done, batch = next(it)
    from raytracer_tpu.io.checkpoint import _atomic_save, _key_hash

    _atomic_save(ckpt, acc=batch, spp_done=np.int64(done),
                 spp_total=np.int64(cfg.spp),
                 seed_hash=np.int64(_key_hash(key)),
                 rng_stream=np.str_("jax"))
    # Same header but resumed with a ktf-stream config: the stale
    # accumulator must be discarded — the result equals a fresh
    # ktf-stream render, not a jax/ktf mixture.
    cfg_ktf = cfg.replace(rng_impl="ktf")
    resumed = np.asarray(render_image_resumable(
        scene, _cam(cfg_ktf), cfg_ktf, key, ckpt))
    from raytracer_tpu.models.wavefront import render_image_wavefront

    fresh = np.asarray(render_image_wavefront(scene, _cam(cfg_ktf), cfg_ktf,
                                              key))
    np.testing.assert_allclose(resumed, fresh, atol=2e-5, rtol=1e-5)
    with np.load(ckpt) as z:
        assert str(z["rng_stream"]) == "ktf"


def test_resume_from_partial_checkpoint(scene, tmp_path):
    cfg = RenderConfig(width=8, height=8, spp=8, max_bounces=3, spp_per_pass=4)
    key = jax.random.key(9)
    ckpt = os.path.join(tmp_path, "partial.npz")
    # Simulate an interrupted run: only the first batch was written.
    from raytracer_tpu.render import render_rows

    first = np.asarray(render_rows(scene, _cam(cfg), cfg, 0, 8, 4, key, sample_offset=0))
    from raytracer_tpu.io.checkpoint import _atomic_save, _key_hash

    _atomic_save(ckpt, acc=first * 4, spp_done=np.int64(4), spp_total=np.int64(8),
                 seed_hash=np.int64(_key_hash(key)))
    resumed = np.asarray(render_image_resumable(scene, _cam(cfg), cfg, key, ckpt))
    direct = np.asarray(render_image(scene, _cam(cfg), cfg, key))
    np.testing.assert_allclose(resumed, direct, atol=2e-5, rtol=1e-5)


def test_progressive_render_writes_previews(scene, tmp_path):
    cfg = RenderConfig(width=8, height=8, spp=4, max_bounces=3)
    out = os.path.join(tmp_path, "prev.png")
    updates = []
    img = progressive_render(scene, _cam(cfg), cfg, jax.random.key(0), out_path=out,
                             spp_per_update=2, on_update=lambda d, p: updates.append(d))
    assert os.path.exists(out)
    assert updates == [2, 4]
    direct = np.asarray(render_image(scene, _cam(cfg), cfg, jax.random.key(0)))
    np.testing.assert_allclose(np.asarray(img), direct, atol=2e-5, rtol=1e-5)


def test_train_state_roundtrip(scene, tmp_path):
    from raytracer_tpu.diff import inverse

    params = inverse.init_params(scene)
    st = inverse.adam_init(params)
    path = os.path.join(tmp_path, "train.npz")
    save_train_state(path, params, st, extra={"loss": 0.5})
    p2, st2, extra = load_train_state(path)
    assert set(p2) == set(params)
    for k in params:
        np.testing.assert_array_equal(np.asarray(p2[k]), np.asarray(params[k]))
    assert float(extra["loss"]) == 0.5


def test_resumable_fused_matches_single_pass(tmp_path):
    """Fused-integrator resumable accumulation (absolute-sample-index
    keying) equals the one-dispatch fused render, including a resume
    from a partial checkpoint."""
    from raytracer_tpu.models.fused import render_image_fused
    from raytracer_tpu.ops.bvh import build_lbvh
    from raytracer_tpu.ops.bvh4 import build_bvh4
    from raytracer_tpu.scene.builder import cornell_materials_scene

    sc = cornell_materials_scene(assets_dir="assets/models")
    bvh = build_lbvh(sc.mesh)
    sc = sc.replace(bvh=bvh, bvh4=build_bvh4(sc.mesh, bvh))
    cfg = RenderConfig(width=128, height=8, spp=4, max_bounces=3,
                       spp_per_pass=2, rng_impl="ktf")
    cam = make_camera(aspect_ratio=cfg.width / cfg.height,
                      fov_degrees=cfg.fov_degrees, aperture=cfg.aperture,
                      position=(0.0, 0.05, 0.29), pitch=-5.0)
    key = jax.random.key(3)
    direct = np.asarray(render_image_fused(sc, cam, cfg, key))
    ck = os.path.join(tmp_path, "fused.npz")
    resumed = np.asarray(render_image_resumable(sc, cam, cfg, key, ck,
                                                integrator="fused"))
    np.testing.assert_allclose(resumed, direct, atol=2e-6, rtol=1e-6)
