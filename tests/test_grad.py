"""Gradient checks: VJP vs finite differences (SURVEY.md §4 item 3,
BASELINE "pixel-grad allclose pass").

The integrator's discrete decisions (hit selection, dielectric branch)
are detached, so gradients are exact for the *fixed-path* estimator:
finite differences with the SAME rng key agree with autodiff as long as
the perturbation doesn't flip a discrete decision — we use small eps and
loose rtol to stay in that regime.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.camera import make_camera
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.render import render_image
from raytracer_tpu.scene.builder import cornell_spheres_scene
from raytracer_tpu.scene.types import Materials


@pytest.fixture(scope="module")
def scene():
    return cornell_spheres_scene()


def _cam(cfg):
    return make_camera(aspect_ratio=cfg.width / cfg.height, fov_degrees=cfg.fov_degrees,
                       aperture=cfg.aperture)


def _loss_fn(scene, cfg, key):
    cam = _cam(cfg)

    def loss(albedo, emission, roughness):
        mats = Materials(
            type=scene.materials.type,
            albedo=albedo,
            emission=emission,
            roughness=roughness,
            ior=scene.materials.ior,
        )
        s = scene.replace(materials=mats)
        img = render_image(s, cam, cfg, key)
        return jnp.mean(img)

    return loss


def test_material_grads_match_finite_difference(scene):
    cfg = RenderConfig(width=12, height=12, spp=4, max_bounces=3)
    key = jax.random.key(17)
    loss = _loss_fn(scene, cfg, key)
    m = scene.materials
    args = (m.albedo, m.emission, m.roughness)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    assert all(bool(jnp.all(jnp.isfinite(g))) for g in grads)

    # Finite-difference spot checks on the most influential entries.
    checks = [
        (0, (0, 0)),  # ground albedo R
        (0, (2, 1)),  # red diffuse G
        (1, (5, 0)),  # light emission R
    ]
    for argi, idx in checks:
        eps = 1e-3
        g_ad = float(grads[argi][idx])
        perturbed = list(args)
        perturbed[argi] = args[argi].at[idx].add(eps)
        lp = float(loss(*perturbed))
        perturbed[argi] = args[argi].at[idx].add(-eps)
        lm = float(loss(*perturbed))
        g_fd = (lp - lm) / (2 * eps)
        assert np.isclose(g_ad, g_fd, rtol=0.08, atol=1e-5), (argi, idx, g_ad, g_fd)


def test_emission_gradient_is_positive_toward_brightness(scene):
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=3)
    loss = _loss_fn(scene, cfg, jax.random.key(3))
    m = scene.materials
    g_em = jax.grad(loss, argnums=1)(m.albedo, m.emission, m.roughness)
    # Brightening the light brightens the image.
    assert float(g_em[5].sum()) > 0.0


def test_camera_gradients_flow(scene):
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=3)
    key = jax.random.key(5)

    def loss(fov, position):
        cam = make_camera(
            aspect_ratio=1.0, fov_degrees=fov, aperture=cfg.aperture, position=position
        )
        return jnp.mean(render_image(scene, cam, cfg, key))

    g_fov, g_pos = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(80.0), jnp.asarray([0.0, 4.0, 4.0])
    )
    assert np.isfinite(float(g_fov))
    assert np.isfinite(np.asarray(g_pos)).all()
    assert (np.abs(np.asarray(g_pos)) > 0).any()


def test_inverse_rendering_recovers_albedo(scene):
    """BASELINE config[4] in miniature: perturb a diffuse albedo, optimize
    against the clean render, and verify the parameter moves back toward
    the truth (not merely that loss decreases)."""
    from raytracer_tpu.diff import inverse

    cfg = RenderConfig(width=32, height=16, spp=4, max_bounces=3)
    # Camera that actually frames the spheres (the reference default pose
    # looks over the scene; see PARITY.md item 7).
    cam = make_camera(aspect_ratio=2.0, fov_degrees=cfg.fov_degrees,
                      aperture=cfg.aperture, position=(0.0, 0.5, 1.6), pitch=-14.0)
    target = render_image(scene, cam, cfg, jax.random.key(77))

    true_albedo = np.asarray(scene.materials.albedo)
    params = {"albedo": scene.materials.albedo.at[2].set(
        jnp.asarray([0.2, 0.6, 0.6]))}  # red diffuse sphere → wrong color
    err0 = float(jnp.abs(params["albedo"][2] - true_albedo[2]).sum())

    state = inverse.adam_init(params)
    step = inverse.make_train_step(scene, cam, cfg, target, lr=0.08)
    # Fixed-noise matching: optimizing with the SAME rng key as the
    # target makes the true parameters an exact optimum (loss → 0),
    # standard practice for low-spp inverse rendering.
    for i in range(25):
        params, state, loss = step(params, state, jax.random.key(77))
    # Compare in EFFECTIVE parameter space: the renderer clips albedo to
    # [0,1] (diff/inverse._apply_params), so raw params may overshoot.
    eff = jnp.clip(params["albedo"][2], 0.0, 1.0)
    err1 = float(jnp.abs(eff - true_albedo[2]).sum())
    assert err1 < err0 * 0.45, (err0, err1, np.asarray(eff))


def _fd_check(loss, args, argi, idx, eps, rtol, atol=1e-5):
    grads = jax.grad(loss, argnums=argi)(*args)
    g_ad = float(grads[idx])
    perturbed = list(args)
    perturbed[argi] = args[argi].at[idx].add(eps)
    lp = float(loss(*perturbed))
    perturbed[argi] = args[argi].at[idx].add(-eps)
    lm = float(loss(*perturbed))
    g_fd = (lp - lm) / (2 * eps)
    assert np.isclose(g_ad, g_fd, rtol=rtol, atol=atol), (idx, g_ad, g_fd)
    return g_ad


def test_ior_gradient_matches_finite_difference(scene):
    """IOR gradients flow through the refracted direction
    (Core/Material.cuh:109-137 is the behavior whose parameter is being
    recovered); the discrete reflect/refract pick is detached, so small
    FD perturbations stay on the same branch."""
    cfg = RenderConfig(width=12, height=12, spp=8, max_bounces=4)
    key = jax.random.key(11)
    cam = make_camera(aspect_ratio=1.0, fov_degrees=cfg.fov_degrees,
                      aperture=cfg.aperture, position=(0.0, 0.5, 1.6), pitch=-14.0)

    def loss(ior):
        mats = Materials(
            type=scene.materials.type, albedo=scene.materials.albedo,
            emission=scene.materials.emission,
            roughness=scene.materials.roughness, ior=ior)
        return jnp.mean(render_image(scene.replace(materials=mats), cam, cfg, key))

    # Glass sphere is material 4 (cornell_spheres_scene).
    g = _fd_check(loss, (scene.materials.ior,), 0, (4,), eps=2e-3, rtol=0.1)
    assert g != 0.0  # the glass sphere is visible: ior must matter


def test_mesh_material_grads_match_finite_difference():
    """FD-vs-AD through the TRIANGLE-MESH shading path (BVH4 traversal,
    detached; gradients via shade_hit's differentiable recomputation)."""
    from raytracer_tpu.scene.builder import cornell_materials_scene, build_scene_bvh4

    scene = cornell_materials_scene()
    scene = scene.replace(bvh4=build_scene_bvh4(scene.mesh))
    cfg = RenderConfig(width=12, height=12, spp=4, max_bounces=3)
    key = jax.random.key(23)
    cam = make_camera(aspect_ratio=1.0, fov_degrees=cfg.fov_degrees,
                      aperture=cfg.aperture, position=(0.0, 0.05, 0.29), pitch=-5.0)

    def loss(albedo, emission):
        mats = Materials(
            type=scene.materials.type, albedo=albedo, emission=emission,
            roughness=scene.materials.roughness, ior=scene.materials.ior)
        return jnp.mean(render_image(scene.replace(materials=mats), cam, cfg, key))

    m = scene.materials
    args = (m.albedo, m.emission)
    # Wall albedo (mesh material 0 region) and the ceiling light emission.
    em_mat = int(np.argmax(np.asarray(m.emission).sum(axis=1)))
    _fd_check(loss, args, 0, (0, 0), eps=1e-3, rtol=0.08)
    g_em = _fd_check(loss, args, 1, (em_mat, 1), eps=1e-2, rtol=0.08)
    assert g_em > 0.0


def test_camera_param_grads_match_finite_difference(scene):
    """Camera fov/position FD-vs-AD (BASELINE north star names camera
    params; reference Camera.cuh:85-118 is the projective model).

    Framing: straight down at the giant ground sphere, so every pixel
    hits the same smooth surface — camera gradients are fixed-path
    (detached visibility): where an FD step flips WHICH primitive a
    pixel hits (e.g. across the horizon silhouette), AD deliberately
    reports only the shading term. Edge-aware visibility gradients are
    the documented research extension (ROADMAP item 4)."""
    cfg = RenderConfig(width=12, height=12, spp=4, max_bounces=3)
    key = jax.random.key(29)

    def loss(fov, position):
        cam = make_camera(aspect_ratio=1.0, fov_degrees=fov,
                          aperture=cfg.aperture, position=position, pitch=-85.0)
        return jnp.mean(render_image(scene, cam, cfg, key))

    fov0 = jnp.asarray(70.0)
    pos0 = jnp.asarray([0.0, 1.0, 0.0])
    g_fov, g_pos = jax.grad(loss, argnums=(0, 1))(fov0, pos0)

    eps = 5e-2
    fd_fov = (float(loss(fov0 + eps, pos0)) - float(loss(fov0 - eps, pos0))) / (2 * eps)
    assert np.isclose(float(g_fov), fd_fov, rtol=0.1, atol=1e-6), (float(g_fov), fd_fov)

    eps = 2e-3
    for axis in range(3):
        dp = jnp.zeros(3).at[axis].set(eps)
        fd = (float(loss(fov0, pos0 + dp)) - float(loss(fov0, pos0 - dp))) / (2 * eps)
        assert np.isclose(float(g_pos[axis]), fd, rtol=0.12, atol=2e-4), (
            axis, float(g_pos[axis]), fd)


def test_edge_aware_lights_forward_identical_and_roughness_grad():
    """The smoothed-boundary visibility term (cfg.edge_aware_lights,
    models/megakernel._edge_light_term) is a control variate: the
    FORWARD image must be bit-identical with the flag on or off, while
    metal ROUGHNESS — whose gradient is ~0 under pure detached
    visibility (it only moves detached scatter directions) — must pick
    up a nonzero gradient through the smoothed light boundary
    (BASELINE north star)."""
    from raytracer_tpu.scene.builder import cornell_materials_scene, build_scene_bvh4

    scene = cornell_materials_scene()
    scene = scene.replace(bvh4=build_scene_bvh4(scene.mesh))
    assert scene.light_rect is not None
    cfg_off = RenderConfig(width=24, height=24, spp=8, max_bounces=4,
                           reference_emission_quirk=False)
    cfg_on = cfg_off.replace(edge_aware_lights=True)
    key = jax.random.key(11)
    cam = make_camera(aspect_ratio=1.0, fov_degrees=cfg_off.fov_degrees,
                      aperture=cfg_off.aperture, position=(0.0, 0.05, 0.29),
                      pitch=-5.0)

    img_off = np.asarray(render_image(scene, cam, cfg_off, key))
    img_on = np.asarray(render_image(scene, cam, cfg_on, key))
    np.testing.assert_array_equal(img_off, img_on)

    def loss(rough, cfg):
        mats = Materials(
            type=scene.materials.type, albedo=scene.materials.albedo,
            emission=scene.materials.emission, roughness=rough,
            ior=scene.materials.ior)
        return jnp.mean(render_image(scene.replace(materials=mats), cam,
                                     cfg, key))

    m = scene.materials
    metal_ids = np.nonzero(np.asarray(m.type) == 1)[0]
    g_on = np.asarray(jax.grad(loss)(m.roughness, cfg_on))
    g_off = np.asarray(jax.grad(loss)(m.roughness, cfg_off))
    assert np.isfinite(g_on).all()
    # The edge term must contribute real signal on at least one metal.
    assert np.abs(g_on[metal_ids]).max() > 1e-5, g_on[metal_ids]
    assert np.abs(g_on[metal_ids]).max() > 3 * np.abs(g_off[metal_ids]).max()


def test_train_step_multi_reduces_loss(scene):
    """Averaged multi-pair training (diff/inverse.make_train_step_multi)
    with cosine lr: loss decreases on the matched-pair objective."""
    from raytracer_tpu.diff import inverse

    cfg = RenderConfig(width=16, height=8, spp=4, max_bounces=3,
                       reference_emission_quirk=False)
    cam = _cam(cfg)
    keys = jax.random.split(jax.random.key(3), 3)
    targets = jnp.stack([render_image(scene, cam, cfg, k) for k in keys])
    params = inverse.init_params(scene, fields=("albedo",),
                                 key=jax.random.key(2), noise=0.15)
    state = inverse.adam_init(params)
    step = inverse.make_train_step_multi(
        scene, cam, cfg, targets, keys, lr=0.05,
        lr_fn=inverse.cosine_lr(0.05, 12))
    losses = []
    for _ in range(12):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.6, losses


def test_joint_camera_pose_step_and_lr_scales(scene):
    """Round-5 joint pose+material machinery (diff/inverse._apply_cam,
    adam_update lr_scales): camera params in the SAME dict as material
    fields get gradients and move; a field with lr scale 0 must not
    move; loss decreases from a pose-perturbed init."""
    from raytracer_tpu.diff import inverse

    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=2,
                       reference_emission_quirk=False)
    cam = _cam(cfg)
    keys = jax.random.split(jax.random.key(5), 2)
    targets = jnp.stack([render_image(scene, cam, cfg, k) for k in keys])

    params = inverse.init_params(scene, fields=("albedo",),
                                 key=jax.random.key(6), noise=0.1)
    params["cam_yaw"] = cam.yaw + 1.5
    params["cam_pitch"] = cam.pitch - 1.0
    params["cam_position"] = cam.position + jnp.asarray([0.01, 0.0, -0.01])

    state = inverse.adam_init(params)
    step = inverse.make_train_step_multi(
        scene, cam, cfg, targets, keys, lr=0.02,
        lr_scales={"cam_yaw": 2.0, "cam_pitch": 0.0, "cam_position": 0.3})
    yaw0, pitch0 = float(params["cam_yaw"]), float(params["cam_pitch"])
    losses = []
    for _ in range(8):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    # At this toy resolution the pose landscape is rugged; assert descent
    # happens (best < first), not monotone convergence.
    assert min(losses) < losses[0], losses
    # lr scale 0 freezes the field exactly; scaled fields move.
    assert float(params["cam_pitch"]) == pitch0
    assert float(params["cam_yaw"]) != yaw0
    assert float(jnp.abs(params["cam_position"] - cam.position -
                         jnp.asarray([0.01, 0.0, -0.01])).max()) > 0


def test_accum_step_matches_multi(scene):
    """Chunked gradient accumulation (make_train_step_accum — the HBM
    workaround for K>8 pair batches: vmap(16) gradient graphs measured
    27.6 GB vs the chip's 15.75) must reproduce make_train_step_multi's
    trajectory exactly: equal chunks partition the pairs, so the mean
    of chunk-means equals the K-mean."""
    from raytracer_tpu.diff import inverse

    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=2,
                       reference_emission_quirk=False)
    cam = _cam(cfg)
    keys = jax.random.split(jax.random.key(5), 4)
    targets = jnp.stack([render_image(scene, cam, cfg, k) for k in keys])
    params = inverse.init_params(scene, fields=("albedo",),
                                 key=jax.random.key(6), noise=0.1)
    params["cam_yaw"] = cam.yaw + 1.0
    scales = {"cam_yaw": 2.0}

    pA, sA = dict(params), inverse.adam_init(params)
    stepA = inverse.make_train_step_multi(
        scene, cam, cfg, targets, keys, lr=0.02,
        lr_fn=inverse.cosine_lr(0.02, 5), lr_scales=scales)
    pB, sB = dict(params), inverse.adam_init(params)
    stepB = inverse.make_train_step_accum(
        scene, cam, cfg, targets, keys, chunk=2, lr=0.02,
        lr_fn=inverse.cosine_lr(0.02, 5), lr_scales=scales)
    for _ in range(3):
        pA, sA, lA = stepA(pA, sA)
        pB, sB, lB = stepB(pB, sB)
    assert abs(float(lA) - float(lB)) < 1e-6
    for k in pA:
        assert float(jnp.abs(pA[k] - pB[k]).max()) < 1e-5, k
