"""Wavefront path tracer with lane-stable path regeneration — the
performance path.

The reference megakernel gives every pixel-thread the full spp ×
20-bounce loop (CUDAKernels.h:147-166); with Russian roulette most paths
die after a few bounces, so late-bounce lanes idle. The masked
megakernel (models/megakernel.py) inherits that waste: dead lanes ride
along for all max_bounces × spp iterations.

Here every queue lane owns ONE pixel and a per-lane sample budget: the
`lax.while_loop` advances each lane one bounce per iteration, and a lane
whose path terminated immediately starts its pixel's next sample in the
same iteration. Total iterations ≈ mean path length × spp + one drain
tail, instead of max_bounces × spp.

The hot loop is scatter-free (an earlier variant that let lanes claim
arbitrary pixels via per-BOUNCE prefix-sum compaction spent most of its
time in scatter-adds and index gathers): accumulation is a
per-lane elementwise add, pixel ids are static per lane, and the only
gathers left are the BVH node/triangle reads inside traversal and the
material table lookups.

The DRAIN TAIL is the exception (round 2): mean path length is ~3
bounces but the deepest lane runs spp*max_bounces iterations, so
without compaction most iterations sweep all n lanes at <10% occupancy
— at 2K/mb20 that was over half the frame. cfg.drain_cascade packs the
pending lanes into geometrically smaller buffers ONCE per stage (a
nonzero + ~10 gathers outside the hot loop — amortized, unlike
per-bounce compaction), preserving bit-exact results: draws depend
only on (pixel, sample, bounce), per-lane fp accumulation order is
kept (acc rides through the gather as a running total), and kernel
results are per-lane independent so packet regrouping is invisible.

Because RNG is keyed by (pixel, sample, bounce, purpose) — see
utils/rng.py — this integrator traces the SAME paths as the megakernel
oracle and matches it to fp-summation tolerance (tests/test_wavefront.py).

Forward-only (while_loop is not reverse-differentiable); gradients use
the megakernel path. Reference semantics are preserved exactly
(RR schedule, unattenuated-emission quirk, 20-bounce black, sky on miss).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer_tpu.camera import Camera, generate_rays
from raytracer_tpu.config import RenderConfig
from raytracer_tpu.ops import intersect as isect
from raytracer_tpu.ops import materials as mat_ops
from raytracer_tpu.ops import tonemap
from raytracer_tpu.scene.types import Scene
from raytracer_tpu.utils import rng as rngu


def _lane_pkeys(cfg: RenderConfig, key, px, py):
    """Per-lane pixel-keyed RNG base — a pure function of (key, pixel
    id), so it can be REBUILT for any lane subset (the drain rebalancer
    reconstructs it for migrated lanes)."""
    if cfg.rng_impl == "ktf":
        from raytracer_tpu.utils import ktf

        return ktf.sampler(key, py * cfg.width + px)
    return rngu.lane_keys(key, py * cfg.width + px)


def _wavefront_body_maker(scene, cam, cfg: RenderConfig, spp, sample_offset):
    """Returns make_body(px, py, pkeys) → the one-bounce-per-iteration
    wavefront loop body (shared by the plain, cascaded, and
    cross-shard-rebalanced drains)."""
    use_ktf = cfg.rng_impl == "ktf"

    def make_body(px, py, pkeys):
      def body(state):
        active = state["active"]
        sample = state["sample"]
        bounce = jnp.where(active, state["bounce"], 0)

        # --- Regeneration: idle lanes with budget start their next sample.
        claim = ~active & (sample < spp)
        if use_ktf:
            # Raygen purposes live at bounce=0 (claim lanes have bounce 0
            # anyway); RR/scatter draws use the per-lane bounce.
            skeys = pkeys.at(sample=sample + sample_offset, bounce=0)
            kb = skeys.at(bounce=bounce)
        else:
            skeys = rngu.fold(pkeys, sample + sample_offset)
            kb = rngu.fold(skeys, bounce)
        # Camera sweep only when some lane actually starts a sample:
        # once the sample budget is exhausted (every post-budget/drain
        # iteration) this skips the full raygen math. Identity branch returns the
        # current rays; the `claim` selects below make it a no-op.
        o_new, d_new = jax.lax.cond(
            jnp.any(claim),
            lambda _: generate_rays(cam, px, py, cfg.width, cfg.height, skeys),
            lambda _: (state["origins"], state["dirs"]),
            None)
        cl3 = claim[:, None]
        origins = jnp.where(cl3, o_new, state["origins"])
        dirs = jnp.where(cl3, d_new, state["dirs"])
        throughput = jnp.where(cl3, 1.0, state["throughput"])
        active = active | claim

        # --- Russian roulette (CUDAKernels.h:113-121), per-lane bounce.
        do_rr = bounce >= cfg.min_bounces
        survival = jnp.minimum(jnp.max(throughput, axis=-1), cfg.rr_max_prob)
        u_rr = rngu.as_sampler(kb).rr_uniform()
        rr_kill = active & do_rr & (u_rr > survival)
        survived_rr = active & ~rr_kill
        rr_scale = jnp.where(survived_rr & do_rr, 1.0 / jnp.maximum(survival, 1e-12), 1.0)
        throughput = throughput * rr_scale[:, None]

        # --- One bounce for the whole queue.
        ids = isect.intersect_scene(scene, origins, dirs, cfg.t_min)
        attrs = isect.shade_hit(scene, origins, dirs, ids)
        ray_hit, point = ids.hit, attrs.point
        sc = mat_ops.scatter(kb, dirs, attrs.normal, attrs.front_face,
                             attrs.mat_id, scene.materials)

        hit = ray_hit & survived_rr
        light_hit = hit & sc.is_light
        miss = survived_rr & ~ray_hit
        cont = hit & sc.scattered & (bounce + 1 < cfg.max_bounces)

        emitted = sc.emission if cfg.reference_emission_quirk else throughput * sc.emission
        contrib = jnp.where(light_hit[:, None], emitted, 0.0)
        contrib = jnp.where(miss[:, None], throughput * tonemap.sky_color(dirs), contrib)
        # Terminations (rr_kill / absorb / max-bounce) contribute black.
        terminated = active & ~cont
        acc = state["acc"] + jnp.where(terminated[:, None], contrib, 0.0)
        sample = jnp.where(terminated, sample + 1, sample)

        throughput = jnp.where(cont[:, None], throughput * sc.attenuation, throughput)
        origins = jnp.where(cont[:, None], point, origins)
        dirs = jnp.where(cont[:, None], sc.direction, dirs)
        bounce = jnp.where(cont, bounce + 1, bounce)

        return {
            "origins": origins,
            "dirs": dirs,
            "throughput": throughput,
            "bounce": bounce,
            "sample": sample,
            "active": cont,
            "acc": acc,
        }

      return body

    return make_body


def render_pixels_wavefront(
    scene: Scene,
    cam: Camera,
    px: jnp.ndarray,  # i32[N]
    py: jnp.ndarray,  # i32[N] (0 = bottom row)
    cfg: RenderConfig,
    key: jax.Array,
    spp: int | None = None,
    sample_offset: int = 0,
    queue_size: int | None = None,  # kept for API compat; lanes == pixels
) -> jnp.ndarray:
    """Mean linear radiance f32[N,3] over spp samples per pixel.
    `sample_offset` shifts the global sample indices so spp-batched calls
    draw the same randoms as one big pass (keeps long renders in short
    device dispatches)."""
    del queue_size
    spp = cfg.spp if spp is None else spp
    n = px.shape[0]
    use_ktf = cfg.rng_impl == "ktf"
    pkeys = _lane_pkeys(cfg, key, px, py)
    make_body = _wavefront_body_maker(scene, cam, cfg, spp, sample_offset)

    def n_pending(state):
        return jnp.sum((state["active"] | (state["sample"] < spp))
                       .astype(jnp.int32))

    state = {
        "origins": jnp.zeros((n, 3), jnp.float32),
        "dirs": jnp.ones((n, 3), jnp.float32),
        "throughput": jnp.ones((n, 3), jnp.float32),
        "bounce": jnp.zeros((n,), jnp.int32),
        "sample": jnp.zeros((n,), jnp.int32),
        "active": jnp.zeros((n,), bool),
        "acc": jnp.zeros((n, 3), jnp.float32),
    }

    # --- Drain-tail compaction cascade (cfg.drain_cascade). Mean path
    # length is ~3 bounces but the deepest lane takes up to
    # spp*max_bounces iterations; without compaction every drain
    # iteration sweeps ALL n lanes (full camera/RNG/traversal cost at
    # <10% occupancy). Each stage runs the SAME body until the pending
    # count fits the next (smaller) buffer, then packs the survivors
    # with one nonzero+gather. Bit-exact by construction: a lane's
    # draws depend only on (pixel, sample, bounce) — not on buffer
    # position — and its acc is gathered/scattered as a running total,
    # preserving per-lane fp addition order. Kernel results are
    # per-lane independent, so packet regrouping is also exact.
    gran = 8
    caps = []
    for div in cfg.drain_cascade:
        c = -(-max(n // int(div), 1) // gran) * gran
        if c < n and (not caps or c < caps[-1]):
            caps.append(c)

    first_limit = caps[0] if caps else 0
    state = jax.lax.while_loop(
        lambda s: n_pending(s) > first_limit, make_body(px, py, pkeys), state)

    for i, cap in enumerate(caps):
        nxt = caps[i + 1] if i + 1 < len(caps) else 0
        pend = state["active"] | (state["sample"] < spp)
        idx = jnp.nonzero(pend, size=cap, fill_value=n)[0].astype(jnp.int32)
        valid = idx < n
        # Unique fill indices (n, n+1, ...): all still out-of-bounds (the
        # mode="drop" scatter ignores them) but never duplicated —
        # duplicate indices under unique_indices=True are documented UB
        # (the scatter's documented contract).
        idx = jnp.where(valid, idx, n + jnp.arange(cap, dtype=jnp.int32))
        gi = jnp.minimum(idx, n - 1)  # clamp fill slots for the gather
        cstate = {k: state[k][gi] for k in state}
        # Fill slots (idx == n) are neutralized: never active, no sample
        # budget — their state never changes and the scatter drops them.
        cstate["active"] = cstate["active"] & valid
        cstate["sample"] = jnp.where(valid, cstate["sample"], spp)
        pk_g = pkeys._replace(pixel=pkeys.pixel[gi]) if use_ktf else pkeys[gi]
        cbody = make_body(px[gi], py[gi], pk_g)
        cstate = jax.lax.while_loop(
            lambda s: n_pending(s) > nxt, cbody, cstate)
        for k in state:
            state[k] = state[k].at[idx].set(
                cstate[k], mode="drop", unique_indices=True)

    return state["acc"] / jnp.float32(spp)


def render_pixels_wavefront_rebalanced(
    scene: Scene,
    cam: Camera,
    px: jnp.ndarray,   # i32[n_local] — THIS SHARD's lanes
    py: jnp.ndarray,
    cfg: RenderConfig,
    key: jax.Array,
    axis: str,
    n_shards: int,
    spp: int | None = None,
    sample_offset: int = 0,
    rebalance_div: int = 8,
    report_iters: bool = False,
):
    """Sharded wavefront with a CROSS-SHARD DRAIN REBALANCE (SURVEY §5
    'long-context analog'). Must run inside
    shard_map over `axis`.

    Per-shard independent drains end at the SLOWEST shard, even after
    round-robin packet interleaving. Here, once a shard's pending
    count falls to n_local/rebalance_div, every shard compacts its
    pending lanes into a fixed-size buffer, the buffers are
    all_gather'd over the mesh, and shard i takes the round-robin stripe
    i, i+S, ... of the S*cap pooled lanes — an equal statistical mix of
    every shard's tail, so all shards finish together. Each migrated
    lane's RNG base is REBUILT from its pixel id (draws depend only on
    (pixel, sample, bounce)) and its radiance accumulator rides along
    as a running total, so the image is bit-identical per lane to the
    unbalanced render; finished lanes return to their owner by a second
    (origin-id, acc) all_gather + scatter.

    Returns acc-mean f32[n_local, 3]; with report_iters=True also an
    i32[1] per-shard count of post-rebalance drain iterations (the
    balance metric: max/mean over shards ≤ ~1.1 when the rebalance
    works)."""
    spp = cfg.spp if spp is None else spp
    n = px.shape[0]
    make_body = _wavefront_body_maker(scene, cam, cfg, spp, sample_offset)
    pkeys = _lane_pkeys(cfg, key, px, py)
    rank = jax.lax.axis_index(axis)

    def n_pending(state):
        return jnp.sum((state["active"] | (state["sample"] < spp))
                       .astype(jnp.int32))

    state = {
        "origins": jnp.zeros((n, 3), jnp.float32),
        "dirs": jnp.ones((n, 3), jnp.float32),
        "throughput": jnp.ones((n, 3), jnp.float32),
        "bounce": jnp.zeros((n,), jnp.int32),
        "sample": jnp.zeros((n,), jnp.int32),
        "active": jnp.zeros((n,), bool),
        "acc": jnp.zeros((n, 3), jnp.float32),
    }

    gran = 8
    cap = -(-max(n // int(rebalance_div), 1) // gran) * gran
    cap = min(cap, n)

    # Phase 1: independent local wavefront down to `cap` pending lanes,
    # running the SAME compaction cascade as the plain path for the
    # stages above `cap` (without it, the pre-rebalance drain sweeps
    # full-size buffers that the plain path has already shrunk —
    # measured ~20% slower overall on the CPU mesh).
    caps1 = []
    for div in cfg.drain_cascade:
        c = -(-max(n // int(div), 1) // gran) * gran
        if cap < c < n and (not caps1 or c < caps1[-1]):
            caps1.append(c)

    first_limit = caps1[0] if caps1 else cap
    state = jax.lax.while_loop(
        lambda s: n_pending(s) > first_limit, make_body(px, py, pkeys), state)

    def compact(state, px_a, py_a, size, limit, body_maker):
        """One cascade stage: pack pending lanes of `state` into a
        `size`-lane buffer and drain it to `limit` pending. Returns
        (packed state, idx into the source buffer, packed px/py)."""
        n_src = px_a.shape[0]
        pend = state["active"] | (state["sample"] < spp)
        idx = jnp.nonzero(pend, size=size, fill_value=n_src)[0].astype(jnp.int32)
        valid = idx < n_src
        idx = jnp.where(valid, idx, n_src + jnp.arange(size, dtype=jnp.int32))
        gi = jnp.minimum(idx, n_src - 1)
        cstate = {k: state[k][gi] for k in state}
        cstate["active"] = cstate["active"] & valid
        cstate["sample"] = jnp.where(valid, cstate["sample"], spp)
        cpx, cpy = px_a[gi], py_a[gi]
        cbody = body_maker(cpx, cpy, _lane_pkeys(cfg, key, cpx, cpy))
        cstate = jax.lax.while_loop(
            lambda s: n_pending(s) > limit, cbody, cstate)
        return cstate, idx, valid, cpx, cpy

    for i, c in enumerate(caps1):
        nxt = caps1[i + 1] if i + 1 < len(caps1) else cap
        cstate, idx, _, _, _ = compact(state, px, py, c, nxt, make_body)
        for k in state:
            state[k] = state[k].at[idx].set(
                cstate[k], mode="drop", unique_indices=True)

    # Compact the pending tail into the fixed-size migration buffer.
    pend = state["active"] | (state["sample"] < spp)
    idx = jnp.nonzero(pend, size=cap, fill_value=n)[0].astype(jnp.int32)
    valid = idx < n
    idx = jnp.where(valid, idx, n + jnp.arange(cap, dtype=jnp.int32))
    gi = jnp.minimum(idx, n - 1)
    bundle = {k: state[k][gi] for k in state}
    bundle["active"] = bundle["active"] & valid
    bundle["sample"] = jnp.where(valid, bundle["sample"], spp)
    bundle["px"] = px[gi]
    bundle["py"] = py[gi]
    bundle["origin"] = jnp.where(valid, rank * n + jnp.minimum(idx, n - 1),
                                 jnp.int32(-1))

    # Pool every shard's tail and take this shard's round-robin stripe.
    pooled = jax.lax.all_gather(bundle, axis)          # leading dim S
    flat = jax.tree_util.tree_map(
        lambda x: x.reshape((n_shards * cap,) + x.shape[2:]), pooled)
    take = rank + n_shards * jnp.arange(cap, dtype=jnp.int32)
    stripe = jax.tree_util.tree_map(lambda x: x[take], flat)

    spx, spy = stripe.pop("px"), stripe.pop("py")
    origin = stripe.pop("origin")
    spk = _lane_pkeys(cfg, key, spx, spy)
    sbody = make_body(spx, spy, spk)

    def drain_cond(c):
        return n_pending(c[0]) > 0

    def drain_body(c):
        s, it = c
        return sbody(s), it + 1

    stripe, iters = jax.lax.while_loop(drain_cond, drain_body,
                                       (stripe, jnp.int32(0)))

    # Return finished accumulators to their owning shard/lane.
    results = jax.lax.all_gather({"origin": origin, "acc": stripe["acc"]},
                                 axis)
    r_origin = results["origin"].reshape(-1)
    r_acc = results["acc"].reshape(-1, 3)
    mine = (r_origin >= rank * n) & (r_origin < (rank + 1) * n)
    m = n_shards * cap
    tgt = jnp.where(mine, r_origin - rank * n,
                    n + jnp.arange(m, dtype=jnp.int32))
    acc = state["acc"].at[tgt].set(r_acc, mode="drop", unique_indices=True)
    rgb = acc / jnp.float32(spp)
    if report_iters:
        return rgb, iters[None]
    return rgb


def _tiled_pixel_grid(cfg: RenderConfig):
    """Pixel ids in 8x128 SCREEN-TILE lane order, so each 1024-lane
    packet is a compact screen tile — coherent camera rays and
    origin-local bounce rays with no per-bounce sorting.

    Returns (px, py [bottom-up], inv) where image.flat[p] = lanes[inv[p]].
    Non-multiple image sizes are padded with duplicated edge pixels
    (their lanes render but are dropped by inv)."""
    import numpy as np

    th, tw = 8, 128
    w, h = cfg.width, cfg.height
    wp = (w + tw - 1) // tw * tw
    hp = (h + th - 1) // th * th
    rows = np.minimum(np.arange(hp), h - 1)
    cols = np.minimum(np.arange(wp), w - 1)
    r2 = np.broadcast_to(rows[:, None], (hp, wp))
    c2 = np.broadcast_to(cols[None, :], (hp, wp))
    lane_rows = r2.reshape(hp // th, th, wp // tw, tw).transpose(0, 2, 1, 3).reshape(-1)
    lane_cols = c2.reshape(hp // th, th, wp // tw, tw).transpose(0, 2, 1, 3).reshape(-1)
    n = lane_rows.size
    flat = lane_rows * w + lane_cols
    inv = np.zeros(h * w, np.int32)
    inv[flat[::-1]] = np.arange(n, dtype=np.int32)[::-1]  # first lane wins
    px = jnp.asarray(lane_cols.astype(np.int32))
    py = jnp.asarray((h - 1 - lane_rows).astype(np.int32))
    return px, py, jnp.asarray(inv)


# Module-level jitted entry: scene/camera/pixels/key are ARGUMENTS (one
# compiled program per (cfg, spp) — scene edits, new keys, and sample
# offsets all reuse it; see CLAUDE.md on closure recompiles).
wavefront_batch = jax.jit(
    render_pixels_wavefront, static_argnames=("cfg", "spp", "queue_size"))


def render_image_wavefront(
    scene: Scene, cam: Camera, cfg: RenderConfig, key: jax.Array, spp: int | None = None
) -> jnp.ndarray:
    """Full-image wavefront render; spp above cfg.spp_per_pass is split
    into several device dispatches (bounding live memory) with identical
    results (sample-offset keying)."""
    px, py, inv = _tiled_pixel_grid(cfg)
    spp = cfg.spp if spp is None else spp
    step = max(1, min(spp, cfg.spp_per_pass))
    if step >= spp:
        rgb = wavefront_batch(scene, cam, px, py, cfg, key, spp=spp)
    else:
        acc = None
        done = 0
        while done < spp:
            s = min(step, spp - done)
            part = wavefront_batch(scene, cam, px, py, cfg, key, spp=s,
                                   sample_offset=jnp.int32(done)) * (s / spp)
            acc = part if acc is None else acc + part
            done += s
        rgb = acc
    return rgb[inv].reshape(cfg.height, cfg.width, 3)
