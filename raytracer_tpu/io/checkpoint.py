"""Checkpoint / resume for long renders and training runs.

The reference has NO persistence at all — the framebuffer lives only in
the SFML window (WindowManager.h:79-93) and a crash loses everything
(SURVEY.md §5 "Checkpoint / resume"). This build makes the HQ
2K/2000spp workload resumable at spp-batch granularity: the f32 sample
accumulator + the done-sample counter are written to an npz after every
batch, and a restarted job continues from the last batch. Because RNG is
(pixel, sample)-keyed (utils/rng.py), the resumed render produces the
SAME image as an uninterrupted one.

Training-state checkpointing for inverse rendering
(diff/inverse.AdamState) uses the same npz container.
"""

from __future__ import annotations

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np


def _atomic_save(path: str, **arrays) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    # Suffix must be ".npz" — np.savez appends it otherwise and the
    # rename would move an empty file.
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _rng_stream_id(cfg, integrator: str) -> str:
    """The RNG stream an accumulation draws from. The fused integrator
    always draws the ktf counter stream; wavefront/megakernel draw
    cfg.rng_impl. Mixing streams in one accumulator silently breaks the
    resumed==uninterrupted invariant, so the stream id is part of the
    checkpoint header."""
    return "ktf" if (integrator == "fused" or cfg.rng_impl == "ktf") else "jax"


def render_image_resumable(scene, cam, cfg, key, ckpt_path: str,
                           spp_per_batch: int | None = None,
                           integrator: str = "wavefront"):
    """Resumable render: accumulates spp in batches, saving
    (accumulated sum, samples done) after each. Returns the mean linear
    image f32[H,W,3]. `integrator`: 'wavefront' (fast path), 'fused'
    (one-dispatch fused path-loop kernel), or 'megakernel' (row-chunked oracle
    path)."""
    spp_per_batch = spp_per_batch or cfg.spp_per_pass
    h, w = cfg.height, cfg.width
    stream = _rng_stream_id(cfg, integrator)

    done = 0
    acc = np.zeros((h, w, 3), np.float32)
    if os.path.exists(ckpt_path):
        with np.load(ckpt_path) as z:
            if (
                z["acc"].shape == acc.shape
                and int(z["spp_total"]) == cfg.spp
                and int(z["seed_hash"]) == _key_hash(key)
                # Checkpoints without the stream field (pre-r4) are
                # rejected too — their stream is unknowable.
                and "rng_stream" in z.files
                and str(z["rng_stream"]) == stream
            ):
                acc = z["acc"]
                done = int(z["spp_done"])

    def save():
        _atomic_save(
            ckpt_path,
            acc=acc,
            spp_done=np.int64(done),
            spp_total=np.int64(cfg.spp),
            seed_hash=np.int64(_key_hash(key)),
            rng_stream=np.str_(stream),
        )

    from raytracer_tpu.render import iter_spp_accumulation

    for done, batch_sum in iter_spp_accumulation(
            scene, cam, cfg, key, integrator=integrator,
            spp_per_batch=spp_per_batch, start_done=done):
        acc = acc + batch_sum
        save()
    return jnp.asarray(acc / cfg.spp)


def _key_hash(key) -> int:
    data = np.asarray(jax.random.key_data(key)).ravel()
    return int(np.bitwise_xor.reduce(data.astype(np.uint32)).astype(np.int64))


def save_train_state(path: str, params: dict, adam_state, extra: dict | None = None) -> None:
    arrays = {f"param_{k}": np.asarray(v) for k, v in params.items()}
    arrays.update({f"mu_{k}": np.asarray(v) for k, v in adam_state.mu.items()})
    arrays.update({f"nu_{k}": np.asarray(v) for k, v in adam_state.nu.items()})
    arrays["step"] = np.asarray(adam_state.step)
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = np.asarray(v)
    _atomic_save(path, **arrays)


def load_train_state(path: str):
    from raytracer_tpu.diff.inverse import AdamState

    with np.load(path) as z:
        params = {k[6:]: jnp.asarray(z[k]) for k in z.files if k.startswith("param_")}
        mu = {k[3:]: jnp.asarray(z[k]) for k in z.files if k.startswith("mu_")}
        nu = {k[3:]: jnp.asarray(z[k]) for k in z.files if k.startswith("nu_")}
        step = jnp.asarray(z["step"])
        extra = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
    return params, AdamState(step=step, mu=mu, nu=nu), extra
