"""Multi-host entry points.

The reference is a single-process, single-GPU program (SURVEY.md §2.2).
This framework scales across hosts with `jax.distributed`: every host
runs the same program, the global device mesh spans all hosts' devices,
the pixel axis is sharded globally (zero-collective forward), and
inverse-render gradients psum over the mesh.

Usage on each host:

    from raytracer_tpu.parallel import multihost
    multihost.initialize(coordinator_address="host0:port",
                         num_processes=N, process_id=rank)
    mesh = multihost.global_mesh()
    img = multihost.render_image_multihost(scene, cam, cfg, key, mesh)

On a single host this degrades gracefully to the local-device mesh, so
the same script runs everywhere.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raytracer_tpu.parallel.sharding import RAY_AXIS, _padded_pixel_grid, _render_sharded


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize; a no-op when already initialized or
    when running single-process. GPU hosts need all three arguments."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        pass  # already initialized, or single-process run


def global_mesh(axis_name: str = RAY_AXIS) -> Mesh:
    """1D mesh over ALL devices in the slice (across hosts)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def render_image_multihost(scene, cam, cfg, key, mesh: Mesh | None = None,
                           spp: int | None = None):
    """Full-image render with pixels sharded across every chip in the
    slice. Each host computes only its addressable shard; the returned
    global array is fully materialized only under
    jax.experimental.multihost_utils / process_allgather if needed —
    callers on pods usually save per-host shards or allgather explicitly.
    """
    mesh = mesh or global_mesh()
    px, py, n = _padded_pixel_grid(cfg, mesh.devices.size)
    sharding = NamedSharding(mesh, P(RAY_AXIS))
    px = jax.device_put(px, sharding)
    py = jax.device_put(py, sharding)
    rgb = _render_sharded(scene, cam, px, py, cfg, key, mesh, spp or cfg.spp)
    return rgb[:n].reshape(cfg.height, cfg.width, 3)


def scaling_report(scene, cam, cfg, key, device_counts=None) -> dict:
    """rays/s at increasing device counts on this slice — the BASELINE
    'scaling efficiency' harness (≥85% at 2 hosts north star). On a
    single chip this returns the 1-device row only."""
    import time

    results = {}
    all_devices = jax.devices()
    counts = device_counts or sorted({1, 2, 4, 8, len(all_devices)})
    # Efficiency is ALWAYS normalized to the 1-device row: baselining at
    # the smallest *measured* count would silently hide 1→2 chip loss if
    # a caller starts the list at 2. Measure 1 device even
    # when the caller didn't ask for it.
    if 1 not in counts:
        counts = [1] + list(counts)
    for c in counts:
        if c > len(all_devices):
            continue
        mesh = Mesh(np.asarray(all_devices[:c]), (RAY_AXIS,))
        img = render_image_multihost(scene, cam, cfg, key, mesh)
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        img = render_image_multihost(scene, cam, cfg, key, mesh)
        jax.block_until_ready(img)
        dt = time.perf_counter() - t0
        rays = cfg.width * cfg.height * cfg.spp
        results[c] = {"seconds": dt, "rays_per_sec": rays / dt}
    # Efficiency = per-device throughput relative to the 1-device run
    # (perfect linear scaling ⇒ 1.0 at every count).
    base_count = 1
    base_per_dev = results[base_count]["rays_per_sec"] / base_count
    for c, row in results.items():
        row["efficiency"] = (row["rays_per_sec"] / c) / base_per_dev
    return results
