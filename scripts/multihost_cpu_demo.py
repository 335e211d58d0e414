"""Two-process jax.distributed demo/test worker (CPU backend).

Launched by tests/test_multiprocess.py (and usable manually):

    python scripts/multihost_cpu_demo.py <coordinator> <nprocs> <rank> <outdir>

Each process initializes jax.distributed, builds the same scene, renders
the image sharded over the GLOBAL device mesh (one CPU device per
process), all-gathers the result, and rank 0 writes it to outdir. This
exercises the identical code path a multi-host accelerator run uses
(parallel/multihost.py), minus the hardware.
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import numpy as np


def main():
    coordinator, nprocs, rank, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=nprocs, process_id=rank)
    assert jax.process_count() == nprocs

    from jax.experimental import multihost_utils

    from raytracer_tpu.camera import make_camera
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.parallel import multihost
    from raytracer_tpu.scene.builder import cornell_spheres_scene

    scene = cornell_spheres_scene()
    cfg = RenderConfig(width=16, height=8, spp=2, max_bounces=3)
    cam = make_camera(aspect_ratio=cfg.aspect_ratio, fov_degrees=cfg.fov_degrees,
                      aperture=cfg.aperture)

    mesh = multihost.global_mesh()
    assert mesh.devices.size == nprocs
    img = multihost.render_image_multihost(scene, cam, cfg, jax.random.key(7), mesh)
    img_local = multihost_utils.process_allgather(img, tiled=True)

    if rank == 0:
        np.save(f"{outdir}/multihost_img.npy", np.asarray(img_local))
        print("rank0 wrote image", np.asarray(img_local).shape, flush=True)
    multihost_utils.sync_global_devices("done")


if __name__ == "__main__":
    main()
