"""What each device platform runs, decided in this one place.

`gpu` runs the fused path loop as a CUDA kernel (native/pathtrace_cuda.cu)
and the wavefront's traversal in XLA. `cpu` runs the same path loop through
its CPU target (native/pathtrace_cpu.cc) and XLA for the rest. Any other
platform is an error: nothing falls back to an interpreter or to another
device.
"""

from __future__ import annotations

import dataclasses

import jax


@dataclasses.dataclass(frozen=True)
class Backend:
    fused_target: str         # FFI target of the fused path loop: "cuda" | "cpu"
    traversal: str            # wavefront BVH traversal in XLA: "lane" | "packets"
    native_bvh_required: bool  # a failed native BVH build is an error


_BACKENDS = {
    # Packets: faster than the per-lane walk under the 2K wavefront on
    # an H100 (CHANGES.md).
    "gpu": Backend(fused_target="cuda", traversal="packets",
                   native_bvh_required=True),
    "cpu": Backend(fused_target="cpu", traversal="packets",
                   native_bvh_required=False),
}


def for_platform(platform: str | None = None) -> Backend:
    """The backend of `platform` (default: JAX's default backend)."""
    platform = jax.default_backend() if platform is None else platform
    try:
        return _BACKENDS[platform]
    except KeyError:
        raise ValueError(f"no backend for platform {platform!r}; "
                         f"supported: {sorted(_BACKENDS)}") from None
