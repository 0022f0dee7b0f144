"""Lane meshes: the batch's lanes split over several devices.

The JAX package shards the lane axis of one step with ``jax.shard_map``
over a ``Mesh`` (``P(None, axis)``: hist, x and y split on lanes, the
weights replicated).  Here a mesh is a sequence of devices, one lane
shard each: the B lanes split into ``len(mesh)`` equal contiguous shards,
in order, and each shard's launch runs on its own device's current stream
with no copy between devices (streams are share-nothing, so a step needs
no collective).  A device may repeat, which splits the lanes on one
device; that is how the CPU tests and a one-card machine exercise a real
split.

:func:`split_lanes` and :func:`join_lanes` take the place of JAX's
``device_put`` to a lane ``NamedSharding`` and of reading a sharded array
back whole.
"""

from __future__ import annotations

import torch

from ..utils.errors import ResamplerError, ResamplerErrorCode

__all__ = ["mesh_devices", "shard_columns", "split_lanes", "join_lanes"]


def mesh_devices(mesh) -> tuple:
    """``mesh`` (a non-empty sequence of ``torch.device``s or strings) as
    a tuple of ``torch.device``s; anything else raises INVALID_ARG."""
    if isinstance(mesh, (str, torch.device)):
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    try:
        devices = tuple(torch.device(d) for d in mesh)
    except (TypeError, RuntimeError):
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    if not devices:
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    return devices


def shard_columns(B: int, n_shards: int) -> list:
    """The [lo, hi) lane range of each of ``n_shards`` equal contiguous
    shards of B lanes; B not divisible by the shard count raises
    INVALID_ARG (JAX's ``shard_map`` refuses the same B)."""
    if B <= 0 or B % n_shards:
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    w = B // n_shards
    return [(i * w, (i + 1) * w) for i in range(n_shards)]


def split_lanes(t: torch.Tensor, mesh, dim: int = 1) -> list:
    """``t``'s lanes (axis ``dim``: 1 for time-major [rows, B], 0 for
    lane-major [B, rows]) split onto the mesh: one contiguous tensor a
    shard, on its device."""
    devices = mesh_devices(mesh)
    cols = shard_columns(t.shape[dim], len(devices))
    return [t.narrow(dim, lo, hi - lo).contiguous().to(d)
            for (lo, hi), d in zip(cols, devices)]


def join_lanes(shards, device=None, dim: int = 1) -> torch.Tensor:
    """The shards joined along the lane axis ``dim`` on ``device`` (by
    default the first shard's)."""
    device = torch.device(device) if device is not None else shards[0].device
    return torch.cat([s.to(device) for s in shards], dim=dim)
