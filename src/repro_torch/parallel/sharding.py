"""A mesh of devices driven by one process, and the two moves retrieval makes on it.

The reference is single-controller: one ``shard_map`` call drives every
device of a ``jax.sharding.Mesh``. This package keeps that shape without
``torch.distributed``. A :class:`DeviceMesh` is an ordered tuple of
``torch.device``s under one axis name; shard ``i`` of an array lives on
``mesh.devices[i]``. The caller's host loop launches each shard's work on
its own device (CUDA launches return at once, so the devices overlap) and
then gathers the small per-shard results onto ``mesh.devices[0]``, as FAISS's
GPU ``IndexShards`` does. Several shards may share a device: that is the
counterpart of the reference tests' ``--xla_force_host_platform_device_count``
(four logical shards on one card, eight on the CPU).

Only what retrieval uses is here: :class:`DeviceMesh`, :func:`make_mesh`,
:func:`shard_put` (rows split into equal per-shard parts, each on its
shard's device) and :func:`all_gather` (per-shard partials concatenated
along a dimension on one device). The reference's logical-axis rules,
collectives and pipeline serve its models and have no counterpart yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["DeviceMesh", "all_gather", "make_mesh", "shard_put"]


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """``devices[i]`` holds shard ``i`` along the one axis ``axis_names[0]``.
    Frozen and comparable: two meshes are equal when they place the same
    shards on the same devices under the same name."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_names) != 1:
            raise ValueError(f"a DeviceMesh has exactly one axis, got {self.axis_names}")
        if not self.devices:
            raise ValueError("a DeviceMesh needs at least one device")

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: shards}``, read as ``mesh.shape[axis]`` like a JAX mesh."""
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A one-axis mesh of ``axis_shapes[0]`` shards; shard ``i`` lives on
    ``devices[i % len(devices)]``. ``devices`` defaults to every visible
    card; with none visible it raises (there is no fallback to the CPU: pass
    ``devices=["cpu"] * n`` for a mesh of CPU shards)."""
    if len(axis_shapes) != 1 or len(axis_names) != 1:
        raise ValueError(f"only one-axis meshes are supported, got shape {tuple(axis_shapes)} "
                         f"over {tuple(axis_names)}")
    n = int(axis_shapes[0])
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible "
                               "(torch.cuda.is_available() is False); pass devices=['cpu'] "
                               "for a mesh of CPU shards")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh: an empty device list")
    return DeviceMesh(tuple(devs[i % len(devs)] for i in range(n)), tuple(axis_names))


def shard_put(t: torch.Tensor, mesh: DeviceMesh) -> List[torch.Tensor]:
    """Rows of ``t`` split into ``mesh.size`` equal parts, part ``i`` moved to
    ``mesh.devices[i]`` (the reference's ``shard_put`` with ``P(axis)``).
    The row count must divide evenly; a part already on its device is a view."""
    n = mesh.size
    if t.shape[0] % n:
        raise ValueError(f"shard_put: {t.shape[0]} rows do not split into {n} equal shards")
    per = t.shape[0] // n
    return [t[i * per : (i + 1) * per].to(dev) for i, dev in enumerate(mesh.devices)]


def all_gather(parts: Sequence[torch.Tensor], device, dim: int = 1) -> torch.Tensor:
    """Per-shard partials concatenated along ``dim`` on ``device``, in shard
    order (the reference's tiled ``all_gather``). Copies between cards are
    queued on the stream; a copy out of a CPU shard is made where it stands."""
    device = torch.device(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)
