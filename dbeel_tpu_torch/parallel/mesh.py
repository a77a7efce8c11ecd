"""Partition meshes — the counterpart of ``dbeel_tpu/parallel/mesh.py``.

A ``Mesh`` is the port's stand-in for a 1-D ``jax.sharding.Mesh`` over
the ``shards`` axis: an ordered list of ``torch.device``s, one per
partition.  A device may repeat (``[cuda:0] * 4``, ``[cpu] * 4``): the
partitions then share it, as ``--xla_force_host_platform_device_count``
gives ``dbeel_tpu``'s tests several virtual devices on one host.  That
is how the CPU tests and a one-card machine build an n-partition mesh;
serving (``shard_mesh()`` with no arguments) never repeats a card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("shards",)

    @property
    def size(self) -> int:
        return len(self.devices)


def shard_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over the ``shards`` axis — the compaction-coalescing /
    key-space data-parallel axis.  With no ``devices``: every visible
    card (or the first ``n_devices``), raising when there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=[...] (e.g. "
                "[torch.device('cpu')] * 4) to build a mesh on the CPU"
            )
        devices = [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())
        ]
        if n_devices is not None:
            devices = devices[:n_devices]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"mixed device types in a mesh: {devs}")
    return Mesh(devs)
