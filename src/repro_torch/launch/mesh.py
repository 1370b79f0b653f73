"""The port's zone mesh: n CAN nodes held in one process on one device.

The JAX package runs its n-node mesh as n devices under `shard_map`.
The port holds the n nodes on one device instead: each node keeps its
own zone of the global bucket array (`CanTopology.zone_range`), and each
collective is a tensor exchange on the device between the nodes' slices
(`repro_torch.core.runtime.MeshCollectives`).  A data axis > 1 holds
`data` independent rows of n nodes over one store, each serving its own
slice of the query batch, as the reference's data-parallel mesh does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ZoneMesh:
    """`data` rows of `n_model` CAN nodes on one device."""

    n_model: int
    data: int
    device: torch.device
    batch_axes: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.n_model}


def make_zone_mesh(n_model: int, data: int = 1, *, device=None) -> ZoneMesh:
    """A mesh of `data` x `n_model` nodes on `device` (the CUDA card
    unless `device="cpu"`)."""
    if n_model < 1 or data < 1:
        raise ValueError(f"mesh needs n_model, data >= 1, got {n_model}, "
                         f"{data}")
    return ZoneMesh(int(n_model), int(data), resolve_device(device))
