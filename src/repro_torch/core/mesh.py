"""The port's zone meshes: n CAN nodes in one process, or in blocks over
processes (built by `repro_torch.launch.mesh.make_zone_mesh`).

The JAX package runs its n-node mesh as n devices under `shard_map`.
The port has two forms of it:

  * `ZoneMesh`: the n nodes held in one process on one device.  Each
    node keeps its own zone of the global bucket array
    (`CanTopology.zone_range`), and each collective is a tensor exchange
    on the device between the nodes' slices
    (`repro_torch.core.runtime.MeshCollectives`).  A data axis > 1 holds
    `data` independent rows of n nodes over one store, each serving its
    own slice of the query batch, as the reference's data-parallel mesh
    does.
  * `ProcessZoneMesh`: one process per card (or per CPU worker), under
    an initialised `torch.distributed` process group.  The world is
    `data x blocks` ranks: rank r serves data row r // blocks and the
    contiguous block r % blocks of `n_loc = n_model / blocks` nodes, with
    their zones of the store and their slice of the query batch
    (`repro_torch.core.runtime.BlockCollectives`).  A CUDA mesh runs
    over NCCL and a CPU mesh over gloo.

Both give the step wrappers of `repro_torch.core.distributed` one
interface: `world`, `collectives(cfg)`, `my_slices(x)`,
`whole_batch(x)`, `store_zones(store)` and `sum_stats(totals)`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as tdist

from repro_torch.core.runtime import BlockCollectives, MeshCollectives
from repro_torch.core.store import BucketStore


def _slices(mesh, x: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [data*n, B/(data*n), ...]: the batch slice of each data
    row and node, in node order; a batch that does not divide raises."""
    shards = mesh.data * mesh.n_model
    if x.shape[0] % shards:
        raise ValueError(f"batch of {x.shape[0]} does not shard over "
                         f"{shards} mesh slices: pad it to a multiple")
    return x.reshape((shards, -1) + x.shape[1:])


def _placed(store: BucketStore, zones: slice, device) -> BucketStore:
    """The store's bucket range `zones` on `device` (the generation is
    global)."""
    def put(x, cut=True):
        return None if x is None else (x[:, zones] if cut else x).to(device)

    return BucketStore(put(store.ids), put(store.timestamps),
                       put(store.write_ptr), put(store.payload),
                       put(store.generation, cut=False))


@dataclasses.dataclass(frozen=True)
class ZoneMesh:
    """`data` rows of `n_model` CAN nodes on one device."""

    n_model: int
    data: int
    device: torch.device
    batch_axes: tuple = ("data", "model")
    world = 1

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.n_model}

    def collectives(self, cfg) -> MeshCollectives:
        return MeshCollectives(n=cfg.n_nodes, device=self.device)

    def my_slices(self, x: torch.Tensor) -> torch.Tensor:
        """[B, ...] -> [data, n, B/(data*n), ...]: every slice."""
        return _slices(self, x).reshape((self.data, self.n_model, -1)
                                        + x.shape[1:])

    def whole_batch(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def store_zones(self, store: BucketStore) -> BucketStore:
        """The global store IS the sharded store: a move to the device."""
        return _placed(store, slice(None), self.device)

    def sum_stats(self, totals: list) -> list:
        return totals


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessZoneMesh:
    """This process's place in a mesh of `data` rows of `n_model` nodes
    spread over a `torch.distributed` world of `data x blocks` ranks.

    `model_group` holds the ranks of this rank's data row (the model
    axis, None meaning the default group); the default group is the
    batch group.  `pod` > 1 splits the data rows into pods, for the
    shape of a multi-pod mesh."""

    n_model: int
    data: int
    device: torch.device
    rank: int
    world: int
    model_group: object = None
    pod: int = 1

    @property
    def blocks(self) -> int:
        return self.world // self.data

    @property
    def n_loc(self) -> int:
        return self.n_model // self.blocks

    @property
    def row(self) -> int:
        return self.rank // self.blocks

    @property
    def block(self) -> int:
        return self.rank % self.blocks

    @property
    def shape(self) -> dict:
        if self.pod > 1:
            return {"pod": self.pod, "data": self.data // self.pod,
                    "model": self.n_model}
        return {"data": self.data, "model": self.n_model}

    @property
    def batch_axes(self) -> tuple:
        return tuple(self.shape)

    def collectives(self, cfg) -> BlockCollectives:
        return BlockCollectives(n=cfg.n_nodes, n_loc=self.n_loc,
                                block=self.block, device=self.device,
                                group=self.model_group)

    def my_slices(self, x: torch.Tensor) -> torch.Tensor:
        """[B, ...] -> [1, n_loc, B/(data*n), ...]: the slices of this
        rank's data row and block."""
        lo = self.rank * self.n_loc
        return _slices(self, x)[lo:lo + self.n_loc][None]

    def whole_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch's [B, ...] results from this process's
        [b, ...]: all-gathered over every rank, in rank order."""
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        out = wire.new_empty((self.world * x.shape[0],) + x.shape[1:])
        tdist.all_gather_into_tensor(out, wire)
        return out > 0 if x.dtype == torch.bool else out

    def store_zones(self, store: BucketStore) -> BucketStore:
        """This block's zones of a host-built store, [T, n_loc*NB/n, C(,
        D|W)], as views (at one rank: the store itself, no copy)."""
        w = store.ids.shape[1] // self.n_model * self.n_loc
        zones = slice(self.block * w, (self.block + 1) * w)
        return _placed(store, zones, self.device)

    def sum_stats(self, totals: list) -> list:
        """Each tensor of `totals` summed over every rank, in one
        all_reduce."""
        flat = torch.cat([t.reshape(-1) for t in totals])
        tdist.all_reduce(flat)
        return [f.reshape(t.shape) for f, t in zip(
            flat.split([t.numel() for t in totals]), totals)]
