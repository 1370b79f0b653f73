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

A `ProcessZoneMesh` issues every collective on its own groups: the
model axis, the batch axes and the world (`world_group`).
`with_own_groups()` gives the same mesh over a second set of them, so
that a second thread (the serving writer's, `repro_torch.serve.writer`)
never shares a communicator with the first.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as tdist

from repro_torch.core.runtime import BlockCollectives, MeshCollectives
from repro_torch.core.store import BucketStore


# ProcessZoneMesh.with_own_groups's group sets, by layout
_OWN_GROUPS: dict = {}


def _slices(mesh, x: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [data*n, B/(data*n), ...]: the batch slice of each data
    row and node, in node order; a batch that does not divide raises."""
    shards = mesh.data * mesh.n_model
    if x.shape[0] % shards:
        raise ValueError(f"batch of {x.shape[0]} does not shard over "
                         f"{shards} mesh slices: pad it to a multiple")
    return x.reshape((shards, -1) + x.shape[1:])


def broadcast0(outs, like, device, group=None) -> list:
    """The tensors `outs` of rank 0 on every rank of `group` (None: the
    default group), in one broadcast of their bytes; `like` gives each
    one's (shape, dtype), which a rank without `outs` (None)
    allocates."""
    sizes = [int(torch.Size(shape).numel()) * torch.empty(
        (), dtype=dtype).element_size() for shape, dtype in like]
    if outs is None:
        wire = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
    else:
        wire = torch.cat([o.contiguous().reshape(-1).view(torch.uint8)
                          for o in outs])
    tdist.broadcast(wire, src=0, group=group)
    return [part.clone().view(dtype).reshape(shape) for part, (shape, dtype)
            in zip(wire.split(sizes), like)]


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
    active = True

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.n_model}

    def collectives(self, cfg) -> MeshCollectives:
        return MeshCollectives(n=cfg.n_nodes, device=self.device)

    def with_own_groups(self) -> "ZoneMesh":
        """One process has no process groups: the mesh itself."""
        return self

    def my_slices(self, x: torch.Tensor) -> torch.Tensor:
        """[B, ...] -> [data, n, B/(data*n), ...]: every slice."""
        return _slices(self, x).reshape((self.data, self.n_model, -1)
                                        + x.shape[1:])

    def whole_batch(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def store_zones(self, store: BucketStore) -> BucketStore:
        """The global store IS the sharded store: a move to the device."""
        return _placed(store, slice(None), self.device)

    def global_store(self, store: BucketStore, num_buckets: int):
        """The global store: this one, as views."""
        return _placed(store, slice(None), store.ids.device)

    def local_node(self, node: int) -> int:
        """Node `node`'s place in this process's store slice."""
        return node

    def sum_stats(self, totals: list) -> list:
        return totals

    def on_nodes(self, fn, like) -> list:
        return fn()

    def reduce_ranks(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return x


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessZoneMesh:
    """This process's place in a mesh of `data` rows of `n_model` nodes
    spread over the first `data x blocks` ranks (`ranks`) of a
    `torch.distributed` world of `world` ranks.

    `model_group` holds the ranks of this rank's data row (the model
    axis, None meaning the default group); `batch_group` the mesh's
    ranks (None: the default group, when they are the whole world);
    `world_group` every rank (None: the default group).  `prefix` > 0
    is the mesh's rank count where it is a prefix of the world (0: every
    rank).  `pod` > 1 splits the data rows into pods, for the shape of a
    multi-pod mesh."""

    n_model: int
    data: int
    device: torch.device
    rank: int
    world: int
    model_group: object = None
    pod: int = 1
    prefix: int = 0
    batch_group: object = None
    world_group: object = None

    @property
    def ranks(self) -> int:
        """The ranks that hold nodes: ranks 0 .. ranks-1."""
        return self.prefix or self.world

    @property
    def active(self) -> bool:
        """Does this rank hold nodes?  The ranks past a prefix do not."""
        return self.rank < self.ranks

    @property
    def blocks(self) -> int:
        return self.ranks // self.data

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

    def with_own_groups(self) -> "ProcessZoneMesh":
        """This mesh over a second set of process groups (world, batch
        and each data row's model group), made once per default process
        group and layout: every rank of the world must make it, in one
        order, on its first call for the layout (NCCL and gloo require
        it); later calls reuse it."""
        key = (self.world, self.ranks, self.data, self.blocks)
        made = _OWN_GROUPS.get(key)
        if made is None or made[0] is not tdist.group.WORLD:
            world = tdist.new_group(list(range(self.world)))
            batch = world if self.ranks == self.world else tdist.new_group(
                list(range(self.ranks)))
            rows = [batch] if self.data == 1 else [
                tdist.new_group(list(range(r * self.blocks,
                                           (r + 1) * self.blocks)))
                for r in range(self.data)]
            made = (tdist.group.WORLD, world, batch, rows)
            _OWN_GROUPS[key] = made
        _, world, batch, rows = made
        return dataclasses.replace(
            self, model_group=rows[self.row] if self.active else None,
            batch_group=batch, world_group=world)

    def collectives(self, cfg) -> BlockCollectives:
        return BlockCollectives(n=cfg.n_nodes, n_loc=self.n_loc,
                                block=self.block, device=self.device,
                                group=self.model_group,
                                batch_group=self.batch_group)

    def my_slices(self, x: torch.Tensor) -> torch.Tensor:
        """[B, ...] -> [1, n_loc, B/(data*n), ...]: the slices of this
        rank's data row and block."""
        lo = self.rank * self.n_loc
        return _slices(self, x)[lo:lo + self.n_loc][None]

    def whole_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch's [B, ...] results from this process's
        [b, ...]: all-gathered over the mesh's ranks, in rank order."""
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        out = wire.new_empty((self.ranks * x.shape[0],) + x.shape[1:])
        tdist.all_gather_into_tensor(out, wire, group=self.batch_group)
        return out > 0 if x.dtype == torch.bool else out

    def _zone_width(self, nb: int) -> int:
        return nb // self.blocks

    def store_zones(self, store: BucketStore) -> BucketStore:
        """This block's zones of a host-built store, [T, n_loc*NB/n, C(,
        D|W)], as views (at one rank: the store itself, no copy); an
        empty slice on a rank past the prefix."""
        w = self._zone_width(store.ids.shape[1])
        lo = self.block * w if self.active else 0
        zones = slice(lo, lo + w if self.active else 0)
        return _placed(store, zones, self.device)

    def global_store(self, store: BucketStore, num_buckets: int):
        """The global [T, NB, ...] store on every rank, from the blocks'
        zones (`store`), all-gathered over the world (a rank past the
        prefix sends fill); at a world of one, the store itself."""
        if self.world == 1:
            return _placed(store, slice(None), store.ids.device)
        w = self._zone_width(num_buckets)

        def gather(x):
            if x is None:
                return None
            zones = x.movedim(1, 0)
            if not self.active:
                zones = zones.new_zeros((w,) + zones.shape[1:])
            out = zones.new_empty((self.world * w,) + zones.shape[1:])
            tdist.all_gather_into_tensor(out, zones.contiguous(),
                                         group=self.world_group)
            return out[:self.blocks * w].movedim(0, 1).contiguous()

        return BucketStore(gather(store.ids), gather(store.timestamps),
                           gather(store.write_ptr), gather(store.payload),
                           store.generation)

    def local_node(self, node: int) -> int | None:
        """Node `node`'s place in this rank's store slice, or None where
        this rank does not hold it."""
        local = node - self.block * self.n_loc
        return local if self.active and 0 <= local < self.n_loc else None

    def sum_stats(self, totals: list) -> list:
        """Each tensor of `totals` summed over the mesh's ranks, in one
        all_reduce."""
        flat = torch.cat([t.reshape(-1) for t in totals])
        tdist.all_reduce(flat, group=self.batch_group)
        return [f.reshape(t.shape) for f, t in zip(
            flat.split([t.numel() for t in totals]), totals)]

    def on_nodes(self, fn, like) -> list:
        """`fn()`'s list of tensors, computed by the ranks that hold
        nodes, on every rank: a rank past the prefix receives rank 0's
        by one broadcast over the world; `like` gives each output's
        (shape, dtype)."""
        outs = fn() if self.active else None
        if self.ranks == self.world:
            return outs
        return broadcast0(outs, like, self.device, self.world_group)

    def reduce_ranks(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`x` reduced (`sum` or `max`) over every rank of the world."""
        out = x.clone()
        if self.world > 1:
            tdist.all_reduce(out, op=dict(sum=tdist.ReduceOp.SUM,
                                          max=tdist.ReduceOp.MAX)[op],
                             group=self.world_group)
        return out
