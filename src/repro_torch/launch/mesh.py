"""Building the port's zone meshes (`repro_torch.core.mesh`): n CAN
nodes in one process (`ZoneMesh`), or in blocks over the processes of a
`torch.distributed` world (`ProcessZoneMesh`), with the counterparts of
the reference's mesh helpers (`make_host_mesh`, `require_host_devices`,
`batch_axes`, `make_production_mesh`).

`make_zone_mesh` builds the first when no process group is initialised
and the second when one is.  The reference's `repro/compat.py` has no
port: it only shims `make_mesh` and `shard_map` across JAX versions, and
the process groups take its place.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.mesh import ProcessZoneMesh, ZoneMesh  # noqa: F401

# (world, data, blocks) -> (the default group they were made under, the
# batch group, each data row's group): every mesh of one layout shares
# its groups
_GROUPS: dict = {}


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank_device(device=None) -> torch.device:
    """This process's device: `cuda:<LOCAL_RANK>` unless the caller asks
    for the CPU (`resolve_device` raises where there is no card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def _backend_of(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_process_mesh(device=None, *, init_method: str = "env://",
                      rank: int = -1, world_size: int = -1) -> torch.device:
    """Initialise the default process group for a mesh on `device` (the
    card `cuda:<LOCAL_RANK>` unless `device="cpu"`): NCCL for a card,
    gloo for the CPU.  With the default `env://`, torchrun's variables
    give the rank and world.  Returns this process's device."""
    dev = _rank_device(device)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(_backend_of(dev), init_method=init_method,
                            rank=rank, world_size=world_size, **kw)
    return dev


@contextlib.contextmanager
def torchrun_group(device=None):
    """The process group that torchrun's environment (`WORLD_SIZE`)
    describes, for the block: initialised on entry, unless one already
    is or the environment names none, and destroyed on exit.  The
    churn CLIs run their meshes over it."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        yield
        return
    init_process_mesh(device)
    try:
        yield
    finally:
        dist.destroy_process_group()


def is_rank0() -> bool:
    """Rank 0 of the process group, or the one process without one: the
    process that prints and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def say(*args, **kw) -> None:
    """`print`, on rank 0 only."""
    if is_rank0():
        print(*args, **kw)


def require_host_devices(n: int) -> None:
    """Fail fast, with the recipe, when the world holds fewer than n
    processes (the port's counterpart of the reference's `XLA_FLAGS`
    recipe: the world is fixed when the processes start)."""
    have = _world()
    if have < n:
        raise RuntimeError(
            f"need {n} processes, have {have}: launch with "
            f"`torchrun --nproc-per-node {n} <script>` (one process per "
            "card, or per CPU worker with --device cpu)")


def make_zone_mesh(n_model: int, data: int = 1, *, device=None, pod: int = 1):
    """A mesh of `data` x `n_model` nodes on `device` (the CUDA card
    unless `device="cpu"`).

    Without an initialised process group: the one-process `ZoneMesh`.
    With one: this rank's `ProcessZoneMesh`.  The world splits into
    `data` rows of a power-of-two number of ranks; a mesh of at least a
    row's ranks in nodes spreads over the whole world, in blocks that
    divide `n_model`; a smaller one over a prefix of the world, `data`
    rows of `n_model` ranks, one node a rank (the ranks past it hold no
    zones).  The device is `cuda:<LOCAL_RANK>`, and
    the group's backend must be the device's (NCCL for a card, gloo for
    the CPU)."""
    if n_model < 1 or data < 1:
        raise ValueError(f"mesh needs n_model, data >= 1, got {n_model}, "
                         f"{data}")
    if not dist.is_initialized():
        return ZoneMesh(int(n_model), int(data), resolve_device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % data:
        raise ValueError(f"a world of {world} processes does not split into "
                         f"{data} data rows")
    row = world // data
    if row & (row - 1):
        raise ValueError(
            f"a row of {row} processes is not a power of two: launch with "
            f"`torchrun --nproc-per-node {data * (1 << row.bit_length() - 1)}"
            " <script>` (a power of two of processes a data row)")
    blocks = min(int(n_model), row)
    if n_model % blocks or n_model & (n_model - 1):
        raise ValueError(f"n_model={n_model} does not split into {blocks} "
                         "blocks of nodes, one a process")
    dev = _rank_device(device)
    backend = dist.get_backend()
    if backend != _backend_of(dev):
        raise ValueError(f"a mesh on {dev} runs over {_backend_of(dev)}, "
                         f"but the process group's backend is {backend}")
    ranks = data * blocks
    batch, rows = _mesh_groups(world, data, blocks)
    group = rows[rank // blocks] if rank < ranks else None
    return ProcessZoneMesh(int(n_model), int(data), dev, rank, world, group,
                           int(pod), 0 if ranks == world else ranks, batch)


def _mesh_groups(world: int, data: int, blocks: int):
    """(batch group, each data row's model group) of `data` rows of
    `blocks` ranks over the first data*blocks ranks of the world, None
    meaning the default group; made once per default process group and
    layout: every rank makes every group, in one order, on its first
    mesh of that layout (NCCL deadlocks otherwise)."""
    key = (world, data, blocks)
    made = _GROUPS.get(key)
    if made is None or made[0] is not dist.group.WORLD:
        ranks = data * blocks
        batch = None if ranks == world else dist.new_group(
            list(range(ranks)))
        rows = [batch] if data == 1 else [
            dist.new_group(list(range(r * blocks, (r + 1) * blocks)))
            for r in range(data)]
        made = (dist.group.WORLD, batch, rows)
        _GROUPS[key] = made
    return made[1], made[2]


def make_host_mesh(data: int = 1, model: int = 1, pod: int | None = None, *,
                   device=None):
    """A mesh of `pod` x `data` x `model` processes, one node each (tests
    and examples); the world must hold exactly that many."""
    pods = pod or 1
    n = pods * data * model
    require_host_devices(n)
    if _world() != n:
        raise RuntimeError(f"a host mesh of {n} processes needs a world of "
                           f"{n}, not {_world()}")
    return make_zone_mesh(model, pods * data, device=device, pod=pods)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: 16 x 16 (data, model) ranks, or 2 x 16 x 16
    (pod, data, model); raises without exactly that many processes."""
    return make_host_mesh(16, 16, 2 if multi_pod else None, device=device)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


# -- the LM side's named mesh -------------------------------------------------


class NamedMesh:
    """`pod` x `data` x `model` processes as a `DeviceMesh` with named
    dims, for the sharding rules (`models.sharding`): `shape` (axis ->
    size), `coordinate` (axis -> this rank's index), `device_mesh`,
    `device`, and `group(axes)`, the process group over a tuple of axes
    in mesh order."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh, self.device = device_mesh, device
        names = device_mesh.mesh_dim_names
        self.shape = dict(zip(names, device_mesh.shape))
        self.coordinate = dict(zip(names, device_mesh.get_coordinate()))
        # the group of every set of axes, made now: every rank makes
        # every group, in one order (`dist.new_group` is collective)
        self._groups = {
            axes: self._make_group(axes)
            for r in range(1, len(names) + 1)
            for axes in itertools.combinations(names, r)}

    def _make_group(self, axes: tuple):
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if all(self.shape[a] == 1 for a in self.shape if a not in axes):
            return dist.group.WORLD
        # one group for each coordinate off `axes`: its ranks row-major
        names = list(self.shape)
        on = [names.index(a) for a in axes]
        off = [i for i in range(len(names)) if i not in on]
        grid = self.device_mesh.mesh.permute(*off, *on).reshape(
            -1, self.size(axes))
        mine = None
        for ranks in grid.tolist():
            g = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine = g
        return mine

    def group(self, axes):
        """The process group over `axes` (a name, or names in mesh
        order)."""
        return self._groups[(axes,) if isinstance(axes, str)
                            else tuple(axes)]

    def size(self, axes) -> int:
        n = 1
        for a in (axes,) if isinstance(axes, str) else axes:
            n *= self.shape[a]
        return n


def make_lm_mesh(data: int = 1, model: int = 1, pod: int | None = None, *,
                 device=None) -> NamedMesh:
    """The LM side's mesh of (pod,) data x model processes over the
    initialised process group (`init_process_mesh`: gloo on the CPU,
    NCCL on a card), whose world must hold exactly that many."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("an LM mesh runs over a process group: call "
                           "init_process_mesh first, or launch with "
                           "`torchrun --nproc-per-node N`")
    names = (("pod",) if pod else ()) + ("data", "model")
    shape = ((pod,) if pod else ()) + (data, model)
    n = 1
    for s in shape:
        n *= s
    if _world() != n:
        raise RuntimeError(f"an LM mesh of {shape} processes needs a world "
                           f"of {n}, not {_world()}")
    dev = _rank_device(device)
    if dist.get_backend() != _backend_of(dev):
        raise ValueError(f"an LM mesh on {dev} runs over {_backend_of(dev)}, "
                         f"but the process group's backend is "
                         f"{dist.get_backend()}")
    return NamedMesh(init_device_mesh(dev.type, shape,
                                      mesh_dim_names=names), dev)


class PlanMesh:
    """The shape of a `pod` x `data` x `model` mesh and one rank's
    coordinates, without processes: what the sharding rules and
    `train_step.Zero3` read to place shards, for a plan on the meta
    device (no collective runs: `group` is None)."""

    def __init__(self, data: int = 1, model: int = 1, rank: int = 0):
        self.shape = {"data": data, "model": model}
        self.coordinate = {"data": rank // model, "model": rank % model}
        self.device = torch.device("meta")

    def size(self, axes) -> int:
        n = 1
        for a in (axes,) if isinstance(axes, str) else axes:
            n *= self.shape[a]
        return n

    def group(self, axes):
        return None


def model_axis_plan(cfg, data: int = 1, model: int = 1,
                    rank: int = 0) -> dict:
    """{parameter name: (its spec, this rank's shape, bytes an
    element)} of `cfg` at its width on a data x model mesh, as
    `train_step.Zero3` places the shards: the model built on the meta
    device, so no weights and no collectives at any width."""
    from repro_torch.models import model as lm
    from repro_torch.train.train_step import Zero3

    m = lm.Model(cfg, device="meta")
    zero = Zero3(m, PlanMesh(data, model, rank))
    return {n: (zero.shardings[n].spec, tuple(t.shape), t.element_size())
            for n, t in zero.shards.items()}


def plan_main(argv=None) -> None:
    """Print each configured architecture's model-axis plan at its
    published width: bytes of parameters a rank holds against the
    whole, and the leaves the model axis splits and replicates."""
    import argparse

    from repro_torch.configs import ARCH_NAMES, get_config

    ap = argparse.ArgumentParser(description=plan_main.__doc__)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=8)
    args = ap.parse_args(argv)
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        plan = model_axis_plan(cfg, args.data, args.model)
        whole = model_axis_plan(cfg)
        mine = sum(math.prod(s) * b for _, s, b in plan.values())
        full = sum(math.prod(s) * b for _, s, b in whole.values())
        split = [n for n, (spec, _, _) in plan.items() if any(
            "model" in ((e,) if isinstance(e, str) else e or ())
            for e in spec)]
        print(f"{arch}: (data {args.data}, model {args.model}) a rank holds "
              f"{mine} of {full} parameter bytes ({mine / full:.4f}); "
              f"{len(split)} of {len(plan)} leaves split over model")


def cli_mesh(args, log):
    """The LM CLIs' layout from `--mesh-data` / `--mesh-model` / `--batch`
    / `--device`: (the `NamedMesh` or None, this process's device, the
    log to use).  A mesh where `--mesh-data` or `--mesh-model` is above
    1 or a process group is up (torchrun, whose world must hold data x
    model ranks); then only rank 0 logs, and the batch must split over
    the data ranks (the model ranks of a data row take the same
    rows), or be one row, which every rank takes whole."""
    for flag in ("mesh_data", "mesh_model"):
        if getattr(args, flag) < 1:
            raise ValueError(f"--{flag.replace('_', '-')} must be >= 1, not "
                             f"{getattr(args, flag)}")
    if args.mesh_data == args.mesh_model == 1 and not dist.is_initialized():
        return None, resolve_device(args.device), log
    mesh = make_lm_mesh(args.mesh_data, args.mesh_model, device=args.device)
    if args.batch % args.mesh_data and args.batch != 1:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"--mesh-data {args.mesh_data} ranks")
    return mesh, mesh.device, log if is_rank0() else (lambda s: None)


if __name__ == "__main__":
    plan_main()
