"""Logical-axis sharding rules and the mesh context, on torch.

The port of `repro.models.sharding`.  Every tensor of the model is named
by *logical* axes; a rules table maps logical axes onto the mesh axes
`pod`, `data` and `model`, so a change of parallel layout is a change of
rules, not of model code.

A spec is a tuple with one entry per tensor dim: None, a mesh axis name,
or a tuple of names (`PartitionSpec`'s counterpart).  Resolution reads
only `mesh.shape`, a dict from axis name to size, so any object with such
a `.shape` resolves: the LM side's `launch.mesh.NamedMesh`, the index
side's zone meshes, or a plain stand-in for a production mesh of 256
processes.  Placement (`placements`, `local_slices`) also needs the
mesh's `device_mesh` (a `torch.distributed.device_mesh.DeviceMesh` whose
dims are named after the axes) and `coordinate` (this rank's index on
each axis).

The context (`use_mesh`) is thread-local, as the reference's.  Outside a
mesh every constraint is a no-op and `batch_sum` returns its input, so
the same model code runs on one device.  Inside one, `batch_sum` is the
all-reduce over the batch axes that the data-parallel loss needs where
the reference's GSPMD sees the whole batch (the cross-entropy's sums,
the MoE load-balance terms).

The model axis (tensor and expert parallelism) is carried out by hand,
where the reference leaves it to GSPMD: each model rank holds its share
of a model-split parameter (`model_slice` gives the index range of it)
and computes with it; `enter` marks a replicated tensor that feeds a
model-split computation (identity; its backward all-reduces the
gradient over the model group), `leave` sums the ranks' partial outputs
(all-reduce; its backward passes the gradient through), and
`model_gather` all-gathers a split tensor.  With a model group of size 1
every one of them returns its input.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
import torch.distributed as dist

# Default rules: how logical axes map onto the production mesh.
#   batch       -> all data-parallel axes (pod + data)
#   fsdp        -> weight sharding over the data axis (ZeRO-3 style)
#   tensor axes -> model
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "data",      # long-context KV/state sharding (SP)
    "d_model": None,
    "fsdp": "data",           # weight d_model/ d_inner rows (ZeRO-3)
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,
    "d_inner": "model",
    "d_state": None,
    "conv": None,
    "layers": None,
    "dt_rank": None,
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict | None = None
        # model_slice's resolutions under this (mesh, rules)
        self.slices: dict = {}


_CTX = _Ctx()


def _merged(rules: dict | None) -> dict:
    base = dict(DEFAULT_RULES)
    if rules:
        base.update(rules)
    return base


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    """(mesh, DEFAULT_RULES updated by `rules`) for this thread, for the
    block."""
    with restored((mesh, _merged(rules), {})):
        yield


def context() -> tuple:
    """This thread's (mesh, rules, resolutions), for `restored`."""
    return _CTX.mesh, _CTX.rules, _CTX.slices


@contextlib.contextmanager
def restored(ctx: tuple):
    """The context of `context()` on this thread, for the block."""
    prev = context()
    _CTX.mesh, _CTX.rules, _CTX.slices = ctx
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.slices = prev


def current_mesh():
    return _CTX.mesh


def axis_size(name: str) -> int:
    m = _CTX.mesh
    if m is None or name not in m.shape:
        return 1
    return m.shape[name]


def _resolve(logical_axes: tuple, shape: tuple | None = None) -> tuple:
    rules = _CTX.rules or DEFAULT_RULES
    mesh = _CTX.mesh
    out, used = [], set()
    for i, ax in enumerate(logical_axes):
        if ax is None:
            out.append(None)
            continue
        mapped = rules.get(ax)
        if mapped is None:
            out.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        # drop mesh axes that don't exist (e.g. 'pod' on single-pod) or were
        # already consumed by an earlier tensor dim
        axes = tuple(
            a for a in axes
            if mesh is not None and a in mesh.shape and a not in used
        )
        # shape-aware fallback: drop trailing mesh axes until the dim
        # divides evenly (e.g. 10 KV heads cannot shard over a 16-way
        # model axis -> replicate).
        if shape is not None and axes:
            dim = shape[i]
            while axes:
                prod = 1
                for a in axes:
                    prod *= mesh.shape[a]
                if dim % prod == 0:
                    break
                axes = axes[:-1]
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return tuple(out)


def logical_spec(logical_axes: tuple) -> tuple:
    """The spec of the given logical axes under the current rules."""
    return _resolve(tuple(logical_axes))


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh: `NamedSharding`'s counterpart."""
    mesh: object
    spec: tuple

    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def constrain(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """A DTensor redistributed to the logical axes' spec inside a mesh
    context; anything else (a plain tensor, or no mesh) as it is."""
    from torch.distributed.tensor import DTensor

    mesh = _CTX.mesh
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = _resolve(tuple(logical_axes), tuple(x.shape))
    return x.redistribute(x.device_mesh, placements(mesh, spec))


def named_sharding(*logical_axes: str | None) -> NamedSharding | None:
    mesh = _CTX.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, _resolve(tuple(logical_axes)))


def _map_tree(fn, tree, other=None):
    """`fn(leaf, other leaf)` over a nested dict whose leaves are spec
    tuples, `other` a dict of the same structure (or None)."""
    if isinstance(tree, tuple):
        return fn(tree, other)
    return {k: _map_tree(fn, v, None if other is None else other[k])
            for k, v in tree.items()}


def spec_tree_to_shardings(mesh, spec_tree, shape_tree=None,
                           rules: dict | None = None):
    """A nested dict of logical-axis tuples -> the same dict of
    `NamedSharding`s.  With `shape_tree` (the same structure, leaves
    with `.shape`), mesh axes that do not divide a dim are dropped from
    it."""
    with use_mesh(mesh, rules):
        return _map_tree(
            lambda axes, leaf: NamedSharding(mesh, _resolve(
                tuple(axes), None if leaf is None else tuple(leaf.shape))),
            spec_tree, shape_tree)


# -- placement ---------------------------------------------------------------


def _dims_of(spec: tuple) -> dict:
    """mesh axis -> the tensor dim it shards."""
    out = {}
    for d, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            out[a] = d
    return out


def placements(mesh, spec: tuple) -> tuple:
    """The DTensor placements of `spec` on the mesh's DeviceMesh: one a
    mesh dim, `Shard(d)` where the axis shards tensor dim d, else
    `Replicate()`.  A dim sharded by several axes takes them in mesh
    order (outer first), as DTensor nests them."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.shape)
    for entry in spec:
        if isinstance(entry, tuple) and \
                [names.index(a) for a in entry] != sorted(
                    names.index(a) for a in entry):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
    dims = _dims_of(spec)
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in names)


def as_dtensor(local: torch.Tensor, sharding: NamedSharding, shape):
    """This rank's shard `local` of a tensor of `shape`, laid out by
    `sharding`, as a DTensor on the mesh's DeviceMesh."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        local, sharding.mesh.device_mesh, sharding.placements(),
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(tuple(shape), device="meta").stride())


def split_axes(mesh, spec: tuple) -> list:
    """[(tensor dim, (mesh axes of size > 1 that split it, in spec
    order))] of the dims that `spec` really splits on this mesh."""
    out = []
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        axes = tuple(a for a in axes if mesh.shape[a] > 1)
        if axes:
            out.append((d, axes))
    return out


def local_slices(mesh, spec: tuple, shape) -> tuple:
    """This rank's slice of a tensor of `shape` laid out by `spec`: a
    dim split by axes (a1, a2, ...) is cut into their product of equal
    chunks, indexed row-major by this rank's coordinates."""
    sl = [slice(None)] * len(shape)
    for d, axes in split_axes(mesh, spec):
        n, idx = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + mesh.coordinate[a]
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways (spec {spec})")
        w = shape[d] // n
        sl[d] = slice(idx * w, (idx + 1) * w)
    return tuple(sl)


def local_shape(mesh, spec: tuple, shape) -> tuple:
    return tuple(len(range(*s.indices(n))) for s, n in
                 zip(local_slices(mesh, spec, shape), shape))


# -- the data-parallel reductions of the loss ----------------------------------


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over a group.  Backward passes the gradient
    through unchanged: every rank computes the same loss from the sum,
    and the trainer sums the ranks' parameter gradients."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def batch_axes() -> tuple:
    """The mesh axes of size > 1 that `batch` resolves to (none outside
    a mesh)."""
    mesh = _CTX.mesh
    if mesh is None:
        return ()
    axes = _resolve(("batch",))[0]
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return tuple(a for a in axes if mesh.shape[a] > 1)


def batch_group():
    """(the process group over `batch_axes()`, its size), or (None, 1)
    where there are none."""
    axes = batch_axes()
    if not axes:
        return None, 1
    n = 1
    for a in axes:
        n *= _CTX.mesh.shape[a]
    return _CTX.mesh.group(axes), n


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the batch ranks (differentiable, see `_SumOver`);
    x itself outside a data-parallel mesh."""
    group, n = batch_group()
    if n == 1:
        return x
    return _SumOver.apply(x, group)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the batch ranks of each rank's x (equal shares of
    the batch make it the whole batch's mean); x outside a mesh."""
    _, n = batch_group()
    return x if n == 1 else batch_sum(x) / n


def _rows_split(rows: int) -> tuple:
    """(group, n): the ranks that a batch of `rows` rows splits over,
    as the reference's `_batch_sharding` places it.  The batch axes
    where the rows divide over them; else the pod and data axes (a
    preset whose batch axes take `model` too); a one-row batch, or one
    whose fallback axes have one rank, is whole on every rank (None,
    1).  Raises where the rows divide over neither."""
    group, n = batch_group()
    if n == 1 or rows % n == 0:
        return group, n
    if rows == 1:
        return None, 1
    mesh = _CTX.mesh
    axes = tuple(a for a in ("pod", "data")
                 if a in mesh.shape and mesh.shape[a] > 1)
    m = 1
    for a in axes:
        m *= mesh.shape[a]
    if axes != batch_axes() and rows % m == 0:
        return (mesh.group(axes), m) if m > 1 else (None, 1)
    raise ValueError(f"a batch of {rows} rows does not split over {n} "
                     f"data-parallel ranks")


def batch_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch tensor: the batch ranks take
    equal blocks of rows in rank order, as the reference's `batch` axis
    shards them (`_rows_split`: a one-row batch is every rank's, as the
    reference replicates it).  Raises where the rows do not divide.  A
    row held by r ranks enters the loss's sums r times over and so does
    its count: `batch_sum` / `batch_mean` give the same mean."""
    group, n = _rows_split(x.shape[0])
    if n == 1:
        return x
    w = x.shape[0] // n
    i = dist.get_rank(group)
    return x[i * w:(i + 1) * w]


def batch_gather(x: torch.Tensor, rows: int) -> torch.Tensor:
    """The global batch of `rows` rows from each rank's rows
    (`batch_rows`' inverse: gathered over the ranks `_rows_split` split
    them over, x itself where every rank holds them whole), on every
    rank."""
    group, n = _rows_split(rows)
    if n == 1:
        return x
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


# -- the model axis -------------------------------------------------------------


def model_size() -> int:
    """The size of the model axis (1 outside a mesh, and where the
    rules put `model` among the batch axes, as the zero3 presets do:
    the model ranks then hold other rows, and `train_step.Zero3`
    gathers a leaf that `model` splits whole, as it gathers any batch
    split, so no layer computes a model share)."""
    if "model" in batch_axes():
        return 1
    return axis_size("model")


def model_rank() -> int:
    """This rank's coordinate on the model axis (0 outside a mesh)."""
    return _CTX.mesh.coordinate["model"] if model_size() > 1 else 0


def model_group():
    """The process group over the model axis (None where it has size
    1)."""
    return _CTX.mesh.group("model") if model_size() > 1 else None


def model_slice(logical_axes: tuple, shape: tuple, dim: int) -> slice:
    """The index range, on `dim`, of this model rank's share of a leaf
    of `logical_axes` and whole `shape`: the rules resolved with the
    shape-aware fallback (a dim that does not divide is whole), the
    model axis alone kept, and `local_slices` of that spec.  The whole
    range outside a mesh or where the model axis does not split `dim`.
    A layer reads whether its leaves split from here, never from the
    axis size alone."""
    if model_size() == 1:
        return slice(0, shape[dim])
    key = (logical_axes, shape, dim)
    got = _CTX.slices.get(key)
    if got is None:
        spec = tuple(
            "model" if "model" in ((e,) if isinstance(e, str) else e or ())
            else None for e in _resolve(logical_axes, shape))
        start, stop, _ = local_slices(_CTX.mesh, spec, shape)[dim].indices(
            shape[dim])
        got = _CTX.slices[key] = slice(start, stop)
    return got


def is_split(s: slice, n: int) -> bool:
    """Whether `s` (a `model_slice`) is a share of a dim of size n."""
    return s.stop - s.start < n


class _ReduceGrad(torch.autograd.Function):
    """Identity; the backward all-reduces (sums) the gradient over the
    group: each rank's model-split computation gives only its share of
    the gradient of a replicated input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def enter(x: torch.Tensor) -> torch.Tensor:
    """x, a tensor every model rank holds whole, into a model-split
    computation: identity forward, gradient summed over the model ranks
    in the backward."""
    if model_size() == 1:
        return x
    return _ReduceGrad.apply(x, model_group())


def leave(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model ranks of each rank's partial x (a
    row-parallel product, a masked lookup); the backward passes the
    gradient through, since every rank then computes the same loss."""
    if model_size() == 1:
        return x
    return _SumOver.apply(x, model_group())


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of x over the model ranks (no gradient)."""
    if model_size() == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=model_group())
    return y


class _GatherModel(torch.autograd.Function):
    """All-gather of each rank's block along `dim`, in model-rank order
    (the group's rank order: the device mesh's coordinate).  The
    backward gives this rank its block of the gradient: summed over the
    ranks (a reduce-scatter) where each rank uses its own part of the
    gathered tensor (`split_use`), taken from its own copy where every
    rank computes the same thing from it."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank, split_use):
        ctx.dim, ctx.group, ctx.n, ctx.split_use = dim, group, n, split_use
        ctx.rank = rank
        x0 = x.movedim(dim, 0).contiguous()
        out = x0.new_empty((n * x0.shape[0],) + tuple(x0.shape[1:]))
        dist.all_gather_into_tensor(out, x0, group=group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        g0 = g.movedim(ctx.dim, 0).contiguous()
        w = g0.shape[0] // ctx.n
        if ctx.split_use:
            part = g0.new_empty((w,) + tuple(g0.shape[1:]))
            dist.reduce_scatter_tensor(part, g0, group=ctx.group)
        else:
            part = g0[ctx.rank * w:(ctx.rank + 1) * w]
        return (part.movedim(0, ctx.dim).contiguous(), None, None, None,
                None, None)


def model_gather(x: torch.Tensor, dim: int, split_use: bool) -> torch.Tensor:
    """The whole tensor from each model rank's block of it along `dim`
    (see `_GatherModel` for `split_use`); x itself at model size 1."""
    n = model_size()
    if n == 1:
        return x
    return _GatherModel.apply(x, dim % x.dim(), model_group(), n,
                              model_rank(), split_use)
