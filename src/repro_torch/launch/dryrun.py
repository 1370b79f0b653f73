"""Multi-pod dry run: step every (arch x shape x mesh) cell on the meta
device, as one rank of a fake process group the size of the mesh.

The port of `repro.launch.dryrun`.  The reference lowers and compiles
each cell's step on 512 forced host devices and reads XLA's memory and
cost analyses and the collectives of the post-SPMD HLO.  The port has no
compiler to ask, so it runs the step itself: the model, its shards, the
optimizer state, the batch rows and the decode states live on the meta
device (shapes and dtypes, no storage), the process group is
`torch.testing._internal.distributed.fake_pg`'s (every collective
returns at once, moving nothing), and one rank's train step, prefill or
decode step runs once through the port's own code (`train_step.Zero3`,
`make_sharded_train_step`, `models.model.prefill` / `decode_step`).
Counters on the dispatcher see every op that this rank would run, and
record, per rank:

  * `cost.flops`: `torch.utils.flop_counter.FlopCounterMode`'s count,
    from its registry (`flop_registry`: products, convolutions and
    attention; elementwise ops count 0) with no module hooks: the mode's
    own hooks keep the backward's tensors alive, which would swell the
    peak it is run beside;
  * `cost.bytes_accessed`: the bytes of every aten op's tensor inputs
    and outputs, views left out: an unfused upper bound;
  * `cost.transcendentals`: the elements of the ops in
    `TRANSCENDENTAL_OPS` (outputs; the input for the softmax family);
  * `collectives`: each c10d op's result buffer, under the reference's
    HLO names and ring wire factors (`_WIRE_FACTOR`);
  * `memory`: the arguments' bytes (this rank's parameter shards,
    optimizer state, batch rows, decode states and token), the peak of
    the storage that the step allocates on top of them (`temp_bytes`,
    every output followed until its storage dies), what the step
    returns or writes in place, and whether the peak fits the card.

These are computed, not measured.  The layers and the loss are Python
loops over every layer, chunk and time step, so the counts see every
executed op whether `--unroll` is given or not: `benchmarks/roofline.py`'s
correction for a scan body counted once does not apply to these records.

A value the step would read on the host raises on the meta device; the
port's train, prefill and decode steps read none, so no step needs a
shape-only stand-in.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_applicable
from repro_torch.data import tokens as data_tokens
from repro_torch.launch.mesh import NamedMesh
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models import unroll as unroll_mod
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import Tracer
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts

# archs big enough to need int8 optimizer states (the reference's)
INT8_OPT_ARCHS = {"llama4-maverick-400b-a17b", "jamba-v0.1-52b"}

# encoder context of the enc-dec decode cells (the decoder's KV is the
# cell's seq_len; the encoder side is a fixed audio context)
ENCDEC_DECODE_SRC_LEN = 4096

# tokens of the prefill that builds a decode cell's states, or the cell's
# seq_len where that is shorter (the recurrent states' shapes do not
# depend on it; the KV caches are padded to the seq_len)
DECODE_PREFILL_LEN = 256

# The reference's sharding-rule presets.
#   default : DP over (pod, data) x TP/EP over model (Megatron-style)
#   zero3   : pure data parallelism over ALL axes + fully-sharded weights
#   zero3b  : zero3 with the vocab dim replicated
RULE_PRESETS = {
    "default": None,
    "zero3": {
        "batch": ("pod", "data", "model"),
        "fsdp": ("data", "model"),
        "heads": None,
        "kv_heads": None,
        "d_ff": None,
        "d_inner": None,
        "expert_ff": None,
    },
    "zero3b": {
        "batch": ("pod", "data", "model"),
        "fsdp": ("data", "model"),
        "heads": None,
        "kv_heads": None,
        "d_ff": None,
        "d_inner": None,
        "expert_ff": None,
        "vocab": None,
    },
}

# ring-algorithm wire multipliers (bytes crossing links / buffer size), the
# reference's; `broadcast` is the port's own: GSPMD computes a replicated
# value on every device and emits no broadcast, while the port's pipeline
# and serving paths send one rank's tensor to the others
_WIRE_FACTOR = {
    "all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0, "broadcast": 1.0,
}

# c10d op -> the reference's HLO name of the collective; the op's first
# argument is its result buffer (or a list of them)
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast",
}
# c10d ops that move no data
_C10D_QUIET = {"barrier", "monitored_barrier_"}

# the transcendental functions, counted by output elements; the softmax
# family (an exp an element) by input elements
TRANSCENDENTAL_OPS = (
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log2", "log10", "log1p",
    "tanh", "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "sqrt",
    "sqrt_", "sin", "cos", "erf", "erfc", "erfinv", "silu", "silu_",
    "silu_backward", "gelu", "gelu_backward", "softplus",
    "softplus_backward", "pow")
_SOFTMAX_OPS = ("_softmax", "_log_softmax", "logsumexp")

# The card's memory where no card is present: an NVIDIA H100 80GB HBM3
# (data sheet: 80 GB), as torch.cuda.get_device_properties(0).total_memory
# read it on one with torch 2.11 + CUDA 12.8
H100_MEMORY_BYTES = 85_017_493_504

def device_memory_bytes() -> int:
    """The card's memory: the present card's, else `H100_MEMORY_BYTES`."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_MEMORY_BYTES


# -- the fake world ---------------------------------------------------------


def mesh_names(mesh_shape: tuple) -> tuple:
    """The axis names of a mesh shape: (data, model), or (pod, data,
    model) for three dims."""
    if len(mesh_shape) not in (2, 3):
        raise ValueError(f"a mesh is (data, model) or (pod, data, model), "
                         f"not {mesh_shape}")
    return ("pod", "data", "model")[3 - len(mesh_shape):]


@contextlib.contextmanager
def fake_world(mesh_shape: tuple, rank: int = 0):
    """A fake process group of prod(mesh_shape) ranks, this process rank
    `rank`, for the block: yields its `launch.mesh.NamedMesh` (axes pod /
    data / model, device meta).  Collectives return at once and move
    nothing.  Refuses to start under an initialised process group, and
    destroys the group on exit, also on an exception."""
    from torch.distributed.device_mesh import init_device_mesh
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg "
            "(a fake process group), which this torch lacks") from e
    if dist.is_initialized():
        raise RuntimeError("the dry run runs in a fake world of its own: a "
                           "process group is already initialised")
    shape = tuple(int(s) for s in mesh_shape)
    names = mesh_names(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        dm = init_device_mesh("cpu", shape, mesh_dim_names=names)
        yield NamedMesh(dm, torch.device("meta"))
    finally:
        dist.destroy_process_group()


# -- the counters -------------------------------------------------------------


def _storages(tensors) -> dict:
    """{id: (storage, bytes)} of the distinct storages under `tensors`."""
    out = {}
    for t in tree_leaves(tensors):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = (st, st.nbytes())
    return out


def tensor_bytes(tree) -> int:
    """The bytes of the distinct storages of the tensors in `tree`."""
    return sum(b for _, b in _storages(tree).values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_POINTWISE_DTYPES: dict = {}


def _stand_in(a):
    """A one-element CPU tensor of a's dtype (0-dim where a is), so the
    op's type promotion sees what it sees on a."""
    if not isinstance(a, torch.Tensor):
        return a
    return torch.zeros(() if a.dim() == 0 else (1,), dtype=a.dtype)


def _pointwise_on_meta(func, args, kwargs):
    """A pointwise op's output on meta tensors, without the op's meta
    kernel (a Python decomposition, ~0.5 ms an op: the sLSTM's time loop
    makes millions): the broadcast of its tensor arguments' shapes, the
    dtype of the same op on one-element CPU stand-ins, C-contiguous (as
    TensorIterator lays out an elementwise output where every input is
    C-contiguous); an in-place op's self.  None, for the op's own meta
    kernel, where that does not hold: the op is not pointwise, writes
    `out=`, sets a layout (`clone`, `memory_format=`), returns more than
    one tensor, has no input on the meta device, or has one off it that
    is not 0-dim, or one not C-contiguous (strides those `torch.empty`
    gives)."""
    if torch.Tag.pointwise not in func.tags or "out" in kwargs or \
            "memory_format" in kwargs or func is torch.ops.aten.clone.default:
        return None
    rets = func._schema.returns
    if len(rets) != 1 or str(rets[0].type) != "Tensor":
        return None
    tensors = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
    if not any(t.device.type == "meta" for t in tensors) or any(
            (t.device.type != "meta" and t.dim() != 0) or not _canonical(t)
            for t in tensors):
        return None
    if rets[0].alias_info is not None:          # in place: self
        return args[0]
    key = (func,) + tuple(
        (a.dtype, a.dim() == 0) if isinstance(a, torch.Tensor) else type(a)
        for a in tree_leaves((args, kwargs)))
    dtype = _POINTWISE_DTYPES.get(key)
    if dtype is None:
        dtype = func(*(_stand_in(a) for a in args),
                     **{k: _stand_in(v) for k, v in kwargs.items()}).dtype
        _POINTWISE_DTYPES[key] = dtype
    return torch.empty(torch.broadcast_shapes(*(t.shape for t in tensors)),
                       dtype=dtype, device="meta")


def _canonical(t: torch.Tensor) -> bool:
    """Whether t's strides are those `torch.empty` gives its shape."""
    step = 1
    for n, st in zip(reversed(t.shape), reversed(t.stride())):
        if st != step:
            return False
        step *= n
    return True


class _FastMeta(TorchDispatchMode):
    """Runs pointwise ops on meta tensors by `_pointwise_on_meta` (the
    cells' build: the decode states' prefill)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _pointwise_on_meta(func, args, kwargs)
        return func(*args, **kwargs) if out is None else out


class StepCounter(TorchDispatchMode):
    """`with StepCounter(arguments) as c: out = step()`, then
    `c.record(out)`: the cost, collectives and memory of every op
    dispatched in the block (see the module docstring).  `arguments`
    are the tensors the step holds when it starts (their storages count
    as arguments, not temporaries).  The same counters run around a
    real step on real tensors (the tests' gloo worlds), where they count
    the same ops."""

    def __init__(self, arguments):
        super().__init__()
        self.args = _storages(arguments)   # id -> (storage, bytes)
        self.argument_bytes = sum(b for _, b in self.args.values())
        self.written: set = set()      # argument storages written in place
        self.live: dict = {}           # id -> [bytes, weakref]
        self.cur = self.peak = 0
        self.aten_ops = 0
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.coll_bytes: dict = {}
        self.coll_counts: dict = {}

    def _dead(self, key, _ref):
        got = self.live.pop(key, None)
        if got is not None:
            self.cur -= got[0]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.args:
            return
        n = st.nbytes()
        got = self.live.get(key)
        if got is None:
            self.live[key] = [n, weakref.ref(st, lambda r, k=key:
                                             self._dead(k, r))]
            self.cur += n
        elif got[0] != n:              # a storage resized in place
            self.cur += n - got[0]
            got[0] = n
        self.peak = max(self.peak, self.cur)

    def _collective(self, name: str, args) -> None:
        op = _C10D.get(name)
        if op is None:
            if name in _C10D_QUIET:
                return
            raise RuntimeError(f"the dry run does not know c10d.{name}")
        size = sum(_nbytes(t) for t in tree_leaves(args[0])
                   if isinstance(t, torch.Tensor))
        self.coll_bytes[op] = self.coll_bytes.get(op, 0.0) + \
            size * _WIRE_FACTOR[op]
        self.coll_counts[op] = self.coll_counts.get(op, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _pointwise_on_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        ns = func.namespace
        name = func.__name__.split(".")[0]
        if ns == "c10d":
            self._collective(name, args)
            return out
        if ns != "aten":
            return out
        self.aten_ops += 1
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                val = args[i] if i < len(args) else kwargs.get(a.name)
                for t in tree_leaves(val):
                    if isinstance(t, torch.Tensor):
                        key = id(t.untyped_storage())
                        if key in self.args:
                            self.written.add(key)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if func.is_view:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        if name in TRANSCENDENTAL_OPS:
            self.transcendentals += sum(t.numel() for t in outs)
        elif name in _SOFTMAX_OPS:
            self.transcendentals += ins[0].numel()
        return out


    def record(self, outputs=None) -> dict:
        """{cost, collectives, memory, aten_ops}; `outputs` is what the
        step returned (its new storages count as output bytes)."""
        alias = sum(self.args[k][1] for k in self.written)
        returned = sum(b for k, (_, b) in _storages(outputs).items()
                       if k not in self.args)
        return dict(
            cost=dict(flops=int(self.flops),
                      bytes_accessed=int(self.bytes_accessed),
                      transcendentals=int(self.transcendentals)),
            collectives=dict(bytes_by_op=dict(self.coll_bytes),
                             counts=dict(self.coll_counts),
                             total_wire_bytes=sum(self.coll_bytes.values())),
            memory=dict(argument_bytes=self.argument_bytes,
                        output_bytes=returned + alias,
                        temp_bytes=self.peak,
                        generated_code_bytes=None,
                        alias_bytes=alias,
                        peak_bytes=self.argument_bytes + self.peak),
            aten_ops=self.aten_ops)


# -- the cells ----------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """One rank's step of a cell, built on the meta device: `step()`
    runs it; `arguments` are the tensors it holds when it starts, by
    part (params, opt, batch, states)."""
    meta: dict
    step: object
    arguments: dict


def _shape_spec(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _rows(mesh, rules, batch: dict) -> dict:
    """This rank's rows of a batch, each in storage of its own (a rank
    holds its rows, not the global batch they are cut from)."""
    with sh.use_mesh(mesh, rules):
        return {k: sh.batch_rows(v).clone() for k, v in batch.items()}


def _decode_prefill_batch(cfg: ModelConfig, b: int, s: int) -> dict:
    pre = data_tokens.input_specs(cfg, b, min(DECODE_PREFILL_LEN, s),
                                  kind="prefill")
    if cfg.encoder_layers:
        pre["frames"] = torch.empty((b, ENCDEC_DECODE_SRC_LEN, cfg.d_model),
                                    dtype=torch.float32, device="meta")
    return pre


def _states_of(model, zero, mesh, rules, cfg, b: int, s: int):
    """This rank's decode states: a `DECODE_PREFILL_LEN`-token prefill
    at max_len s (the KV caches padded to s, and every state laid out
    as the reference's `_decode_state_shardings` lays it out:
    `sharding.cache_spec`, `sharding.state_spec`), as the reference
    builds them, with the gathered weights."""
    rows = _rows(mesh, rules, _decode_prefill_batch(cfg, b, s))
    zero.gather()
    try:
        with torch.no_grad(), sh.use_mesh(mesh, rules), _FastMeta():
            _, states = M.prefill(model, rows, max_len=s, rows=b)
    finally:
        zero.release()
    return states


def build_cell(arch: str, shape, mesh: NamedMesh, rules: dict | None = None,
               *, cfg: ModelConfig | None = None) -> Cell:
    """The counterpart of the reference's `build_lowering`: this rank's
    step of the cell on `mesh` (a `fake_world`'s), everything on the
    meta device.  `shape` is a name in `configs.shapes.SHAPES` or a
    `ShapeSpec`; `cfg` replaces `get_config(arch)`.  Train: one
    `make_sharded_train_step` over `Zero3` shards and the optimizer
    state (int8 for `INT8_OPT_ARCHS`); prefill: the prefill at max_len
    = seq_len with the gathered weights; decode: one `decode_step` at
    position seq_len - 1 against the states of a 256-token prefill."""
    cfg = cfg or get_config(arch)
    spec = _shape_spec(shape)
    b, s = spec.global_batch, spec.seq_len
    meta = dict(arch=arch, shape=spec.name, kind=spec.kind, batch=b, seq=s,
                mesh=tuple(mesh.shape.values()))
    model = M.Model(cfg, device="meta")
    zero = ts.Zero3(model, mesh, rules)
    params = list(zero.shards.values())

    if spec.kind == "train":
        ocfg = opt_mod.OptConfig(
            state_dtype="int8" if arch in INT8_OPT_ARCHS else "fp32")
        state = zero.init_opt_state(ocfg)
        rows = _rows(mesh, rules, data_tokens.input_specs(cfg, b, s,
                                                          kind="train"))
        train = ts.make_sharded_train_step(cfg, ocfg, zero, ts.TrainHParams())

        def step():
            return train(model, state, rows)

        return Cell(meta, step, dict(params=params, opt=state, batch=rows))

    if spec.kind == "prefill":
        rows = _rows(mesh, rules, data_tokens.input_specs(cfg, b, s,
                                                          kind="prefill"))

        def step():
            zero.gather()
            try:
                with torch.no_grad(), sh.use_mesh(mesh, rules):
                    return M.prefill(model, rows, max_len=s, rows=b)
            finally:
                zero.release()

        return Cell(meta, step, dict(params=params, batch=rows))

    states = _states_of(model, zero, mesh, rules, cfg, b, s)
    token = _rows(mesh, rules, {"token": torch.empty(
        (b,), dtype=torch.int32, device="meta")})["token"]

    def step():
        zero.gather()
        try:
            with torch.no_grad(), sh.use_mesh(mesh, rules):
                return M.decode_step(model, token, states, s - 1)
        finally:
            zero.release()

    return Cell(meta, step, dict(params=params, batch=[token],
                                 states=states))


def run_cell(arch: str, shape, multi_pod: bool, unroll: bool = False,
             rules_name: str = "default", remat: bool = True, *,
             mesh_shape: tuple | None = None, rank: int = 0,
             cfg: ModelConfig | None = None) -> dict:
    """One cell's record, under the reference's keys: the step built and
    run once as rank `rank` of a fake world of `mesh_shape` ((16, 16),
    or (2, 16, 16) with `multi_pod`)."""
    rules = RULE_PRESETS[rules_name]
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    tracer = Tracer()
    with fake_world(mesh_shape, rank) as mesh, \
            unroll_mod.unroll_scope(unroll), unroll_mod.remat_scope(remat):
        with tracer.span("dryrun/build", cat="dryrun", arch=arch) as sp_b:
            cell = build_cell(arch, shape, mesh, rules, cfg=cfg)
        counter = StepCounter(cell.arguments)
        with tracer.span("dryrun/step", cat="dryrun", arch=arch) as sp_s, \
                counter:
            out = cell.step()
        rec = counter.record(out)
        del out
    # the reference's key, for the most any rank holds: the same as this
    # rank's, since `sharding.local_slices` cuts a split dim into equal
    # chunks (and refuses one that does not divide), and the rows and
    # decode states split evenly too (a split cache length or head dim
    # takes only a candidate that divides whole: `sharding.cache_spec`,
    # `sharding.state_spec`)
    rec["memory"]["argument_bytes_max_rank"] = \
        rec["memory"]["argument_bytes"]
    mem = rec["memory"]
    limit = device_memory_bytes()
    return dict(
        **cell.meta,
        multi_pod=multi_pod,
        unrolled=unroll,
        rules=rules_name,
        remat=remat,
        rank=rank,
        ok=True,
        t_build_s=round(sp_b.duration_s, 1),
        t_step_s=round(sp_s.duration_s, 1),
        memory=mem,
        device_memory_bytes=limit,
        fits=mem["peak_bytes"] <= limit,
        cost=rec["cost"],
        collectives=rec["collectives"],
        aten_ops=rec["aten_ops"],
    )


def cell_tag(arch: str, shape_name: str, multi_pod: bool, unroll: bool,
             rules: str, no_remat: bool) -> str:
    """The reference's file name of a cell's record (without .json)."""
    return (f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
            + ("__unroll" if unroll else "")
            + (f"__{rules}" if rules != "default" else "")
            + ("__noremat" if no_remat else ""))


def summary(rec: dict) -> str:
    """One line of a cell's record."""
    mem = rec["memory"]
    return (f"build {rec['t_build_s']}s step {rec['t_step_s']}s, args "
            f"{mem['argument_bytes'] / 2**30:.2f} GiB/rank, peak "
            f"{mem['peak_bytes'] / 2**30:.2f} GiB "
            f"({'fits' if rec['fits'] else 'does NOT fit'}), flops "
            f"{rec['cost']['flops']:.3e}, wire "
            f"{rec['collectives']['total_wire_bytes']:.3e} B")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="the reference's flag; the port's loops are "
                         "unrolled either way")
    ap.add_argument("--rules", default="default", choices=sorted(RULE_PRESETS),
                    help="sharding-rule preset")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation remat")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    failed = []
    for arch in archs:
        for shape_name in shapes:
            tag = cell_tag(arch, shape_name, args.multi_pod, args.unroll,
                           args.rules, args.no_remat)
            path = os.path.join(args.out, tag + ".json")
            if not cell_applicable(arch, shape_name):
                rec = dict(arch=arch, shape=shape_name, ok=True,
                           skipped=True, multi_pod=args.multi_pod,
                           reason="full-attention arch: long_500k requires "
                                  "sub-quadratic mixing (DESIGN.md Sec. 5)")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[skip] {tag}")
                continue
            print(f"[cell] {tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape_name, args.multi_pod,
                               unroll=args.unroll, rules_name=args.rules,
                               remat=not args.no_remat)
                print(f"  ok: {summary(rec)}", flush=True)
            except Exception as e:
                rec = dict(arch=arch, shape=shape_name, ok=False,
                           multi_pod=args.multi_pod, error=str(e),
                           traceback=traceback.format_exc())
                failed.append(tag)
                print(f"  FAIL: {e}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    if failed:
        print(f"[dryrun] {len(failed)} cell(s) failed: {', '.join(failed)}",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
