"""Training step: chunked-vocab cross-entropy, gradients, AdamW update.

The port of `repro.train.train_step`.  The loss never materializes the
[B, S, V] logits: a loop over sequence chunks computes each chunk's
logits, logsumexp and gold logit under `unroll.maybe_checkpoint`, so
with remat one [B, chunk, V] f32 block lives at a time, in the forward
and in the backward.  Remat (of these chunks and of the model's
periods) is on unless the caller runs the step inside
`unroll.remat_scope(False)`.

A step takes the model (its parameters updated in place), the optimizer
state and a batch of device tensors, and returns the new state and the
metrics as device tensors: the host reads nothing unless it asks.

Data parallelism (`Zero3`, `make_sharded_train_step`): the batch rows
split over the `pod` x `data` ranks, and each parameter and its
optimizer state are stored as the sharding rules place them (`fsdp` ->
`data` is ZeRO-3: a rank holds its shard of each weight).  A step
gathers the shards into the model's parameters for the forward and
backward, frees them after, reduce-scatters each gradient back to its
shard (the sum over the ranks of each rank's share of the global
loss), and runs `apply_updates` on the shards.  Under the reference's
GSPMD the mesh does not change what is computed; here that is made so
by hand: the cross-entropy's sum and count, the MoE load-balance
terms and the z-loss's mean are all-reduced over the batch ranks
(`sharding.batch_sum`), the gradient norm sums the shards' squares
over the ranks, and an int8 state whose blocks a shard cuts is
(de)quantized over whole blocks, so its codes are one rank's.  Without
a mesh (`Zero3(model, None)`, one device) nothing is split or
reduced, and the step computes what `make_train_step`'s does.

Tensor and expert parallelism (the `model` axis): the gather leaves
each model-split parameter as this rank's model shard, the layers
compute their share (`models.sharding`: `enter` / `leave` around the
split products, a vocab-parallel cross-entropy here), a shard's
gradient is whole over the model ranks, so `reduce` runs over the
batch axes only, and the gradient norm counts each leaf's copies over
the whole world.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.models.unroll import maybe_checkpoint
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    loss_chunk: int = 512
    lb_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3


def _xent_chunk(model: M.Model, h: torch.Tensor, lab: torch.Tensor):
    """(sum of the chunk's nll, its count of valid labels as int32).
    Vocab-parallel: each model rank's logsumexp of its columns, combined
    over the ranks from their max (the sum of exp(lse_r - max) summed by
    `leave`), and the gold logit from the rank that holds the label.  At
    one rank the combination adds log(exp(0)) = 0: the same bits as the
    plain logsumexp, and a gradient multiplied by exactly 1."""
    logits = M.logits_from_hidden(model, h)          # [B, chunk, V / M] f32
    lse_r = torch.logsumexp(logits, dim=-1)
    top = sh.model_max(lse_r.detach())
    lse = top + torch.log(sh.leave(torch.exp(lse_r - top)))
    loc, mine = M.local_ids(lab, M.vocab_slice(model))
    gold = torch.gather(logits, -1, loc[..., None])[..., 0]
    gold = sh.leave(torch.where(mine, gold, 0.0))
    valid = lab >= 0
    nll = torch.where(valid, lse - gold, 0.0)
    return torch.sum(nll), torch.sum(valid, dtype=torch.int32)


def chunked_xent(model: M.Model, hidden: torch.Tensor, labels: torch.Tensor,
                 chunk: int):
    """Cross-entropy over sequence chunks.

    hidden: [B, S, d]; labels: [B, S] int, -1 = masked.  Returns
    (sum_loss f32, num_valid int32), 0-dim tensors.
    """
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:  # pad to a multiple (masked labels)
        pad = chunk - s % chunk
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        s = hidden.shape[1]
    body = maybe_checkpoint(_xent_chunk)
    sum_loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n_valid = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c0 in range(0, s, chunk):
        part, n = body(model, hidden[:, c0:c0 + chunk],
                       labels[:, c0:c0 + chunk])
        sum_loss = sum_loss + part
        n_valid = n_valid + n
    return sum_loss, n_valid


def make_loss_fn(cfg: ModelConfig, hp: TrainHParams):
    """loss_fn(model, batch) -> (total loss, metrics {loss, xent,
    lb_loss, z_loss, tokens}), device tensors."""
    def loss_fn(model: M.Model, batch):
        hidden, aux = M.forward_with_aux(model, batch)
        sum_loss, n_valid = chunked_xent(model, hidden, batch["labels"],
                                         hp.loss_chunk)
        # the whole batch's: masked labels make a mean of the ranks'
        # means wrong
        sum_loss, n_valid = sh.batch_sum(sum_loss), sh.batch_sum(n_valid)
        xent = sum_loss / torch.clamp(n_valid.to(torch.float32), min=1.0)
        total = xent + hp.lb_loss_weight * aux[0] + hp.z_loss_weight * aux[1]
        metrics = {"loss": total, "xent": xent, "lb_loss": aux[0],
                   "z_loss": aux[1], "tokens": n_valid}
        return total, metrics

    return loss_fn


def parameters(model: M.Model) -> dict:
    """The model's parameters by name, with autograd turned on."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def grads_of(loss: torch.Tensor, params: dict) -> dict:
    """d loss / d each parameter, by name (zeros for an unused one)."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return dict(zip(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: opt.OptConfig,
                    hp: TrainHParams = TrainHParams()):
    """Returns step(model, opt_state, batch) -> (opt_state, metrics):
    the loss metrics plus grad_norm and lr.  The model's parameters are
    updated in place."""
    loss_fn = make_loss_fn(cfg, hp)

    def step(model: M.Model, opt_state, batch):
        params = parameters(model)
        loss, metrics = loss_fn(model, batch)
        grads = grads_of(loss, params)
        del loss
        metrics = {k: v.detach() for k, v in metrics.items()}
        _, opt_state, om = opt.apply_updates(params, grads, opt_state,
                                             opt_cfg)
        metrics.update(om)
        return opt_state, metrics

    return step


def make_grad_accum_train_step(cfg: ModelConfig, opt_cfg: opt.OptConfig,
                               hp: TrainHParams, num_microbatches: int):
    """Gradient accumulation: batch leaves [A, B/A, ...], one backward a
    microbatch, each gradient summed into f32 buffers (never into a
    bf16 `.grad`), then divided by A.  Returns step(model, opt_state,
    batch) -> (opt_state, {"grad_norm", "lr", "loss"})."""
    loss_fn = make_loss_fn(cfg, hp)

    def step(model: M.Model, opt_state, batch):
        params = parameters(model)
        gsum = {name: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                for name, p in params.items()}
        msum = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
        for i in range(num_microbatches):
            mb = {k: v[i] for k, v in batch.items()}
            loss, metrics = loss_fn(model, mb)
            grads = grads_of(loss, params)
            for name, g in grads.items():
                gsum[name].add_(g)
            msum = msum + metrics["loss"].detach()
            del loss, metrics, grads
        grads = {name: g.div_(num_microbatches) for name, g in gsum.items()}
        _, opt_state, om = opt.apply_updates(params, grads, opt_state,
                                             opt_cfg)
        om["loss"] = msum / num_microbatches
        return opt_state, om

    return step


# -- data parallelism ----------------------------------------------------------


def _gather(local: torch.Tensor, split: list, mesh) -> torch.Tensor:
    """The whole tensor from each rank's shard: one all-gather for each
    split dim, over the group of the axes that split it."""
    for d, axes in split:
        x = local.movedim(d, 0).contiguous()
        out = torch.empty((mesh.size(axes) * x.shape[0],) + x.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=mesh.group(axes))
        local = out.movedim(0, d)
    return local.contiguous()


class Zero3:
    """A model's parameters stored as the sharding rules place them on
    `mesh` (a `launch.mesh.NamedMesh`, or None for one device, where
    nothing is split): `shards[name]` is this rank's shard of each
    parameter (the parameter itself where no axis of size > 1 splits
    it), over the batch axes (ZeRO-3) and the model axis (tensor and
    expert parallelism) alike.  Between steps the model's split
    parameters hold no storage; `gather()` fills each with this rank's
    model shard (the batch-axis splits gathered: the layers compute on
    the model shard, `sharding.model_slice`), `gather(whole=True)` with
    the whole parameter, and `release()` frees them."""

    def __init__(self, model: M.Model, mesh, rules: dict | None = None):
        self.mesh, self.rules = mesh, rules
        self.device = model.device if mesh is None else mesh.device
        self.params = dict(model.named_parameters())
        self.specs = M.param_specs(model)
        self.shardings = sh.spec_tree_to_shardings(mesh, self.specs,
                                                   self.params, rules)
        with sh.use_mesh(mesh, rules):
            _, self.dp = sh.batch_group()
            self.batch_axes = sh.batch_axes()
        self.world = 1 if mesh is None else math.prod(mesh.shape.values())
        self.split, self.batch_split, self.shards, self.shapes = \
            {}, {}, {}, {}
        for name, p in self.params.items():
            spec = self.shardings[name].spec
            split = sh.split_axes(mesh, spec)
            for _, axes in split:
                if set(axes) & set(self.batch_axes) and \
                        not set(axes) <= set(self.batch_axes):
                    raise ValueError(f"{name}: one dim split over batch and "
                                     f"other axes {axes}")
            self.split[name], self.shapes[name] = split, tuple(p.shape)
            self.batch_split[name] = [(d, axes) for d, axes in split
                                      if set(axes) <= set(self.batch_axes)]
            self.shards[name] = p.detach()[sh.local_slices(
                mesh, spec, p.shape)].clone() if split else p
        self.release()

    def release(self) -> None:
        """Free the model's split parameters (shape kept in `shapes`)."""
        for name, p in self.params.items():
            if self.split[name]:
                p.data = p.data.new_empty((0,))

    @torch.no_grad()
    def gather(self, whole: bool = False) -> None:
        """Fill the model's split parameters from the shards: this
        rank's model shard of each, or with `whole` every parameter
        whole (a model to return or to run outside the mesh)."""
        for name, p in self.params.items():
            if self.split[name]:
                p.data = _gather(self.shards[name], self.split[name] if whole
                                 else self.batch_split[name], self.mesh)

    def reduce(self, grads: dict) -> dict:
        """Each rank's gradients of its share of the loss (a model
        shard's gradient is already whole over the model ranks) -> this
        rank's shard of their sum over the batch ranks (f32 where a
        collective runs; the gradient as it is at one batch rank)."""
        if self.dp == 1:
            return grads
        out = {}
        for name, g in grads.items():
            g = g.to(torch.float32)
            used = set()
            for d, axes in self.batch_split[name]:
                x = g.movedim(d, 0).contiguous()
                n = self.mesh.size(axes)
                part = torch.empty((x.shape[0] // n,) + x.shape[1:],
                                   dtype=x.dtype, device=x.device)
                dist.reduce_scatter_tensor(part, x,
                                           group=self.mesh.group(axes))
                g = part.movedim(0, d)
                used.update(axes)
            rest = tuple(a for a in self.batch_axes if a not in used)
            if rest:
                g = g.contiguous()
                dist.all_reduce(g, group=self.mesh.group(rest))
            out[name] = g.contiguous()
        return out

    def grad_norm(self, grads: dict) -> torch.Tensor:
        """The norm of the whole (reduced) gradient from this rank's
        shards: each shard's sum of squares over the number of ranks
        that hold a copy of it, summed over the whole world (a leaf the
        model axis splits counts each rank's share, a replicated one
        once)."""
        if self.world == 1:
            return opt.global_norm(grads)
        total = 0
        for name, g in grads.items():
            copies = self.world
            for _, axes in self.split[name]:
                copies //= self.mesh.size(axes)
            total = total + torch.sum(torch.square(g.to(torch.float32))) \
                / copies
        dist.all_reduce(total, group=self.mesh.group(tuple(self.mesh.shape)))
        return torch.sqrt(total)

    # -- the optimizer state on the shards --

    def state_shardings(self, cfg: opt.OptConfig) -> dict:
        specs = opt.opt_state_specs(self.specs, cfg)
        shapes = {"count": torch.empty((), device="meta"), "mu": {
            name: {k: torch.empty(s, device="meta") for k, s in
                   opt.state_shapes(shape, cfg).items()}
            for name, shape in self.shapes.items()}}
        return sh.spec_tree_to_shardings(self.mesh, specs, shapes,
                                         self.rules)

    def init_opt_state(self, cfg: opt.OptConfig) -> dict:
        """The zero state, each leaf this rank's shard of it (int8:
        zeros are the codes and scales of zero moments)."""
        shard = self.state_shardings(cfg)

        def zeros(name, key, shape):
            dt = torch.int8 if key.endswith("_q") else torch.float32
            return torch.zeros(sh.local_shape(
                self.mesh, shard["mu"][name][key].spec, shape), dtype=dt,
                device=self.device)

        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=self.device),
                "mu": {name: {k: zeros(name, k, s) for k, s in
                              opt.state_shapes(shape, cfg).items()}
                       for name, shape in self.shapes.items()}}

    def moments(self, cfg: opt.OptConfig):
        """`apply_updates`' `moments` for this layout, or None where
        every state leaf's shard lines up with its parameter's."""
        if cfg.state_dtype != "int8":
            return None
        m = _Int8Moments(self, cfg)
        return m if m.whole else None

    # -- checkpoints: the whole tree's layout, this rank's shards --

    def checkpoint_tree(self, state: dict, cfg: opt.OptConfig) -> dict:
        """{"params", "opt"} for `checkpoint.save`: split leaves as
        DTensors (save gathers them), whole ones as they are."""
        sst = self.state_shardings(cfg)["mu"]
        params = {n: sh.as_dtensor(self.shards[n], self.shardings[n],
                                   self.shapes[n]) if self.split[n]
                  else self.shards[n] for n in self.shapes}
        mu = {}
        for n, leaves in state["mu"].items():
            shapes = opt.state_shapes(self.shapes[n], cfg)
            mu[n] = {k: sh.as_dtensor(t, sst[n][k], shapes[k])
                     if sh.split_axes(self.mesh, sst[n][k].spec) else t
                     for k, t in leaves.items()}
        return {"params": params, "opt": {"count": state["count"], "mu": mu}}

    def checkpoint_template(self, cfg: opt.OptConfig):
        """(template, shardings) for `checkpoint.restore` of a
        checkpoint_tree, whatever mesh wrote it (no shardings without a
        mesh: every leaf whole)."""
        st = self.state_shardings(cfg)
        tmpl = {"params": {n: torch.empty(s, dtype=self.params[n].dtype,
                                          device="meta")
                           for n, s in self.shapes.items()},
                "opt": {"count": torch.empty((), dtype=torch.int32,
                                             device="meta"),
                        "mu": {n: {k: torch.empty(
                            s, dtype=torch.int8 if k.endswith("_q")
                            else torch.float32, device="meta")
                            for k, s in opt.state_shapes(shape, cfg).items()}
                            for n, shape in self.shapes.items()}}}
        if self.mesh is None:
            return tmpl, None
        return tmpl, {"params": self.shardings,
                      "opt": {"count": None, "mu": st["mu"]}}

    def load(self, restored: dict) -> dict:
        """Take a restored checkpoint_tree: the parameters into the
        shards; returns the optimizer state's shards."""
        def local(t):
            return t.to_local() if hasattr(t, "to_local") else t

        with torch.no_grad():
            for n, t in restored["params"].items():
                self.shards[n].copy_(local(t))
        mu = {n: {k: local(t) for k, t in leaves.items()}
              for n, leaves in restored["opt"]["mu"].items()}
        return {"count": restored["opt"]["count"], "mu": mu}

    def full_state(self, state: dict, cfg: opt.OptConfig) -> dict:
        """The whole optimizer state from the shards, on every rank."""
        sst = self.state_shardings(cfg)["mu"]
        return {"count": state["count"], "mu": {
            n: {k: _gather(t, sh.split_axes(self.mesh, sst[n][k].spec),
                           self.mesh) for k, t in leaves.items()}
            for n, leaves in state["mu"].items()}}


class _Int8Moments:
    """int8 moments on shards.  A leaf whose codes and scales shard as
    its parameter does (the split dims leading, the parameter's last dim
    whole) dequantizes and quantizes its own blocks.  Otherwise a shard
    cuts the 256-blocks (the parameter's last-axis rule, over a batch
    axis or the model axis alike, lands on the block axis): the codes
    are gathered and dequantized whole, and the new moments gathered
    and quantized whole, so the absmax of each block is the whole
    block's and the codes equal one rank's bit for bit."""

    def __init__(self, zero: Zero3, cfg: opt.OptConfig):
        self.zero, self.cfg = zero, cfg
        self.st = st = zero.state_shardings(cfg)["mu"]
        self.split = {}
        self.whole = set()
        for n, shape in zero.shapes.items():
            ps = zero.split[n]
            qs = sh.split_axes(zero.mesh, st[n]["m_q"].spec)
            ss = sh.split_axes(zero.mesh, st[n]["m_s"].spec)
            self.split[n] = (qs, ss)
            if any(d == len(shape) - 1 for d, _ in ps) or qs != ps \
                    or ss != ps:
                self.whole.add(n)

    def load(self, name, mu, p):
        if name not in self.whole:
            return (opt.dequantize_blockwise(mu["m_q"], mu["m_s"], p.shape),
                    opt.dequantize_v_log(mu["v_q"], mu["v_s"], p.shape))
        z = self.zero
        qs, ss = self.split[name]
        shape = z.shapes[name]
        sl = sh.local_slices(z.mesh, z.shardings[name].spec, shape)
        m = opt.dequantize_blockwise(_gather(mu["m_q"], qs, z.mesh),
                                     _gather(mu["m_s"], ss, z.mesh), shape)
        v = opt.dequantize_v_log(_gather(mu["v_q"], qs, z.mesh),
                                 _gather(mu["v_s"], ss, z.mesh), shape)
        return m[sl].contiguous(), v[sl].contiguous()

    def store(self, name, m, v):
        if name not in self.whole:
            return opt.quantized_moments(m, v, self.cfg)
        z = self.zero
        qs, ss = self.split[name]
        full = opt.quantized_moments(
            _gather(m, z.split[name], z.mesh),
            _gather(v, z.split[name], z.mesh), self.cfg)
        st = self.st[name]
        return {k: t[sh.local_slices(z.mesh, st[k].spec, t.shape)]
                .contiguous() for k, t in full.items()}


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: opt.OptConfig,
                            zero: Zero3, hp: TrainHParams = TrainHParams()):
    """Returns step(model, opt_state, rows) -> (opt_state, metrics) for
    this rank's rows of the global batch (`sharding.batch_rows`; the
    model ranks of a data row take the same rows); the state is
    `zero.init_opt_state`'s shards, the metrics the global batch's (the
    same on every rank)."""
    loss_fn = make_loss_fn(cfg, hp)
    moments = zero.moments(opt_cfg)

    def step(model: M.Model, opt_state, rows):
        params = parameters(model)
        zero.gather()
        with sh.use_mesh(zero.mesh, zero.rules):
            loss, metrics = loss_fn(model, rows)
            grads = grads_of(loss, params)
        del loss
        zero.release()
        grads = zero.reduce(grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        _, opt_state, om = opt.apply_updates(
            zero.shards, grads, opt_state, opt_cfg,
            grad_norm=zero.grad_norm(grads), moments=moments)
        metrics.update(om)
        return opt_state, metrics

    return step
