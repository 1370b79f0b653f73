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
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.unroll import maybe_checkpoint
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    loss_chunk: int = 512
    lb_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3


def _xent_chunk(model: M.Model, h: torch.Tensor, lab: torch.Tensor):
    """(sum of the chunk's nll, its count of valid labels as int32)."""
    logits = M.logits_from_hidden(model, h)          # [B, chunk, V] f32
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp(lab, min=0).long()
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
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
