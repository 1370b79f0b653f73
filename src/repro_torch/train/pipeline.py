"""GPipe-style pipeline parallelism over a process group of stages.

The port of `repro.train.pipeline`.  The period stack is split across
the stages: stage s holds periods [s P / S, (s + 1) P / S) of the
model's blocks (a period is `cfg.scan_period` blocks, the layers of
`cfg.period_kinds()`).  Microbatches flow through the stages one hop a
tick, T = M + S - 1 ticks for M microbatches over S stages: at tick t
stage s runs microbatch t - s, then sends its [mb, S, d] output to
stage s + 1.  Each period runs under `unroll.maybe_checkpoint`, as the
reference's `jax.checkpoint(body)`: the backward recomputes one period
at a time.  The output is the last stage's, on every stage (a broadcast
where the reference takes a masked psum; the values are the same).

Autograd does not cross `dist.send` / `dist.recv`, so the pipeline is
one `torch.autograd.Function`: its forward runs the fill-and-drain
schedule, keeping each microbatch's graph on its stage; its backward
runs the reverse schedule (ticks T - 1 down to 0: the last stage takes
its share of the output's gradient, each stage sends its input's
gradient to the stage before), which is the reference's transpose of
its tick scan.  As the reference's replicated output, the output's
gradient is counted once (the last stage's); the input's gradient is
stage 0's, broadcast to every stage; each stage's parameters get the
gradients of its own periods (zero elsewhere).

Embedding and loss stay outside the pipelined region.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


class _Schedule:
    """One call's stage: its blocks, microbatches and peers."""

    def __init__(self, cfg: ModelConfig, group, blocks, positions, m: int,
                 need_grad: bool):
        self.group = group
        self.n_stages = dist.get_world_size(group)
        self.stage = dist.get_rank(group)
        n_periods = cfg.num_layers // cfg.scan_period
        per = n_periods // self.n_stages
        p0 = self.stage * per * cfg.scan_period
        self.blocks = blocks[p0:p0 + per * cfg.scan_period]
        self.period = cfg.scan_period
        self.m = m
        self.positions = positions
        self.need_grad = need_grad
        self.params = [p for p in self.blocks.parameters()
                       if p.requires_grad]
        self.saved = {}

    def _peer(self, stage: int) -> int:
        return stage if self.group is None else \
            dist.get_global_rank(self.group, stage)

    def _periods(self, x, positions):
        body = M._remat(M._train_period, "train")
        for p0 in range(0, len(self.blocks), self.period):
            x, _ = body(self.blocks[p0:p0 + self.period], x, positions,
                        None)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        S, s, m = self.n_stages, self.stage, self.m
        mb = x.shape[0] // m
        outs = []
        for t in range(m + S - 1):
            j = t - s                      # the microbatch of this tick
            if not 0 <= j < m:
                continue
            if s == 0:
                xin = x[j * mb:(j + 1) * mb]
            else:
                xin = torch.empty((mb,) + tuple(x.shape[1:]), dtype=x.dtype,
                                  device=x.device)
                dist.recv(xin, self._peer(s - 1), group=self.group)
            xin = xin.detach().requires_grad_(self.need_grad)
            with torch.set_grad_enabled(self.need_grad):
                y = self._periods(xin, self.positions[j * mb:(j + 1) * mb])
            if s < S - 1:
                dist.send(y.detach().contiguous(), self._peer(s + 1),
                          group=self.group)
            else:
                outs.append(y.detach())
            if self.need_grad:
                self.saved[j] = (xin, y)
        out = torch.cat(outs) if outs else torch.empty_like(x)
        if S > 1:
            dist.broadcast(out, self._peer(S - 1), group=self.group)
        return out

    def backward(self, gout: torch.Tensor):
        S, s, m = self.n_stages, self.stage, self.m
        mb = gout.shape[0] // m
        gparams = [None] * len(self.params)
        gx = []
        for t in reversed(range(m + S - 1)):
            j = t - s
            if not 0 <= j < m:
                continue
            if s == S - 1:
                gy = gout[j * mb:(j + 1) * mb]
            else:
                gy = torch.empty_like(gout[:mb])
                dist.recv(gy, self._peer(s + 1), group=self.group)
            xin, y = self.saved.pop(j)
            grads = torch.autograd.grad(y, [xin] + self.params, gy,
                                        allow_unused=True)
            for i, g in enumerate(grads[1:]):
                if g is not None:
                    g = g.to(torch.float32)
                    gparams[i] = g if gparams[i] is None else gparams[i] + g
            if s > 0:
                dist.send(grads[0].contiguous(), self._peer(s - 1),
                          group=self.group)
            else:
                gx.append(grads[0])
        gx = torch.cat(gx[::-1]) if gx else torch.empty_like(gout)
        if S > 1:
            dist.broadcast(gx, self._peer(0), group=self.group)
        return gx, [None if g is None else g.to(p.dtype)
                    for g, p in zip(gparams, self.params)]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _Schedule, x, *params):
        ctx.run = run
        return run.forward(x)

    @staticmethod
    def backward(ctx, gout):
        gx, gparams = ctx.run.backward(gout)
        return (None, gx, *gparams)


def pipeline_forward(cfg: ModelConfig, group, blocks, x: torch.Tensor,
                     positions: torch.Tensor,
                     num_microbatches: int) -> torch.Tensor:
    """Hidden states [B, S, d] after the whole block stack, pipelined
    over the stages of `group` (a process group; None: the default
    one).  blocks: the model's `blocks` (every stage passes all of
    them and runs its own); x: [B, S, d] embedded inputs, B divisible
    by `num_microbatches`; positions: [B, S] int.  Every stage calls it
    with the same x and positions, and every stage returns the same
    output."""
    n_stages = dist.get_world_size(group)
    n_periods = cfg.num_layers // cfg.scan_period
    if n_periods % n_stages:
        raise ValueError("num_periods must divide over stages")
    if x.shape[0] % num_microbatches:
        raise ValueError(f"batch {x.shape[0]} does not split into "
                         f"{num_microbatches} microbatches")
    run = _Schedule(cfg, group, blocks, positions, num_microbatches,
                    torch.is_grad_enabled())
    return _GPipe.apply(run, x, *run.params)
