"""Mixture-of-Experts layer on torch.

The port of `repro.models.moe`.  Under data parallelism
(`sharding.use_mesh` over data / pod ranks) each rank routes its own
rows at the capacity of its own tokens, as the reference's
`local_tokens` does, and the load-balance and z-loss terms are averaged
over the batch ranks.  Over the model axis (expert parallelism, the
reference's `shard_map` over `model`) the router is replicated, each
model rank runs its `E / M` experts over its data row's tokens from an
[E/M, cap] table (the other ranks' pairs sorted last and left out),
and the partial outputs are summed by `sharding.leave`; x and the top-k
weights enter the experts through `sharding.enter`, so the router's
gradient holds every expert's share.  `E % M != 0` raises, as the
reference does.  Routing: f32 router
logits, softmax, top-k with ties to the lowest expert id (a stable
descending sort cut to k: `torch.topk` does not promise that order),
the top-k weights renormalised with a 1e-9 floor.  Dispatch is the
reference's capacity-bounded Switch table: the (token, expert) pairs
sorted stably by expert, each ranked within its expert by
`core.routing.run_ranks`, and written into an [E, cap] table of flat
token indices; a pair ranked past the capacity is dropped, as the
reference's out-of-bounds `mode="drop"` scatter drops it (here a spare
column that is sliced off).  Every expert runs its cap slots, full or
empty; the outputs are weighted and each token gathers its k slots and
adds them in expert-id order, the order in which the reference's
scatter-add adds them on the CPU.  The gather makes the sum the same on
every run (a scatter-add on the card would add with atomics, in an
order that varies).  No boolean-mask indexing and no read of a device
value on the host: a decode step through this layer makes no host
sync.

The reference casts each expert weight to the activation's dtype before
its product; with bf16 weights and the f32 residual stream that is an
f32 copy.  The port upcasts `EXPERT_BLOCK_BYTES` of f32 a weight at a
time (a block of experts), so no f32 copy of every expert of a large
layer is live at once; the upcast is exact, so the products are the
same.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.routing import run_ranks
from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Mlp, _draw, _empty

# the f32 bytes of one expert weight upcast at a time: llama4-maverick's
# [128, 5120, 8192] w_gate would be 21.5 GB in f32 at once
EXPERT_BLOCK_BYTES = 1 << 30


class Moe(nn.Module):
    """router [d, E], w_gate / w_up [E, d, f], w_down [E, f, d], and with
    `cfg.moe_num_shared` the always-on `shared` MLP of width
    f * moe_num_shared."""

    SPECS = {"router": (None, None),
             "w_gate": ("experts", "fsdp", "expert_ff"),
             "w_up": ("experts", "fsdp", "expert_ff"),
             "w_down": ("experts", "expert_ff", "fsdp")}

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, e = cfg.d_model, cfg.moe_num_experts
        f = cfg.moe_d_ff or cfg.d_ff
        self.router = _empty((d, e), device, dtype)
        self.w_gate = _empty((e, d, f), device, dtype)
        self.w_up = _empty((e, d, f), device, dtype)
        self.w_down = _empty((e, f, d), device, dtype)
        self.shared = Mlp(cfg, f * cfg.moe_num_shared, device=device,
                          dtype=dtype) if cfg.moe_num_shared else None

    def reset_parameters(self, g: torch.Generator):
        """The shared MLP resets itself.  The reference's default scale
        for w_gate / w_up is 1/sqrt(shape[0]), the expert count; drawn
        one expert at a time, so no f32 copy of a whole weight is made."""
        _draw(self.router, g, 0.02)
        e, f = self.w_down.shape[:2]
        for w, scale in ((self.w_gate, 1.0 / math.sqrt(e)),
                         (self.w_up, 1.0 / math.sqrt(e)),
                         (self.w_down, 1.0 / math.sqrt(f))):
            for i in range(e):
                _draw(w[i], g, scale)


@dataclasses.dataclass
class MoeAux:
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    # the share of (token, expert) pairs past the capacity (the
    # reference's field holds a constant 0)
    dropped_fraction: torch.Tensor


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for n_tokens tokens: the reference's capacity
    when n_tokens is this rank's own (its `local_tokens` divides the
    batch by data x pod)."""
    return max(int(math.ceil(n_tokens * cfg.moe_top_k / cfg.moe_num_experts
                             * cfg.moe_capacity_factor)), 4)


def route(p: Moe, x: torch.Tensor):
    """x: [B, S, d] -> (f32 logits [B, S, E], probs, top-k weights
    [B, S, k] renormalised, top-k expert ids [B, S, k])."""
    logits = x.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = p.cfg.moe_top_k
    w, idx = w[..., :k], idx[..., :k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, w, idx


def dispatch(topk_idx: torch.Tensor, topk_w: torch.Tensor, n_experts: int,
             cap: int, dtype: torch.dtype, experts: slice | None = None):
    """The [E_loc, cap] table of flat token indices (-1 empty) of the
    experts `experts` (default: all n_experts), its weights in `dtype`,
    and each (token, choice) pair's slot e_loc * cap + rank in the
    table, [..., k] as topk_idx, -1 where the pair went to another
    rank's expert or was dropped (ranked past cap)."""
    experts = experts or slice(0, n_experts)
    e_loc = experts.stop - experts.start
    k = topk_idx.shape[-1]
    key = topk_idx.reshape(-1)
    if e_loc < n_experts:   # other ranks' pairs sort last, to a spare row
        key = key - experts.start
        key = torch.where((key >= 0) & (key < e_loc), key, e_loc)
    flat_tok = torch.arange(key.numel(), device=key.device) // k
    order = torch.argsort(key, stable=True)
    e_sorted = key[order]
    rank = run_ranks(e_sorted).long()
    col = torch.clamp(rank, max=cap)           # past capacity: spare column
    disp = torch.full((e_loc + 1, cap + 1), -1, dtype=torch.int64,
                      device=key.device)
    disp[e_sorted, col] = flat_tok[order]
    wdisp = torch.zeros((e_loc + 1, cap + 1), dtype=dtype, device=key.device)
    wdisp[e_sorted, col] = topk_w.reshape(-1)[order].to(dtype)
    kept = rank < cap
    if e_loc < n_experts:
        kept &= e_sorted < e_loc
    slot = torch.where(kept, e_sorted * cap + rank, -1)
    slot = torch.empty_like(slot).scatter_(0, order, slot)  # pair order
    return disp[:e_loc, :cap], wdisp[:e_loc, :cap], slot.reshape(
        topk_idx.shape)


def _expert_compute(p: Moe, xe: torch.Tensor) -> torch.Tensor:
    """xe: [E, cap, d] -> [E, cap, d], each expert's swiglu MLP, its
    weights cast to xe's dtype a block of experts at a time."""
    e, _, d = xe.shape
    f = p.w_gate.shape[2]
    step = max(1, EXPERT_BLOCK_BYTES // (d * f * xe.element_size()))
    blocks = []  # no `out=`: autograd differentiates none of those
    for e0 in range(0, e, step):
        sl = slice(e0, e0 + step)
        x = xe[sl]
        h = F.silu(torch.bmm(x, p.w_gate[sl].to(xe.dtype))) \
            * torch.bmm(x, p.w_up[sl].to(xe.dtype))
        blocks.append(torch.bmm(h, p.w_down[sl].to(xe.dtype)))
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks)


def moe(p: Moe, x: torch.Tensor):
    """x: [B, S, d] -> (y [B, S, d], MoeAux)."""
    cfg = p.cfg
    e = cfg.moe_num_experts
    b, s, d = x.shape
    n_model = sh.model_size()
    if e % n_model:
        raise ValueError(f"experts {e} must divide over model axis {n_model}")
    f = p.w_down.shape[1]
    experts = sh.model_slice(Moe.SPECS["w_gate"], (e, d, f), 0)
    split = sh.is_split(experts, e)
    logits, probs, topk_w, topk_idx = route(p, x)

    # Switch load-balance loss (density by scatter-add) and router
    # z-loss, of the whole batch: under data parallelism the density,
    # the mean probabilities and the z-loss's mean are averaged over the
    # batch ranks before their product, as the reference computes them
    # on the global batch
    flat = topk_idx.reshape(-1)
    density = torch.zeros(e, dtype=torch.float32, device=x.device) \
        .index_add_(0, flat, torch.ones(flat.shape, device=x.device)) \
        / float(flat.numel())
    lb_loss = e * torch.sum(sh.batch_mean(density)
                            * sh.batch_mean(probs.mean(dim=(0, 1))))
    z_loss = sh.batch_mean(torch.mean(torch.logsumexp(logits, dim=-1) ** 2))

    n = b * s
    xin, w_in = (sh.enter(x), sh.enter(topk_w)) if split else (x, topk_w)
    disp, wdisp, slot = dispatch(topk_idx, w_in, e, capacity(cfg, n),
                                 x.dtype, experts)
    # the share of pairs past capacity: each rank's over its own
    # experts' pairs (another rank's are not dropped), summed over the
    # ranks, which route the same tokens
    dropped = slot < 0
    if split:
        dropped &= (topk_idx >= experts.start) & (topk_idx < experts.stop)
    dropped = sh.leave(dropped.float().mean())
    xe = torch.where((disp >= 0)[..., None],
                     xin.reshape(n, d)[disp.clamp(min=0)], 0.0)
    ye = (_expert_compute(p, xe) * wdisp[..., None]).reshape(-1, d)
    # each token's slots in expert-id order (a dropped pair or another
    # rank's, -1, adds 0)
    slot = slot.reshape(n, -1).sort(dim=-1).values
    parts = torch.where((slot >= 0)[..., None], ye[slot.clamp(min=0)], 0.0)
    y = parts[:, 0]
    for j in range(1, parts.shape[1]):
        y = y + parts[:, j]
    y = y.reshape(b, s, d)
    if split:
        y = sh.leave(y)
    if p.shared is not None:
        y = y + p.shared(x)
    return y, MoeAux(lb_loss, z_loss, dropped)
