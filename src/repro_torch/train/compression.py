"""Gradient compression for data parallelism across pods.

The port of `repro.train.compression`: int8 blockwise quantization with
error feedback (1-bit-Adam style residual accumulation).  The exchange
moves the int8 payload and one f32 scale per 256-block instead of f32,
about 4x fewer bytes, while the error feedback keeps the *accumulated*
update unbiased.  A process group takes the place of the reference's
`shard_map` axis name.

Op order, as the reference's: g32 = g + e; quantize blockwise; new e =
g32 - dequantized; all-gather every rank's codes and scales; sum q * s
over the ranks in f32, in rank order; strip each row's block padding.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.train.optimizer import dequantize_blockwise, \
    quantize_blockwise


def _map(fn, *trees):
    """`fn` over the leaves of nested dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_error_state(grads):
    """f32 zeros shaped as each gradient."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[world, *x.shape]: every rank's x, in rank order."""
    world = dist.get_world_size(group)
    out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.reshape(world, *x.shape)


def compressed_psum(grads, error, group=None, block: int = 256,
                    stats: dict | None = None):
    """Quantize (grads + error) to int8, sum over the group's ranks,
    dequantize: returns (reduced grads, new error), trees like `grads`
    (nested dicts of tensors), the reduced grads f32 and equal on every
    rank.  `group`: the process group (None: the default one).  With
    `stats`, its "wire_bytes" (the int8 codes and f32 scales each rank
    sends) and "f32_bytes" (what an f32 exchange would send) grow by
    this call's."""
    def leaf(g, e):
        g32 = g.to(torch.float32) + e
        q, s = quantize_blockwise(g32, block)    # int8 codes, f32 scales
        new_e = g32 - dequantize_blockwise(q, s, g.shape)
        # int8 on the wire: gather the codes (and the small scales) and
        # reduce here; per-rank scales leave an int8 all-reduce
        # ill-defined
        qg = _all_gather(q, group)               # [P, ..., nb, block]
        sg = _all_gather(s, group)               # [P, ..., nb, 1]
        red_blocks = qg[0].to(torch.float32) * sg[0]
        for r in range(1, qg.shape[0]):
            red_blocks = red_blocks + qg[r].to(torch.float32) * sg[r]
        # strip the block padding of each row (not a flat slice)
        red = red_blocks.reshape(*g.shape[:-1], -1)[..., :g.shape[-1]]
        if stats is not None:
            stats["wire_bytes"] = stats.get("wire_bytes", 0) \
                + q.numel() * q.element_size() + s.numel() * s.element_size()
            stats["f32_bytes"] = stats.get("f32_bytes", 0) + 4 * g.numel()
        return red, new_e

    outs = _map(leaf, grads, error)

    def part(tree, i):
        if isinstance(tree, tuple):
            return tree[i]
        return {k: part(v, i) for k, v in tree.items()}

    return part(outs, 0), part(outs, 1)
