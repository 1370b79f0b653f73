"""Mamba (selective SSM) block on torch: the chunked selective scan.

The port of `repro.models.ssm`.  The recurrence h_t = dA_t * h_{t-1} +
dBx_t runs over chunks of `chunk` steps (256, as the reference's): the
[B, di, N] state is carried from one chunk to the next by a Python loop,
and inside a chunk the prefix of the affine maps is a log-depth doubling
scan (ceil(log2 Q) shifted multiply-adds over [B, Q, di, N]), the same
combine `(a1 a2, b1 a2 + b2)` as the reference's `associative_scan` in
another association order.  No Python loop over the steps of a chunk,
and no exp-of-cumsum form, whose [B, Q, Q, di, N] tensor would not fit
at jamba's widths.

Decode keeps (h [B, di, N] f32, conv [B, d_conv - 1, di]) and costs
O(1) a token.  `Mamba` holds the parameters in the reference's shapes
and dtypes; the functions take it as the reference's take `p`.

Over the model axis each rank runs its share of the d_inner channels
(`sharding.model_slice`): conv, dt_proj, dt_bias, A_log and D are its
channels', x_proj and out_proj are row-parallel (`sharding.leave`; the
[B, S, r + 2N] of x_proj then enters the channel products again), and
the states are [B, di / M, N] and [B, d_conv - 1, di / M].  in_proj is
[d, 2 di], x then z, split on that concatenated axis in contiguous
pieces (at M = 2 rank 0 holds all of x, rank 1 all of z): the weight is
all-gathered over the model ranks and this rank's x and z columns are
taken from it (its gradient reduce-scattered back to the shards).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _draw, _empty


class Mamba(nn.Module):
    """in_proj [d, 2 di], conv_w [d_conv, di], conv_b [di], x_proj
    [di, dt_rank + 2 N], dt_proj [dt_rank, di], dt_bias [di], A_log
    [di, N], D [di], out_proj [di, d]."""

    SPECS = {"in_proj": ("fsdp", "d_inner"), "conv_w": ("conv", "d_inner"),
             "conv_b": ("d_inner",), "x_proj": ("d_inner", None),
             "dt_proj": ("dt_rank", "d_inner"), "dt_bias": ("d_inner",),
             "A_log": ("d_inner", "d_state"), "D": ("d_inner",),
             "out_proj": ("d_inner", "fsdp")}

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, di, n, r = cfg.d_model, cfg.d_inner, cfg.mamba_d_state, cfg.dt_rank
        dc = cfg.mamba_d_conv
        self.in_proj = _empty((d, 2 * di), device, dtype)
        self.conv_w = _empty((dc, di), device, dtype)
        self.conv_b = _empty((di,), device, dtype)
        self.x_proj = _empty((di, r + 2 * n), device, dtype)
        self.dt_proj = _empty((r, di), device, dtype)
        self.dt_bias = _empty((di,), device, dtype)
        self.A_log = _empty((di, n), device, dtype)
        self.D = _empty((di,), device, dtype)
        self.out_proj = _empty((di, d), device, dtype)

    def reset_parameters(self, g: torch.Generator):
        cfg = self.cfg
        _draw(self.in_proj, g)
        _draw(self.conv_w, g, 1.0 / math.sqrt(cfg.mamba_d_conv))
        self.conv_b.zero_()
        _draw(self.x_proj, g)
        _draw(self.dt_proj, g, 1.0 / math.sqrt(cfg.dt_rank))
        # softplus^-1(0.01), in f32 as the reference computes it
        self.dt_bias.copy_(torch.full(self.dt_bias.shape, 0.01).expm1().log())
        n = cfg.mamba_d_state
        self.A_log.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32))
                         .expand(self.A_log.shape))
        self.D.fill_(1.0)
        _draw(self.out_proj, g, 1.0 / math.sqrt(cfg.d_inner))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: [B, S, di]; w: [dc, di].  The
    dc taps unrolled over a left-padded input, in the reference's order
    (no `F.conv1d`, whose sums associate otherwise)."""
    dc, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = torch.zeros_like(x)
    for i in range(dc):
        out = out + pad[:, i:i + s, :] * w[i]
    return out + b


def _prefix_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the affine maps h -> a h + b, the
    earlier map applied first: ceil(log2 Q) doubling steps, step j
    combining each t with t - 2^j."""
    s = 1
    while s < a.shape[1]:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], b[:, :-s], a[:, s:])],
                      dim=1)
        a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1)
        s *= 2
    return a, b


def _ssm_scan_chunked(dA, dBx, C, h0, chunk: int):
    """Selective scan in chunks.

    dA, dBx: [B, S, di, N]; C: [B, S, N]; h0: [B, di, N].
    Returns (y [B, S, di], h_final).
    """
    s = dA.shape[1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    h, ys = h0, []
    for c0 in range(0, s, q):
        pref_a, scan_b = _prefix_scan(dA[:, c0:c0 + q], dBx[:, c0:c0 + q])
        h_t = scan_b + pref_a * h[:, None]                 # [B, q, di, N]
        ys.append(torch.einsum("bqdn,bqn->bqd", h_t, C[:, c0:c0 + q]))
        h = h_t[:, -1]
        del pref_a, scan_b, h_t
    return torch.cat(ys, dim=1), h


def _dt(p: Mamba, dt_r: torch.Tensor, dtype) -> torch.Tensor:
    return F.softplus((dt_r @ p.dt_proj.to(dtype)).float() + p.dt_bias)


def _channels(p: Mamba) -> tuple:
    """(this rank's d_inner channels, whether they are a share)."""
    di = p.cfg.d_inner
    ch = sh.model_slice(Mamba.SPECS["conv_b"], (di,), 0)
    return ch, sh.is_split(ch, di)


def _in_proj(p: Mamba, x: torch.Tensor):
    """(x_in, z) of this rank's channels: x passes `enter` where the
    channels split; a split in_proj is gathered (for split use where
    the channels split, for the whole layer on every rank where they do
    not) and this rank's x and z columns taken from it."""
    cfg, dt = p.cfg, x.dtype
    di = cfg.d_inner
    ch, split = _channels(p)
    w = p.in_proj
    shape = (cfg.d_model, 2 * di)
    if sh.is_split(sh.model_slice(Mamba.SPECS["in_proj"], shape, 1), 2 * di):
        w = sh.model_gather(w, 1, split_use=split)
    if split:
        x = sh.enter(x)
        w = torch.cat([w[:, ch], w[:, di + ch.start:di + ch.stop]], dim=1)
    return (x @ w.to(dt)).chunk(2, dim=-1)


def _x_proj(p: Mamba, x_c: torch.Tensor):
    """(dt_r, B, C): row-parallel over split channels, summed by `leave`
    and entering the channel products again."""
    r, n = p.cfg.dt_rank, p.cfg.mamba_d_state
    out = x_c @ p.x_proj.to(x_c.dtype)
    if _channels(p)[1]:
        out = sh.enter(sh.leave(out))
    return out.split([r, n, n], dim=-1)


def _out_proj(p: Mamba, y: torch.Tensor) -> torch.Tensor:
    out = y @ p.out_proj.to(y.dtype)
    return sh.leave(out) if _channels(p)[1] else out


def mamba_with_state(p: Mamba, x: torch.Tensor, h0=None, conv0=None,
                     chunk: int = 256):
    """x: [B, S, d] -> (out [B, S, d], (h, conv_state)), from the state
    (h0, conv0) or from zeros."""
    cfg, dt = p.cfg, x.dtype
    b, s, _ = x.shape
    n, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    ch, _ = _channels(p)
    di = ch.stop - ch.start
    x_in, z = _in_proj(p, x)
    w, bias = p.conv_w.to(dt), p.conv_b.to(dt)
    if conv0 is not None:
        x_cat = torch.cat([conv0.to(dt), x_in], dim=1)
        x_c = _causal_conv(x_cat, w, bias)[:, conv0.shape[1]:]
    else:
        x_c = _causal_conv(x_in, w, bias)
    x_c = F.silu(x_c)
    dt_r, bmat, cmat = _x_proj(p, x_c)
    delta = _dt(p, dt_r, dt)                                  # [B, S, di]
    A = -torch.exp(p.A_log)                                   # [di, N]
    dA = torch.exp(delta[..., None] * A)                      # [B, S, di, N]
    dBx = delta[..., None] * bmat[:, :, None, :].float() \
        * x_c[..., None].float()
    if h0 is None:
        h0 = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    y, h = _ssm_scan_chunked(dA, dBx, cmat.float(), h0, chunk)
    del dA, dBx
    y = y.to(dt) + x_c * p.D.to(dt)
    y = y * F.silu(z)
    out = _out_proj(p, y)
    conv_state = x_in[:, -(dc - 1):, :] if s >= dc - 1 else x_in
    return out, (h, conv_state)


def mamba_decode(p: Mamba, x: torch.Tensor, state):
    """One-token step. x: [B, 1, d]; state = (h [B, di, N], conv
    [B, dc - 1, di]), this rank's channels.  Returns (out [B, 1, d],
    new state)."""
    dt = x.dtype
    h, conv_state = state
    x_in, z = _in_proj(p, x)                                  # [B, 1, di]
    window = torch.cat([conv_state.to(dt), x_in], dim=1)      # [B, dc, di]
    x_c = torch.einsum("bti,ti->bi", window, p.conv_w.to(dt)) \
        + p.conv_b.to(dt)
    x_c = F.silu(x_c)[:, None, :]                             # [B, 1, di]
    dt_r, bmat, cmat = _x_proj(p, x_c)
    delta = _dt(p, dt_r, dt)[:, 0]                            # [B, di]
    A = -torch.exp(p.A_log)
    dA = torch.exp(delta[..., None] * A)                      # [B, di, N]
    dBx = delta[..., None] * bmat[:, 0, None, :].float() \
        * x_c[:, 0, :, None].float()
    h = dA * h + dBx
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0].float()).to(dt)
    y = (y + x_c[:, 0] * p.D.to(dt))[:, None, :]
    y = y * F.silu(z)
    return _out_proj(p, y), (h, window[:, 1:, :])
