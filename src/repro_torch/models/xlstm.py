"""xLSTM blocks (arXiv:2405.04517) on torch: the mLSTM (matrix memory,
chunkwise parallel) and the sLSTM (scalar memory, strictly recurrent).

The port of `repro.models.xlstm`.  The mLSTM is quadratic inside a chunk
and carries its (C, n, m) state from chunk to chunk (a Python loop over
the chunks); decode is the same function at chunk 1.  The sLSTM feeds
h_{t-1} through a recurrent matrix into the gates, so it is a Python
loop over time, one step a few torch ops.

States, as the reference's tuples:
  mLSTM: (C [B, H, dh, dh], n [B, H, dh], m [B, H])
  sLSTM: (c [B, H, dh], n [B, H, dh], h [B, H, dh], m [B, H, dh])
The initial m is -1e30 and the sLSTM's initial n 1e-6, as the
reference's, so the first `exp` terms match.

Over the model axis (`sharding.model_slice`):
  mLSTM: wq / wk / wv split their d columns (`heads`), up_proj its 4d
    (x branch, then gate) and down_proj its 2d rows (`d_inner`).  A rank
    runs the heads its q / k / v columns touch (where a shard cuts a
    head, q / k / v are all-gathered and the head is run by each rank
    that holds a piece of it), and the read-out's 2d channels of its
    down_proj rows; channel c reads h[c mod d], so h is all-gathered
    from each rank's columns.  up_proj is split on its concatenated
    axis in contiguous pieces: gathered, and this rank's x and gate
    columns taken.  The gates (`w_if`, `b_i`, `b_f`, not split) are
    computed whole on every rank and enter the heads' products.
  sLSTM: w_gates / b_gates [d, 4d] lay each head's i, f, z, o side by
    side (the pre-activations reshape to [.., H, 4 dh]), so a split on
    whole heads is head-local, as r_gates' split on `heads`; the heads'
    h are all-gathered for out_proj, which is not split.  Where the heads
    do not divide while 4d does, the split w_gates / b_gates are
    gathered and the layer runs whole on every rank.
The states hold this rank's heads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _draw, _empty


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLstm(nn.Module):
    """up_proj [d, 4d] (the x branch and the gate branch, di = 2d each),
    wq / wk / wv [d, d], w_if [d, 2H], b_i / b_f [H], down_proj [2d, d]."""

    SPECS = {"up_proj": ("fsdp", "d_inner"), "wq": ("fsdp", "heads"),
             "wk": ("fsdp", "heads"), "wv": ("fsdp", "heads"),
             "w_if": ("fsdp", None), "b_i": (None,), "b_f": (None,),
             "down_proj": ("d_inner", "fsdp")}

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, hn = cfg.d_model, cfg.num_heads
        self.up_proj = _empty((d, 4 * d), device, dtype)
        self.wq = _empty((d, d), device, dtype)
        self.wk = _empty((d, d), device, dtype)
        self.wv = _empty((d, d), device, dtype)
        self.w_if = _empty((d, 2 * hn), device, dtype)
        self.b_i = _empty((hn,), device, dtype)
        self.b_f = _empty((hn,), device, dtype)
        self.down_proj = _empty((2 * d, d), device, dtype)

    def reset_parameters(self, g: torch.Generator):
        for w in (self.up_proj, self.wq, self.wk, self.wv):
            _draw(w, g)
        _draw(self.w_if, g, 0.02)
        self.b_i.zero_()
        self.b_f.fill_(3.0)  # open forget gates
        _draw(self.down_proj, g)


def _mlstm_chunk(q, k, v, li, lf, state):
    """One chunkwise-parallel mLSTM step.

    q/k/v: [B, H, Q, dh]; li/lf: [B, H, Q] log input / forget gates.
    state: (C [B, H, dh, dh], n [B, H, dh], m [B, H]).
    """
    C, n, m = state
    b_cum = torch.cumsum(lf, dim=-1)                   # [B, H, Q]
    B_tot = b_cum[..., -1]
    u = li - b_cum
    u_max = torch.cummax(u, dim=-1).values
    m_t = b_cum + torch.maximum(m[..., None], u_max)   # [B, H, Q]

    inter_w = torch.exp(b_cum + m[..., None] - m_t)
    # intra weights D_{t tau} = exp(b_t - b_tau + li_tau - m_t), tau <= t
    lD = (b_cum[..., :, None] - b_cum[..., None, :] + li[..., None, :]
          - m_t[..., :, None])
    qn = lD.shape[-1]
    tri = torch.ones((qn, qn), dtype=torch.bool, device=lD.device).tril()
    D = torch.where(tri, torch.exp(lD), 0.0)           # [B, H, Q, Q]

    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * D
    h_intra = torch.einsum("bhqk,bhkd->bhqd", scores, v)
    h_inter = torch.einsum("bhqd,bhde->bhqe", q, C) * inter_w[..., None]
    num = h_intra + h_inter

    n_intra = torch.einsum("bhqk,bhkd->bhqd", D, k)
    n_t = n_intra + n[..., None, :] * inter_w[..., None]
    denom = torch.maximum(torch.einsum("bhqd,bhqd->bhq", q, n_t).abs(),
                          torch.exp(-m_t))
    h = num / denom[..., None]                         # [B, H, Q, dh]

    # the state at the end of the chunk
    m_new = B_tot + torch.maximum(m, u_max[..., -1])
    decay_prev = torch.exp(B_tot + m - m_new)          # [B, H]
    w_tau = torch.exp(B_tot[..., None] - b_cum + li - m_new[..., None])
    C_new = C * decay_prev[..., None, None] + torch.einsum(
        "bhqd,bhqe,bhq->bhde", k, v, w_tau)
    n_new = n * decay_prev[..., None] + torch.einsum("bhqd,bhq->bhd", k,
                                                     w_tau)
    return h, (C_new, n_new, m_new)


def _heads(x: torch.Tensor, hn: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, hn, d // hn).transpose(1, 2)  # [B, H, S, dh]


def _gathered_cols(w: torch.Tensor, spec: tuple, n: int, split_use: bool):
    """A [*, n] weight whose last dim the model axis may split: gathered
    whole where it does (see `sharding.model_gather`), else itself."""
    full = tuple(w.shape[:-1]) + (n,)
    if sh.is_split(sh.model_slice(spec, full, w.dim() - 1), n):
        return sh.model_gather(w, -1, split_use)
    return w


def mlstm_with_state(p: MLstm, x: torch.Tensor, state=None,
                     chunk: int = 256):
    """x: [B, S, d] -> ([B, S, d], state), from `state` or the initial
    one.  Decode is this function at chunk 1 (`mlstm_decode`)."""
    cfg, dt = p.cfg, x.dtype
    b, s, d = x.shape
    hn = cfg.num_heads
    dh = d // hn
    cols = sh.model_slice(MLstm.SPECS["wq"], (d, d), 1)      # q / k / v
    chans = sh.model_slice(MLstm.SPECS["down_proj"], (2 * d, d), 0)
    heads_split, chans_split = sh.is_split(cols, d), sh.is_split(chans, 2 * d)
    h0, h1 = cols.start // dh, -(-cols.stop // dh)            # heads run
    xe = sh.enter(x) if chans_split else x
    # this rank's channels of the x branch and of the gate
    w_up = _gathered_cols(p.up_proj, MLstm.SPECS["up_proj"], 4 * d,
                          chans_split)
    if chans_split:
        w_up = torch.cat([w_up[:, chans],
                          w_up[:, 2 * d + chans.start:2 * d + chans.stop]], 1)
    x_br, z = (xe @ w_up.to(dt)).chunk(2, dim=-1)
    # q / k / v of the heads this rank runs: from its own columns, whole
    # heads; all-gathered where a shard cuts a head
    xq = xe if heads_split else x
    q, k, v = (xq @ w.to(dt) for w in (p.wq, p.wk, p.wv))
    if heads_split and (cols.start % dh or cols.stop % dh):
        q, k, v = (sh.model_gather(t, -1, split_use=True)[
            ..., h0 * dh:h1 * dh] for t in (q, k, v))
    hl = h1 - h0
    q = _heads(q, hl)
    # the reference divides by a numpy f64 scalar, which promotes bf16
    k = _heads(k, hl).float() / math.sqrt(dh)
    v = _heads(v, hl)
    gates = x.float() @ p.w_if.float() + torch.cat([p.b_i, p.b_f])
    if heads_split:
        gates = sh.enter(gates)
    li = gates[..., h0:h1].transpose(1, 2)                   # [B, H, S]
    lf = F.logsigmoid(gates[..., hn + h0:hn + h1]).transpose(1, 2)
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((b, hl, dh, dh), **f32),
                 torch.zeros((b, hl, dh), **f32),
                 torch.full((b, hl), -1e30, **f32))
    qn = min(chunk, s)
    if s % qn:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {qn}")
    hs = []
    for c0 in range(0, s, qn):
        sl = slice(c0, c0 + qn)
        h, state = _mlstm_chunk(q[:, :, sl].float(), k[:, :, sl],
                                v[:, :, sl].float(), li[..., sl], lf[..., sl],
                                state)
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(b, s, hl * dh)
    # every feature of h, from each rank's columns; or, heads whole on
    # every rank, h entering the split channels
    if heads_split:
        h = sh.model_gather(h[..., cols.start - h0 * dh:cols.stop - h0 * dh],
                            -1, split_use=chans_split)
    elif chans_split:
        h = sh.enter(h)
    # GLU-style read-out: h modulates the up-projected branch, gated by
    # silu(z); channel c of the 2d reads h[c mod d]
    hh = torch.cat([h.to(dt)] * 2, dim=-1)
    out = x_br * F.silu(z) * (hh[..., chans] if chans_split else hh)
    out = out @ p.down_proj.to(dt)
    return (sh.leave(out) if chans_split else out), state


def mlstm_decode(p: MLstm, x: torch.Tensor, state):
    """x: [B, 1, d]; the O(1) recurrent update."""
    return mlstm_with_state(p, x, state, chunk=1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLstm(nn.Module):
    """w_gates [d, 4d] (i, f, z, o pre-activations), r_gates [H, dh, 4dh],
    b_gates [4d], out_proj [d, d]."""

    SPECS = {"w_gates": ("fsdp", "d_inner"), "r_gates": ("heads", None, None),
             "b_gates": ("d_inner",), "out_proj": ("fsdp", "d_model")}

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, hn = cfg.d_model, cfg.num_heads
        dh = d // hn
        self.w_gates = _empty((d, 4 * d), device, dtype)
        self.r_gates = _empty((hn, dh, 4 * dh), device, dtype)
        self.b_gates = _empty((4 * d,), device, dtype)
        self.out_proj = _empty((d, d), device, dtype)

    def reset_parameters(self, g: torch.Generator):
        d = self.cfg.d_model
        _draw(self.w_gates, g)
        _draw(self.r_gates, g, 1.0 / math.sqrt(self.r_gates.shape[1]))
        self.b_gates.zero_()
        self.b_gates[d:2 * d] = 3.0
        _draw(self.out_proj, g)


def slstm_with_state(p: SLstm, x: torch.Tensor, state=None):
    """The recurrence over time, x: [B, S, d] -> ([B, S, d], state)."""
    cfg = p.cfg
    b, s, d = x.shape
    hn = cfg.num_heads
    dh = d // hn
    heads = sh.model_slice(SLstm.SPECS["r_gates"], (hn, dh, 4 * dh), 0)
    split = sh.is_split(heads, hn)
    hl = heads.stop - heads.start
    w, bias = p.w_gates, p.b_gates
    if not split:   # heads whole: any split of 4d gathered
        w = _gathered_cols(w, SLstm.SPECS["w_gates"], 4 * d, False)
        bias = _gathered_cols(bias, SLstm.SPECS["b_gates"], 4 * d, False)
    xin = sh.enter(x) if split else x
    pre_x = (xin.float() @ w.float() + bias.float()).reshape(
        b, s, hl, 4 * dh)
    if state is None:
        zero = torch.zeros((b, hl, dh), dtype=torch.float32, device=x.device)
        state = (zero, zero + 1e-6, zero, zero - 1e30)  # c, n, h, m
    c, n, h, m = state
    r = p.r_gates.float()
    hs = []
    for t in range(s):
        pre = pre_x[:, t] + torch.einsum("bhd,hde->bhe", h, r)
        it, ft, zt, ot = pre.chunk(4, dim=-1)
        fm = ft + m
        m_new = torch.maximum(fm, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(fm - m_new)
        c = fp * c + ip * torch.tanh(zt)
        n = fp * n + ip
        h = torch.sigmoid(ot) * (c / torch.clamp(n, min=1e-6))
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(b, s, hl * dh).to(x.dtype)
    if split:   # out_proj is not split: every rank runs it whole
        out = sh.model_gather(out, -1, split_use=False)
    return out @ p.out_proj.to(x.dtype), (c, n, h, m)


def slstm_decode(p: SLstm, x: torch.Tensor, state):
    return slstm_with_state(p, x, state)
