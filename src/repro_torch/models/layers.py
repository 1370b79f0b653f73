"""Transformer building blocks on torch: norms, RoPE, grouped-query
attention, MLPs.

The port of `repro.models.layers`.  The functions mirror the reference's
operations and its cast points, type promotion included: the attention
scores are f32 from the division by sqrt(dh) on (the reference divides
by a numpy f64 scalar, which promotes bf16), the probabilities are cast
back to q's dtype before the value product, and every weight is cast to
the activation's dtype before its product.  No library attention
kernel: it could apply neither the logit softcap nor those casts.

The modules (`RmsNorm`, `Attention`, `Mlp`) hold their parameters in the
reference's shapes (`wq [d, H, dh]`, `wo [H, dh, d]`, `w_down [f, d]`),
so carrying JAX weights across is a copy.  Parameters are allocated
empty; `reset_parameters(generator)` draws them as the reference's init
functions scale them.

Over the model axis (`sharding.model_slice`) a parameter holds this
rank's share: attention's q / k / v and their biases are column-
parallel over the heads and wo row-parallel, the MLP's first products
column-parallel over d_ff and w_down row-parallel.  The block's input
passes `sharding.enter` once, the row-parallel product
`sharding.leave`.  Where the kv heads do not divide while the q heads
do (GQA), every rank projects all kv heads and gives each of its q
heads its own; where the heads do not divide, the attention runs whole
on every rank.  `RmsNorm` is replicated.

A decode cache whose length `sharding.length_split` splits (the kv
heads do not divide over `model`, or a batch of one row) holds every
kv head on rows [lo, hi) of the length.  The decode step then attends
every q head over the slice (`_sdpa_partial`: the slice's max score m,
l = sum exp(s - m) and o = sum exp(s - m) v, in f32) and combines the
ranks' partials (`combine_partials`: an all-reduce MAX of m, then one
all-reduce SUM of o and l rescaled by exp(m - max)); only the rank whose
slice holds `pos` writes the step's K / V.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig


def _draw(p: torch.Tensor, g: torch.Generator, scale: float | None = None):
    """Fill `p` with normal * scale (default 1/sqrt(shape[0])), drawn in
    f32 from `g` and cast to p's dtype, as the reference's `_init`."""
    scale = scale if scale is not None else 1.0 / math.sqrt(p.shape[0])
    p.copy_(torch.randn(p.shape, generator=g, device=p.device) * scale)


def _empty(shape, device, dtype) -> nn.Parameter:
    """An uninitialised parameter, without autograd until a trainer
    turns it on (`model.requires_grad_(True)`)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with the `1 + w` scale, computed in f32."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(dtype)


class RmsNorm(nn.Module):
    # each parameter's logical axes (the reference's init specs), read
    # by `model.param_specs`
    SPECS = {"weight": ("d_model",)}

    def __init__(self, d: int, eps: float, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = _empty((d,), device, dtype)

    def reset_parameters(self, g: torch.Generator | None = None):
        self.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S] (or [S]) int.  Rotates the two
    halves of dh (not interleaved pairs), in f32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # [B, S, dh/2]
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, d] x [d, H, dh] -> [B, S, H, dh]."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return scores
    return cap * torch.tanh(scores / cap)


def _sdpa(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """Grouped-query attention core.

    q: [B, Sq, Hq, dh]; k/v: [B, Sk, Hkv, dh]; mask: broadcastable to
    [B, 1, 1, Sq, Sk] (True = attend).
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    ct = torch.promote_types(q.dtype, k.dtype)  # cross: f32 q, bf16 k / v
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg.to(ct), k.to(ct))
    # the reference divides by a numpy f64 scalar, which promotes bf16
    # scores to f32 before the division
    scores = scores.float() / math.sqrt(dh)
    scores = _softcap(scores, cfg.attn_logit_softcap)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ct = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs.to(ct), v.to(ct))
    return out.reshape(b, sq, hq, dh)


def _sdpa_partial(q, k, v, mask, cfg: ModelConfig) -> tuple:
    """`_sdpa` over one slice of the keys, not yet normalised: (m, l, o)
    in f32, m [B, Hkv, g, Sq, 1] the slice's max score (-1e30 where the
    mask leaves it empty), l = sum exp(s - m) and o [B, Hkv, g, Sq, dh] =
    sum exp(s - m) v.  The scores as `_sdpa` makes them: the division by
    sqrt(dh), the softcap and the -1e30 fill."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    ct = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg.to(ct), k.to(ct))
    scores = _softcap(scores.float() / math.sqrt(dh), cfg.attn_logit_softcap)
    scores = torch.where(mask, scores, -1e30)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    o = torch.einsum("bhgqs,bshk->bhgqk", p, v.float())
    return m, p.sum(-1, keepdim=True), o


def combine_partials(m, l, o, reduce, dtype) -> torch.Tensor:
    """The attention output [B, Sq, Hq, dh] in `dtype` from the slices'
    partials (`_sdpa_partial`), reduced over the slices by `reduce(t,
    op)` (op "max" or "sum": an all-reduce over the ranks that split the
    length, or `over_slices` for partials stacked on dim 0).  A slice
    the mask leaves empty (m = -1e30) adds exp(-1e30 - max) = 0."""
    top = reduce(m, "max")
    w = torch.exp(m - top)
    ol = reduce(torch.cat([o * w, l * w], dim=-1), "sum")
    out = ol[..., :-1] / ol[..., -1:]              # [B, Hkv, g, Sq, dh]
    b, hkv, g, sq, dh = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hkv * g, dh).to(dtype)


def over_slices(t: torch.Tensor, op: str) -> torch.Tensor:
    """`combine_partials`' reduce over partials stacked on dim 0."""
    return t.amax(0) if op == "max" else t.sum(0)


def sdpa_slices(q, ks, vs, masks, cfg: ModelConfig) -> torch.Tensor:
    """`_sdpa` over the keys cut into slices (k / v [B, s_r, Hkv, dh],
    each with its mask), the partials combined in this process: what
    the ranks that split a decode cache's length compute together."""
    parts = [_sdpa_partial(q, k, v, m, cfg) for k, v, m in zip(ks, vs, masks)]
    m, l, o = (torch.stack(t) for t in zip(*parts))
    return combine_partials(m, l, o, over_slices,
                            torch.promote_types(q.dtype, vs[0].dtype))


def decode_mask(lo: int, hi: int, pos: int, window: int,
                device=None) -> torch.Tensor:
    """[1, 1, 1, 1, hi - lo] mask of cache rows lo..hi-1 (global
    positions) for the query at `pos`: at or before it, and with window
    > 0 within the window's last `window` positions."""
    ki = torch.arange(lo, hi, device=device)
    mask = ki <= pos
    if window > 0:
        mask &= ki > pos - window
    return mask[None, None, None, None, :]


def causal_mask(sq: int, sk: int, window: int = 0,
                device=None) -> torch.Tensor:
    """[1, 1, 1, sq, sk] mask; window > 0 adds a sliding-window band."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)  # align ends
    ki = torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window > 0:
        m &= ki > qi - window
    return m[None, None, None]


# Above this many query rows, attention runs q-chunked (exact row
# blocking): the [Sq, Sk] score matrix never materializes, each step
# holds one [chunk, Sk] row block in f32.  Read at call time, so a test
# can raise the threshold to force the dense path.
Q_CHUNK_THRESHOLD = 2048
Q_CHUNK = 1024


def _sdpa_qchunked(q, k, v, cfg: ModelConfig, causal: bool,
                   window: int) -> torch.Tensor:
    """Exact attention with the query dim in chunks of Q_CHUNK rows.

    q: [B, Sq, Hq, dh]; k/v: [B, Sk, Hkv, dh].  Assumes Sq and Sk align
    at the sequence end (prefill layout).
    """
    b, sq, hq, dh = q.shape
    sk = k.shape[1]
    c = Q_CHUNK
    assert sq % c == 0, (sq, c)
    ki = torch.arange(sk, device=q.device)
    outs = []
    for idx in range(sq // c):
        qc = q[:, idx * c:(idx + 1) * c]
        if causal:
            qi = idx * c + (sk - sq) + torch.arange(c, device=q.device)
            m = ki[None, :] <= qi[:, None]
            if window > 0:
                m &= ki[None, :] > qi[:, None] - window
            m = m[None, None, None]
        else:
            m = torch.ones((1, 1, 1, c, sk), dtype=torch.bool,
                           device=q.device)
        outs.append(_sdpa(qc, k, v, m, cfg))
    return torch.cat(outs, dim=1)


def _full_attention(q, k, v, cfg: ModelConfig, causal: bool, window: int,
                    chunk_ok: bool) -> torch.Tensor:
    """The q-chunked path above Q_CHUNK_THRESHOLD rows (where the caller
    allows it), else the dense mask."""
    sq, sk = q.shape[1], k.shape[1]
    if chunk_ok and sq > Q_CHUNK_THRESHOLD and sq % Q_CHUNK == 0:
        return _sdpa_qchunked(q, k, v, cfg, causal, window)
    if causal:
        mask = causal_mask(sq, sk, window, q.device)
    else:
        mask = torch.ones((1, 1, 1, sq, sk), dtype=torch.bool,
                          device=q.device)
    return _sdpa(q, k, v, mask, cfg)


class Attention(nn.Module):
    """Grouped-query attention: wq [d, H, dh], wk / wv [d, Hkv, dh],
    wo [H, dh, d], and with `cfg.qkv_bias` (self-attention only) the
    biases bq [H, dh], bk / bv [Hkv, dh]; over the model axis, this
    rank's heads of each."""

    SPECS = {"wq": ("fsdp", "heads", "head_dim"),
             "wk": ("fsdp", "kv_heads", "head_dim"),
             "wv": ("fsdp", "kv_heads", "head_dim"),
             "wo": ("heads", "head_dim", "fsdp"),
             "bq": ("heads", "head_dim"),
             "bk": ("kv_heads", "head_dim"),
             "bv": ("kv_heads", "head_dim")}

    def __init__(self, cfg: ModelConfig, *, cross: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, hq, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim)
        self.q_shape, self.kv_shape = (d, hq, dh), (d, hkv, dh)
        self.wq = _empty((d, hq, dh), device, dtype)
        self.wk = _empty((d, hkv, dh), device, dtype)
        self.wv = _empty((d, hkv, dh), device, dtype)
        self.wo = _empty((hq, dh, d), device, dtype)
        self.has_bias = cfg.qkv_bias and not cross
        if self.has_bias:
            self.bq = _empty((hq, dh), device, dtype)
            self.bk = _empty((hkv, dh), device, dtype)
            self.bv = _empty((hkv, dh), device, dtype)

    def reset_parameters(self, g: torch.Generator):
        for w in (self.wq, self.wk, self.wv):
            _draw(w, g)
        _draw(self.wo, g, 1.0 / math.sqrt(self.wo.shape[0]
                                          * self.wo.shape[1]))
        if self.has_bias:
            for b in (self.bq, self.bk, self.bv):
                b.zero_()

    def _heads(self):
        """(this rank's q heads, its kv heads, whether the q heads are a
        share of H)."""
        q = sh.model_slice(self.SPECS["wq"], self.q_shape, 1)
        kv = sh.model_slice(self.SPECS["wk"], self.kv_shape, 1)
        return q, kv, sh.is_split(q, self.cfg.num_heads)

    def _q(self, xe):
        q = _proj(xe, self.wq)
        return q + self.bq.to(xe.dtype) if self.has_bias else q

    def _kv(self, x):
        k, v = _proj(x, self.wk), _proj(x, self.wv)
        if self.has_bias:
            k = k + self.bk.to(x.dtype)
            v = v + self.bv.to(x.dtype)
        return k, v

    def project_kv(self, x, xe=None, heads=None):
        """K / V of x as a cache holds them (for cross-attention, the
        encoder states, projected once for all decoder calls): this
        rank's kv heads where they split, else all of them, projected on
        every rank.  `xe` is x already through `enter`, `heads`
        `_heads()`."""
        heads = heads or self._heads()
        if sh.is_split(heads[1], self.cfg.num_kv_heads):
            return self._kv(sh.enter(x) if xe is None else xe)
        return self._kv(x)

    def _per_q(self, k, v, heads):
        """The kv heads this rank's q heads read: k / v as they are,
        or, where the q heads split while the kv heads are whole, each
        of this rank's q heads' own (one kv head a q head), through
        `enter`."""
        qs, kvs, q_split = heads
        if not q_split or sh.is_split(kvs, self.cfg.num_kv_heads):
            return k, v
        g = self.cfg.num_heads // self.cfg.num_kv_heads
        ids = torch.arange(qs.start, qs.stop, device=k.device) // g
        return sh.enter(k)[:, :, ids], sh.enter(v)[:, :, ids]

    def _out(self, o, dtype, q_split: bool):
        out = torch.einsum("bshk,hkd->bsd", o, self.wo.to(dtype))
        return sh.leave(out) if q_split else out

    def forward(self, x, positions, *, local: bool = False,
                causal: bool = True, kv_override=None):
        """Full-sequence attention (training / prefill): the reference's
        `attention`.  kv_override supplies cross-attention keys/values
        (the encoder states), already projected (`project_kv`); q is
        then not rotated.
        """
        heads = self._heads()
        xe = sh.enter(x) if heads[2] else x
        q = self._q(xe)
        if kv_override is None:
            k, v = self._per_q(*self.project_kv(x, xe, heads), heads)
            q = apply_rope(q, positions, self.cfg.rope_theta)
            k = apply_rope(k, positions, self.cfg.rope_theta)
        else:
            k, v = self._per_q(*kv_override, heads)
        window = self.cfg.window_size if local else 0
        out = _full_attention(q, k, v, self.cfg, causal, window,
                              chunk_ok=q.shape[1] == k.shape[1])
        return self._out(out, x.dtype, heads[2])

    def prefill(self, x, positions, *, local: bool = False):
        """Causal self-attention that also returns the rotated K / V for
        the decode cache (`project_kv`'s heads): the reference's
        `_attn_prefill`."""
        heads = self._heads()
        xe = sh.enter(x) if heads[2] else x
        q = apply_rope(self._q(xe), positions, self.cfg.rope_theta)
        k, v = self.project_kv(x, xe, heads)
        k = apply_rope(k, positions, self.cfg.rope_theta)
        window = self.cfg.window_size if local else 0
        out = _full_attention(q, *self._per_q(k, v, heads), self.cfg, True,
                              window, chunk_ok=True)
        return self._out(out, x.dtype, heads[2]), (k, v)

    def decode(self, x, cache_k, cache_v, pos: int, *, local: bool = False,
               cross: bool = False, split: sh.LengthSplit | None = None):
        """One decode step at position `pos` (a host int): x [B, 1, d].
        Writes this step's K / V into the caches in place, at `pos`, and
        returns (out [B, 1, d], cache_k, cache_v).  A cross-attention
        cache holds the projected encoder states and is left as it is.

        With `split` the caches hold every kv head on rows [lo, hi) of
        the length: the rank whose rows hold `pos` writes there, every
        q head (gathered over `model` where they split) attends the
        slice, the ranks' partials are combined, and this rank's q
        heads' output goes on to wo."""
        heads = self._heads()
        qs, kvs, q_split = heads
        xe = sh.enter(x) if q_split else x
        q = self._q(xe)
        if not cross:
            k, v = self.project_kv(x, xe, heads)
            posb = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                              device=x.device)
            q = apply_rope(q, posb, self.cfg.rope_theta)
            k = apply_rope(k, posb, self.cfg.rope_theta)
        lo, hi = (0, cache_k.shape[1]) if split is None else (split.lo,
                                                              split.hi)
        if split is not None:
            if not 0 <= pos < split.length:
                raise IndexError(f"position {pos} outside a cache of "
                                 f"{split.length}")
            if q_split:
                q = sh.model_gather(q, 2, split_use=False)
            if not cross and sh.is_split(kvs, self.cfg.num_kv_heads):
                k = sh.model_gather(k, 2, split_use=False)
                v = sh.model_gather(v, 2, split_use=False)
        if not cross and (split is None or lo <= pos < hi):
            cache_k[:, pos - lo:pos - lo + 1] = k
            cache_v[:, pos - lo:pos - lo + 1] = v
        if cross:
            mask = torch.ones((1, 1, 1, 1, hi - lo), dtype=torch.bool,
                              device=x.device)
        else:
            mask = decode_mask(lo, hi, pos, self.cfg.window_size if local
                               else 0, x.device)
        if split is None:
            out = _sdpa(q, *self._per_q(cache_k, cache_v, heads), mask,
                        self.cfg)
        else:
            out = combine_partials(
                *_sdpa_partial(q, cache_k, cache_v, mask, self.cfg),
                split.reduce, torch.promote_types(q.dtype, cache_v.dtype))
            if q_split:
                out = out[:, :, qs]
        return self._out(out, x.dtype, q_split), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class Mlp(nn.Module):
    """swiglu: w_gate, w_up [d, f], w_down [f, d]; gelu (tanh, as
    `jax.nn.gelu`) or relu: w_in [d, f], w_down [f, d].  f is `hidden`,
    by default `cfg.d_ff` (an MoE's shared expert is wider); over the
    model axis, this rank's columns of f."""

    SPECS = {"w_gate": ("fsdp", "d_ff"), "w_up": ("fsdp", "d_ff"),
             "w_in": ("fsdp", "d_ff"), "w_down": ("d_ff", "fsdp")}

    def __init__(self, cfg: ModelConfig, hidden: int | None = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        d, f = cfg.d_model, hidden or cfg.d_ff
        self.kind = cfg.mlp_type
        self.down_shape = (f, d)
        if self.kind == "swiglu":
            self.w_gate = _empty((d, f), device, dtype)
            self.w_up = _empty((d, f), device, dtype)
        else:
            self.w_in = _empty((d, f), device, dtype)
        self.w_down = _empty((f, d), device, dtype)

    def reset_parameters(self, g: torch.Generator):
        for w in ((self.w_gate, self.w_up) if self.kind == "swiglu"
                  else (self.w_in,)):
            _draw(w, g)
        _draw(self.w_down, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = sh.is_split(sh.model_slice(
            self.SPECS["w_down"], self.down_shape, 0), self.down_shape[0])
        if split:
            x = sh.enter(x)
        if self.kind == "swiglu":
            h = F.silu(x @ self.w_gate.to(x.dtype)) * (x @ self.w_up.to(x.dtype))
        else:
            h = x @ self.w_in.to(x.dtype)
            h = (F.gelu(h, approximate="tanh") if self.kind == "gelu"
                 else F.relu(h))
        out = h @ self.w_down.to(x.dtype)
        return sh.leave(out) if split else out
