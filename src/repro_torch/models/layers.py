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
        """K / V of x for this rank's q heads (for cross-attention, the
        encoder states, projected once for all decoder calls); `xe` is x
        already through `enter`, `heads` `_heads()`.  Split kv heads:
        this rank's.  kv heads whole while the q heads split: all of
        them projected on every rank, then through `enter`, and each of
        this rank's q heads given its kv head (one kv head a q head)."""
        qs, kvs, q_split = heads or self._heads()
        if sh.is_split(kvs, self.cfg.num_kv_heads):
            return self._kv(sh.enter(x) if xe is None else xe)
        k, v = self._kv(x)
        if not q_split:
            return k, v
        g = self.cfg.num_heads // self.cfg.num_kv_heads
        ids = torch.arange(qs.start, qs.stop, device=x.device) // g
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
            k, v = self.project_kv(x, xe, heads)
            q = apply_rope(q, positions, self.cfg.rope_theta)
            k = apply_rope(k, positions, self.cfg.rope_theta)
        else:
            k, v = kv_override
        window = self.cfg.window_size if local else 0
        out = _full_attention(q, k, v, self.cfg, causal, window,
                              chunk_ok=q.shape[1] == k.shape[1])
        return self._out(out, x.dtype, heads[2])

    def prefill(self, x, positions, *, local: bool = False):
        """Causal self-attention that also returns the rotated K / V for
        the decode cache (this rank's kv heads): the reference's
        `_attn_prefill`."""
        heads = self._heads()
        xe = sh.enter(x) if heads[2] else x
        q = apply_rope(self._q(xe), positions, self.cfg.rope_theta)
        k, v = self.project_kv(x, xe, heads)
        k = apply_rope(k, positions, self.cfg.rope_theta)
        window = self.cfg.window_size if local else 0
        out = _full_attention(q, k, v, self.cfg, True, window, chunk_ok=True)
        return self._out(out, x.dtype, heads[2]), (k, v)

    def decode(self, x, cache_k, cache_v, pos: int, *, local: bool = False,
               cross: bool = False):
        """One decode step at position `pos` (a host int): x [B, 1, d].
        Writes this step's K / V into the caches in place, at `pos`, and
        returns (out [B, 1, d], cache_k, cache_v).  A cross-attention
        cache holds the projected encoder states and is left as it is."""
        heads = self._heads()
        xe = sh.enter(x) if heads[2] else x
        q = self._q(xe)
        s = cache_k.shape[1]
        ki = torch.arange(s, device=x.device)
        if cross:
            mask = torch.ones((s,), dtype=torch.bool, device=x.device)
        else:
            k, v = self.project_kv(x, xe, heads)
            posb = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                              device=x.device)
            q = apply_rope(q, posb, self.cfg.rope_theta)
            k = apply_rope(k, posb, self.cfg.rope_theta)
            cache_k[:, pos:pos + 1] = k
            cache_v[:, pos:pos + 1] = v
            mask = ki <= pos
            if local and self.cfg.window_size > 0:
                mask &= ki > pos - self.cfg.window_size
        out = _sdpa(q, cache_k, cache_v, mask[None, None, None, None, :],
                    self.cfg)
        return self._out(out, x.dtype, heads[2]), cache_k, cache_v


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
