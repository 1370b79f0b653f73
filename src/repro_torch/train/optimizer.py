"""AdamW with optional int8 block-quantized moments, on torch.

The port of `repro.train.optimizer`.  The int8 states (blockwise absmax
for the first moment, a log codebook for the second) cut the state from
8 bytes a parameter to about 2.03.

The parameters are a dict of the model's tensors by name (`dict(model.
named_parameters())`); `apply_updates` writes each new value into its
parameter in place and returns the same dict.  The update is the
reference's formula op for op in f32: clip scale, bias corrections,
`mhat / (sqrt(vhat) + eps)`, decoupled decay `lr * (step + wd * p)`,
then a cast back to the parameter's dtype.  It is not `torch.optim.
AdamW`, whose rounding differs and which has no int8 state.  The f32
moments are updated in place; each leaf's temporaries are freed before
the next leaf's, so the largest leaf (an embedding) sets the peak.
The step count, the learning rate and the clip scale stay on the
device: a step makes no host sync.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "fp32"   # fp32 | int8
    quant_block: int = 256


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The warmup + cosine schedule at `step` (an int tensor): f32, on
    the step's device."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, decay)


# -- blockwise int8 quantization ---------------------------------------------


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    """[..., last] -> [..., nb, block], zero-padded: blocked along the
    last axis, so the leading axes stay the parameter's."""
    last = x.shape[-1]
    nb = -(-last // block)
    xp = F.pad(x, (0, nb * block - last))
    return xp.reshape(*x.shape[:-1], nb, block)


def _unblocked(xb: torch.Tensor, shape) -> torch.Tensor:
    out = xb.reshape(*shape[:-1], -1)
    return out[..., :shape[-1]]


def quantize_blockwise(x: torch.Tensor, block: int):
    """(int8 codes [..., nb, block], f32 absmax / 127 scales [..., nb,
    1]); codes round half to even, as `jnp.round`."""
    xb = _blocked(x.to(torch.float32), block)
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0
    q = torch.round(xb / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         shape) -> torch.Tensor:
    return _unblocked(q.to(torch.float32) * scale, shape)


# Log-codebook quantization for the (non-negative) second moment: code 0
# -> 0; codes 1..255 -> scale * 10^(-DECADES * (1 - (k-1)/254)), log-
# spaced over DECADES decades (<= 5.6 % relative error).  Linear absmax
# int8 would collapse a block's small entries to 0, and Adam divides by
# sqrt(v).
_V_DECADES = 12.0


def _log10(x: torch.Tensor) -> torch.Tensor:
    """log10 as XLA computes `jnp.log10`: log(x) times the f32 constant
    1 / ln 10 (`torch.log10` rounds otherwise and moves codes that lie
    on a rounding boundary)."""
    return torch.log(x) * (1.0 / math.log(10.0))


def quantize_v_log(x: torch.Tensor, block: int):
    """(int8 codes k - 128 [..., nb, block], f32 block maxima [..., nb,
    1]) of a non-negative x."""
    blocks = _blocked(x.to(torch.float32), block)
    scale = torch.amax(blocks, dim=-1, keepdim=True)
    safe = torch.clamp(scale, min=1e-38)
    r = torch.clamp(blocks / safe, 0.0, 1.0)
    logr = _log10(torch.clamp(r, min=10.0 ** (-_V_DECADES - 1)))
    k = torch.round((logr / _V_DECADES + 1.0) * 254.0) + 1.0
    k = torch.where(r < 10.0 ** (-_V_DECADES), 0.0,
                    torch.clamp(k, 1.0, 255.0))
    # A block of zeros takes code k = 128 (stored 0), as the reference's
    # does on its platforms: they flush the f32 subnormal 1e-38 floor to
    # zero, so such a block divides 0 / 0 and its NaN codes convert to
    # 0.  Either code dequantizes to 0 there (the scale is 0).
    k = torch.where(scale < torch.finfo(torch.float32).tiny, 128.0, k)
    # the uint8 range in an int8 container
    return (k - 128.0).to(torch.int8), scale


def dequantize_v_log(q: torch.Tensor, scale: torch.Tensor,
                     shape) -> torch.Tensor:
    k = q.to(torch.float32) + 128.0
    r = torch.where(k <= 0.5, 0.0,
                    10.0 ** (_V_DECADES * ((k - 1.0) / 254.0 - 1.0)))
    return _unblocked(r * scale, shape)


# -- state -------------------------------------------------------------------


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    """{"count": int32 0, "mu": {name: {"m", "v"} f32 zeros, or with
    int8 state {"m_q", "m_s", "v_q", "v_s"}}} on each parameter's
    device."""
    def leaf_state(p):
        if cfg.state_dtype == "int8":
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            zq, zs = quantize_blockwise(z, cfg.quant_block)
            vq, vs = quantize_v_log(z, cfg.quant_block)
            return {"m_q": zq, "m_s": zs, "v_q": vq, "v_s": vs}
        return {"m": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}

    dev = next(iter(params.values())).device
    return {"count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": {name: leaf_state(p) for name, p in params.items()}}


def opt_state_specs(param_specs: dict, cfg: OptConfig) -> dict:
    """Logical-axis specs of the optimizer state, mirroring the
    parameters' ({name: axes}, `models.model.param_specs`).  int8: the
    codes [..., nb, block] shard their leading axes as the parameter
    does, and the parameter's last-axis rule lands on the *block* axis
    (256 divides any mesh axis; nb often does not: 5120 / 256 = 20
    blocks cannot split 16 ways); the scales [..., nb, 1] try the nb
    axis."""
    def leaf(spec):
        if cfg.state_dtype == "int8":
            qspec = tuple(spec[:-1]) + (None, spec[-1])
            sspec = tuple(spec[:-1]) + (spec[-1], None)
            return {"m_q": qspec, "m_s": sspec, "v_q": qspec, "v_s": sspec}
        return {"m": tuple(spec), "v": tuple(spec)}

    return {"count": (),
            "mu": {name: leaf(spec) for name, spec in param_specs.items()}}


def state_shapes(shape, cfg: OptConfig) -> dict:
    """The shape of each of a parameter's state leaves."""
    if cfg.state_dtype == "int8":
        nb = -(-shape[-1] // cfg.quant_block)
        q = tuple(shape[:-1]) + (nb, cfg.quant_block)
        s = tuple(shape[:-1]) + (nb, 1)
        return {"m_q": q, "m_s": s, "v_q": q, "v_s": s}
    return {"m": tuple(shape), "v": tuple(shape)}


# -- update ------------------------------------------------------------------


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (a dict's values or
    an iterable), in f32."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    total = 0
    for x in tensors:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, cfg: OptConfig, *,
                  grad_norm: torch.Tensor | None = None, moments=None):
    """One AdamW step.  params / grads: {name: tensor}, the same names;
    each parameter is overwritten in place, and so are the f32 moments
    of `state` (the state passed in is spent).  Returns (params, the new
    state, metrics {"grad_norm", "lr"} as device tensors).

    A data-parallel trainer passes the shards of a parameter tree:
    `grad_norm`, the norm of the whole gradient (by default that of
    `grads`), and `moments`, an object whose `load(name, mu, p)` gives
    the f32 (m, v) of the parameter shard p from its state leaves and
    whose `store(name, m, v)` gives the new state leaves (by default
    the leaves are p's own: f32 moments, or int8 codes of p's own
    blocks)."""
    count = state["count"] + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    lr = lr_at(cfg, count)
    cf = count.to(torch.float32)
    bc1 = 1 - cfg.b1 ** cf
    bc2 = 1 - cfg.b2 ** cf

    new_mu = {}
    for name, p in params.items():
        mu = state["mu"][name]
        g = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        g.copy_(grads[name])
        g.mul_(scale)
        if moments is not None:
            m, v = moments.load(name, mu, p)
        elif cfg.state_dtype == "int8":
            m = dequantize_blockwise(mu["m_q"], mu["m_s"], p.shape)
            v = dequantize_v_log(mu["v_q"], mu["v_s"], p.shape)
        else:
            m, v = mu["m"], mu["v"]
        # m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        t = g * (1 - cfg.b2)
        v.mul_(cfg.b2).add_(t.mul_(g))
        del g, t
        step = m / bc1                      # mhat
        vhat = v / bc2
        step.div_(vhat.sqrt_().add_(cfg.eps))
        del vhat
        pf = p.to(torch.float32)
        step.add_(cfg.weight_decay * pf).mul_(lr)
        if pf.data_ptr() == p.data_ptr():   # an f32 parameter
            p.sub_(step)
        else:
            p.copy_(pf.sub_(step))
        del step, pf
        if moments is not None:
            new_mu[name] = moments.store(name, m, v)
        elif cfg.state_dtype == "int8":
            new_mu[name] = quantized_moments(m, v, cfg)
        else:
            new_mu[name] = {"m": m, "v": v}
    return params, {"count": count, "mu": new_mu}, {"grad_norm": gn,
                                                     "lr": lr}


def quantized_moments(m: torch.Tensor, v: torch.Tensor,
                      cfg: OptConfig) -> dict:
    """The int8 state leaves of f32 moments m and v."""
    mq, ms = quantize_blockwise(m, cfg.quant_block)
    vq, vs = quantize_v_log(v, cfg.quant_block)
    return {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}
