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

The decode states take the reference's dry-run layout
(`sharding.state_spec`, laid out after the prefill by `lay_out_states`).
Where the heads divide over `model`, a rank holds its heads, as it runs
them.  Where they do not, it holds every head (`sharding.HeadDimSplit`,
under the layer's `dh_split`): on its rows [lo, hi) of the head dim
where that divides over `model` (the mLSTM's C [B, H, dh/M, dh] on the
rows of the key dim, n [B, H, dh/M], m [B, H] whole; the sLSTM's four
[B, H, dh/M]), else whole (a batch of one row).  A decode step then:
  mLSTM: q / k / v of every head (gathered), the gates and q . k whole;
    each rank reads its rows of C and n (`_mlstm_partial`), one
    all-reduce sums the reads, h is formed whole on every rank and each
    rank updates its rows (`mlstm_step_split`; `mlstm_step_slices` is
    the same over slices in one process);
  sLSTM: the four state slices are all-gathered, the step runs whole
    (its recurrent product mixes a whole head), each rank keeps its
    rows: one rank's result bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
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


def _per_head(q, k, v, hl: int, dh: int) -> tuple:
    """q / k / v [B, S, hl * dh] -> [B, hl, S, dh], k in f32 over
    sqrt(dh) (the reference divides by a numpy f64 scalar, which
    promotes bf16)."""
    return (_heads(q, hl), _heads(k, hl).float() / math.sqrt(dh),
            _heads(v, hl))


def _log_gates(p: MLstm, x, h0: int, h1: int, enter: bool) -> tuple:
    """The log input and forget gates li / lf [B, h1 - h0, S] of heads
    h0..h1-1, computed whole (w_if is not split)."""
    hn = p.cfg.num_heads
    gates = x.float() @ p.w_if.float() + torch.cat([p.b_i, p.b_f])
    if enter:
        gates = sh.enter(gates)
    li = gates[..., h0:h1].transpose(1, 2)
    lf = F.logsigmoid(gates[..., hn + h0:hn + h1]).transpose(1, 2)
    return li, lf


def mlstm_step_inputs(p: MLstm, x: torch.Tensor) -> tuple:
    """(q, k, v) [B, H, S, dh] f32 and (li, lf) [B, H, S] of every head,
    as one device computes them (no mesh): `_mlstm_chunk`'s inputs."""
    dt = x.dtype
    hn = p.cfg.num_heads
    q, k, v = _per_head(*(x @ w.to(dt) for w in (p.wq, p.wk, p.wv)), hn,
                        x.shape[-1] // hn)
    return (q.float(), k, v.float()) + _log_gates(p, x, 0, hn, False)


def _mlstm_weights(li, lf, m) -> tuple:
    """`_mlstm_chunk`'s weights at Q = 1 (b_cum = B_tot = lf, u = u_max
    = li - lf), per head, whole on every rank: (m_t [B, H, 1], inter_w
    [B, H, 1], D [B, H, 1, 1] the step's own weight, decay_prev [B, H])."""
    m_new = lf[..., -1] + torch.maximum(m, (li - lf)[..., -1])
    m_t = m_new[..., None]
    inter_w = torch.exp(lf + m[..., None] - m_t)
    D = torch.exp(li - m_t)[..., None]
    return m_t, inter_w, D, torch.exp(lf[..., -1] + m - m_new)


def _mlstm_partial(q, k, state, weights, lo: int, hi: int):
    """One rank's reads of the state in a decode step (Q = 1), from its
    rows [lo, hi) of the key dim of C [B, H, hi - lo, dh] and n [B, H,
    hi - lo] (q / k [B, H, 1, dh] whole) -> [B, H, 1, dh + 1]: q_s C_s
    and q_s . n_t,s (n_t = D k + inter_w n), whose sums over the ranks
    are `_mlstm_chunk`'s q C and q . n_t."""
    C, n, _ = state
    _, inter_w, D, _ = weights
    qs = q[..., lo:hi]
    n_t = torch.einsum("bhqk,bhkd->bhqd", D, k[..., lo:hi]) \
        + n[..., None, :] * inter_w[..., None]
    return torch.cat([torch.einsum("bhqd,bhde->bhqe", qs, C),
                      torch.einsum("bhqd,bhqd->bhq", qs, n_t)[..., None]],
                     -1)


def _mlstm_finish(q, k, v, state, weights, reads, lo: int, hi: int):
    """`_mlstm_chunk` at Q = 1 on rows [lo, hi) of the key dim, from the
    ranks' summed `reads` (`_mlstm_partial`): (h [B, H, 1, dh], whole on
    every rank, and the new (C, n) rows and m [B, H]).  The max in the
    denominator is taken after the sum over the ranks."""
    C, n, _ = state
    m_t, inter_w, D, decay_prev = weights
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * D
    num = torch.einsum("bhqk,bhkd->bhqd", scores, v) \
        + reads[..., :-1] * inter_w[..., None]
    denom = torch.maximum(reads[..., -1].abs(), torch.exp(-m_t))
    h = num / denom[..., None]
    w_tau = D[..., 0]                   # exp(li - m_new) at one step
    ks = k[..., lo:hi]
    C_new = C * decay_prev[..., None, None] + torch.einsum(
        "bhqd,bhqe,bhq->bhde", ks, v, w_tau)
    n_new = n * decay_prev[..., None] + torch.einsum("bhqd,bhq->bhd", ks,
                                                     w_tau)
    return h, (C_new, n_new, m_t[..., 0])


def mlstm_step_split(q, k, v, li, lf, state, lo: int, hi: int, reduce):
    """One decode step of a rank that holds rows [lo, hi) of the key dim
    of every head's (C, n) and m whole: its reads summed over the ranks
    by `reduce(t)` (`sharding.HeadDimSplit.reduce`), then
    `_mlstm_finish`."""
    w = _mlstm_weights(li, lf, state[2])
    reads = reduce(_mlstm_partial(q, k, state, w, lo, hi))
    return _mlstm_finish(q, k, v, state, w, reads, lo, hi)


def mlstm_step_slices(q, k, v, li, lf, states: list, bounds: list):
    """`mlstm_step_split` of every rank in one process: `states[r]` holds
    rows `bounds[r]` = (lo, hi); their reads summed here.  Returns (h,
    the ranks' new states), what the ranks compute together."""
    w = _mlstm_weights(li, lf, states[0][2])
    reads = torch.stack([_mlstm_partial(q, k, st, w, lo, hi)
                         for st, (lo, hi) in zip(states, bounds)]).sum(0)
    outs = [_mlstm_finish(q, k, v, st, w, reads, lo, hi)
            for st, (lo, hi) in zip(states, bounds)]
    return outs[0][0], [st for _, st in outs]


def mlstm_with_state(p: MLstm, x: torch.Tensor, state=None,
                     chunk: int = 256, split: sh.HeadDimSplit | None = None):
    """x: [B, S, d] -> ([B, S, d], state), from `state` or the initial
    one.  Decode is this function at chunk 1 (`mlstm_decode`).  With
    `split` the state holds every head (on rows [lo, hi) of the head
    dim unless `split.whole`), and q / k / v are those of every head."""
    cfg, dt = p.cfg, x.dtype
    b, s, d = x.shape
    hn = cfg.num_heads
    dh = d // hn
    cols = sh.model_slice(MLstm.SPECS["wq"], (d, d), 1)      # q / k / v
    chans = sh.model_slice(MLstm.SPECS["down_proj"], (2 * d, d), 0)
    heads_split, chans_split = sh.is_split(cols, d), sh.is_split(chans, 2 * d)
    # the heads run: those the columns touch, or every head with `split`
    h0, h1 = ((0, hn) if split is not None else
              (cols.start // dh, -(-cols.stop // dh)))
    xe = sh.enter(x) if chans_split else x
    # this rank's channels of the x branch and of the gate
    w_up = _gathered_cols(p.up_proj, MLstm.SPECS["up_proj"], 4 * d,
                          chans_split)
    if chans_split:
        w_up = torch.cat([w_up[:, chans],
                          w_up[:, 2 * d + chans.start:2 * d + chans.stop]], 1)
    x_br, z = (xe @ w_up.to(dt)).chunk(2, dim=-1)
    # q / k / v of the heads run: from this rank's columns, whole heads;
    # all-gathered where a shard cuts a head or every head is run
    xq = xe if heads_split else x
    q, k, v = (xq @ w.to(dt) for w in (p.wq, p.wk, p.wv))
    if heads_split and (split is not None or cols.start % dh
                        or cols.stop % dh):
        q, k, v = (sh.model_gather(t, -1, split_use=True)[
            ..., h0 * dh:h1 * dh] for t in (q, k, v))
    hl = h1 - h0
    q, k, v = _per_head(q, k, v, hl, dh)
    li, lf = _log_gates(p, x, h0, h1, heads_split)
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((b, hl, dh, dh), **f32),
                 torch.zeros((b, hl, dh), **f32),
                 torch.full((b, hl), -1e30, **f32))
    qn = min(chunk, s)
    if s % qn:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {qn}")
    rows = split is not None and not split.whole
    if rows and qn != 1:
        raise ValueError("a state split over its head dim steps one token "
                         "at a time")
    hs = []
    for c0 in range(0, s, qn):
        sl = slice(c0, c0 + qn)
        args = (q[:, :, sl].float(), k[:, :, sl], v[:, :, sl].float(),
                li[..., sl], lf[..., sl], state)
        if rows:
            h, state = mlstm_step_split(*args, split.lo, split.hi,
                                        split.reduce)
        else:
            h, state = _mlstm_chunk(*args)
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(b, s, hl * dh)
    # every feature of h: from each rank's columns; or, heads whole on
    # every rank (or every head run), h entering the split channels
    if heads_split and split is None:
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


def mlstm_decode(p: MLstm, x: torch.Tensor, state,
                 split: sh.HeadDimSplit | None = None):
    """x: [B, 1, d]; the O(1) recurrent update."""
    return mlstm_with_state(p, x, state, chunk=1, split=split)


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


def slstm_with_state(p: SLstm, x: torch.Tensor, state=None,
                     split: sh.HeadDimSplit | None = None):
    """The recurrence over time, x: [B, S, d] -> ([B, S, d], state).
    With `split` (the heads do not divide, so the layer runs every head)
    the state holds rows [lo, hi) of the head dim: the ranks' rows are
    all-gathered, the steps run whole, and this rank's rows are kept."""
    cfg = p.cfg
    b, s, d = x.shape
    hn = cfg.num_heads
    dh = d // hn
    heads = sh.model_slice(SLstm.SPECS["r_gates"], (hn, dh, 4 * dh), 0)
    split_heads = sh.is_split(heads, hn)
    if split is not None and split_heads:
        raise ValueError("an sLSTM whose heads split holds its own heads")
    hl = heads.stop - heads.start
    w, bias = p.w_gates, p.b_gates
    if not split_heads:   # heads whole: any split of 4d gathered
        w = _gathered_cols(w, SLstm.SPECS["w_gates"], 4 * d, False)
        bias = _gathered_cols(bias, SLstm.SPECS["b_gates"], 4 * d, False)
    xin = sh.enter(x) if split_heads else x
    pre_x = (xin.float() @ w.float() + bias.float()).reshape(
        b, s, hl, 4 * dh)
    if state is None:
        zero = torch.zeros((b, hl, dh), dtype=torch.float32, device=x.device)
        state = (zero, zero + 1e-6, zero, zero - 1e30)  # c, n, h, m
    elif split is not None:
        state = split.gather(torch.stack(state)).unbind(0)
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
    if split_heads:   # out_proj is not split: every rank runs it whole
        out = sh.model_gather(out, -1, split_use=False)
    state = (c, n, h, m)
    if split is not None and not split.whole:
        state = tuple(t[..., split.lo:split.hi].clone() for t in state)
    return out @ p.out_proj.to(x.dtype), state


def slstm_decode(p: SLstm, x: torch.Tensor, state,
                 split: sh.HeadDimSplit | None = None):
    return slstm_with_state(p, x, state, split)


def slstm_step_slices(p: SLstm, x: torch.Tensor, states: list,
                      bounds: list):
    """`slstm_decode` of ranks that each hold rows `bounds[r]` of the
    head dim (`states[r]`), in one process: their rows concatenated, the
    step run whole, each rank's rows kept.  Returns (out, the ranks' new
    states)."""
    whole = tuple(torch.cat(parts, -1) for parts in zip(*states))
    out, st = slstm_with_state(p, x, whole)
    return out, [tuple(t[..., lo:hi] for t in st) for lo, hi in bounds]


# ---------------------------------------------------------------------------
# the decode states' layout
# ---------------------------------------------------------------------------


def lay_out_states(kind: str, cfg: ModelConfig, st: dict, rows: int) -> dict:
    """An mLSTM / sLSTM layer's decode states from the prefill, laid out
    by `sharding.state_spec` on their global shapes (`rows` rows):
    unchanged where that puts the heads over `model` (a rank ran and
    holds its heads) or nothing splits `model`; else every head, on this
    rank's rows [lo, hi) of the head dim or whole
    (`sharding.head_dim_split`), the split under `dh_split`.  The mLSTM's
    heads, run by the ranks whose q / k / v columns touch them, reach
    each rank's rows in one all-to-all (`to_head_dim`); the sLSTM ran
    every head on every rank and keeps its rows.  New tensors are in
    storage of their own."""
    d, hn = cfg.d_model, cfg.num_heads
    dh = d // hn
    first = st["C" if kind == "mlstm" else "c"]
    split = sh.head_dim_split(kind, (rows, hn, dh) + tuple(first.shape[3:]))
    if split is None:
        return st
    cols = sh.model_slice(MLstm.SPECS["wq"], (d, d), 1)
    if kind == "mlstm" and sh.is_split(cols, d):
        m, w = sh.model_size(), d // sh.model_size()
        ran = [(r * w // dh, -(-(r + 1) * w // dh)) for r in range(m)]
        ws = split.hi - split.lo
        bounds = [(r * ws, (r + 1) * ws) if split.axes else (0, dh)
                  for r in range(m)]
        out = to_head_dim(st, ran, bounds, sh.model_rank(), _all_to_all)
    else:
        out = {f: t[:, :, split.lo:split.hi].clone()
               if t.dim() > 2 and not split.whole else t
               for f, t in st.items()}
    out["dh_split"] = split
    return out


def _all_to_all(buf, out_splits: list, in_splits: list):
    out = buf.new_empty(sum(out_splits))
    dist.all_to_all_single(out, buf, out_splits, in_splits,
                           group=sh.model_group())
    return out


def to_head_dim(st: dict, ran: list, bounds: list, me: int,
                exchange) -> dict:
    """A layer's states from the heads each rank ran to every head on
    each rank's rows of the head dim.  `st`'s fields [b, h1 - h0, ...]
    hold the heads [h0, h1) = `ran[me]`; rank r ran `ran[r]` and takes
    rows `bounds[r]` = (lo, hi) of dim 2 of every field that has one
    (whole [b, H] fields it takes whole).  Each head is sent by the
    first rank that ran it, every field of it in one buffer:
    `exchange(buf, out_splits, in_splits)` is an all-to-all over the
    ranks (split sizes in elements, by rank).  Rank order is head order,
    since the ranks' heads rise with the rank.  The transient is this
    rank's heads' whole state (what it sends) plus its rows."""
    hn = ran[-1][1]
    owner = [next(r for r, (a, z) in enumerate(ran) if a <= j < z)
             for j in range(hn)]
    h0 = ran[me][0]
    mine = [j for j in range(hn) if owner[j] == me]

    def shape(t, lo, hi):
        return (t.shape[0],) + ((hi - lo,) + tuple(t.shape[3:])
                                if t.dim() > 2 else ())

    def piece(t, j, lo, hi):
        x = t[:, j - h0]
        return x[:, lo:hi] if x.dim() > 1 else x

    send = [piece(t, j, lo, hi).reshape(-1) for lo, hi in bounds
            for j in mine for t in st.values()]
    first = next(iter(st.values()))
    buf = torch.cat(send) if send else first.new_empty(0)
    per = [sum(math.prod(shape(t, lo, hi)) for t in st.values())
           for lo, hi in bounds]
    in_splits = [len(mine) * n for n in per]
    out_splits = [owner.count(r) * per[me] for r in range(len(ran))]
    got = exchange(buf, out_splits, in_splits).view(hn, per[me])
    out, off = {}, 0
    for f, t in st.items():
        sz = shape(t, *bounds[me])
        n = math.prod(sz)
        out[f] = got[:, off:off + n].reshape((hn,) + sz).movedim(
            0, 1).contiguous()
        off += n
    return out
