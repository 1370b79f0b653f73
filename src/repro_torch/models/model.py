"""Model assembly: embeddings, the layer stack, heads, modality stubs.

The port of `repro.models.model` for every configured architecture.  A
layer's mixer is `cfg.layer_kind(i)`: grouped-query attention (gemma2's
local / global alternation and softcaps, qkv biases, the encoder-
decoder's cross-attention, the vision prefix), mamba
(`models/ssm.py`), or the xLSTM's mLSTM / sLSTM (`models/xlstm.py`).
Its feed-forward is an MoE layer where `cfg.layer_is_moe(i)`
(`models/moe.py`), else a dense MLP where `d_ff > 0`, else none (the
xLSTM blocks, which then have no norm2 either).

The layers run as a Python loop over `num_layers` blocks: layer i is the
reference's period `i // scan_period`, sub-layer `i % scan_period`.  A
training forward that records a graph runs each period (and each
encoder layer) under `unroll.maybe_checkpoint`, as the reference does:
the backward recomputes one period at a time.  Parameters are created
with `requires_grad=False`; a trainer turns them on
(`model.requires_grad_(True)`).

Entry points, as the reference's:
  forward(model, batch)          -> hidden [B, S, d]
  forward_with_aux(model, batch) -> (hidden, aux [2]): the reference's
                                    `forward(...)[:2]`, aux = (MoE
                                    load-balance loss, router z-loss)
                                    summed over the layers
  logits_from_hidden(model, h)   -> f32 logits, final softcap applied
  prefill(model, batch, max_len, rows) -> (last logits [B, V], decode
                                    states)
  decode_step(model, token, states, pos) -> (logits [B, V], states)

Over the model axis (`sharding.model_slice`; the rules carry `heads`,
`kv_heads`, `d_ff`, `vocab`, `experts` and `d_inner` on it) each rank
holds and computes its share of every split leaf: the embedding is a
vocab-parallel lookup (this rank's rows, zeros for the others' tokens,
summed over the ranks: exact), `logits_from_hidden` gives this rank's
vocab columns (the tied embedding's shard is the embedding's),
`prefill` / `decode_step` gather them into the whole [B, V] logits,
and the decode states take the reference's dry-run layout (below).
`prefix_proj` is not split over model.

Decode states are one dict per layer.  Attention: `k` / `v` [B, max_len,
Hkv, dh] self-attention caches, and for the encoder-decoder `xk` / `xv`,
the projected encoder states; `decode_step` writes each step's K / V
into the caches in place.  Over a mesh a cache is laid out as the
reference's dry run lays it out (`sharding.cache_spec`): this rank's kv
heads, or where they do not divide (or the batch is one row) every kv
head on this rank's slice of the length, with its
`sharding.LengthSplit` under `kv_split` / `xkv_split`.  Mamba: `h` [B,
di, N] f32 and `conv` [B, d_conv - 1, di].  mLSTM: `C`, `n`, `m`;
sLSTM: `c`, `n`, `h`, `m` (the reference's tuples, by name); over a
mesh laid out as the reference's dry run lays them out
(`sharding.state_spec`): this rank's heads, or where they do not divide
every head on this rank's rows of the head dim (or whole, at one row),
with its `sharding.HeadDimSplit` under `dh_split`.  Recurrent states are
fixed-size and are replaced at each step; `pos` is no input to them.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding as sh
from repro_torch.models import ssm, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Attention, Mlp, RmsNorm
from repro_torch.models.unroll import maybe_checkpoint

# each recurrent mixer: its module, its full-sequence and its one-token
# function, and the names of its state tuple's fields, in order
_RECURRENT = {
    "mamba": (ssm.Mamba, ssm.mamba_with_state, ssm.mamba_decode,
              ("h", "conv")),
    "mlstm": (xlstm.MLstm, xlstm.mlstm_with_state, xlstm.mlstm_decode,
              ("C", "n", "m")),
    "slstm": (xlstm.SLstm, xlstm.slstm_with_state, xlstm.slstm_decode,
              ("c", "n", "h", "m")),
}
STATE_FIELDS = {kind: r[3] for kind, r in _RECURRENT.items()}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg, num_layers=cfg.encoder_layers, encoder_layers=0,
        scan_period=1, moe_num_experts=0, attn_every=1, xlstm=False,
    )


def _cache(k, v, split, prefix: str = "") -> dict:
    """A layer's cache entries: k / v (xk / xv with prefix "x"), and
    their `sharding.LengthSplit` where the length is split."""
    out = {prefix + "k": k, prefix + "v": v}
    if split is not None:
        out[prefix + "kv_split"] = split
    return out


class Block(nn.Module):
    """Layer i: norm1 + its mixer (self-attention, with `cross` a
    norm_x + cross-attention over the encoder states; or mamba, mLSTM,
    sLSTM), then norm2 + MoE or MLP, or no feed-forward (d_ff = 0)."""

    def __init__(self, cfg: ModelConfig, i: int, cross: bool, *, device,
                 dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.kind = cfg.layer_kind(i)
        self.local = cfg.layer_is_local_attn(i)
        self.norm1 = RmsNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.cross = None
        if self.kind == "attn":
            self.attn = Attention(cfg, **kw)
            if cross:
                self.cross = Attention(cfg, cross=True, **kw)
                self.norm_x = RmsNorm(cfg.d_model, cfg.norm_eps, **kw)
        else:
            setattr(self, self.kind, _RECURRENT[self.kind][0](cfg, **kw))
        self.moe = self.mlp = self.norm2 = None
        if cfg.layer_is_moe(i):
            self.moe = moe_mod.Moe(cfg, **kw)
        elif cfg.d_ff > 0:
            self.mlp = Mlp(cfg, **kw)
        if self.moe is not None or self.mlp is not None:
            self.norm2 = RmsNorm(cfg.d_model, cfg.norm_eps, **kw)

    def _attend(self, h, positions, mode, state, pos):
        if mode == "train":
            return self.attn(h, positions, local=self.local), {}
        if mode == "prefill":
            mix, (ck, cv) = self.attn.prefill(h, positions, local=self.local)
            return mix, {"k": ck, "v": cv}
        split = state.get("kv_split")
        mix, ck, cv = self.attn.decode(h, state["k"], state["v"], pos,
                                       local=self.local, split=split)
        return mix, _cache(ck, cv, split)

    def _recur(self, h, mode, state):
        _, with_state, decode, fields = _RECURRENT[self.kind]
        mixer = getattr(self, self.kind)
        split = None
        if mode == "decode":
            # an xLSTM state laid out over its head dim, or every head
            # whole (`xlstm.lay_out_states`)
            split = state.get("dh_split")
            kw = {} if split is None else {"split": split}
            mix, st = decode(mixer, h, tuple(state[f] for f in fields), **kw)
        else:
            mix, st = with_state(mixer, h)
        if mode == "prefill":
            # in storage of their own: the scan's last state and the
            # conv's last rows are views of the prefill's whole buffers,
            # which they would keep alive through the decode
            st = tuple(t.clone() for t in st)
        out = {} if mode == "train" else dict(zip(fields, st))
        if split is not None:
            out["dh_split"] = split
        return mix, out

    def forward(self, x, positions, enc_out=None, mode: str = "train",
                state=None, pos: int | None = None):
        """mode train | prefill | decode; returns (x, new state, aux [2]
        or None: this layer's MoE (load-balance, z) losses)."""
        h = self.norm1(x)
        if self.kind == "attn":
            mix, st = self._attend(h, positions, mode, state, pos)
        else:
            mix, st = self._recur(h, mode, state)
        x = x + mix
        if self.cross is not None:
            hx = self.norm_x(x)
            if mode == "decode":
                split = state.get("xkv_split")
                cx, _, _ = self.cross.decode(hx, state["xk"], state["xv"],
                                             pos, cross=True, split=split)
                st.update(_cache(state["xk"], state["xv"], split, "x"))
            else:
                kx, vx = self.cross.project_kv(enc_out)
                cx = self.cross(hx, positions, causal=False,
                                kv_override=(kx, vx))
                if mode == "prefill":
                    st.update(xk=kx, xv=vx)
            x = x + cx
        aux = None
        if self.moe is not None:
            y, maux = moe_mod.moe(self.moe, self.norm2(x))
            aux = torch.stack([maux.load_balance_loss, maux.router_z_loss])
            x = x + y
        elif self.mlp is not None:
            x = x + self.mlp(self.norm2(x))
        return x, st, aux


class Model(nn.Module):
    """The parameters of one config, allocated empty on `device` in
    `cfg.dtype`; `init_model` draws them, `convert.model_from` copies
    them from the reference's tree."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        cfg.period_kinds()  # the layer pattern must tile num_layers
        self.cfg = cfg
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=_dtype(cfg))
        d = cfg.d_model
        self.embed = nn.Parameter(torch.empty((cfg.vocab_size, d), **kw),
                                  requires_grad=False)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty((d, cfg.vocab_size), **kw), requires_grad=False)
        self.prefix_proj = nn.Parameter(
            torch.empty((d, d), **kw), requires_grad=False
        ) if cfg.num_prefix_embeds or cfg.encoder_layers else None
        cross = cfg.encoder_layers > 0
        self.blocks = nn.ModuleList(
            Block(cfg, i, cross, **kw) for i in range(cfg.num_layers))
        self.final_norm = RmsNorm(d, cfg.norm_eps, **kw)
        if cfg.encoder_layers:
            enc_cfg = _encoder_cfg(cfg)
            self.encoder = nn.ModuleList(
                Block(enc_cfg, i, False, **kw)
                for i in range(enc_cfg.num_layers))
            self.enc_norm = RmsNorm(d, cfg.norm_eps, **kw)
        else:
            self.encoder = None

    @property
    def device(self) -> torch.device:
        return self.embed.device


# the top-level parameters' logical axes (the reference's init_model)
_TOP_SPECS = {"embed": ("vocab", "fsdp"), "lm_head": ("fsdp", "vocab"),
              "prefix_proj": ("fsdp", "d_model")}


def param_specs(model: Model | ModelConfig) -> dict:
    """{parameter name: its logical axes}, in `named_parameters()`
    order: the axes the reference's `init_model` gives each leaf, read
    from each module's `SPECS`.  The reference's leading `layers` axis
    (its blocks stack on it; no rule maps it) is left out, because the
    port's blocks are a ModuleList.  Given a config, the model is built
    on the meta device: no memory, at any width."""
    if isinstance(model, ModelConfig):
        model = Model(model, device="meta")
    out = {}
    for mname, mod in model.named_modules():
        specs = getattr(type(mod), "SPECS", _TOP_SPECS)
        for pname, _ in mod.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = specs[pname]
    return {name: out[name] for name, _ in model.named_parameters()}


def init_model(cfg: ModelConfig, seed: int = 0, *, device=None) -> Model:
    """A model with random weights drawn from a `torch.Generator` seeded
    with `seed`, on the device, scaled as the reference's init scales
    them (drawn in f32, then cast to `cfg.dtype`).  The draws are not
    the reference's: carry its weights with `convert.model_from`."""
    model = Model(cfg, device=device)
    g = torch.Generator(device=model.device).manual_seed(seed)
    model.embed.copy_(torch.randn(model.embed.shape, generator=g,
                                  device=model.device) * 0.02)
    for p in (model.lm_head, model.prefix_proj):
        if p is not None:
            p.copy_(torch.randn(p.shape, generator=g, device=model.device)
                    / math.sqrt(p.shape[0]))
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return model


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def vocab_slice(model: Model) -> slice:
    """This model rank's vocab ids: its rows of the embedding, its
    columns of the logits (the untied head splits as the embedding
    does: both have the vocab dim whole or split by the same rule)."""
    cfg = model.cfg
    return sh.model_slice(_TOP_SPECS["embed"], (cfg.vocab_size, cfg.d_model),
                          0)


def local_ids(ids: torch.Tensor, vs: slice):
    """(ids - vs.start clamped into this rank's rows, whether each id is
    this rank's)."""
    loc = ids.long() - vs.start
    width = vs.stop - vs.start
    return loc.clamp(0, width - 1), (loc >= 0) & (loc < width)


def _lookup(model: Model, tokens: torch.Tensor) -> torch.Tensor:
    """The f32 embedding rows of the tokens: over a split vocab each
    rank's rows for its own ids, zeros elsewhere, summed over the ranks
    (x + 0 + ... is x: exact)."""
    vs = vocab_slice(model)
    if not sh.is_split(vs, model.cfg.vocab_size):
        return model.embed[tokens].float()
    loc, mine = local_ids(tokens, vs)
    rows = torch.where(mine[..., None], model.embed[loc].float(), 0.0)
    return sh.leave(rows)


def _embed_inputs(model: Model, batch) -> torch.Tensor:
    cfg, dt = model.cfg, _dtype(model.cfg)
    parts = []
    if "prefix_embeds" in batch:
        pe = batch["prefix_embeds"].to(dt)
        parts.append(pe @ model.prefix_proj)
    if "tokens" in batch:
        # the reference scales by a numpy f64 scalar, which promotes the
        # bf16 rows to f32: the decoder's residual stream (and so every
        # product after it) runs in f32 whatever cfg.dtype says
        parts.append(_lookup(model, batch["tokens"]) * math.sqrt(cfg.d_model))
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.float() for p in parts], dim=1)


def _remat(f, mode: str):
    """`f` under `unroll.maybe_checkpoint` where a training forward
    records a graph, as the reference wraps each period (and encoder
    layer) in `maybe_checkpoint`; prefill and decode run `f` as is."""
    if mode == "train" and torch.is_grad_enabled():
        return maybe_checkpoint(f)
    return f


def _encoder_layer(blk: Block, x, positions):
    x = x + blk.attn(blk.norm1(x), positions, causal=False)
    return x + blk.mlp(blk.norm2(x))


def _encode(model: Model, frames: torch.Tensor,
            mode: str = "train") -> torch.Tensor:
    """Bidirectional encoder over frontend-provided frame embeddings."""
    dt = _dtype(model.cfg)
    x = frames.to(dt) @ model.prefix_proj
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    layer = _remat(_encoder_layer, mode)
    for blk in model.encoder:
        x = layer(blk, x, positions)
    return model.enc_norm(x)


def _period(blocks, x, positions, enc_out, mode: str):
    """One period of `cfg.scan_period` blocks: (x, the period's aux
    [2], each block's state), the aux summed from zeros as the
    reference's `_period_forward` sums it."""
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    states = []
    for blk in blocks:
        x, st, a = blk(x, positions, enc_out=enc_out, mode=mode)
        states.append(st)
        if a is not None:
            aux = aux + a
    return x, aux, states


def _train_period(blocks, x, positions, enc_out):
    x, aux, _ = _period(blocks, x, positions, enc_out, "train")
    return x, aux


def _run(model: Model, batch, mode: str):
    enc_out = (_encode(model, batch["frames"], mode)
               if model.cfg.encoder_layers else None)
    x = _embed_inputs(model, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None].expand(x.shape[:2])
    states = []
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    period = model.cfg.scan_period
    train = _remat(_train_period, mode)
    for p0 in range(0, len(model.blocks), period):
        blocks = model.blocks[p0:p0 + period]
        if mode == "train":
            x, a = train(blocks, x, positions, enc_out)
        else:
            x, a, st = _period(blocks, x, positions, enc_out, mode)
            states.extend(st)
        aux = aux + a
    return model.final_norm(x), states, aux


def forward_with_aux(model: Model, batch):
    """Full-sequence forward.

    batch keys: tokens [B, S_text] and/or prefix_embeds [B, P, d];
    frames [B, S_src, d] for enc-dec.  Returns (hidden [B, S, d], aux
    [2] f32: the MoE layers' load-balance and router z-losses, summed;
    zeros without MoE).
    """
    hidden, _, aux = _run(model, batch, "train")
    return hidden, aux


def forward(model: Model, batch) -> torch.Tensor:
    """`forward_with_aux`'s hidden states [B, S, d]."""
    return forward_with_aux(model, batch)[0]


def logits_from_hidden(model: Model, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits of this model rank's vocab columns (`vocab_slice`; all
    of them without a split), the final softcap applied."""
    if sh.is_split(vocab_slice(model), model.cfg.vocab_size):
        hidden = sh.enter(hidden)
    dt = hidden.dtype
    if model.lm_head is None:
        logits = hidden @ model.embed.to(dt).T
    else:
        logits = hidden @ model.lm_head.to(dt)
    logits = logits.float()
    c = model.cfg.final_logit_softcap
    if c > 0:
        logits = c * torch.tanh(logits / c)
    return logits


def prefill(model: Model, batch, max_len: int, rows: int | None = None):
    """Returns (last_logits [B, V], decode states).  Self-attention
    caches are padded to max_len so decode_step extends them in place;
    cross caches keep the encoder length, recurrent states their size.

    `rows` is the number of rows of the global batch that this rank's
    `batch` was cut from (`sharding.batch_rows`); it may be left out
    where nothing splits the batch.  Each cache is laid out by
    `sharding.cache_spec` on its global shape [rows, length, Hkv, dh]:
    where that splits the length, the cache keeps every kv head (those
    of the other model ranks gathered) on this rank's rows [lo, hi) of
    the length, and its `LengthSplit` goes with it (`kv_split` /
    `xkv_split`).  An mLSTM / sLSTM layer's states are laid out by
    `sharding.state_spec` on their global shapes [rows, H, ...]
    (`xlstm.lay_out_states`): this rank's heads, or every head on this
    rank's rows of the head dim or whole, with its
    `sharding.HeadDimSplit` under `dh_split`."""
    if rows is None:
        if sh.batch_group()[1] > 1:
            raise ValueError("prefill over data-parallel ranks needs the "
                             "global batch's rows")
        rows = next(iter(batch.values())).shape[0]
    hidden, states, _ = _run(model, batch, "prefill")
    for blk, st in zip(model.blocks, states):
        if blk.kind in ("mlstm", "slstm"):
            st.update(xlstm.lay_out_states(blk.kind, model.cfg, st, rows))
        if "k" in st:
            st.update(_lay_out(model.cfg, st["k"], st["v"], rows, max_len))
        if "xk" in st:
            st.update(_lay_out(model.cfg, st["xk"], st["xv"], rows,
                               st["xk"].shape[1], "x"))
    return _whole_logits(model, hidden[:, -1:, :])[:, 0], states


def _lay_out(cfg: ModelConfig, k, v, rows: int, length: int,
             prefix: str = "") -> dict:
    """A cache pair from the prefill's K / V [b, s, heads, dh] (s <=
    length), laid out at `length` positions: zero-padded to it where the
    length is whole; where `sharding.length_split` splits it, every kv
    head on this rank's rows [lo, hi), in storage of its own."""
    split = sh.length_split((rows, length, cfg.num_kv_heads, cfg.head_dim))
    out = []
    for c in (k, v):
        if split is None:
            if c.shape[1] < length:
                pad = c.new_zeros((c.shape[0], length - c.shape[1])
                                  + c.shape[2:])
                c = torch.cat([c, pad], dim=1)
            out.append(c)
            continue
        if c.shape[2] < cfg.num_kv_heads:
            c = sh.model_gather(c, 2, split_use=False)
        part = c.new_zeros((c.shape[0], split.hi - split.lo) + c.shape[2:])
        n = max(0, min(split.hi, c.shape[1]) - split.lo)
        part[:, :n] = c[:, split.lo:split.lo + n]
        out.append(part)
    return _cache(*out, split, prefix)


def _whole_logits(model: Model, hidden: torch.Tensor) -> torch.Tensor:
    """Every vocab column's logits: the model ranks' columns gathered,
    so the argmax (ties to the lowest id) is one rank's."""
    logits = logits_from_hidden(model, hidden)
    if sh.is_split(vocab_slice(model), model.cfg.vocab_size):
        logits = sh.model_gather(logits, -1, split_use=True)
    return logits


def decode_step(model: Model, token: torch.Tensor, states, pos: int):
    """token: [B] int on the model's device; pos: the host int position.
    Returns (logits [B, V], states), the attention caches written in
    place, the recurrent states new."""
    x = _embed_inputs(model, {"tokens": token[:, None]})
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    new_states = []
    for blk, st in zip(model.blocks, states):
        x, nst, _ = blk(x, positions, mode="decode", state=st, pos=pos)
        new_states.append(nst)
    x = model.final_norm(x)
    return _whole_logits(model, x)[:, 0], new_states
