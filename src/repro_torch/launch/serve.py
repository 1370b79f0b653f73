"""End-to-end LM serving driver: batched prefill, then greedy (or sampled)
decode, on one device or data-parallel over processes.

The port of `repro.launch.serve`, for every configured architecture
(`--arch`, one of `configs.ARCH_NAMES`: attention, mamba + attention +
MoE, mLSTM / sLSTM, MoE).  Prefill, decode and `generate` run under
`torch.no_grad()`.  The decode loop keeps the tokens on the
device and makes no host sync per step: each step's position is a host
int, the next token an argmax on the device, and the tokens come back
once, after the last step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
        --smoke --device cpu --batch 4 --prompt-len 64 --gen 32

`--mesh-data D` serves data-parallel over D processes and `--mesh-model
M` splits the model over M processes a data row (under torchrun, D x M
processes: gloo with `--device cpu`, NCCL on cards): every rank builds
the same weights and request batch, keeps its model shard of each
weight (`train_step.Zero3` with `fsdp` off: the weights are whole over
the data ranks), generates its data row's rows (`sharding.batch_rows`;
the batch must divide over D, or be one row, which every rank serves
whole), and the tokens are all-gathered, so every rank returns the
whole batch; rank 0 prints.  The logits of a split vocab are gathered
before the argmax, so greedy tokens (ties to the lowest id) equal one
rank's.  The decode states take the reference's layout.  The KV caches
(`sharding.cache_spec`): where the kv heads do not divide over M, or
the batch is one row, each rank holds a slice of the length, and the
decode step combines the ranks' partial softmaxes.  The xLSTM's states
(`sharding.state_spec`): where the heads do not divide over M, each
rank holds every head on its rows of the head dim (the mLSTM's reads of
them summed over the ranks, the sLSTM's gathered for each step), or at
one row every head whole.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as M
from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import Tracer
from repro_torch.train.train_step import Zero3

# serving keeps the weights whole over the data ranks (no ZeRO-3), split
# only over the model axis
SERVE_RULES = {"fsdp": None}


def make_prefill_step(cfg: ModelConfig, max_len: int):
    @torch.no_grad()
    def prefill(model: M.Model, batch, rows: int | None = None):
        return M.prefill(model, batch, max_len, rows)

    return prefill


def make_decode_step(cfg: ModelConfig, greedy: bool = True):
    @torch.no_grad()
    def decode(model: M.Model, states, token, pos: int,
               generator: torch.Generator | None = None):
        logits, states = M.decode_step(model, token, states, pos)
        if greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:  # Gumbel-max: argmax(logits + Gumbel) samples softmax(logits)
            e = torch.empty_like(logits).exponential_(generator=generator)
            nxt = torch.argmax(logits - torch.log(e), dim=-1)
        return nxt.to(torch.int32), logits, states

    return decode


@torch.no_grad()
def generate(model: M.Model, batch, steps: int, max_len: int,
             greedy: bool = True, seed: int = 0,
             rows: int | None = None) -> torch.Tensor:
    """Prefill, then `steps - 1` decode steps.  Returns the [B, steps]
    int32 tokens on the model's device (not synchronised).  The steps
    run under `torch.no_grad()`: a model being trained records no graph
    here.  Over data-parallel ranks `batch` is this rank's rows of a
    global batch of `rows` rows (`models.model.prefill`: the decode
    caches' layout reads it)."""
    cfg = model.cfg
    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg, greedy)
    logits, states = prefill(model, batch, rows)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    pos0 = sum(batch[k].shape[1] for k in ("tokens", "prefix_embeds")
               if k in batch)
    gen = None if greedy else torch.Generator(
        device=model.device).manual_seed(seed)
    out = [tok]
    for t in range(steps - 1):
        tok, _, states = decode(model, states, tok, pos0 + t, gen)
        out.append(tok)
    return torch.stack(out, dim=1)


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
               device) -> dict:
    """The driver's random request batch, drawn from numpy in the
    reference's order: encoder frames, vision prefix embeds, tokens."""
    rng = np.random.default_rng(seed)
    out = {}

    def normal(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(device) * 0.02

    if cfg.encoder_layers:
        out["frames"] = normal((batch, prompt_len, cfg.d_model))
    if cfg.modality == "vision_patches":
        out["prefix_embeds"] = normal((batch, cfg.num_prefix_embeds,
                                       cfg.d_model))
    out["tokens"] = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(device)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="one of " + ", ".join(ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, model: M.Model | None = None,
        log=print) -> np.ndarray:
    """Serve one request batch per `args`; `model` replaces the one
    drawn from `--seed` (its config is then the model's; it is whole
    again on return).  Returns the [batch, gen] tokens, the whole batch
    on every rank."""
    mesh, dev, log = mesh_mod.cli_mesh(args, log)
    if model is None:
        model = M.init_model(get_config(args.arch, smoke=args.smoke),
                             args.seed, device=dev)
    cfg = model.cfg
    batch = make_batch(cfg, args.batch, args.prompt_len, args.seed, dev)
    max_len = args.prompt_len + args.gen + 8
    tracer = Tracer()
    # without a mesh (one device) nothing is split and the rows are the
    # whole batch
    zero = Zero3(model, mesh, SERVE_RULES)
    zero.gather()
    try:
        with tracer.span("lm/generate", cat="lm", batch=args.batch,
                         gen=args.gen) as sp, sh.use_mesh(mesh, SERVE_RULES):
            rows = {k: sh.batch_rows(v) for k, v in batch.items()}
            toks = generate(model, rows, steps=args.gen, max_len=max_len,
                            seed=args.seed, rows=args.batch)
            toks = sh.batch_gather(toks, args.batch).cpu().numpy()
    finally:
        zero.gather(whole=True)
    dt = sp.duration_s
    log(f"[serve] generated {toks.shape} tokens in {dt:.1f}s "
        f"({toks.size / dt:.1f} tok/s) on {dev}"
        + (f", {args.mesh_data} data x {args.mesh_model} model ranks"
           if mesh else ""))
    log(f"first sequences: {toks[:2, :16].tolist()}")
    if not (np.all(toks >= 0) and np.all(toks < cfg.vocab_size)):
        raise RuntimeError("generated a token outside the vocabulary")
    log("[done]")
    return toks


def main(argv=None):
    args = parse_args(argv)
    with mesh_mod.torchrun_group(args.device):
        run(args)


if __name__ == "__main__":
    main()
