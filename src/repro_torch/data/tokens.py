"""Deterministic synthetic LM data.

The port of `repro.data.tokens`.  A batch is a pure function of (seed,
step, shape): numpy draws from `np.random.default_rng((seed, step))` in
the reference's order, so every batch is the reference's bit for bit,
and a restart or a backup worker regenerates any step's batch.  Tokens
follow a Zipfian unigram draw with a Markov bigram twist, so the loss
has learnable structure.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return p / p.sum()


def make_batch(cfg: ModelConfig, dcfg: DataConfig, step: int, batch: int,
               seq: int, *, device=None) -> dict:
    """One step's batch on the device: int32 tokens [B, S_text] and
    labels [B, S] (-1 over a vision prefix), f32 `prefix_embeds`
    [B, P, d] for a vision prefix and `frames` [B, S, d] for an
    encoder."""
    rng = np.random.default_rng((dcfg.seed, step))
    probs = _zipf_probs(min(cfg.vocab_size, 50_000), dcfg.zipf_a)
    body = {}
    n_text = seq
    if cfg.modality == "vision_patches":
        n_text = seq - cfg.num_prefix_embeds
        body["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.num_prefix_embeds, cfg.d_model)
        ).astype(np.float32) * 0.02
    if cfg.encoder_layers:
        body["frames"] = rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32) * 0.02
    toks = rng.choice(len(probs), size=(batch, n_text + 1), p=probs)
    # bigram structure: token t+1 correlated with t
    corr = (toks[:, :-1] * 31 + 7) % len(probs)
    mix = rng.random((batch, n_text)) < 0.5
    nxt = np.where(mix, corr, toks[:, 1:])
    labels = nxt.astype(np.int32)
    if cfg.modality == "vision_patches":
        labels = np.concatenate(
            [np.full((batch, cfg.num_prefix_embeds), -1, np.int32), labels],
            axis=1)
    body["tokens"] = toks[:, :-1].astype(np.int32)
    body["labels"] = labels
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for k, x in body.items()}


def input_specs(cfg: ModelConfig, batch: int, seq: int,
                kind: str = "train") -> dict:
    """Stand-ins of a batch's tensors on the meta device (shapes and
    dtypes, no allocation).  kind: train (tokens + labels) | prefill
    (tokens) | decode (one token; the states are built apart)."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {}
    n_text = seq
    if cfg.modality == "vision_patches":
        n_text = seq - cfg.num_prefix_embeds
        out["prefix_embeds"] = meta((batch, cfg.num_prefix_embeds,
                                     cfg.d_model), torch.float32)
    if cfg.encoder_layers:
        out["frames"] = meta((batch, seq, cfg.d_model), torch.float32)
    out["tokens"] = meta((batch, n_text), torch.int32)
    if kind == "train":
        lab_len = seq if cfg.modality == "vision_patches" else n_text
        out["labels"] = meta((batch, lab_len), torch.int32)
    return out
