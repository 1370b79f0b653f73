"""The port's LM serving driver (`repro_torch.launch.serve`) against the
JAX package's `repro.launch.serve`, on the reduced (SMOKE) configs of
every configured architecture."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import serve
from repro_torch.models import model as M


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_greedy_generate_equals_reference(arch):
    """Greedy tokens of prefill + 7 decode steps equal JAX's, in f32 on
    the reference's weights and the driver's own batch."""
    jc = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
    tc = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params, _ = JM.init_model(jc, 0)
    model = convert.model_from(params, tc, device="cpu")
    batch = serve.make_batch(tc, 2, 16, 0, "cpu")
    want = jserve.generate(params, jc,
                           {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                           steps=8, max_len=32)
    got = serve.generate(model, batch, steps=8, max_len=32)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_driver(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[done]" in out and "on cpu" in out


def test_serve_driver_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma2-2b", "--smoke", "--gen", "2"])


def test_serve_driver_refuses_a_mesh():
    """A model axis of 2 needs a process group of 2 ranks (torchrun),
    which one process is not."""
    with pytest.raises(RuntimeError, match="torchrun"):
        serve.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                    "--mesh-model", "2"])


def test_make_batch_draws_the_reference_batch():
    """The driver's batch is the reference driver's: the same numpy draws
    in the same order (frames, prefix embeds, tokens)."""
    for arch in ("seamless-m4t-medium", "phi-3-vision-4.2b"):
        cfg = get_config(arch, smoke=True)
        b = serve.make_batch(cfg, 3, 10, 5, "cpu")
        rng = np.random.default_rng(5)
        if cfg.encoder_layers:
            want = jnp.asarray(rng.standard_normal((3, 10, cfg.d_model)),
                               jnp.float32) * 0.02
            np.testing.assert_array_equal(b["frames"].numpy(),
                                          np.asarray(want))
        if cfg.modality == "vision_patches":
            want = jnp.asarray(rng.standard_normal(
                (3, cfg.num_prefix_embeds, cfg.d_model)), jnp.float32) * 0.02
            np.testing.assert_array_equal(b["prefix_embeds"].numpy(),
                                          np.asarray(want))
        np.testing.assert_array_equal(
            b["tokens"].numpy(), rng.integers(0, cfg.vocab_size, (3, 10)))


def test_sampled_generate_is_seeded_and_in_vocab():
    cfg = get_config("gemma2-2b", smoke=True)
    model = M.init_model(cfg, 0, device="cpu")
    batch = serve.make_batch(cfg, 2, 8, 0, "cpu")
    a = serve.generate(model, batch, steps=6, max_len=16, greedy=False,
                       seed=1)
    b = serve.generate(model, batch, steps=6, max_len=16, greedy=False,
                       seed=1)
    assert torch.equal(a, b)
    assert bool(((a >= 0) & (a < cfg.vocab_size)).all())
    greedy = serve.generate(model, batch, steps=6, max_len=16)
    assert torch.equal(a[:, 0], greedy[:, 0])  # the prefill's argmax

