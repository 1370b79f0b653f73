"""The port's synthetic LM data (`repro_torch.data.tokens`) against the
JAX package's (`repro.data.tokens`): `make_batch` bit for bit for every
configured architecture (text, the vision prefix with its masked labels,
the encoder's frames) at several (seed, step) pairs, int32 tokens and
labels on the requested device; `input_specs`' shapes and dtypes on the
meta device."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import tokens as jtok
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import tokens as tok


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_make_batch_bit_equal_reference(arch):
    jc, tc = jget(arch, smoke=True), get_config(arch, smoke=True)
    for seed, step, b, s in ((0, 0, 2, 32), (7, 3, 3, 40), (1, 1000, 1, 24)):
        want = jtok.make_batch(jc, jtok.DataConfig(seed=seed), step, b, s)
        got = tok.make_batch(tc, tok.DataConfig(seed=seed), step, b, s,
                             device="cpu")
        assert set(got) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].device.type == "cpu"
            assert str(got[k].dtype)[6:] == str(w.dtype), k
            np.testing.assert_array_equal(got[k].numpy(), w)
        assert got["tokens"].dtype == torch.int32 == got["labels"].dtype
        if tc.modality == "vision_patches":
            p = tc.num_prefix_embeds
            assert bool((got["labels"][:, :p] == -1).all())
            assert got["tokens"].shape == (b, s - p)
        assert got["labels"].shape == (b, s)
        if tc.encoder_layers:
            assert got["frames"].shape == (b, s, tc.d_model)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "phi-3-vision-4.2b",
                                  "seamless-m4t-medium"])
def test_input_specs_equal_reference(arch, kind):
    jc, tc = jget(arch, smoke=True), get_config(arch, smoke=True)
    want = jtok.input_specs(jc, 4, 64, kind)
    got = tok.input_specs(tc, 4, 64, kind)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype)[6:] == str(jnp.dtype(w.dtype)), k


def test_zipf_probs_equal_reference():
    np.testing.assert_array_equal(tok._zipf_probs(1000, 1.2),
                                  jtok._zipf_probs(1000, 1.2))
