"""Shared by the training parity tests (not collected): the reference's
loss and gradients on a SMOKE config against the port's, on JAX's
weights (`convert.model_from`) and the same token batch.

Tolerances: f32 configs (`dtype="float32"`) within 5e-5 of each leaf's
largest gradient magnitude and the loss within 1e-6 relative; the bf16
configs within 2e-2.  seamless-m4t's bf16 leaves are the exception: its
encoder is the one stack that computes in bf16 (ROADMAP 3), and there
JAX's own bf16 gradients lie up to 4.7e-2 of a leaf's largest magnitude
from its f32 gradients on the same weights, so the port is held within
1.5x that distance, which the test measures on the reference itself.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import tokens as jtok
from repro.models import model as JM
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import tokens as tok
from repro_torch.train import train_step as ts

@pytest.fixture
def one_torch_thread():
    """torch on one thread for the test: these models' ops are small,
    and under the suite's parallel workers torch's own thread pool
    oversubscribes the cores (the training example took 197 s so,
    7 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 5e-5, "bfloat16": 2e-2}
LOSS_TOL = {"float32": 1e-6, "bfloat16": 2e-3}
B, S, CHUNK = 2, 32, 16


def configs(arch: str, dtype: str):
    return (dataclasses.replace(jget(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


def jax_value_and_grad(jc, params, batch, chunk=CHUNK):
    fn = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jc, jts.TrainHParams(loss_chunk=chunk)),
        has_aux=True))
    (_, metrics), grads = fn(params, batch)
    return {k: float(v) for k, v in metrics.items()}, grads


def leaf_errors(want: dict, got: dict) -> dict:
    """{name: max |want - got| / max |want|}."""
    out = {}
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[name].detach().float().numpy()
        out[name] = float(np.abs(w - g).max() / max(np.abs(w).max(), 1e-30))
    return out


def compare(arch: str, dtype: str):
    """(reference metrics, port metrics, {leaf: relative error}, the
    bound for this arch and dtype)."""
    jc, tc = configs(arch, dtype)
    params, _ = JM.init_model(jc, 0)
    jb = jtok.make_batch(jc, jtok.DataConfig(), 0, B, S)
    jm, jg = jax_value_and_grad(jc, params, jb)
    model = convert.model_from(params, tc, device="cpu")
    batch = tok.make_batch(tc, tok.DataConfig(), 0, B, S, device="cpu")
    p = ts.parameters(model)
    loss, metrics = ts.make_loss_fn(tc, ts.TrainHParams(loss_chunk=CHUNK))(
        model, batch)
    grads = ts.grads_of(loss, p)
    tm = {k: float(v.detach()) for k, v in metrics.items()}
    errs = leaf_errors(convert.leaves_by_name(jg, model), grads)
    bound = TOL[dtype]
    if dtype == "bfloat16" and jc.encoder_layers:
        # the bf16 encoder's rounding noise, measured on the reference:
        # its bf16 gradients against its f32 gradients on the same weights
        jc32 = dataclasses.replace(jc, dtype="float32")
        p32 = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        _, jg32 = jax_value_and_grad(jc32, p32, jb)
        noise = max(leaf_errors(
            convert.leaves_by_name(jg32, model),
            {k: _tensor(v) for k, v in
             convert.leaves_by_name(jg, model).items()}).values())
        bound = max(bound, 1.5 * noise)
    return jm, tm, errs, bound


def _tensor(a):
    return torch.from_numpy(np.array(a, np.float32))
