"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
package's (`repro.models.moe`, its one-device path), mirroring
`tests/test_moe.py`: equal to the dense per-token reference when nothing
is dropped, equal to JAX's output (the same pairs dropped) at a small
capacity, the uniform load-balance loss of 1 with every probability
tied, the aux losses, and the dispatch table slot for slot.

Tolerances: f32 1e-4 (the combine adds each token's expert outputs in
the order the reference's scatter-add adds them on the CPU; the expert
products round as the two libraries' batched products do); bf16 weights
0.08.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import routing as jrouting
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe
from test_moe import _dense_reference

ARCHS = ("deepseek-moe-16b", "jamba-v0.1-52b", "llama4-maverick-400b-a17b")
TOL = {"float32": 1e-4, "bfloat16": 0.08}


def max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(torch.as_tensor(b).float(),
                                     np.float32)).max())


def pair(arch, cf=None, dtype="float32", zero_router=False):
    """(reference config, params; port config, Moe holding them)."""
    jc, tc = jget(arch, smoke=True), get_config(arch, smoke=True)
    if cf is not None:
        jc = dataclasses.replace(jc, moe_capacity_factor=cf)
        tc = dataclasses.replace(tc, moe_capacity_factor=cf)
    p, _ = jmoe.init_moe(jc, jax.random.PRNGKey(0))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    p = jax.tree.map(lambda x: x.astype(jdt), p)
    if zero_router:
        p = dict(p, router=jnp.zeros_like(p["router"]))
    m = moe.Moe(tc, dtype=torch.bfloat16 if dtype == "bfloat16"
                else torch.float32)
    for name, t in m.state_dict().items():
        leaf = p
        for part in name.split("."):
            leaf = leaf[part]
        t.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return jc, p, m


def x_of(cfg, B=2, S=16, seed=0):
    x = (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
         * 0.3).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_dense_reference(arch):
    """Capacity factor 16: nothing dropped, so the dispatch equals the
    explicit per-token top-k sum (`tests/test_moe.py`'s reference)."""
    jc, p, m = pair(arch, cf=16.0)
    jx, tx = x_of(jc)
    got, aux = moe.moe(m, tx)
    assert max_err(_dense_reference(p, jx, jc), got) < 2e-5
    assert float(aux.dropped_fraction) == 0.0
    assert float(aux.load_balance_loss) > 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.5, 1.5, 16.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_equals_reference(arch, cf, dtype):
    """The output and the aux losses equal JAX's `moe`; at a capacity
    factor of 0.5 pairs are dropped, the same ones (the output would
    differ otherwise), and the output stays finite."""
    jc, p, m = pair(arch, cf=cf, dtype=dtype)
    jx, tx = x_of(jc)
    want, jaux = jmoe.moe(p, jx, jc)
    got, aux = moe.moe(m, tx)
    assert bool(torch.isfinite(got).all())
    assert max_err(want, got) < TOL[dtype]
    assert max_err(jaux.load_balance_loss, aux.load_balance_loss) < 1e-5
    assert max_err(jaux.router_z_loss, aux.router_z_loss) < 1e-5
    if cf == 0.5:
        assert float(aux.dropped_fraction) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_uniform_routing_ties_to_lowest_ids(arch):
    """A zero router ties every probability: lb loss is 1 (Switch
    normalisation), and the layer equals JAX's, whose top-k takes the
    lowest expert ids."""
    jc, p, m = pair(arch, zero_router=True)
    x = np.ones((2, 16, jc.d_model), np.float32)
    want, jaux = jmoe.moe(p, jnp.asarray(x), jc)
    got, aux = moe.moe(m, torch.from_numpy(x))
    assert abs(float(aux.load_balance_loss) - 1.0) < 1e-5
    assert max_err(jaux.load_balance_loss, aux.load_balance_loss) < 1e-6
    assert max_err(want, got) < 1e-4
    _, _, _, idx = moe.route(m, torch.from_numpy(x))
    assert torch.equal(idx, torch.arange(jc.moe_top_k).expand_as(idx))


def jax_dispatch(topk_idx, topk_w, e, cap):
    """The reference's table, by `_moe_shard`'s own operations (one
    device: every expert local)."""
    b, s, k = topk_idx.shape
    flat_e = topk_idx.reshape(-1)
    flat_tok = jnp.repeat(jnp.arange(b * s, dtype=jnp.int32), k)
    order = jnp.argsort(flat_e)
    e_sorted = flat_e[order]
    rank = jrouting.run_ranks(e_sorted)
    disp = jnp.full((e, cap), -1, jnp.int32).at[e_sorted, rank].set(
        flat_tok[order], mode="drop")
    wdisp = jnp.zeros((e, cap), jnp.float32).at[e_sorted, rank].set(
        topk_w.reshape(-1)[order], mode="drop")
    return np.asarray(disp), np.asarray(wdisp)


@pytest.mark.parametrize("cf", [0.5, 16.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_table_equals_reference(arch, cf):
    """Routing (ids exactly, weights within 1e-6) and the [E, cap] table
    of token indices and weights, slot for slot, against JAX's."""
    jc, p, m = pair(arch, cf=cf)
    jx, tx = x_of(jc, seed=1)
    logits = jnp.einsum("bsd,de->bse", jx, p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    jw, jidx = jax.lax.top_k(probs, jc.moe_top_k)
    jw = jw / jnp.maximum(jnp.sum(jw, axis=-1, keepdims=True), 1e-9)
    _, _, tw, tidx = moe.route(m, tx)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert max_err(jw, tw) < 1e-6
    cap = moe.capacity(m.cfg, tx.shape[0] * tx.shape[1])
    want_d, want_w = jax_dispatch(jidx, jw, jc.moe_num_experts, cap)
    disp, wdisp, slot = moe.dispatch(tidx, tw, jc.moe_num_experts, cap,
                                     torch.float32)
    np.testing.assert_array_equal(disp.numpy(), want_d)
    assert max_err(want_w, wdisp) < 1e-6
    # each kept pair's slot holds its token; the dropped ones are the rest
    n, k = tidx.shape[0] * tidx.shape[1], jc.moe_top_k
    flat = slot.reshape(n, k)
    kept = flat >= 0
    tok = torch.arange(n)[:, None].expand(n, k)
    assert torch.equal(disp.reshape(-1)[flat[kept]], tok[kept])
    assert torch.equal(flat[kept] // cap, tidx.reshape(n, k)[kept])
    assert int((~kept).sum()) == n * k - int((want_d >= 0).sum())


def test_capacity_is_the_references():
    """max(ceil(B S k / E cf), 4): deepseek's decode of 8 tokens gets 4
    slots (drops happen), a prefill of 8 x 512 tokens 576."""
    cfg = get_config("deepseek-moe-16b")
    assert moe.capacity(cfg, 8) == 4
    assert moe.capacity(cfg, 8 * 512) == 576
    assert moe.capacity(get_config("llama4-maverick-400b-a17b"), 4) == 4
