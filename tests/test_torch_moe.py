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


def _moe_loss(y, aux):
    """`tests/test_moe.py::test_moe_grads_flow`'s loss."""
    return (y ** 2).sum() + 0.01 * aux.load_balance_loss


def test_moe_grads_flow():
    """`tests/test_moe.py::test_moe_grads_flow` on the port: jamba's
    layer at a capacity factor of 8; every gradient is finite, and the
    router and w_gate get nonzero ones."""
    tc = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True),
                             moe_capacity_factor=8.0)
    m = moe.Moe(tc)
    m.reset_parameters(torch.Generator().manual_seed(1))
    m.requires_grad_(True)
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (2, 8, tc.d_model)) * 0.3).astype(np.float32))
    names, params = zip(*m.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(_moe_loss(*moe.moe(m, x)),
                                                params)))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["router"].norm()) > 0
    assert float(grads["w_gate"].float().norm()) > 0


@pytest.mark.parametrize("cf", [0.5, 16.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_grads_equal_reference(arch, cf):
    """Every parameter's gradient of `_moe_loss` and the input's equal
    JAX's `jax.grad` of the same loss (f32), within 1e-4 of each leaf's
    largest magnitude, at a factor of 0.5 with the same pairs dropped;
    the router's gradient of the aux losses alone likewise."""
    jc, p, m = pair(arch, cf=cf)
    jx, tx = x_of(jc)

    def jloss(p, x):
        y, aux = jmoe.moe(p, x, jc)
        return jnp.sum(y ** 2) + 0.01 * aux.load_balance_loss

    def aux_loss(aux):
        return 0.01 * aux.load_balance_loss + 1e-3 * aux.router_z_loss

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(p, jx)
    jr = jax.grad(lambda p: aux_loss(jmoe.moe(p, jx, jc)[1]))(p)["router"]
    m.requires_grad_(True)
    tx.requires_grad_(True)
    names, params = zip(*m.named_parameters())
    got = torch.autograd.grad(_moe_loss(*moe.moe(m, tx)), params + (tx,))
    want = {}
    for name in names:
        leaf = jg
        for part in name.split("."):
            leaf = leaf[part]
        want[name] = np.asarray(leaf, np.float32)
    want["x"] = np.asarray(jgx)
    top = max(np.abs(w).max() for w in want.values())
    for name, g in zip(names + ("x",), got):
        w = want[name]
        # a leaf below 1e-4 of the layer's largest gradient is a zero of
        # exact arithmetic: with top-1 routing (llama4) the renormalised
        # weight w / w is 1 and the router's gradient through it is the
        # rounding residue of both libraries, held within 1e-6 of the
        # layer's largest gradient
        bound = (1e-4 * np.abs(w).max() if np.abs(w).max() >= 1e-4 * top
                 else 1e-6 * top)
        assert max_err(w, g) <= bound, name
    # the router's gradient through the aux losses alone
    r, = torch.autograd.grad(aux_loss(moe.moe(m, tx)[1]), (m.router,))
    assert max_err(jr, r) <= 1e-4 * np.abs(np.asarray(jr)).max()


def test_expert_blocks_keep_the_forward(monkeypatch):
    """The expert products, a block of experts at a time and then
    concatenated, equal the same products written block by block into
    one buffer, bit for bit, with one block and with several."""
    jc, p, m = pair("deepseek-moe-16b")
    e, d, f = m.w_gate.shape
    xe = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (e, 8, d)).astype(np.float32))
    for block_bytes in (moe.EXPERT_BLOCK_BYTES, 3 * d * f * 4):
        monkeypatch.setattr(moe, "EXPERT_BLOCK_BYTES", block_bytes)
        step = max(1, block_bytes // (d * f * 4))
        want = torch.empty_like(xe)
        for e0 in range(0, e, step):
            sl = slice(e0, e0 + step)
            h = torch.nn.functional.silu(torch.bmm(xe[sl], m.w_gate[sl])) \
                * torch.bmm(xe[sl], m.w_up[sl])
            torch.bmm(h, m.w_down[sl], out=want[sl])
        assert torch.equal(moe._expert_compute(m, xe), want)
