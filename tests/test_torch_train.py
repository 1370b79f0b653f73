"""The port's train step (`repro_torch.train.train_step`) against the JAX
package's (`repro.train.train_step`), beyond the per-arch loss and
gradients of `tests/test_torch_train_grads*.py`.

`chunked_xent` against JAX's with a chunk that does not divide S, with
chunk = S and past it, on masked labels, its gradient too; remat on
equal to remat off bit for bit; gradient accumulation against the full
batch (`tests/test_train.py::test_grad_accum_equivalence` on the port)
and one `make_grad_accum_train_step` against JAX's; five
`make_train_step` steps against JAX's on starcoder2 and deepseek (f32):
xent within 1e-4 at every step, and the parameters within 1e-6 of each
leaf's largest magnitude but for fewer than 1 in 1000 (measured: 35 of
201 152 and 53 of 468 288 after five steps), each of those within the
two learning rates a step by which Adam's first steps move a parameter
whose near-zero gradient rounded to the other sign.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as jtok
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.data import tokens as tok
from repro_torch.models.unroll import remat_scope
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from torch_train_cases import configs, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pair(arch, dtype="float32"):
    jc, tc = configs(arch, dtype)
    params, _ = JM.init_model(jc, 0)
    return jc, tc, params, convert.model_from(params, tc, device="cpu")


@pytest.mark.parametrize("s,chunk", [(20, 8), (20, 20), (20, 64), (32, 16)])
def test_chunked_xent_equals_reference(s, chunk):
    """Sum of the nll and the count of valid labels (a quarter masked)
    equal JAX's, and so does the gradient of the sum w.r.t. the hidden
    states: padded chunks (8 over 20), one chunk (20 and past it)."""
    jc, tc, params, model = _pair("gemma2-2b")
    rng = np.random.default_rng(s + chunk)
    h = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    lab = rng.integers(0, jc.vocab_size, (2, s)).astype(np.int32)
    lab[rng.random((2, s)) < 0.25] = -1

    def jfn(x):
        return jts.chunked_xent(params, jc, x, jnp.asarray(lab), chunk)

    (jl, jn), jvjp = jax.vjp(jfn, jnp.asarray(h))
    jgh = jvjp((jnp.float32(1.0), np.zeros((), jax.dtypes.float0)))[0]
    th = torch.from_numpy(h).requires_grad_(True)
    tl, tn = ts.chunked_xent(model, th, torch.from_numpy(lab), chunk)
    tgh, = torch.autograd.grad(tl, th)
    assert tn.dtype == torch.int32 and int(tn) == int(jn) == (lab >= 0).sum()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    jgh = np.asarray(jgh)
    assert np.abs(tgh.numpy() - jgh).max() <= 5e-5 * np.abs(jgh).max()


def test_chunked_xent_all_masked_is_zero():
    """Every label masked: the sum and the count are 0, and the loss
    function's xent divides by max(count, 1)."""
    _, tc, _, model = _pair("starcoder2-7b")
    h = torch.randn(2, 12, tc.d_model, generator=torch.Generator()
                    .manual_seed(0))
    tl, tn = ts.chunked_xent(model, h, torch.full((2, 12), -1), 5)
    assert float(tl) == 0.0 and int(tn) == 0


@pytest.fixture
def deterministic():
    """Deterministic algorithms for the test: without them the CPU's
    `index_put_` with accumulate (the backward of the MoE layer's
    gathers) adds in an order that varies from run to run, so two
    backwards of one deepseek batch differ in the last bits even with
    remat on in both."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "deepseek-moe-16b",
                                  "seamless-m4t-medium"])
def test_remat_equals_no_remat(arch, deterministic):
    """The loss, its metrics and every gradient are the same bits with
    remat on (each period, encoder layer and loss chunk recomputed in
    the backward) and off; the MoE routing recomputes identically."""
    _, tc, _, model = _pair(arch)
    batch = tok.make_batch(tc, tok.DataConfig(), 3, 2, 32, device="cpu")
    loss_fn = ts.make_loss_fn(tc, ts.TrainHParams(loss_chunk=8))
    p = ts.parameters(model)
    out = {}
    for remat in (True, False):
        with remat_scope(remat):
            loss, metrics = loss_fn(model, batch)
            out[remat] = (metrics, ts.grads_of(loss, p))
    for k in out[True][0]:
        assert torch.equal(out[True][0][k], out[False][0][k]), k
    for name in p:
        assert torch.equal(out[True][1][name], out[False][1][name]), name


def test_grad_accum_equivalence():
    """`tests/test_train.py::test_grad_accum_equivalence` on the port:
    2 microbatches of 2 summed in f32 and halved against the batch of 4
    (starcoder2 smoke, bf16 weights): the loss within 1e-4, the
    gradients' cosine above 0.999."""
    _, tc, _, model = _pair("starcoder2-7b", "bfloat16")
    hp = ts.TrainHParams(loss_chunk=64)
    loss_fn = ts.make_loss_fn(tc, hp)
    batch = tok.make_batch(tc, tok.DataConfig(), 0, 4, 32, device="cpu")
    p = ts.parameters(model)
    l_full, _ = loss_fn(model, batch)
    g_full = ts.grads_of(l_full, p)
    g_sum = {n: torch.zeros(v.shape) for n, v in p.items()}
    l_sum = 0.0
    for i in range(2):
        mb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        loss, _ = loss_fn(model, mb)
        l_sum += float(loss.detach())
        for n, g in ts.grads_of(loss, p).items():
            g_sum[n] += g.float()
    assert abs(l_sum / 2 - float(l_full.detach())) < 1e-4
    a = torch.cat([g.float().ravel() for g in g_full.values()])
    b = torch.cat([(g / 2).ravel() for g in g_sum.values()])
    assert float(a @ b / (a.norm() * b.norm())) > 0.999


def _far(model, want: dict, lr_sum: float):
    """(count of parameters more than 1e-6 of their leaf's largest
    magnitude from `want`, the count of all); raises if one is more than
    two learning rates a step (plus that tolerance) away."""
    n_far = n = 0
    for name, p in model.named_parameters():
        w = np.asarray(want[name], np.float32)
        d = np.abs(w - p.detach().float().numpy())
        tol = 1e-6 * np.abs(w).max()
        n_far += int((d > tol).sum())
        n += w.size
        assert d.max() <= 2.2 * lr_sum + tol, (name, float(d.max()))
    return n_far, n


def test_grad_accum_step_equals_reference():
    """One `make_grad_accum_train_step` (A = 2, f32 sums) against JAX's
    on the same weights, state and batch [2, 2, 32]: the loss and the
    gradient norm within 1e-5, the parameters as in `_far`."""
    jc, tc, params, model = _pair("starcoder2-7b")
    kw = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    jcfg, cfg = jopt.OptConfig(**kw), opt.OptConfig(**kw)
    hp, jhp = ts.TrainHParams(loss_chunk=16), jts.TrainHParams(loss_chunk=16)
    jb = jtok.make_batch(jc, jtok.DataConfig(), 0, 4, 32)
    jb = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in jb.items()}
    tb = tok.make_batch(tc, tok.DataConfig(), 0, 4, 32, device="cpu")
    tb = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in tb.items()}
    state = opt.init_opt_state(dict(model.named_parameters()), cfg)
    jstep = jts.make_grad_accum_train_step(jc, jcfg, jhp, 2)
    params, _, jm = jstep(params, jopt.init_opt_state(params, jcfg), jb)
    state, m = ts.make_grad_accum_train_step(tc, cfg, hp, 2)(model, state,
                                                              tb)
    assert set(m) == set(jm) == {"grad_norm", "lr", "loss"}
    for k in m:
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    n_far, n = _far(model, convert.leaves_by_name(params, model),
                    float(jm["lr"]))
    assert n_far < 1e-3 * n, (n_far, n)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "deepseek-moe-16b"])
def test_train_step_trajectory_equals_reference(arch):
    """Five `make_train_step` steps from JAX's weights and state on
    `make_batch`'s batches (2 x 32, warmup 2): xent within 1e-4 and the
    gradient norm within 1e-5 relative at every step; after the last,
    the parameters as in `_far`, fewer than 1 in 1000 of them more than
    1e-6 apart."""
    jc, tc, params, model = _pair(arch)
    kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
    jcfg, cfg = jopt.OptConfig(**kw), opt.OptConfig(**kw)
    jstate = jopt.init_opt_state(params, jcfg)
    state = opt.init_opt_state(dict(model.named_parameters()), cfg)
    jstep = jts.make_train_step(jc, jcfg, jts.TrainHParams(loss_chunk=16))
    step = ts.make_train_step(tc, cfg, ts.TrainHParams(loss_chunk=16))
    lr_sum = 0.0
    for i in range(5):
        jb = jtok.make_batch(jc, jtok.DataConfig(), i, 2, 32)
        tb = tok.make_batch(tc, tok.DataConfig(), i, 2, 32, device="cpu")
        params, jstate, jm = jstep(params, jstate, jb)
        state, m = step(model, state, tb)
        assert set(m) == set(jm)
        assert abs(float(m["xent"]) - float(jm["xent"])) <= 1e-4
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-5 * float(jm["grad_norm"])
        lr_sum += float(jm["lr"])
    n_far, n = _far(model, convert.leaves_by_name(params, model), lr_sum)
    assert n_far < 1e-3 * n, (n_far, n)
    # the moments too, through the state's name map
    want = convert.opt_state_from(jstate, model)
    assert int(state["count"]) == int(want["count"]) == 5
    for name, mu in state["mu"].items():
        for k in ("m", "v"):
            w = want["mu"][name][k]
            assert float((mu[k] - w).abs().max()) <= 1e-4 * max(
                float(w.abs().max()), 1e-30) + 1e-12, (name, k)


def test_opt_state_from_int8():
    """`convert.opt_state_from` carries JAX's int8 state: each code and
    scale by the port's parameter name, the period stacking undone, the
    dtypes kept; the moments dequantize to the zeros they hold."""
    jc, tc, params, model = _pair("jamba-v0.1-52b")
    jstate = jax.jit(lambda p: jopt.init_opt_state(
        p, jopt.OptConfig(state_dtype="int8")))(params)
    got = convert.opt_state_from(jstate, model)
    assert set(got["mu"]) == set(dict(model.named_parameters()))
    for k in ("m_q", "m_s", "v_q", "v_s"):
        want = convert.leaves_by_name(
            jax.tree.map(lambda mu: mu[k], jstate["mu"],
                         is_leaf=lambda x: isinstance(x, dict) and k in x),
            model)
        for name, w in want.items():
            t = got["mu"][name][k]
            assert str(t.dtype)[6:] == str(w.dtype), (name, k)
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    for name, p in model.named_parameters():
        mu = got["mu"][name]
        assert float(opt.dequantize_blockwise(mu["m_q"], mu["m_s"], p.shape)
                     .abs().max()) == 0.0
        assert float(opt.dequantize_v_log(mu["v_q"], mu["v_s"], p.shape)
                     .abs().max()) == 0.0
