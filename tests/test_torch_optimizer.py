"""The port's AdamW (`repro_torch.train.optimizer`) against the JAX
package's (`repro.train.optimizer`), mirroring `tests/test_train.py`.

The schedule at its corners; the int8 codes and scales of both
quantizers bit-equal to JAX's and their dequantized values within
2e-7 relative; `tests/test_train.py`'s own error bounds on the port;
one `apply_updates` on the same tree and gradients as JAX's (fp32 and
int8), parameters and moments within 1e-6 relative; the numpy AdamW
check and the 10-step int8-vs-fp32 trajectory.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import given, settings, st  # hypothesis or skip-fallback

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as opt


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 100, 109, 110, 200])
def test_lr_at_equals_reference(step):
    """Warmup, its end, the cosine decay and past it: the same f32 as
    JAX's, on the step's device, with no host read."""
    cfg = opt.OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
                        min_lr_ratio=0.1)
    jcfg = jopt.OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
                          min_lr_ratio=0.1)
    got = opt.lr_at(cfg, torch.tensor(step, dtype=torch.int32))
    want = np.asarray(jopt.lr_at(jcfg, jnp.int32(step)))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= 1e-7 * max(float(want), 1e-30)
    if step == 0:
        assert float(got) == 0.0
    if step == 10:
        assert abs(float(got) - 1e-3) < 1e-9
    if step == 200:
        assert abs(float(got) - 1e-4) < 1e-9


def _values(seed: int, shape, kind: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "v":  # non-negative, over many decades, zeros among them
        x = 10.0 ** rng.uniform(-14, 2, size=shape)
        x[rng.random(shape) < 0.05] = 0.0
        return x.astype(np.float32)
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-4, 3)).astype(np.float32)


@pytest.mark.parametrize("shape", [(512, 512), (3, 7, 300), (1000,), (5, 1)])
@pytest.mark.parametrize("block", [256, 64])
def test_quantizers_bit_equal_reference(shape, block):
    """Codes and scales of `quantize_blockwise` and `quantize_v_log`
    equal JAX's bit for bit (262 144 values at 512 x 512, a padded last
    block at the others); the dequantized values within 2e-7 relative
    of JAX's."""
    for kind, q_fn, dq_fn, jq_fn, jdq_fn in (
            ("m", opt.quantize_blockwise, opt.dequantize_blockwise,
             jopt.quantize_blockwise, jopt.dequantize_blockwise),
            ("v", opt.quantize_v_log, opt.dequantize_v_log,
             jopt.quantize_v_log, jopt.dequantize_v_log)):
        x = _values(len(shape) * 7 + block, shape, kind)
        q, s = q_fn(t(x), block)
        jq, js = jq_fn(jnp.asarray(x), block)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = dq_fn(q, s, shape).numpy()
        want = np.asarray(jdq_fn(jq, js, shape))
        assert back.shape == shape
        np.testing.assert_allclose(back, want, rtol=2e-7, atol=0)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 3))
def test_quantize_roundtrip_error_bounded(seed, ndim):
    """`tests/test_train.py`'s bound on the port: absmax int8 errs by at
    most half a step (absmax / 254) a block; the codes equal JAX's."""
    rng = np.random.default_rng(seed)
    shape = tuple(int(n) for n in rng.integers(1, 40, ndim))
    x = rng.standard_normal(shape).astype(np.float32) \
        * np.float32(10.0 ** rng.integers(-4, 3))
    q, s = opt.quantize_blockwise(t(x), 64)
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jopt.quantize_blockwise(jnp.asarray(x), 64)[0]))
    back = opt.dequantize_blockwise(q, s, shape).numpy()
    bound = opt._blocked(t(np.abs(x)), 64).amax(-1).numpy() / 127.0
    err_b = opt._blocked(t(np.abs(back - x)), 64).amax(-1).numpy()
    assert np.all(err_b <= bound * 0.51 + 1e-12)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_v_log_quant_relative_error(seed):
    """The log codebook errs by under 6.6 % over 9 decades, and its
    codes equal JAX's."""
    rng = np.random.default_rng(seed)
    x = (10.0 ** rng.uniform(-9, 0, size=(8, 64))).astype(np.float32)
    q, s = opt.quantize_v_log(t(x), 64)
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jopt.quantize_v_log(jnp.asarray(x), 64)[0]))
    back = opt.dequantize_v_log(q, s, x.shape).numpy()
    assert np.max(np.abs(back - x) / x) < 0.066


def _tree(seed: int, dtype=np.float32):
    """A small parameter tree with a bf16-sized leaf, a padded last
    block and a vector, and gradients for it."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 300), "b": (7,), "k": (3, 4, 64)}
    p = {n: (rng.standard_normal(s) * 0.5).astype(dtype)
         for n, s in shapes.items()}
    g = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for n, s in shapes.items()}
    return p, g


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("clip", [1e9, 1.0])
@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_apply_updates_equals_reference(state_dtype, clip):
    """Three `apply_updates` from the same tree, state and gradients as
    JAX's: parameters, f32 moments (int8: the scales) and the metrics
    within 1e-6 relative, the int8 codes equal; the grad clip scaling
    once clip = 1 is below the gradient norm."""
    kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10,
              weight_decay=0.1, grad_clip=clip, state_dtype=state_dtype,
              quant_block=64)
    cfg, jcfg = opt.OptConfig(**kw), jopt.OptConfig(**kw)
    p0, _ = _tree(0)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    tp = {n: t(v) for n, v in p0.items()}
    js, ts_ = jopt.init_opt_state(jp, jcfg), opt.init_opt_state(tp, cfg)
    for step in range(3):
        _, g = _tree(step + 1)
        jp, js, jm = jopt.apply_updates(jp, {n: jnp.asarray(v)
                                             for n, v in g.items()}, js, jcfg)
        tp, ts_, tm = opt.apply_updates(tp, {n: t(v) for n, v in g.items()},
                                        ts_, cfg)
        assert int(ts_["count"]) == int(js["count"]) == step + 1
        for k in ("grad_norm", "lr"):
            assert _rel(tm[k].numpy(), jm[k]) <= 1e-6, k
        for n in p0:
            assert _rel(tp[n].numpy(), jp[n]) <= 1e-6, n
            jmu, tmu = js["mu"][n], ts_["mu"][n]
            if state_dtype == "fp32":
                assert _rel(tmu["m"].numpy(), jmu["m"]) <= 1e-6, n
                assert _rel(tmu["v"].numpy(), jmu["v"]) <= 1e-6, n
            else:
                for q, sc in (("m_q", "m_s"), ("v_q", "v_s")):
                    assert _rel(tmu[sc].numpy(), jmu[sc]) <= 1e-6, n
                    np.testing.assert_array_equal(tmu[q].numpy(),
                                                  np.asarray(jmu[q]))


def test_apply_updates_bf16_param_in_place():
    """A bf16 parameter is updated in f32 and written back in its own
    dtype, in place: the result is JAX's `new_p.astype(bf16)`."""
    cfg = opt.OptConfig(peak_lr=1e-2, warmup_steps=0, decay_steps=10**9)
    jcfg = jopt.OptConfig(peak_lr=1e-2, warmup_steps=0, decay_steps=10**9)
    p0, g = _tree(3)
    tp = {n: t(v).to(torch.bfloat16) for n, v in p0.items()}
    jp = {n: jnp.asarray(v, jnp.bfloat16) for n, v in p0.items()}
    ptrs = {n: v.data_ptr() for n, v in tp.items()}
    tp, _, _ = opt.apply_updates(tp, {n: t(v) for n, v in g.items()},
                                 opt.init_opt_state(tp, cfg), cfg)
    jp, _, _ = jopt.apply_updates(jp, {n: jnp.asarray(v) for n, v in
                                       g.items()},
                                  jopt.init_opt_state(jp, jcfg), jcfg)
    for n in p0:
        assert tp[n].dtype == torch.bfloat16 and tp[n].data_ptr() == ptrs[n]
        np.testing.assert_array_equal(tp[n].float().numpy(),
                                      np.asarray(jp[n], np.float32))


def test_adamw_matches_numpy():
    """`tests/test_train.py::test_adamw_matches_reference` on the port:
    one fp32 step against a hand-rolled numpy AdamW."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    gw = (rng.standard_normal((4, 8)) * 0.1).astype(np.float32)
    cfg = opt.OptConfig(peak_lr=1e-2, warmup_steps=0, decay_steps=10**9,
                        weight_decay=0.01, grad_clip=1e9)
    p = {"w": t(w)}
    new_p, _, _ = opt.apply_updates(p, {"w": t(gw)},
                                    opt.init_opt_state(p, cfg), cfg)
    mhat = 0.1 * gw / (1 - 0.9)
    vhat = 0.05 * gw ** 2 / (1 - 0.95)
    want = w - 1e-2 * (mhat / (np.sqrt(vhat) + 1e-8) + 0.01 * w)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)


def test_int8_matches_fp32_trajectory():
    """`tests/test_train.py::test_int8_matches_fp32_trajectory` on the
    port: int8 states track fp32 within float noise over 10 steps."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((16, 32)).astype(np.float32)
    cfgs = {sd: opt.OptConfig(peak_lr=1e-2, warmup_steps=0,
                              decay_steps=10**9, weight_decay=0.0,
                              state_dtype=sd)
            for sd in ("fp32", "int8")}
    ps = {sd: {"w": t(w0)} for sd in cfgs}
    states = {sd: opt.init_opt_state(ps[sd], c) for sd, c in cfgs.items()}
    for _ in range(10):
        g = rng.standard_normal((16, 32)).astype(np.float32)
        for sd, c in cfgs.items():
            ps[sd], states[sd], _ = opt.apply_updates(ps[sd], {"w": t(g)},
                                                      states[sd], c)
    diff = float((ps["fp32"]["w"] - ps["int8"]["w"]).abs().max())
    scale = float((ps["fp32"]["w"] - t(w0)).abs().max())
    assert diff < 0.12 * scale, (diff, scale)


def test_init_opt_state_equals_reference():
    """fp32: zero moments; int8: JAX's codes and scales of zeros, shaped
    [..., nb, block] along the parameter's last axis."""
    p0, _ = _tree(0)
    for sd in ("fp32", "int8"):
        cfg = opt.OptConfig(state_dtype=sd, quant_block=64)
        st_ = opt.init_opt_state({n: t(v) for n, v in p0.items()}, cfg)
        jst = jopt.init_opt_state({n: jnp.asarray(v) for n, v in p0.items()},
                                  jopt.OptConfig(state_dtype=sd,
                                                 quant_block=64))
        assert st_["count"].dtype == torch.int32 and int(st_["count"]) == 0
        for n in p0:
            assert set(st_["mu"][n]) == set(jst["mu"][n])
            for k, v in st_["mu"][n].items():
                want = np.asarray(jst["mu"][n][k])
                assert v.shape == want.shape and str(v.dtype)[6:] == \
                    str(want.dtype)
                np.testing.assert_array_equal(v.numpy(), want)
