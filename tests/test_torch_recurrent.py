"""The port's recurrent mixers (`repro_torch.models.ssm`, `.xlstm`)
against the JAX package's, layer by layer, on the reference's params and
numpy inputs from a seed; and the port's decode started from JAX's
prefill states (`convert.decode_states_from`).

Tolerances: f32 within 1e-4 (the mamba doubling scan associates the
f32 products otherwise than `associative_scan`); bf16 weights and
inputs within 0.08, `tests/test_models.py`'s own bound.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import ssm, xlstm

TOL = {"float32": 1e-4, "bfloat16": 0.08}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(torch.as_tensor(b).float(),
                                     np.float32)).max())


def tensor(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def layer_pair(arch, init, module, dtype, seed=3):
    """The reference's params of one layer, cast to `dtype`, and the
    port's module holding them."""
    jdt, tdt = DTYPES[dtype]
    cfg = jget(arch, smoke=True)
    p, _ = init(cfg, jax.random.PRNGKey(seed))
    p = jax.tree.map(lambda x: x.astype(jdt), p)
    m = module(get_config(arch, smoke=True), dtype=tdt)
    for name, leaf in p.items():
        getattr(m, name).data.copy_(tensor(leaf, tdt))
    return cfg, p, m


def inputs(shape, dtype, seed=0, scale=0.5):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), tensor(x, tdt)


# ---------------------------------------------------------------------------
# mamba
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_equals_reference(dtype):
    jx, tx = inputs((2, 11, 24), dtype)
    jw, tw = inputs((4, 24), dtype, seed=1)
    jb, tb = inputs((24,), dtype, seed=2)
    got = ssm._causal_conv(tx, tw, tb)
    assert got.dtype == tx.dtype
    assert max_err(jssm._causal_conv(jx, jw, jb), got) < TOL[dtype] / 10


@pytest.mark.parametrize("chunk", [8, 32, 5])
def test_ssm_scan_chunked_equals_reference(chunk):
    """Chunks of 8 over S = 32 (four chunks carrying the state), one
    chunk, and Q = 5 (a doubling scan over a length that is no power of
    two), from a nonzero h0."""
    rng = np.random.default_rng(4)
    S = 40 if chunk == 5 else 32
    dA = rng.uniform(0.5, 1.0, (2, S, 6, 4)).astype(np.float32)
    dBx = rng.standard_normal((2, S, 6, 4)).astype(np.float32)
    C = rng.standard_normal((2, S, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    jy, jh = jssm._ssm_scan_chunked(*map(jnp.asarray, (dA, dBx, C, h0)),
                                    chunk)
    ty, th = ssm._ssm_scan_chunked(*map(torch.from_numpy, (dA, dBx, C, h0)),
                                   chunk)
    assert max_err(jy, ty) < 1e-4 and max_err(jh, th) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_with_state_and_decode_equal_reference(dtype):
    """Prefill of 32 steps in chunks of 8, then 3 decode steps from its
    state, and a run over the prefix's conv state (`conv0`)."""
    cfg, p, m = layer_pair("jamba-v0.1-52b", jssm.init_mamba, ssm.Mamba,
                           dtype)
    jx, tx = inputs((2, 35, cfg.d_model), dtype)
    jy, (jh, jc) = jax.jit(lambda p, x: jssm.mamba_with_state(
        p, x, cfg, None, None, chunk=8))(p, jx[:, :32])
    ty, (th, tc) = ssm.mamba_with_state(m, tx[:, :32], chunk=8)
    tol = TOL[dtype]
    assert max_err(jy, ty) < tol and max_err(jh, th) < tol
    assert max_err(jc, tc) == 0.0 and tc.shape == (2, 3, cfg.d_inner)
    st_j, st_t = (jh, jc), (th, tc)
    decode = jax.jit(lambda p, x, st: jssm.mamba_decode(p, x, st, cfg))
    for t in range(32, 35):
        jo, st_j = decode(p, jx[:, t:t + 1], st_j)
        to, st_t = ssm.mamba_decode(m, tx[:, t:t + 1], st_t)
        assert max_err(jo, to) < tol
        assert max_err(st_j[0], st_t[0]) < tol
        assert max_err(st_j[1], st_t[1]) < tol
    jy2, (jh2, _) = jssm.mamba_with_state(p, jx[:, 32:], cfg, jh, jc)
    ty2, (th2, _) = ssm.mamba_with_state(m, tx[:, 32:], th, tc)
    assert max_err(jy2, ty2) < tol and max_err(jh2, th2) < tol


def test_mamba_short_prompt_conv_state_equals_reference():
    """s < d_conv - 1: the conv state is the whole (shorter) x_in, and a
    later run over it as conv0 equals the reference's."""
    cfg, p, m = layer_pair("jamba-v0.1-52b", jssm.init_mamba, ssm.Mamba,
                           "float32")
    jx, tx = inputs((2, 6, cfg.d_model), "float32", seed=5)
    jy, (jh, jc) = jssm.mamba_with_state(p, jx[:, :2], cfg, None, None)
    ty, (th, tc) = ssm.mamba_with_state(m, tx[:, :2])
    assert tc.shape == (2, 2, cfg.d_inner) and jc.shape == tc.shape
    assert max_err(jy, ty) < 1e-4 and max_err(jc, tc) == 0.0
    jy2, (jh2, jc2) = jssm.mamba_with_state(p, jx[:, 2:], cfg, jh, jc)
    ty2, (th2, tc2) = ssm.mamba_with_state(m, tx[:, 2:], th, tc)
    assert max_err(jy2, ty2) < 1e-4 and max_err(jh2, th2) < 1e-4
    assert max_err(jc2, tc2) == 0.0


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fresh", [True, False])
def test_mlstm_chunk_equals_reference(fresh):
    """One chunk of 8 from the initial state (m = -1e30) and from a
    random one."""
    rng = np.random.default_rng(6)
    B, H, Q, dh = 2, 4, 8, 16

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    q, k, v = r(B, H, Q, dh), r(B, H, Q, dh, scale=0.25), r(B, H, Q, dh)
    li = r(B, H, Q)
    lf = np.log(1 / (1 + np.exp(-(r(B, H, Q) + 3.0)))).astype(np.float32)
    if fresh:
        st = (np.zeros((B, H, dh, dh), np.float32),
              np.zeros((B, H, dh), np.float32),
              np.full((B, H), -1e30, np.float32))
    else:
        st = (r(B, H, dh, dh), r(B, H, dh), r(B, H))
    jh, jst = jxl._mlstm_chunk(*map(jnp.asarray, (q, k, v, li, lf)),
                               tuple(map(jnp.asarray, st)))
    th, tst = xlstm._mlstm_chunk(*map(torch.from_numpy, (q, k, v, li, lf)),
                                 tuple(map(torch.from_numpy, st)))
    assert max_err(jh, th) < 1e-4
    for a, b in zip(jst, tst):
        assert max_err(a, b) < 1e-4


@pytest.mark.parametrize("chunk", [8, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_with_state_equals_reference(dtype, chunk):
    """S = 32 in chunks of 8 (or 1: the decode form), then one decode
    step from the state."""
    cfg, p, m = layer_pair("xlstm-1.3b", jxl.init_mlstm, xlstm.MLstm, dtype)
    jx, tx = inputs((2, 33, cfg.d_model), dtype)
    jy, jst = jax.jit(lambda p, x: jxl.mlstm_with_state(
        p, x, cfg, None, chunk=chunk))(p, jx[:, :32])
    ty, tst = xlstm.mlstm_with_state(m, tx[:, :32], chunk=chunk)
    tol = TOL[dtype]
    assert max_err(jy, ty) < tol
    for a, b in zip(jst, tst):
        assert max_err(a, b) < tol
    jo, _ = jxl.mlstm_decode(p, jx[:, 32:], cfg, jst)
    to, _ = xlstm.mlstm_decode(m, tx[:, 32:], tst)
    assert max_err(jo, to) < tol


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_with_state_equals_reference(dtype, given):
    """From the reference's initial state (n = 1e-6, m = -1e30), or from
    a given one; then one decode step."""
    cfg, p, m = layer_pair("xlstm-1.3b", jxl.init_slstm, xlstm.SLstm, dtype)
    jx, tx = inputs((2, 13, cfg.d_model), dtype)
    st = None
    if given:
        rng = np.random.default_rng(7)
        shape = (2, cfg.num_heads, cfg.d_model // cfg.num_heads)
        st = tuple(rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
        st = (st[0], np.abs(st[1]) + 0.5, st[2], st[3])
    jy, jst = jxl.slstm_with_state(
        p, jx[:, :12], cfg, None if st is None else tuple(map(jnp.asarray,
                                                               st)))
    ty, tst = xlstm.slstm_with_state(
        m, tx[:, :12], None if st is None else tuple(map(torch.from_numpy,
                                                         st)))
    tol = TOL[dtype]
    assert max_err(jy, ty) < tol
    for a, b in zip(jst, tst):
        assert max_err(a, b) < tol
    jo, _ = jxl.slstm_decode(p, jx[:, 12:], cfg, jst)
    to, _ = xlstm.slstm_decode(m, tx[:, 12:], tst)
    assert max_err(jo, to) < tol


# ---------------------------------------------------------------------------
# the port's decode from JAX's prefill states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-v0.1-52b"])
def test_decode_from_reference_states(arch, dtype):
    """JAX prefills 12 tokens; its states (mLSTM / sLSTM, or mamba and
    attention) carried across by `convert.decode_states_from` start the
    port's decode_step, whose logits equal JAX's decode steps."""
    jc = dataclasses.replace(jget(arch, smoke=True), dtype=dtype)
    tc = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    params, _ = JM.init_model(jc, 0)
    model = convert.model_from(params, tc, device="cpu")
    toks = np.random.default_rng(8).integers(0, jc.vocab_size, (2, 16)
                                             ).astype(np.int32)
    _, jst, _ = jax.jit(lambda p, t: JM.prefill(p, jc, {"tokens": t}, 24))(
        params, jnp.asarray(toks[:, :12]))
    decode = jax.jit(lambda p, tok, st, pos: JM.decode_step(p, jc, tok, st,
                                                            pos))
    tst = convert.decode_states_from(jax.tree.map(np.asarray, jst), tc,
                                     device="cpu")
    kinds = {tc.layer_kind(i) for i in range(tc.num_layers)}
    assert all(set(s) == set(M.STATE_FIELDS.get(tc.layer_kind(i), "kv"))
               for i, s in enumerate(tst))
    assert kinds == ({"mlstm", "slstm"} if arch == "xlstm-1.3b"
                     else {"attn", "mamba"})
    for t in range(12, 16):
        jl, jst = decode(params, jnp.asarray(toks[:, t]), jst, jnp.int32(t))
        tl, tst = M.decode_step(model, torch.from_numpy(toks[:, t]), tst, t)
        assert max_err(jl, tl) < TOL[dtype]
