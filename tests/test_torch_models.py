"""The port's LM stack (`repro_torch.models`, `repro_torch.configs`)
against the JAX package's, on the reduced (SMOKE) configs.

The reference's parameter tree is carried across by
`convert.model_from`, so both packages compute on the same weights; the
whole-model tests run every configured architecture (attention, mamba,
mLSTM / sLSTM, MoE layers).
Tolerances: f32 runs (`dtype="float32"`) within 1e-4; the default bf16
configs within 0.08, `tests/test_models.py`'s own bound (the decoder
computes in f32 there too, since the reference's embedding scale
promotes bf16 to f32; only the encoder of seamless runs in bf16).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as J_ARCHS
from repro.configs import get_config as jget
from repro.models import layers as jly
from repro.models import model as JM
from repro.models.config import count_params as j_count
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, SHAPES, all_cells, get_config
from repro_torch.models import layers as ly
from repro_torch.models import model as M
from repro_torch.models.config import count_params

ATTN_ARCHS = ("gemma2-2b", "starcoder2-7b", "codeqwen1.5-7b",
              "phi3-medium-14b", "seamless-m4t-medium", "phi-3-vision-4.2b")
TOL = {"float32": 1e-4, "bfloat16": 0.08}


def smoke_pair(arch, dtype="bfloat16"):
    """(reference config, port config) of the SMOKE arch in `dtype`."""
    return (dataclasses.replace(jget(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


def make_batch(cfg, rng, B=2, S=16):
    """`tests/test_models.py`'s batch, as numpy arrays."""
    batch = {}
    if cfg.encoder_layers:
        batch["frames"] = (rng.standard_normal((B, 12, cfg.d_model))
                           * 0.1).astype(np.float32)
    if cfg.modality == "vision_patches":
        batch["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)) * 0.1).astype(np.float32)
    batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return batch


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@functools.lru_cache(maxsize=None)
def reference(arch, dtype):
    """JAX's params and outputs on one batch: forward hidden and logits,
    then prefill of the first S - 4 tokens and 4 teacher-forced decode
    steps, each jitted (as the reference's drivers run them).  Cached:
    several tests read one run."""
    jc, tc = smoke_pair(arch, dtype)
    params, _ = JM.init_model(jc, 0)
    b = make_batch(jc, np.random.default_rng(0))
    S = b["tokens"].shape[1]
    jb = jax_batch(b)

    @jax.jit
    def forward(p, batch):
        hidden, aux, _ = JM.forward(p, jc, batch)
        return hidden, JM.logits_from_hidden(p, jc, hidden), aux

    prefill = jax.jit(lambda p, batch: JM.prefill(p, jc, batch, S + 8)[:2])
    decode = jax.jit(lambda p, tok, st, pos: JM.decode_step(p, jc, tok, st,
                                                            pos))
    hidden, logits, aux = forward(params, jb)
    last, states = prefill(params, dict(jb, tokens=jb["tokens"][:, :S - 4]))
    off = jc.num_prefix_embeds if jc.modality == "vision_patches" else 0
    steps = [np.asarray(last)]
    for t in range(4):
        lg, states = decode(params, jb["tokens"][:, S - 4 + t], states,
                            jnp.int32(S - 4 + off + t))
        steps.append(np.asarray(lg))
    return dict(params=params, batch=b, hidden=np.asarray(hidden, np.float32),
                logits=np.asarray(logits), aux=np.asarray(aux), steps=steps,
                off=off)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_equals_reference(arch, smoke):
    jc, tc = jget(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for active in (False, True):
        assert count_params(tc, active) == j_count(jc, active)
    assert tc.period_kinds() == jc.period_kinds()
    assert (tc.num_periods, tc.q_dim, tc.kv_dim, tc.d_inner, tc.dt_rank,
            tc.uses_kv_cache) == (jc.num_periods, jc.q_dim, jc.kv_dim,
                                  jc.d_inner, jc.dt_rank, jc.uses_kv_cache)


def test_registry_and_shapes_equal_reference():
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import all_cells as j_cells

    assert ARCH_NAMES == J_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert all_cells(ARCH_NAMES) == j_cells(J_ARCHS)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_config_rejects_what_the_reference_rejects():
    cfg = get_config("gemma2-2b", smoke=True)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, scan_period=3)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, encoder_layers=2)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope_equal_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32) * 0.1
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    assert max_err(jly.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6),
                   ly.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
                   ) < 1e-5
    assert max_err(jly.rope_frequencies(16, 1e6),
                   ly.rope_frequencies(16, 1e6)) < 1e-7
    assert max_err(jly.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4),
                   ly.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 1e4)) < 1e-4


@pytest.mark.parametrize("sq,sk,window", [(5, 5, 0), (3, 9, 0), (12, 12, 4),
                                          (4, 20, 6)])
def test_causal_mask_equals_reference(sq, sk, window):
    np.testing.assert_array_equal(np.asarray(jly.causal_mask(sq, sk, window)),
                                  ly.causal_mask(sq, sk, window).numpy())


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_layers_equal_reference(arch):
    """Full-sequence, cross (kv_override) and decode attention, and the
    MLP, on the reference's layer params."""
    jc, tc = smoke_pair(arch, "float32")
    key = jax.random.PRNGKey(3)
    p, _ = jly.init_attention(jc, key)
    pm, _ = jly.init_mlp(jc, key)
    att = ly.Attention(tc)
    mlp = ly.Mlp(tc)
    for mod, tree in ((att, p), (mlp, pm)):
        for name, leaf in tree.items():
            getattr(mod, name).data.copy_(torch.from_numpy(np.array(leaf)))
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 10, jc.d_model)) * 0.5).astype(np.float32)
    enc = (rng.standard_normal((2, 6, jc.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos.copy())
    with torch.no_grad():
        for local in (False, True):
            assert max_err(jly.attention(p, jx, jc, jpos, local=local),
                           att(tx, tpos, local=local)) < 1e-4
        jkv = jly.project_cross_kv(p, jnp.asarray(enc), jc)
        tkv = att.project_kv(torch.from_numpy(enc))
        assert max_err(jly.attention(p, jx, jc, jpos, causal=False,
                                     kv_override=jkv),
                       att(tx, tpos, causal=False, kv_override=tkv)) < 1e-4
        ck = (rng.standard_normal((2, 16, jc.num_kv_heads, jc.head_dim))
              ).astype(np.float32)
        cv = (rng.standard_normal(ck.shape)).astype(np.float32)
        for cross in (False, True):
            jo, jk, jv = jly.attention_decode(
                p, jx[:, :1], jnp.asarray(ck), jnp.asarray(cv), jnp.int32(9),
                jc, local=True, cross=cross)
            to, tk, tv = att.decode(tx[:, :1], torch.from_numpy(ck.copy()),
                                    torch.from_numpy(cv.copy()), 9,
                                    local=True, cross=cross)
            assert max_err(jo, to) < 1e-4
            assert max_err(jk, tk) < 1e-5 and max_err(jv, tv) < 1e-5
        assert max_err(jly.mlp(pm, jx, jc), mlp(tx)) < 1e-4


def test_chunked_attention_matches_dense(monkeypatch):
    """The q-chunked path equals the dense-mask path (S = 4096), and
    JAX's chunked attention on the same weights."""
    jc, tc = smoke_pair("phi3-medium-14b", "float32")
    p, _ = jly.init_attention(jc, jax.random.PRNGKey(0))
    att = ly.Attention(tc)
    for name, leaf in p.items():
        getattr(att, name).data.copy_(torch.from_numpy(np.array(leaf)))
    B, S = 2, 4096
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((B, S, jc.d_model)) * 0.1).astype(np.float32)
    pos = torch.arange(S)[None].expand(B, S)
    with torch.no_grad():
        chunked = att(torch.from_numpy(x), pos)
        monkeypatch.setattr(ly, "Q_CHUNK_THRESHOLD", 10**9)
        dense = att(torch.from_numpy(x), pos)
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)
    want = jly.attention(p, jnp.asarray(x), jc, jnp.asarray(pos.numpy()))
    assert max_err(want, chunked) < 1e-4


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_equals_reference(arch, dtype):
    ref = reference(arch, dtype)
    _, tc = smoke_pair(arch, dtype)
    model = convert.model_from(ref["params"], tc, device="cpu")
    hidden = M.forward(model, torch_batch(ref["batch"]))
    logits = M.logits_from_hidden(model, hidden)
    assert hidden.shape == ref["hidden"].shape
    assert logits.dtype == torch.float32
    assert max_err(ref["hidden"], hidden.float()) < TOL[dtype]
    assert max_err(ref["logits"], logits) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_aux_equals_reference(arch, dtype):
    """The forward's aux, the MoE layers' (load-balance, z) losses summed
    over the layers, equals the reference's `forward(...)[1]` (zeros
    without MoE)."""
    ref = reference(arch, dtype)
    _, tc = smoke_pair(arch, dtype)
    model = convert.model_from(ref["params"], tc, device="cpu")
    hidden, aux = M.forward_with_aux(model, torch_batch(ref["batch"]))
    assert aux.dtype == torch.float32 and aux.shape == (2,)
    assert max_err(ref["aux"], aux) < 1e-5 * max(1.0, float(
        np.abs(ref["aux"]).max()))
    assert torch.equal(hidden, M.forward(model, torch_batch(ref["batch"])))
    if not any(tc.layer_is_moe(i) for i in range(tc.num_layers)):
        assert not aux.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_decode_equal_reference(arch, dtype):
    ref = reference(arch, dtype)
    _, tc = smoke_pair(arch, dtype)
    model = convert.model_from(ref["params"], tc, device="cpu")
    tb = torch_batch(ref["batch"])
    S = tb["tokens"].shape[1]
    last, states = M.prefill(model, dict(tb, tokens=tb["tokens"][:, :S - 4]),
                             max_len=S + 8)
    got = [last]
    for t in range(4):
        lg, states = M.decode_step(model, tb["tokens"][:, S - 4 + t], states,
                                   S - 4 + ref["off"] + t)
        got.append(lg)
    errs = [max_err(a, b) for a, b in zip(ref["steps"], got)]
    assert max(errs) < TOL[dtype], errs
    assert all(st["k"].shape[1] == S + 8 for st in states if "k" in st)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_decode_consistency(arch):
    """Teacher-forced decode reproduces the full forward's logits, on the
    port's own init (tests/test_models.py's check, on the port)."""
    cfg = get_config(arch, smoke=True)
    model = M.init_model(cfg, seed=0, device="cpu")
    tb = torch_batch(make_batch(cfg, np.random.default_rng(0)))
    S = tb["tokens"].shape[1]
    off = cfg.num_prefix_embeds if cfg.modality == "vision_patches" else 0
    full = M.logits_from_hidden(model, M.forward(model, tb))
    last, states = M.prefill(model, dict(tb, tokens=tb["tokens"][:, :S - 4]),
                             max_len=S + 8)
    pos0 = S - 4 + off
    errs = [max_err(last, full[:, pos0 - 1])]
    for t in range(4):
        lg, states = M.decode_step(model, tb["tokens"][:, S - 4 + t], states,
                                   pos0 + t)
        errs.append(max_err(lg, full[:, pos0 + t]))
    assert max(errs) < 0.08, (arch, errs)
    assert bool(torch.isfinite(full).all())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_count_matches_closed_form(arch):
    """The port's model holds as many parameters as the reference's init
    (leaf for leaf: `convert.model_from` checks the shapes), which is
    count_params(cfg) exactly for the attention-only archs and within
    `tests/test_models.py`'s 2 % for the others (xlstm's closed form is
    256 above its init), all bf16 as the reference casts every leaf."""
    cfg = get_config(arch, smoke=True)
    model = M.Model(cfg, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(lambda: JM.init_model(jget(arch, smoke=True),
                                                  0)[0])
    assert n == sum(x.size for x in jax.tree.leaves(shapes))
    if arch in ATTN_ARCHS:
        assert n == count_params(cfg)
    assert abs(n - count_params(cfg)) / count_params(cfg) < 0.02
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_gemma2_softcaps_bound_logits():
    cfg = get_config("gemma2-2b", smoke=True)
    model = M.init_model(cfg, 0, device="cpu")
    tb = torch_batch(make_batch(cfg, np.random.default_rng(0)))
    logits = M.logits_from_hidden(model, M.forward(model, tb))
    assert float(logits.abs().max()) <= cfg.final_logit_softcap + 1e-3


def test_local_attention_window():
    """A gemma2 local layer (window 16) ignores a token outside its window:
    in a one-local-layer model, changing token 0 leaves position 20's
    hidden state as it was."""
    cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True),
                              num_layers=2, scan_period=2, dtype="float32")
    model = M.init_model(cfg, 0, device="cpu")
    model.blocks = model.blocks[:1]  # layer 0 only: the local one
    toks = torch.randint(0, cfg.vocab_size, (1, 24),
                         generator=torch.Generator().manual_seed(0))
    other = toks.clone()
    other[0, 0] = (toks[0, 0] + 1) % cfg.vocab_size
    h1 = M.forward(model, {"tokens": toks})
    h2 = M.forward(model, {"tokens": other})
    assert torch.equal(h1[0, 20:], h2[0, 20:])
    assert not torch.equal(h1[0, 1:16], h2[0, 1:16])
