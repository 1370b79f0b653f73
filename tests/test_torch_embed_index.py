"""An LM's embeddings indexed and searched through the port's LSH layers
(DESIGN.md Sec. 4), against `tests/test_system.py`'s
`test_model_embeddings_to_lsh_index` on the JAX package.

Users in 8 communities share a 6-token prefix; each user's embedding is
the mean-pooled final hidden state, unit-normalised; the index is
`build_store_host` at capacity 64 and the search `LshEngine(variant=
"cnb")`.  The backbones are the reference test's own, xlstm-1.3b's SMOKE
config (mLSTM / sLSTM blocks), and gemma2's.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import DenseCorpus as JDenseCorpus
from repro.core import EngineConfig as JEngineConfig
from repro.core import LshEngine as JLshEngine
from repro.core import LshParams as JLshParams
from repro.core import make_hyperplanes as j_hyperplanes
from repro.core.hashing import sketch_codes_batched as j_sketch
from repro.core.store import build_store_host as j_build
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.corpus import DenseCorpus
from repro_torch.core.engine import EngineConfig, LshEngine
from repro_torch.core.hashing import (LshParams, make_hyperplanes,
                                      sketch_codes_batched)
from repro_torch.core.runtime import IndexRuntime, RuntimeConfig
from repro_torch.core.store import build_store_host
from repro_torch.models import model as M
from torch_parity_rules import topk_swaps

N_USERS, SEQ, N_COMM, PREFIX, NQ, M_TOP = 96, 12, 8, 6, 16, 5


def users(vocab: int):
    """test_system.py's users: (tokens [96, 12], community [96])."""
    rng = np.random.default_rng(0)
    comm = rng.integers(0, N_COMM, N_USERS)
    toks = rng.integers(0, vocab, (N_USERS, SEQ))
    prefix = rng.integers(0, vocab, (N_COMM, PREFIX))
    toks[:, :PREFIX] = prefix[comm]
    return toks.astype(np.int32), comm


def embed(model, toks) -> torch.Tensor:
    """Mean-pooled final hidden, unit-normalised, in f32."""
    hidden = M.forward(model, {"tokens": torch.from_numpy(toks)})
    emb = hidden.mean(dim=1).float()
    return emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)


@functools.lru_cache(maxsize=None)
def reference(dtype, arch="gemma2-2b"):
    """JAX's embeddings of the users and its cnb search over them."""
    cfg = dataclasses.replace(jget(arch, smoke=True), dtype=dtype)
    params, _ = JM.init_model(cfg, 0)
    toks, comm = users(cfg.vocab_size)
    hidden = jax.jit(lambda p, t: JM.forward(p, cfg, {"tokens": t})[0])(
        params, jnp.asarray(toks))
    emb = np.array(hidden.mean(axis=1), np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    lsh = JLshParams(d=emb.shape[1], k=5, L=4, seed=2)
    h = j_hyperplanes(lsh)
    store = j_build(j_sketch(jnp.asarray(emb), h), lsh.num_buckets,
                    capacity=64)
    e = JLshEngine(lsh, h, store, JDenseCorpus(jnp.asarray(emb)), None,
                   JEngineConfig(variant="cnb"))
    r = e.search(jnp.asarray(emb[:NQ]), m=M_TOP, exclude=np.arange(NQ))
    return dict(params=params, toks=toks, comm=comm, emb=emb,
                h=np.asarray(h), ids=r.ids, scores=r.scores)


def port_index(emb, h, use_kernels=False):
    lsh = LshParams(d=emb.shape[1], k=5, L=4, seed=2)
    codes = sketch_codes_batched(emb, h)
    store = build_store_host(codes, lsh.num_buckets, 64, payload=emb,
                             device="cpu")
    engine = LshEngine(lsh, h, store, DenseCorpus(emb), None,
                       EngineConfig(variant="cnb", use_kernels=use_kernels),
                       device="cpu")
    return lsh, store, engine


def community_share(ids, comm) -> float:
    total = match = 0
    for i in range(ids.shape[0]):
        for j in ids[i]:
            if j >= 0:
                total += 1
                match += int(comm[j] == comm[i])
    assert total > 0
    return match / total


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embeddings_equal_reference(dtype):
    ref = reference(dtype)
    cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True), dtype=dtype)
    model = convert.model_from(ref["params"], cfg, device="cpu")
    emb = embed(model, ref["toks"])
    assert emb.dtype == torch.float32
    np.testing.assert_allclose(emb.numpy(), ref["emb"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_cnb_search_on_embeddings_equals_reference(use_kernels):
    """The port's embeddings, indexed with JAX's hyperplanes, give JAX's
    cnb ids under the near-tie rule (the kernel wrappers' plain versions
    on the CPU with use_kernels)."""
    ref = reference("bfloat16")
    cfg = get_config("gemma2-2b", smoke=True)
    emb = embed(convert.model_from(ref["params"], cfg, device="cpu"),
                ref["toks"])
    h = convert.hyperplanes_from(ref["h"], device="cpu")
    _, _, engine = port_index(emb, h, use_kernels)
    r = engine.search(emb[:NQ], m=M_TOP, exclude=np.arange(NQ))
    assert topk_swaps(ref["scores"], ref["ids"], r.scores, r.ids,
                      tol=1e-5) == 0
    assert community_share(r.ids, ref["comm"]) > 0.6


@pytest.mark.parametrize("use_kernels", [False, True])
def test_xlstm_embeddings_to_lsh_index(use_kernels):
    """`tests/test_system.py:131` on the port: xlstm-1.3b's SMOKE
    embeddings (JAX's weights) equal JAX's within 1e-5, the cnb ids over
    them, indexed with JAX's hyperplanes, equal JAX's under the near-tie
    rule, and the same-community share exceeds 0.6."""
    ref = reference("bfloat16", "xlstm-1.3b")
    cfg = get_config("xlstm-1.3b", smoke=True)
    emb = embed(convert.model_from(ref["params"], cfg, device="cpu"),
                ref["toks"])
    np.testing.assert_allclose(emb.numpy(), ref["emb"], rtol=0, atol=1e-5)
    h = convert.hyperplanes_from(ref["h"], device="cpu")
    _, _, engine = port_index(emb, h, use_kernels)
    r = engine.search(emb[:NQ], m=M_TOP, exclude=np.arange(NQ))
    assert topk_swaps(ref["scores"], ref["ids"], r.scores, r.ids,
                      tol=1e-5) == 0
    assert community_share(r.ids, ref["comm"]) > 0.6
    assert community_share(ref["ids"], ref["comm"]) > 0.6


def test_port_pipeline_retrieves_communities():
    """test_system.py's assertion on the port alone: its own init and its
    own hyperplanes.  The runtime's dot search over the store's payload
    and the engine's corpus-scored search agree, and each user's own id
    lies in its probed buckets."""
    cfg = get_config("gemma2-2b", smoke=True)
    toks, comm = users(cfg.vocab_size)
    emb = embed(M.init_model(cfg, 0, device="cpu"), toks)
    h = make_hyperplanes(LshParams(d=emb.shape[1], k=5, L=4, seed=2),
                         device="cpu")
    lsh, store, engine = port_index(emb, h)
    ex = np.arange(NQ)
    r = engine.search(emb[:NQ], m=M_TOP, exclude=ex)
    assert community_share(r.ids, comm) > 0.6
    rt = IndexRuntime(RuntimeConfig(params=lsh, variant="cnb", m=M_TOP,
                                    use_kernels=True, fused="on"),
                      device="cpu")
    ids, scores, _ = rt.search(h, store, emb[:NQ], exclude=ex)
    assert topk_swaps(r.scores, r.ids, scores.numpy(), ids.numpy(),
                      tol=1e-5) == 0
    assert engine.contains(emb, np.arange(N_USERS)).all()
