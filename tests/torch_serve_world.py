"""One serving world in both packages, for the serving parity tests.

`make_world` builds the reference tests' world (tests/test_serve.py,
tests/test_pipeline.py: 400 unit vectors, D = 16, k = 5, L = 3, C = 32)
with the JAX package, and carries the hyperplanes, store and corpus
across to the port with `repro_torch.convert`, so both engines index the
same state.  `store_update` builds one write epoch's update in both
packages from the same drifted vectors.  Not collected by pytest; the
test files import it.
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import DenseCorpus as JCorpus
from repro.core import EngineConfig as JEngineConfig
from repro.core import LshEngine as JEngine
from repro.core import LshParams as JParams
from repro.core import make_hyperplanes as j_make_hyperplanes
from repro.core.hashing import sketch_codes_batched as j_sketch_batched
from repro.core.store import build_store_host as j_build_store_host
from repro.core.store import insert_batch as j_insert_batch
from repro_torch import convert
from repro_torch.core import EngineConfig, LshEngine, LshParams
from repro_torch.core.store import insert_batch

K, L, D, M = 5, 3, 16, 8


def make_world(n=400, seed=0, capacity=32, variant="cnb", payload=False):
    """Namespace of emb (host [n, D]), the JAX engine `jeng` and the
    port's engine `teng` (on the CPU) over the same state."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    jparams = JParams(d=D, k=K, L=L, seed=seed + 1)
    jh = j_make_hyperplanes(jparams)
    codes = j_sketch_batched(jnp.asarray(emb), jh)
    jstore = j_build_store_host(codes, jparams.num_buckets,
                                capacity=capacity,
                                payload=emb if payload else None)
    jeng = JEngine(jparams, jh, jstore, JCorpus(jnp.asarray(emb)), None,
                   JEngineConfig(variant=variant))
    teng = LshEngine(
        LshParams(d=D, k=K, L=L, seed=seed + 1),
        convert.hyperplanes_from(jh, device="cpu"),
        convert.store_from(jstore, device="cpu"),
        convert.corpus_from(emb, device="cpu"), None,
        EngineConfig(variant=variant), device="cpu")
    return types.SimpleNamespace(emb=emb, jeng=jeng, teng=teng, jh=jh)


def store_update(w, seed, epoch):
    """One churn write epoch in both packages: drifted vectors, the store
    rebuilt from them, and a no-op insert stamped `epoch` (bumps the
    generation past any earlier store's).  Returns (jax kwargs, port
    kwargs, vecs)."""
    rng = np.random.default_rng(seed)
    vecs = (w.emb + 0.05 * rng.standard_normal(w.emb.shape)).astype(
        np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    codes = j_sketch_batched(jnp.asarray(vecs), w.jh)
    jstore = j_build_store_host(codes, 1 << K, capacity=32)
    tstore = convert.store_from(jstore, device="cpu")
    jstore = j_insert_batch(jstore, jnp.arange(0, dtype=jnp.int32),
                            jnp.zeros((0, L), jnp.uint32), jnp.int32(epoch))
    tstore = insert_batch(tstore, torch.arange(0, dtype=torch.int32),
                          torch.zeros((0, L), dtype=torch.int32), epoch)
    jkw = dict(store=jstore, corpus=JCorpus(jnp.asarray(vecs)))
    tkw = dict(store=tstore, corpus=convert.corpus_from(vecs, device="cpu"))
    return jkw, tkw, vecs
