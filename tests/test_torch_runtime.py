"""The slice as a whole: `repro_torch`'s 1-node IndexRuntime and LshEngine
against the JAX package on the goldens world
(tests/goldens/make_goldens.py: N=1200, D=32, k=5, L=3, m=10).

  * the engine reproduces `engine_v1.npz` on all 9 (lsh/nb/cnb x
    full/p2/ranked3) cells: ids and contains bit for bit, scores to 1e-6,
    with and without `use_kernels`;
  * the runtime's payload path with `fused="on"` (the kernels' plain
    versions on CPU) equals `fused="off"` and JAX's staged runtime;
  * `score="hamming"` ids and scores equal JAX's 1-node hamming run;
  * insert / expire / payload_sync leave the store JAX's steps leave.

The goldens' hyperplanes come from JAX's PRNG with
`threefry_partitionable` off, the mode they were drawn in.
"""

from __future__ import annotations

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BucketStore as JStore
from repro.core import DenseCorpus as JCorpus
from repro.core import EngineConfig as JEngineConfig
from repro.core import LshEngine as JEngine
from repro.core import LshParams as JParams
from repro.core import make_hyperplanes as j_make_hyperplanes
from repro.core import packed as jpacked
from repro.core.hashing import sketch_codes_batched
from repro.core.runtime import IndexRuntime as JRuntime
from repro.core.runtime import RuntimeConfig as JConfig
from repro.core.store import build_store_host as j_build_store_host
from repro.core.store import make_store as j_make_store
from repro_torch import convert
from repro_torch.core import packed as tpacked
from repro_torch.core import runtime as truntime
from repro_torch.core.engine import EngineConfig, LshEngine
from repro_torch.core.hashing import LshParams
from repro_torch.core.runtime import IndexRuntime, RuntimeConfig
from repro_torch.core.store import make_store

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "engine_v1.npz")
N, D, K, L, M, NQ = 1200, 32, 5, 3, 10, 48
PROBE_CELLS = [
    ("full", dict()),
    ("p2", dict(num_probes=2)),
    ("ranked3", dict(num_probes=3, ranked_probes=True)),
]
CELLS = [(v, c, kw) for v in ("lsh", "nb", "cnb") for c, kw in PROBE_CELLS]
CELL_IDS = [f"{v}-{c}" for v, c, _ in CELLS]


def goldens_prng():
    """The PRNG mode the goldens' hyperplanes were drawn in: threefry
    not partitionable (the default before jax 0.5)."""
    mode = getattr(jax, "threefry_partitionable", None)
    return contextlib.nullcontext() if mode is None else mode(False)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    jparams = JParams(d=D, k=K, L=L, seed=23)
    with goldens_prng():
        jh = j_make_hyperplanes(jparams)
    codes = sketch_codes_batched(jnp.asarray(vecs), jh)
    jst = j_build_store_host(codes, jparams.num_buckets, capacity=64,
                             payload=vecs)
    jids = JStore(jst.ids, jst.timestamps, jst.write_ptr, None)
    w = dict(
        vecs=vecs, golden=dict(np.load(GOLDENS)), jparams=jparams, jh=jh,
        jst=jst, jids=jids, jcorpus=JCorpus(jnp.asarray(vecs)),
        jst_h=jpacked.pack_store_payload(jst, jh),
        params=LshParams(d=D, k=K, L=L, seed=23),
        h=convert.hyperplanes_from(jh, device="cpu"),
        st=convert.store_from(jst, device="cpu"),
        ids_only=convert.store_from(jids, device="cpu"),
        corpus=convert.corpus_from(vecs, device="cpu"),
    )
    w["st_h"] = convert.store_from(w["jst_h"], device="cpu")
    return w


def np_(x) -> np.ndarray:
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["staged", "kernels"])
@pytest.mark.parametrize("variant,cell,pkw", CELLS, ids=CELL_IDS)
def test_engine_reproduces_goldens(world, variant, cell, pkw, use_kernels):
    w = world
    eng = LshEngine(w["params"], w["h"], w["ids_only"], w["corpus"], None,
                    EngineConfig(variant=variant, use_kernels=use_kernels,
                                 **pkw), device="cpu")
    r = eng.search(w["vecs"][:NQ], m=M, exclude=np.arange(NQ))
    g = w["golden"]
    np.testing.assert_array_equal(r.ids, g[f"search_ids_{variant}_{cell}"])
    np.testing.assert_allclose(r.scores, g[f"search_scores_{variant}_{cell}"],
                               atol=1e-6)
    np.testing.assert_array_equal(eng.contains(w["vecs"][:NQ], g["targets"]),
                                  g[f"contains_{variant}_{cell}"])
    assert r.dropped_probes == 0 and r.cost.nodes_contacted > 0


def test_engine_message_simulation_matches_jax(world):
    w = world
    for variant in ("lsh", "nb"):
        jeng = JEngine(w["jparams"], w["jh"], w["jids"], w["jcorpus"], None,
                       JEngineConfig(variant=variant))
        teng = LshEngine(w["params"], w["h"], w["ids_only"], w["corpus"],
                         None, EngineConfig(variant=variant), device="cpu")
        q = w["vecs"][:NQ]
        assert teng.simulate_messages(q) == jeng.simulate_messages(
            jnp.asarray(q))


def test_runtime_corpus_path_matches_goldens(world):
    w = world
    rt = IndexRuntime(RuntimeConfig(params=w["params"], variant="cnb", m=M),
                      device="cpu")
    q = w["vecs"][:NQ]
    ids, _, stats = rt.search(w["h"], w["ids_only"], q, corpus=w["corpus"],
                              exclude=np.arange(NQ))
    assert int(stats) == 0
    np.testing.assert_array_equal(ids.numpy(),
                                  w["golden"]["search_ids_cnb_full"])
    hits, _ = rt.contains(w["h"], w["ids_only"], q, w["golden"]["targets"])
    np.testing.assert_array_equal(hits.numpy(),
                                  w["golden"]["contains_cnb_full"])


@pytest.mark.parametrize("variant,cell,pkw", CELLS, ids=CELL_IDS)
def test_runtime_payload_fused_matches_staged_and_jax(world, variant, cell,
                                                      pkw):
    w = world
    q, ex = w["vecs"][:NQ], np.arange(NQ)
    jrt = JRuntime(JConfig(params=w["jparams"], variant=variant, m=M,
                           fused="off", **pkw))
    wi, ws, wstats = jrt.search(w["jh"], w["jst"], q, exclude=ex)
    for fused in ("on", "off"):
        for use_kernels in (False, True):
            rt = IndexRuntime(RuntimeConfig(
                params=w["params"], variant=variant, m=M, fused=fused,
                use_kernels=use_kernels, **pkw), device="cpu")
            gi, gs, stats = rt.search(w["h"], w["st"], q, exclude=ex)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-6)
            assert stats.host() == wstats.host()


@pytest.mark.parametrize("variant,cell,pkw", CELLS, ids=CELL_IDS)
def test_runtime_hamming_equals_jax_exactly(world, variant, cell, pkw):
    w = world
    q = w["vecs"][:NQ]
    jrt = JRuntime(JConfig(params=w["jparams"], variant=variant, m=M,
                           score="hamming", fused="off", **pkw))
    wi, ws, _ = jrt.search(w["jh"], w["jst_h"], q)
    for fused in ("on", "off"):
        rt = IndexRuntime(RuntimeConfig(
            params=w["params"], variant=variant, m=M, score="hamming",
            fused=fused, use_kernels=fused == "on", **pkw), device="cpu")
        gi, gs, _ = rt.search(w["h"], w["st_h"], q)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("variant", ["lsh", "cnb"])
def test_runtime_contains_fused_matches_jax(world, variant):
    w = world
    q, tgt = w["vecs"][:NQ], w["golden"]["targets"]
    want, _ = JRuntime(JConfig(params=w["jparams"], variant=variant,
                               fused="off")).contains(w["jh"], w["jst"], q,
                                                      tgt)
    for fused in ("on", "off"):
        rt = IndexRuntime(RuntimeConfig(params=w["params"], variant=variant,
                                        fused=fused), device="cpu")
        got, _ = rt.contains(w["h"], w["ids_only"], q, tgt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("score", ["dot", "hamming"])
def test_runtime_insert_expire_sync_match_jax(world, score):
    w = world
    nv, cap = 300, 8  # small buckets: the insert overflows and evicts
    vecs = w["vecs"]
    jrt = JRuntime(JConfig(params=w["jparams"], variant="cnb", m=M,
                           score=score))
    trt = IndexRuntime(RuntimeConfig(params=w["params"], variant="cnb", m=M,
                                     score=score), device="cpu")
    if score == "dot":
        js = j_make_store(L, 1 << K, cap, payload_dim=D)
        ts = make_store(L, 1 << K, cap, payload_dim=D, device="cpu")
    else:
        W = tpacked.num_words(K, L)
        js = j_make_store(L, 1 << K, cap, payload_dim=W, dtype=jnp.uint32)
        ts = make_store(L, 1 << K, cap, payload_dim=W, dtype=torch.int32,
                        device="cpu")
    vid = np.arange(nv, dtype=np.int32)
    js = jrt.insert(w["jh"], js, vecs[:nv], vid, 3)
    ts = trt.insert(w["h"], ts, vecs[:nv], vid, 3)
    moved = np.roll(vecs[:nv], 1, axis=0)
    js = jrt.insert(w["jh"], js, moved[:100], vid[:100], 5)
    ts = trt.insert(w["h"], ts, moved[:100], vid[:100], 5)
    js = jrt.payload_sync(js, moved, hyperplanes=w["jh"])
    ts = trt.payload_sync(ts, moved, hyperplanes=w["h"])
    js = jrt.expire(js, 7, ttl=3)
    ts = trt.expire(ts, 7, ttl=3)
    for f in ("ids", "timestamps", "write_ptr"):
        np.testing.assert_array_equal(np_(getattr(ts, f)),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_array_equal(
        ts.payload.numpy().view(np.asarray(js.payload).dtype),
        np.asarray(js.payload))
    assert int(ts.generation) == int(js.generation) == 2 * L + 2


def test_fused_on_refuses_corpus_and_ids_only(world):
    w = world
    rt = IndexRuntime(RuntimeConfig(params=w["params"], fused="on"),
                      device="cpu")
    with pytest.raises(ValueError, match="fused='on' unsupported"):
        rt.search(w["h"], w["ids_only"], w["vecs"][:4], corpus=w["corpus"])
    with pytest.raises(ValueError, match="fused='on' unsupported"):
        rt.search(w["h"], w["ids_only"], w["vecs"][:4])


def test_mesh_runtime_not_ported(world):
    """The mesh runs (tests/test_torch_mesh.py) and so does replication
    (tests/test_torch_failure.py): a replicated config builds, one with
    more replicas than nodes is refused as the reference refuses it, and
    a mesh-sized config still needs its mesh."""
    p = world["params"]
    assert RuntimeConfig(params=p, n_nodes=2, replication=2).replication == 2
    with pytest.raises(ValueError, match="exceeds n_nodes"):
        RuntimeConfig(params=p, n_nodes=2, replication=3)
    with pytest.raises(ValueError, match="replication must be >= 1"):
        RuntimeConfig(params=p, replication=0)
    with pytest.raises(ValueError, match="needs a mesh"):
        IndexRuntime(RuntimeConfig(params=p, n_nodes=2), device="cpu")
    with pytest.raises(ValueError, match="1-node only"):
        truntime.search_kernel(
            RuntimeConfig(params=p),
            truntime.MeshCollectives(n=1, device=torch.device("cpu")), M,
            world["h"], world["st"].ids, None, None, None,
            torch.zeros(1, 1, D), exclude=torch.zeros(1, dtype=torch.int32))


def test_entry_points_need_card_or_cpu(world):
    if torch.cuda.is_available():
        pytest.skip("the no-card rule needs a host without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IndexRuntime(RuntimeConfig(params=world["params"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_store(1, 4, 4)
