"""The paper's sparse OSN workload on the port, against the JAX package.

Two worlds: `tests/test_system.py`'s `tiny_osn` (`osn.tiny_spec()`:
2 000 users, 512 interests, k = 6; capacity 128), and a 3 000-user cut
of LIVEJOURNAL_S at its full width (24 576 interests, k = 11; capacity
256); L = 4, hyperplane seed 7.  JAX draws the hyperplanes with
`threefry_partitionable` off (the mode of the goldens) and builds the
store; both cross to the port through `repro_torch.convert`, and the
corpus is the port's own `osn.generate`, equal to JAX's bit for bit.
Then:

  * the query codes agree (a flip would have to lie within the 1e-5 band
    of a near-zero projection; none does here);
  * `LshEngine.search` over the `SparseCorpus` gives JAX's ids for lsh /
    layered / nb / cnb under the near-tie rule of `torch_parity_rules.py`
    (swaps within 1e-6 in score, counted: none on either world), and
    recall@10 / NCS@10 within 1e-6 of JAX's against the same ideal sets;
  * `LshEngine.contains` equals JAX's exactly;
  * the port's own pipeline (its generator, hyperplanes, sketch, store,
    engine and oracle) holds `test_system.py`'s two assertions: CNB beats
    LSH at equal messages, and the success probability tracks Prop. 1/4;
  * `use_kernels=True` with a sparse corpus raises, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JEngineConfig
from repro.core import LshEngine as JEngine
from repro.core import LshParams as JParams
from repro.core import make_hyperplanes as j_make_hyperplanes
from repro.core import metrics as jmetrics
from repro.core import paper_topology as j_paper_topology
from repro.core.corpus import exact_topk_sparse as j_exact_topk_sparse
from repro.core.corpus import sparse_densify_host as j_sparse_densify_host
from repro.core.hashing import sketch_codes as j_sketch_codes
from repro.core.hashing import sketch_codes_batched as j_sketch_codes_batched
from repro.core.store import build_store_host as j_build_store_host
from repro.data import osn as josn
from repro_torch import convert
from repro_torch.core import analysis, hashing, metrics
from repro_torch.core.can import paper_topology
from repro_torch.core.corpus import exact_topk_sparse, sparse_densify_host
from repro_torch.core.engine import EngineConfig, LshEngine
from repro_torch.core.hashing import LshParams, make_hyperplanes
from repro_torch.core.runtime import IndexRuntime, RuntimeConfig
from repro_torch.core.store import build_store_host
from repro_torch.data import osn
from torch_parity_rules import flips_outside_band, topk_swaps

K_L, SEED, M, NQ = 4, 7, 10, 48
VARIANTS = ["lsh", "layered", "nb", "cnb"]
# world -> (its spec from an osn module, bucket capacity)
WORLDS = {
    "tiny_osn": (lambda o: o.tiny_spec(), 128),
    "livejournal_3000": (lambda o: dataclasses.replace(o.LIVEJOURNAL_S,
                                                       num_users=3000), 256),
}


def goldens_prng():
    mode = getattr(jax, "threefry_partitionable", None)
    return contextlib.nullcontext() if mode is None else mode(False)


def drop_self(scores, ids, qidx, m):
    """The ideal top-m of each query with its own id removed, from a
    top-(m+1) oracle result."""
    keep_s = np.empty((len(qidx), m), np.float32)
    keep_i = np.empty((len(qidx), m), np.int32)
    for i, q in enumerate(qidx):
        mask = ids[i] != q
        keep_s[i] = scores[i][mask][:m]
        keep_i[i] = ids[i][mask][:m]
    return keep_s, keep_i


@pytest.fixture(scope="module", params=list(WORLDS))
def world(request):
    make_spec, cap = WORLDS[request.param]
    spec = make_spec(josn)
    jc = josn.generate(spec)
    jparams = JParams(d=spec.num_interests, k=spec.k, L=K_L, seed=SEED)
    with goldens_prng():
        jh = j_make_hyperplanes(jparams)
    dense = j_sparse_densify_host(jc, np.arange(jc.n))
    jst = j_build_store_host(j_sketch_codes_batched(jnp.asarray(dense), jh),
                             jparams.num_buckets, capacity=cap)
    qidx = np.arange(NQ)
    qd = dense[qidx] / np.maximum(
        np.linalg.norm(dense[qidx], axis=1, keepdims=True), 1e-12)
    ideal_s, ideal_i = drop_self(*j_exact_topk_sparse(jc, qd, M + 1), qidx, M)
    return dict(
        spec=spec, cap=cap, jc=jc, jparams=jparams, jh=jh, jst=jst,
        qidx=qidx, qd=qd, ideal_s=ideal_s, ideal_i=ideal_i,
        params=LshParams(d=spec.num_interests, k=spec.k, L=K_L, seed=SEED),
        corpus=osn.generate(make_spec(osn), device="cpu"),
        h=convert.hyperplanes_from(jh, device="cpu"),
        store=convert.store_from(jst, device="cpu"),
    )


def test_query_codes_match_jax(world):
    """Checked before any id, so that a sign flip shows as a flip: flips
    are allowed only within the near-zero band, and none occurs here
    (the engine tests below compare ids of every query)."""
    w = world
    want = np.array(j_sketch_codes(jnp.asarray(w["qd"]), w["jh"]))
    got = hashing.sketch_codes(torch.from_numpy(w["qd"]), w["h"])
    want_t = torch.from_numpy(want.view(np.int32))
    assert flips_outside_band(torch.from_numpy(w["qd"]), w["h"], got,
                              want_t) == 0
    assert torch.equal(got, want_t)
    # and the corpus codes through the port's batched sketch (plain
    # version on the CPU), densified 512 rows at a time
    codes = hashing.sketch_codes_batched(w["corpus"], w["h"], batch=512)
    flat = convert.store_from(
        build_store_host(codes, w["params"].num_buckets, w["cap"],
                         device="cpu"),
        device="cpu")
    assert torch.equal(flat.ids, w["store"].ids)


@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_matches_jax(world, variant):
    w = world
    topo_j, topo_t = j_paper_topology(w["spec"].k), paper_topology(
        w["spec"].k)
    jr = JEngine(w["jparams"], w["jh"], w["jst"], w["jc"], topo_j,
                 JEngineConfig(variant=variant)).search(
        jnp.asarray(w["qd"]), m=M, exclude=w["qidx"])
    tr = LshEngine(w["params"], w["h"], w["store"], w["corpus"], topo_t,
                   EngineConfig(variant=variant), device="cpu").search(
        w["qd"], m=M, exclude=w["qidx"])
    swaps = topk_swaps(jr.scores, jr.ids, tr.scores, tr.ids)
    assert swaps <= 2, f"{variant}: {swaps} near-tie swaps"  # 0 seen
    for fn, a, b in ((jmetrics.recall_at_m, tr.ids, jr.ids),
                     (jmetrics.ncs_at_m, tr.scores, jr.scores)):
        ideal = w["ideal_i"] if fn is jmetrics.recall_at_m else w["ideal_s"]
        port_fn = getattr(metrics, fn.__name__)
        assert abs(port_fn(a, ideal) - fn(b, ideal)) <= 1e-6
    assert (tr.cost.messages, tr.cost.nodes_contacted) == (
        jr.cost.messages, jr.cost.nodes_contacted)
    np.testing.assert_allclose(tr.cost.vectors_searched,
                               jr.cost.vectors_searched, rtol=1e-6)


@pytest.mark.parametrize("variant", ["lsh", "nb", "cnb"])
def test_contains_matches_jax_exactly(world, variant):
    w = world
    # each query's top non-self neighbour, and ids no bucket holds
    targets = np.concatenate([w["ideal_i"][:, 0], np.full(4, 10**6)])
    q = np.concatenate([w["qd"], w["qd"][:4]])
    want = JEngine(w["jparams"], w["jh"], w["jst"], w["jc"], None,
                   JEngineConfig(variant=variant)).contains(
        jnp.asarray(q), targets)
    got = LshEngine(w["params"], w["h"], w["store"], w["corpus"], None,
                    EngineConfig(variant=variant), device="cpu").contains(
        q, targets)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not got[-4:].any()


def test_runtime_sparse_corpus_equals_engine(world):
    """`IndexRuntime.search(corpus=SparseCorpus)` is the engine's path."""
    w = world
    rt = IndexRuntime(RuntimeConfig(params=w["params"], variant="cnb", m=M),
                      device="cpu")
    ids, sc, stats = rt.search(w["h"], w["store"], w["qd"],
                               corpus=w["corpus"], exclude=w["qidx"])
    r = LshEngine(w["params"], w["h"], w["store"], w["corpus"], None,
                  EngineConfig(variant="cnb"), device="cpu").search(
        w["qd"], m=M, exclude=w["qidx"])
    assert int(stats) == 0
    np.testing.assert_array_equal(ids.numpy(), r.ids)
    np.testing.assert_array_equal(sc.numpy(), r.scores)


def test_use_kernels_with_sparse_corpus_raises(world):
    w = world
    with pytest.raises(ValueError, match="use_kernels"):
        LshEngine(w["params"], w["h"], w["store"], w["corpus"], None,
                  EngineConfig(use_kernels=True), device="cpu")


# -- the port's own pipeline: tests/test_system.py's two assertions -------


@pytest.fixture(scope="module")
def port_osn():
    spec = osn.tiny_spec()
    corpus = osn.generate(spec, device="cpu")
    params = LshParams(d=spec.num_interests, k=spec.k, L=4, seed=7)
    h = make_hyperplanes(params, device="cpu")
    dense = sparse_densify_host(corpus, np.arange(corpus.n))
    codes = hashing.sketch_codes_batched(torch.from_numpy(dense), h)
    store = build_store_host(codes, params.num_buckets, capacity=128,
                             device="cpu")
    return spec, corpus, params, h, dense, store


def test_paper_headline_cnb_beats_lsh_at_equal_cost(port_osn):
    spec, corpus, params, h, dense, store = port_osn
    topo = paper_topology(spec.k)
    qidx = np.arange(NQ)
    qd = dense[qidx] / np.maximum(
        np.linalg.norm(dense[qidx], axis=1, keepdims=True), 1e-12)
    s, i = exact_topk_sparse(corpus, qd, M + 1)
    keep_s, keep_i = drop_self(s.numpy(), i.numpy(), qidx, M)
    results = {}
    for variant in ("lsh", "cnb"):
        r = LshEngine(params, h, store, corpus, topo,
                      EngineConfig(variant=variant), device="cpu").search(
            qd, m=M, exclude=qidx)
        results[variant] = dict(
            recall=metrics.recall_at_m(r.ids, keep_i),
            ncs=metrics.ncs_at_m(r.scores, keep_s),
            messages=r.cost.messages,
        )
    assert results["cnb"]["messages"] == results["lsh"]["messages"]
    assert results["cnb"]["recall"] > results["lsh"]["recall"]
    assert results["cnb"]["ncs"] >= results["lsh"]["ncs"] - 1e-9


def test_success_probability_tracks_analysis(port_osn):
    spec, corpus, params, h, dense, store = port_osn
    nq = 200
    rng = np.random.default_rng(3)
    qidx = rng.choice(corpus.n, nq, replace=False)
    qd = dense[qidx] / np.maximum(
        np.linalg.norm(dense[qidx], axis=1, keepdims=True), 1e-12)
    s, i = exact_topk_sparse(corpus, qd, 2)
    s, i = s.numpy(), i.numpy()
    # top non-self result
    y = np.where(i[:, 0] == qidx, i[:, 1], i[:, 0])
    y_sim = np.where(i[:, 0] == qidx, s[:, 1], s[:, 0])
    for variant, spf in (("lsh", analysis.sp_lsh),
                         ("nb", analysis.sp_nearbucket)):
        found = LshEngine(params, h, store, corpus, paper_topology(spec.k),
                          EngineConfig(variant=variant),
                          device="cpu").contains(qd, y)
        s_ang = analysis.angular_from_cosine(np.clip(y_sim, 0, 1))
        expected = spf(s_ang, params.k, params.L)
        assert abs(found.mean() - expected.mean()) < 0.15, (
            variant, found.mean(), expected.mean())
        _, frac, counts = metrics.success_probability_by_interval(found,
                                                                  y_sim)
        assert counts.sum() == nq
