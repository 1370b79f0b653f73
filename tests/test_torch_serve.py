"""`repro_torch.serve`'s frontend, backend, cache and telemetry against the
JAX package (`repro.serve`), on the CPU.

The invariants of tests/test_serve.py, held on the port, and the two
packages fed the same submits on the same state (tests/torch_serve_world
.py carries JAX's hyperplanes, store and corpus across):

  * served ids equal JAX's under the near-tie rule of
    tests/torch_parity_rules.py, and equal the port's own
    `engine.search` exactly, cache on and off;
  * the pow-2 dispatch grid bounds the distinct dispatch shapes (the
    port's `traces`, the count a jit would retrace on) by 7;
  * ring-full pushback, admission shedding and the cache bypass of a
    full ring count as JAX's do;
  * `QueryCache` keys, LRU and generation counters equal JAX's; m is in
    the key; nothing stale is served after a generation bump, a
    corpus-only update or a topology swap;
  * `ServeStats` fed the same events summarises as JAX's does;
  * the mesh backend on a 1-node and a 4-node zone mesh equals JAX's
    (1, 1) mesh backend and the port's own 1-node results.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core.runtime import IndexRuntime as JRuntime
from repro.core.runtime import RuntimeConfig as JConfig
from repro.core.runtime import reshard as j_reshard
from repro.serve import FrontendConfig as JFrontendConfig
from repro.serve import QueryCache as JQueryCache
from repro.serve import RetrievalFrontend as JFrontend
from repro.serve import RuntimeBackend as JBackend
from repro.serve import ServeStats as JServeStats
from repro.serve import dispatch_pad as j_dispatch_pad
from repro.serve import pow2_pad as j_pow2_pad
from repro_torch.core import costmodel
from repro_torch.core.corpus import DenseCorpus
from repro_torch.core.runtime import IndexRuntime, RuntimeConfig, reshard
from repro_torch.core.store import expire, insert_batch
from repro_torch.launch.mesh import make_zone_mesh
from repro_torch.serve import (
    ADMIT_REJECT, RING_FULL, FrontendConfig, QueryCache, RetrievalFrontend,
    RuntimeBackend, ServeStats, SubmitReject, dispatch_pad, pow2_pad,
)
from torch_parity_rules import topk_swaps
from torch_serve_world import M, make_world


def _fe(backend, **kw):
    kw.setdefault("m", M)
    kw.setdefault("max_batch", 16)
    kw.setdefault("queue_capacity", 64)
    return RetrievalFrontend(backend, FrontendConfig(**kw))


def _jfe(backend, **kw):
    kw.setdefault("m", M)
    kw.setdefault("max_batch", 16)
    kw.setdefault("queue_capacity", 64)
    return JFrontend(backend, JFrontendConfig(**kw))


# -- bit-identity with the engines --------------------------------------------


@pytest.mark.parametrize("cache", [False, True])
def test_frontend_matches_jax_frontend_and_engine(cache):
    w = make_world()
    fe = _fe(RuntimeBackend(w.teng), cache=cache)
    jfe = _jfe(JBackend(w.jeng), cache=cache)
    q, ex = w.emb[:50], np.arange(50)
    ids, scores = fe.search(q, exclude=ex)
    jids, jscores = jfe.search(q, exclude=ex)
    assert topk_swaps(jscores, jids, scores, ids) == 0
    ref = w.teng.search(q, m=M, exclude=ex)
    np.testing.assert_array_equal(ids, ref.ids)
    np.testing.assert_array_equal(scores, ref.scores)
    assert fe.stats.summary()["batches"] == jfe.stats.summary()["batches"]


def test_repeat_queries_hit_cache_and_stay_identical():
    w = make_world()
    fe = _fe(RuntimeBackend(w.teng), cache=True)
    q = w.emb[:24]
    ids1, sc1 = fe.search(q)
    ids2, sc2 = fe.search(q)
    np.testing.assert_array_equal(ids1, ids2)
    np.testing.assert_array_equal(sc1, sc2)
    assert fe.stats.cache_hits == 24 and fe.stats.completed == 48
    # a cache hit costs zero overlay messages: the measured average halves
    full = fe.backend.cost().messages
    assert fe.stats.messages_per_query == pytest.approx(full / 2)
    assert dataclasses.asdict(fe.backend.cost()) == dataclasses.asdict(
        JBackend(w.jeng).cost())


# -- the pow-2 dispatch grid --------------------------------------------------


def test_pow2_and_dispatch_pad_match_jax():
    for n in range(0, 70):
        assert pow2_pad(n) == j_pow2_pad(n)
        assert pow2_pad(n, floor=8) == j_pow2_pad(n, floor=8)
        for mult in (1, 3, 4):
            assert dispatch_pad(n, mult) == j_dispatch_pad(n, mult)
    assert len({dispatch_pad(n, 3) for n in range(1, 65)}) <= 7


def test_pow2_padding_bounds_dispatch_shapes():
    """`traces` counts distinct dispatch shapes: at most 7 for any
    arrival-size mix up to 64, and no more than the pads dispatched."""
    w = make_world()
    backend = RuntimeBackend(w.teng)
    fe = _fe(backend, max_batch=64, queue_capacity=128, cache=True)
    rng = np.random.default_rng(3)
    for n in [1, 2, 3, 5, 7, 11, 13, 17, 23, 31, 43, 57, 64, 6, 29]:
        fe.search(w.emb[rng.integers(0, w.emb.shape[0], size=n)])
    assert 1 <= backend.traces <= 7
    assert fe.stats.batches >= backend.traces


def test_sketch_codes_match_jax_and_count_shapes():
    w = make_world()
    backend, jbackend = RuntimeBackend(w.teng), JBackend(w.jeng)
    for pad in (1, 2, 4, 8, 4):
        q = np.zeros((pad, w.emb.shape[1]), np.float32)
        q[:] = w.emb[:pad] if pad <= 8 else 0
        got = backend.sketch_codes(q)
        want = jbackend.sketch_codes(q)
        np.testing.assert_array_equal(got.view(np.uint32), want)
    assert backend.sketch_traces == jbackend.sketch_traces == 4


# -- admission control --------------------------------------------------------


def test_ring_full_pushback_is_retryable():
    w = make_world()
    fe = _fe(RuntimeBackend(w.teng), max_batch=4, queue_capacity=8,
             cache=False)
    tickets = [fe.submit(w.emb[i]) for i in range(12)]
    ok = [t for t in tickets if not isinstance(t, SubmitReject)]
    assert len(ok) == 8
    assert all(t is RING_FULL and t.retryable for t in tickets[8:])
    assert not any(tickets[8:])  # falsy, so `if not ticket` still works
    assert fe.stats.ring_full == 4
    assert fe.stats.rejected == 0 and fe.stats.accepted == 8
    fe.step()  # drains max_batch rows: the retry is admitted
    t = fe.submit(w.emb[8])
    assert not isinstance(t, SubmitReject)
    fe.flush()
    assert fe.stats.completed == 9
    assert all(fe.poll(k) is not None for k in ok + [t])


def test_admission_limit_sheds_with_admit_reject():
    w = make_world()
    fe = _fe(RuntimeBackend(w.teng), max_batch=4, queue_capacity=16,
             cache=False, admit_limit=6)
    jfe = _jfe(JBackend(w.jeng), max_batch=4, queue_capacity=16,
               cache=False, admit_limit=6)
    tickets = [fe.submit(w.emb[i]) for i in range(9)]
    jtickets = [jfe.submit(w.emb[i]) for i in range(9)]
    assert [getattr(t, "reason", "ticket") for t in tickets] == \
        [getattr(t, "reason", "ticket") for t in jtickets]
    ok = [t for t in tickets if not isinstance(t, SubmitReject)]
    assert len(ok) == 6
    assert all(t is ADMIT_REJECT and not t.retryable for t in tickets[6:])
    assert fe.stats.rejected == 3 and fe.stats.ring_full == 0
    fe.flush()
    assert fe.stats.completed == 6
    assert all(fe.poll(t) is not None for t in ok)
    with pytest.raises(ValueError, match="admit_limit"):
        FrontendConfig(admit_limit=0)
    with pytest.raises(ValueError, match="pipeline_depth"):
        FrontendConfig(pipeline_depth=0)


def test_cache_hit_bypasses_full_ring():
    w = make_world()
    fe = _fe(RuntimeBackend(w.teng), max_batch=4, queue_capacity=4,
             cache=True)
    ids0, _ = fe.search(w.emb[:1])
    fillers = [fe.submit(w.emb[10 + i]) for i in range(4)]
    assert all(not isinstance(t, SubmitReject) for t in fillers)
    assert isinstance(fe.submit(w.emb[30]), SubmitReject)  # really full
    t_hit = fe.submit(w.emb[0])  # the primed query: served NOW
    assert not isinstance(t_hit, SubmitReject)
    got = fe.poll(t_hit)
    np.testing.assert_array_equal(got[0], ids0[0])
    assert fe.stats.cache_hits == 1 and fe.pending == 4
    fe.flush()


# -- the query cache ----------------------------------------------------------


def test_qcache_lru_and_generation_match_jax():
    q = np.ones((4,), np.float32)
    q2 = q.copy()
    q2[0] = 0.5
    for sketch_only in (False, True):
        caches = (QueryCache(capacity=2, sketch_only=sketch_only),
                  JQueryCache(capacity=2, sketch_only=sketch_only))
        trace = []
        for c in caches:
            k1 = c.key([1, 2, 3], -2, q)
            k2 = c.key([1, 2, 4], -2, q2)
            k3 = c.key([9, 9, 9], -2, q, m=4)
            ids = np.arange(3)
            c.put(k1, ids, ids, generation=5)
            c.put(k2, ids, ids, generation=5)
            got = [c.get(k1, 5) is not None]   # hit refreshes recency
            c.put(k3, ids, ids, generation=5)  # evicts k2 (LRU)
            got += [c.get(k2, 5) is None, c.get(k1, 6) is None,
                    c.get(k1, 5) is None, len(c)]
            trace.append((k1, k2, k3, got, c.hits, c.misses,
                           c.stale_evictions, c.lru_evictions))
        assert trace[0] == trace[1]
    c = QueryCache(capacity=2)
    assert c.key([1, 2, 3], -2, q) != c.key([1, 2, 3], 7, q)
    assert c.key([1, 2, 3], -2, q) != c.key([1, 2, 3], -2, q2)
    assert QueryCache(sketch_only=True).key([1, 2, 3], -2, q) == \
        QueryCache(sketch_only=True).key([1, 2, 3], -2, q2)
    with pytest.raises(ValueError, match="capacity"):
        QueryCache(capacity=0)


def test_cache_key_includes_m():
    c = QueryCache()
    q = np.ones((4,), np.float32)
    assert c.key([1, 2, 3], -2, q, m=4) != c.key([1, 2, 3], -2, q, m=8)
    w = make_world()
    backend = RuntimeBackend(w.teng)
    fe4 = _fe(backend, m=4, cache=True)
    q = w.emb[:8]
    ids4, _ = fe4.search(q)
    assert ids4.shape[1] == 4
    fe8 = _fe(backend, cache=True)
    fe8.cache = fe4.cache  # one result cache behind two serving m's
    ids8, _ = fe8.search(q)
    np.testing.assert_array_equal(ids8, w.teng.search(q, m=M).ids)
    ids4b, _ = fe4.search(q)
    np.testing.assert_array_equal(ids4b, ids4)


def test_cache_never_serves_stale_after_churn():
    w = make_world(n=200)
    backend = RuntimeBackend(w.teng)
    fe = _fe(backend, cache=True)
    q = w.emb[:16]
    fe.search(q)
    fe.search(q)
    assert fe.stats.cache_hits == 16
    # write epoch: near-duplicates of the queries under new ids
    n = w.emb.shape[0]
    store = w.teng.store
    codes = backend.sketch_codes(q)
    store = insert_batch(store, torch.arange(n, n + 16, dtype=torch.int32),
                         torch.from_numpy(codes), 1)
    backend.update(store, DenseCorpus(torch.from_numpy(
        np.concatenate([w.emb, q]))))
    ids3, _ = fe.search(q)
    # the duplicate (cosine 1.0) appears right after the query's own id
    # in every row: a stale entry could not hold ids >= n
    assert np.all(ids3[:, 0] == np.arange(16))
    assert np.all(ids3[:, 1] == np.arange(n, n + 16))
    assert fe.cache.stale_evictions == 16
    store = expire(store, 100, ttl=1)
    backend.update(store)
    ids4, _ = fe.search(q)
    assert np.all(ids4 == -1)


def test_corpus_only_update_invalidates_cache():
    w = make_world(n=100)
    backend = RuntimeBackend(w.teng)
    fe = _fe(backend, cache=True)
    q = w.emb[:4]
    fe.search(q)
    gen0 = backend.generation
    emb2 = np.tile(w.emb[0], (w.emb.shape[0], 1)).astype(np.float32)
    backend.update(w.teng.store, DenseCorpus(torch.from_numpy(emb2)))
    assert backend.generation == gen0 + 1
    ids2, sc2 = fe.search(q)
    assert fe.cache.stale_evictions == 4
    live = ids2[0] >= 0
    np.testing.assert_allclose(sc2[0][live], 1.0, atol=1e-6)


# -- telemetry ----------------------------------------------------------------

EVENTS = [("submit", True), ("submit", True), ("submit", False),
          ("ring_full",), ("queue", 12.5), ("queue", 40.0),
          ("batch", 2, 6, 3), ("done", 100.0, False), ("done", 300.0, False),
          ("done", 5.0, True), ("batch", 1, 0, 0), ("done", 80.0, False)]


def _feed(stats, cost):
    for ev in EVENTS:
        if ev[0] == "submit":
            stats.record_submit(ev[1])
        elif ev[0] == "ring_full":
            stats.record_ring_full()
        elif ev[0] == "queue":
            stats.record_queue_time(ev[1])
        elif ev[0] == "batch":
            stats.record_batch(ev[1], ev[2], ev[3], cost)
        else:
            stats.record_done(ev[1], hit=ev[2])
    return stats


@pytest.mark.parametrize("window", [65536, 3])
def test_telemetry_summaries_equal_jax(window):
    from repro.core import costmodel as jcostmodel

    got = _feed(ServeStats(latency_window=window),
                costmodel.table1("cnb", k=6, L=4, bucket_size=2.0))
    want = _feed(JServeStats(latency_window=window),
                 jcostmodel.table1("cnb", k=6, L=4, bucket_size=2.0))
    g, s = got.summary(), want.summary()
    assert g.keys() == s.keys()
    for key in g:
        if key != "qps":  # wall-clock: the two runs' own timings
            assert g[key] == s[key], key
    assert got.format_summary().split("qps=")[1].split("\n")[1:] == \
        want.format_summary().split("qps=")[1].split("\n")[1:]
    np.testing.assert_array_equal(got.latencies_us, want.latencies_us)


def test_telemetry_empty_summary_is_finite_and_publishes():
    from repro_torch.obs import Registry

    s = ServeStats()
    out = s.summary()
    assert all(np.isfinite(v) for v in out.values() if isinstance(v, float))
    assert out["qps"] == 0.0 and out["p99_us"] == 0.0
    reg = Registry()
    _feed(s, None).publish(reg, cell="x")
    assert reg.value("serve_completed", cell="x") == 4
    assert reg.value("serve_rejected", cell="x") == 1


# -- the mesh backend ---------------------------------------------------------


def _mesh_backends(w, n, single_mesh, cap_factor=2.0):
    """(port backend on an n-node zone mesh, JAX backend on the (1, 1)
    mesh) over the payload store, m + 1 headroom."""
    rt = IndexRuntime(RuntimeConfig(params=w.teng.params, variant="cnb",
                                    m=M + 1, n_nodes=n,
                                    cap_factor=cap_factor),
                      mesh=make_zone_mesh(n, device="cpu"))
    cache = rt.refresh_cache(w.teng.store)
    tb = RuntimeBackend(rt, hyperplanes=w.teng.hyperplanes,
                        store=w.teng.store, cache=cache)
    jrt = JRuntime(jdist.DistConfig(params=w.jeng.params, n_shards=1,
                                    variant="cnb", m=M + 1,
                                    routing="alltoall",
                                    cap_factor=cap_factor),
                   mesh=single_mesh)
    jb = JBackend(jrt, hyperplanes=w.jeng.hyperplanes,
                  store=jdist.shard_store(single_mesh, w.jeng.store))
    return tb, jb


@pytest.mark.parametrize("n", [1, 4])
def test_mesh_backend_matches_jax_mesh_and_one_node(n, single_mesh):
    w = make_world(payload=True)
    tb, jb = _mesh_backends(w, n, single_mesh)
    assert tb.min_batch == n and tb.max_m == M
    fe = _fe(tb, cache=True)
    jfe = _jfe(jb, cache=True)
    q, ex = w.emb[:20], np.arange(20)
    ids, sc = fe.search(q, exclude=ex)
    jids, jsc = jfe.search(q, exclude=ex)
    assert topk_swaps(jsc, jids, sc, ids) == 0
    one = _fe(RuntimeBackend(w.teng), cache=False).search(q, exclude=ex)[0]
    np.testing.assert_array_equal(ids, one)
    ids2, _ = fe.search(q, exclude=ex)
    np.testing.assert_array_equal(ids2, ids)
    assert fe.stats.cache_hits == 20
    assert fe.stats.dropped_probes == jfe.stats.dropped_probes == 0
    with pytest.raises(ValueError, match="headroom"):
        tb.dispatch(np.zeros((n, q.shape[1]), np.float32),
                    np.full(n, -2, np.int32), M + 1)
    with pytest.raises(ValueError, match="unsupported"):
        _fe(tb, m=M + 1)


def test_mesh_backend_surfaces_dropped_probes(single_mesh):
    w = make_world(payload=True)
    tb, jb = _mesh_backends(w, 1, single_mesh, cap_factor=0.25)
    fe = _fe(tb, cache=False)
    jfe = _jfe(jb, cache=False)
    fe.search(w.emb[:16])
    jfe.search(w.emb[:16])
    assert fe.stats.dropped_probes == jfe.stats.dropped_probes > 0
    assert fe.stats.summary()["dropped_probes"] == fe.stats.dropped_probes


def test_backend_guards_match_jax(single_mesh):
    w = make_world(payload=True)
    tb, _ = _mesh_backends(w, 1, single_mesh)
    with pytest.raises(ValueError, match="1-node only"):
        tb.update(w.teng.store, corpus=w.teng.corpus)
    local = RuntimeBackend(w.teng)
    with pytest.raises(ValueError, match="mesh runtimes"):
        local.update(w.teng.store, cache=(None, None))
    with pytest.raises(ValueError, match="hyperplanes= and store="):
        RuntimeBackend(w.teng.runtime)
    with pytest.raises(TypeError, match="LshEngine or IndexRuntime"):
        RuntimeBackend(object())
    with pytest.raises(ValueError, match="replicas/live"):
        RuntimeBackend(w.teng.runtime, hyperplanes=w.teng.hyperplanes,
                       store=w.teng.store, live=[1])
    slot = RuntimeBackend(IndexRuntime(RuntimeConfig(
        params=w.teng.params, m=M + 1), device="cpu"),
        hyperplanes=w.teng.hyperplanes, store=w.teng.store)
    with pytest.raises(ValueError, match="built without a corpus"):
        slot.update(corpus=w.teng.corpus)


# -- live topology swaps ------------------------------------------------------


def _swap_world():
    w = make_world(payload=True)
    rcfg = RuntimeConfig(params=w.teng.params, variant="cnb", m=M + 1,
                         cap_factor=2.0)
    rt_local = IndexRuntime(rcfg, device="cpu")
    rt_mesh = IndexRuntime(rcfg, mesh=make_zone_mesh(1, device="cpu"))
    backend = RuntimeBackend(rt_local, hyperplanes=w.teng.hyperplanes,
                             store=w.teng.store)
    return w, backend, rt_local, rt_mesh


def test_topology_swap_bumps_generation_never_serves_stale(single_mesh):
    w, backend, rt_local, rt_mesh = _swap_world()
    fe = _fe(backend, cache=True)
    q, ex = w.emb[:20], np.arange(20)
    ids_pre, _ = fe.search(q, exclude=ex)
    np.testing.assert_array_equal(fe.search(q, exclude=ex)[0], ids_pre)
    assert fe.stats.cache_hits == 20
    gen0 = backend.generation
    rt2, store2, ev = reshard(rt_local, w.teng.store, runtime=rt_mesh)
    assert ev.handoff_bytes == 0
    fe.update_backend(runtime=rt2, store=store2)
    assert backend.generation > gen0 and backend.runtime is rt_mesh
    hits = fe.stats.cache_hits
    ids_post, _ = fe.search(q, exclude=ex)
    assert fe.stats.cache_hits == hits and fe.cache.stale_evictions >= 20
    np.testing.assert_array_equal(ids_post, ids_pre)
    np.testing.assert_array_equal(fe.search(q, exclude=ex)[0], ids_pre)
    assert fe.stats.cache_hits == hits + 20
    # and back: mesh -> 1 node; the same ids as JAX's swap to its mesh
    rt3, store3, _ = reshard(rt2, store2, runtime=rt_local)
    fe.update_backend(runtime=rt3, store=store3)
    ids_back, sc_back = fe.search(q, exclude=ex)
    np.testing.assert_array_equal(ids_back, ids_pre)
    jcfg = JConfig(params=w.jeng.params, variant="cnb", m=M + 1,
                   cap_factor=2.0)
    jrt, jst, _ = j_reshard(JRuntime(jcfg), w.jeng.store,
                            runtime=JRuntime(jcfg, mesh=single_mesh))
    jb = JBackend(JRuntime(jcfg), hyperplanes=w.jeng.hyperplanes,
                  store=w.jeng.store)
    jfe = _jfe(jb, cache=True)
    jfe.update_backend(runtime=jrt, store=jst)
    jids, jsc = jfe.search(q, exclude=ex)
    assert topk_swaps(jsc, jids, sc_back, ids_back) == 0
    assert backend.generation == jb.generation + 1  # one more swap here


def test_topology_swap_argument_guards():
    w, backend, rt_local, rt_mesh = _swap_world()
    with pytest.raises(ValueError, match="migrated store"):
        backend.update(runtime=rt_mesh)
    with pytest.raises(ValueError, match="runtime swap"):
        backend.update(w.teng.store, hyperplanes=w.teng.hyperplanes)
    ids_only = make_world(payload=False).teng.store
    with pytest.raises(ValueError, match="payload-carrying"):
        backend.update(runtime=rt_mesh, store=ids_only)
    fe = _fe(backend, max_batch=8, queue_capacity=32, cache=True)
    tight = IndexRuntime(dataclasses.replace(rt_local.cfg, m=M),
                         mesh=make_zone_mesh(1, device="cpu"))
    with pytest.raises(ValueError, match="headroom"):
        fe.update_backend(runtime=tight, store=w.teng.store)
    with pytest.raises(ValueError, match="update_backend"):
        fe.apply_update(runtime=rt_mesh, store=w.teng.store)
    # the failed swaps installed nothing: the backend still serves
    ids, _ = fe.search(w.emb[:4], exclude=np.arange(4))
    assert ids.shape == (4, M) and backend.runtime is rt_local


def test_replicated_backend_guards_and_liveness():
    w = make_world(payload=True)
    rt = IndexRuntime(RuntimeConfig(params=w.teng.params, variant="cnb",
                                    m=M + 1, n_nodes=4, cap_factor=4.0,
                                    replication=2),
                      mesh=make_zone_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="needs replicas="):
        RuntimeBackend(rt, hyperplanes=w.teng.hyperplanes,
                       store=w.teng.store)
    reps = rt.replicate_store(w.teng.store)
    b = RuntimeBackend(rt, hyperplanes=w.teng.hyperplanes,
                       store=w.teng.store,
                       cache=rt.refresh_cache(w.teng.store), replicas=reps)
    fe = _fe(b, cache=True)
    q, ex = w.emb[:16], np.arange(16)
    ids_live, _ = fe.search(q, exclude=ex)
    one = _fe(RuntimeBackend(w.teng), cache=False).search(q, exclude=ex)[0]
    np.testing.assert_array_equal(ids_live, one)
    gen = b.generation
    fe.update_backend(live=[1, 0, 1, 1])
    assert b.generation == gen + 1
    # node 1 down: its zone's rows read the replica on node 2 (and skip
    # the cache, which mirrors primaries only), as the runtime's own read
    ids_dead, _ = fe.search(q, exclude=ex)
    assert fe.cache.stale_evictions == 16 and fe.stats.cache_hits == 0
    want, _, _ = rt.search(w.teng.hyperplanes, w.teng.store, q,
                           cache=rt.refresh_cache(w.teng.store),
                           replicas=reps, live=[1, 0, 1, 1])
    keep = want.numpy() != ex[:, None]
    want = np.stack([r[k][:M] for r, k in zip(want.numpy(), keep)])
    np.testing.assert_array_equal(ids_dead, want)
