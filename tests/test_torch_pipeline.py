"""Pipelined serving in `repro_torch.serve` (DESIGN.md Sec. 13): the
depth-K dispatch queue, out-of-order reap, the background churn writer
and open-loop load, on the CPU, against the JAX package.

The load-bearing invariant of tests/test_pipeline.py, held here
deterministically: pipelining changes WHEN work happens, never WHAT is
computed.  One fixed submit/step schedule, with churn updates installed
mid-flight or not, serves ids identical at depths 1, 2 and 4, cache on
or off, and equal to the JAX frontend's at depth 1 on the same schedule
(near-tie rule of tests/torch_parity_rules.py).  Also: the writer's
generation contract, the writer inline and threaded (with a stress run
of many epochs), the refusal of topology swaps, the dispatch-shape
budget with obs on, the queue metrics, `poisson_arrivals` equal to
JAX's array, the open loop's accounting, the max-qps-at-SLO sweep
beside JAX's, and the shadow-rescoring recall probe's ground truth.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

from repro.serve import FrontendConfig as JFrontendConfig
from repro.serve import RetrievalFrontend as JFrontend
from repro.serve import RuntimeBackend as JBackend
from repro.serve import max_qps_at_slo as j_max_qps_at_slo
from repro.serve import poisson_arrivals as j_poisson_arrivals
from repro_torch.obs import Observability
from repro_torch.serve import (
    ChurnWriter, FrontendConfig, RetrievalFrontend, RuntimeBackend,
    SubmitReject, max_qps_at_slo, poisson_arrivals, run_open_loop,
)
from torch_parity_rules import topk_swaps
from torch_serve_world import M, make_world, store_update


def _fe(backend, **kw):
    kw.setdefault("m", M)
    return RetrievalFrontend(backend, FrontendConfig(**kw))


def _drive_schedule(fe, w, *, churn, jax_side=False):
    """One fixed deterministic schedule: submit bursts of varied sizes,
    interleaved step() calls, optional mid-flight churn updates — the
    SAME call sequence at any pipeline depth.  Returns (ids, scores)
    keyed by submission order."""
    tickets = []
    rows = np.random.default_rng(7).integers(0, w.emb.shape[0], size=60)
    rows[45:] = rows[:15]   # the last burst repeats served rows (hits)
    qsrc = w.emb

    def sub(a, b):
        for r in rows[a:b]:
            t = fe.submit(qsrc[r], int(r))
            assert not isinstance(t, SubmitReject)
            tickets.append(t)

    def update(seed, epoch):
        jkw, tkw, vecs = store_update(w, seed, epoch)
        fe.apply_update(**(jkw if jax_side else tkw))
        return vecs

    sub(0, 5)
    fe.step()
    sub(5, 20)          # includes repeats of earlier rows (cache fodder)
    fe.step()
    fe.step()
    if churn:
        qsrc = update(11, 2)
    sub(20, 41)
    fe.step()
    if churn:
        qsrc = update(12, 3)
    sub(41, 45)
    fe.flush()          # part of the schedule: rows 0..44 all reaped here
    sub(45, 60)         # repeats of rows 0..14 — cache hits at ANY depth
    fe.flush()
    got = [fe.poll(t) for t in tickets]
    return np.stack([g[0] for g in got]), np.stack([g[1] for g in got])


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("churn", [False, True])
def test_pipelined_ids_identical_to_sync_and_to_jax(cache, churn):
    w = make_world()
    jfe = JFrontend(JBackend(w.jeng),
                    JFrontendConfig(m=M, max_batch=8, queue_capacity=256,
                                    cache=cache))
    jids, jsc = _drive_schedule(jfe, w, churn=churn, jax_side=True)
    ref = None
    for depth in (1, 2, 4):
        fe = _fe(RuntimeBackend(w.teng), max_batch=8, queue_capacity=256,
                 cache=cache, pipeline_depth=depth)
        ids, sc = _drive_schedule(fe, w, churn=churn)
        if cache and not churn:
            assert fe.stats.cache_hits > 0  # repeats really hit
        if ref is None:
            ref = ids
            assert topk_swaps(jsc, jids, sc, ids) == 0
            assert fe.stats.cache_hits == jfe.stats.cache_hits
            assert fe.backend.generation == jfe.backend.generation
        else:
            np.testing.assert_array_equal(ids, ref)


def test_deep_pipeline_really_overlaps():
    w = make_world()
    fe = _fe(RuntimeBackend(w.teng), max_batch=4, queue_capacity=64,
             cache=False, pipeline_depth=3)
    for i in range(12):
        fe.submit(w.emb[i])
    fe.step()
    fe.step()
    assert fe.inflight == 2 and fe.inflight_rows == 8
    fe.step()   # stages the 3rd AND block-reaps the oldest (pipeline full)
    assert fe.inflight == 2
    fe.flush()
    assert fe.inflight == 0 and fe.stats.completed == 12


def test_out_of_order_reap_by_ticket():
    w = make_world()
    fe = _fe(RuntimeBackend(w.teng), max_batch=4, queue_capacity=64,
             cache=False, pipeline_depth=3)
    ta = [fe.submit(w.emb[i]) for i in range(4)]
    fe.step()                       # stage batch A
    tb = [fe.submit(w.emb[i]) for i in range(4, 8)]
    fe.step()                       # stage batch B
    assert fe.inflight == 2
    assert all(b.pending.ready() for b in fe._inflight)  # the CPU ran them
    got = fe.wait(tb[2])            # newest batch first
    assert got[0].shape == (M,)
    assert fe.inflight == 1         # batch A still in flight
    assert all(t not in fe._results for t in ta)
    assert all(fe.poll(t) is not None for t in tb if t != tb[2])
    assert all(fe.wait(t) is not None for t in ta)
    assert fe.inflight == 0
    with pytest.raises(KeyError):
        fe.wait(10_000)


def test_update_while_in_flight_keeps_the_batch_on_the_old_store():
    """A staged batch holds the tensors it was dispatched with: its
    results equal a synchronous run on the old store, whatever installs
    before its reap."""
    w = make_world()
    backend = RuntimeBackend(w.teng)
    q = w.emb[:8]
    old, _ = _fe(backend, cache=False).search(q)
    fe = _fe(backend, max_batch=8, cache=False, pipeline_depth=2)
    tickets = [fe.submit(r) for r in q]
    fe.step()
    assert fe.inflight == 1
    _, tkw, _ = store_update(w, seed=5, epoch=2)
    fe.apply_update(**tkw)
    got = np.stack([fe.wait(t)[0] for t in tickets])
    np.testing.assert_array_equal(got, old)
    new, _ = _fe(backend, cache=False).search(q)
    assert not np.array_equal(new, old)


def test_writer_generation_vs_reader():
    w = make_world()
    fe = _fe(RuntimeBackend(w.teng), max_batch=4, queue_capacity=64,
             cache=True, pipeline_depth=2)
    q = w.emb[:4]
    for r in q:
        fe.submit(r)
    fe.step()                               # batch in flight at gen g0
    assert fe.inflight == 1
    _, tkw, _ = store_update(w, seed=21, epoch=2)
    fe.apply_update(**tkw)                  # installs mid-flight: gen g1
    fe.flush()                              # reap: cache fill at g0 < g1
    evict0 = fe.cache.stale_evictions
    ids2, _ = fe.search(q)                  # post-update serving
    assert fe.cache.stale_evictions == evict0 + 4
    assert fe.stats.cache_hits == 0
    fe2 = _fe(fe.backend, max_batch=4, queue_capacity=64, cache=False)
    np.testing.assert_array_equal(ids2, fe2.search(q)[0])


@pytest.mark.parametrize("inline", [True, False])
def test_churn_writer_prepare_install_split(inline):
    w = make_world()
    fe = _fe(RuntimeBackend(w.teng), max_batch=4, queue_capacity=64,
             cache=True, pipeline_depth=2)
    with ChurnWriter(fe, inline=inline) as wr:
        assert fe.writer is wr
        g0 = fe.backend.generation
        _, tkw, vecs = store_update(w, seed=31, epoch=2)
        wr.submit(lambda: tkw)
        if inline:
            assert wr.prepared == 1 and wr.installed == 0
            assert fe.backend.generation == g0  # prepared != installed
        for r in vecs[:4]:
            fe.submit(r)
        if not inline:
            wr.drain()                       # thread barrier, then install
        else:
            fe.step()                        # stage boundary installs
        assert wr.installed == 1
        assert fe.backend.generation > g0
        fe.flush()
        ids, _ = fe.search(vecs[:4])
        fe_ref = _fe(fe.backend, max_batch=4, queue_capacity=64,
                     cache=False)
        np.testing.assert_array_equal(ids, fe_ref.search(vecs[:4])[0])
    assert fe.writer is None                 # close() detached


def test_writer_refuses_topology_swaps_and_surfaces_errors():
    w = make_world()
    fe = _fe(RuntimeBackend(w.teng))
    with ChurnWriter(fe, inline=True) as wr:
        wr.submit(lambda: dict(runtime=object()))
        with pytest.raises(ValueError, match="update_backend"):
            wr.install()
    with ChurnWriter(fe) as wr:
        wr.submit(lambda: 1 / 0)
        with pytest.raises(RuntimeError, match="writer died"):
            wr.drain(timeout_s=10.0)


def test_threaded_writer_stress_installs_every_epoch_in_order():
    """Many write epochs prepared on the worker thread while the serving
    thread keeps staging, with a short switch interval: every epoch is
    installed once, in submission order (the generation only grows), and
    every served batch reads one whole store."""
    w = make_world()
    backend = RuntimeBackend(w.teng)
    fe = _fe(backend, max_batch=4, queue_capacity=64, cache=False,
             pipeline_depth=4)
    updates = [store_update(w, seed=100 + e, epoch=2 + e)[1]
               for e in range(16)]
    seen = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ChurnWriter(fe) as wr:
            for e, kw in enumerate(updates):
                wr.submit(lambda kw=kw: kw)
                for r in w.emb[4 * e:4 * e + 4]:
                    fe.submit(r)
                fe.step()
                seen.append(backend.generation)
            wr.drain(timeout_s=60.0)
            fe.flush()
            assert wr.prepared == wr.installed == len(updates)
            worker = wr._thread
    finally:
        sys.setswitchinterval(switch)
    assert not worker.is_alive()  # close() stopped it
    assert all(b >= a for a, b in zip(seen, seen[1:]))
    assert backend._store is updates[-1]["store"]
    assert fe.stats.completed == 4 * len(updates)


def test_zero_retrace_with_pipeline_and_obs():
    w = make_world()
    traces = {}
    for tag, obs in (("off", None), ("on", Observability())):
        backend = RuntimeBackend(w.teng)
        fe = RetrievalFrontend(
            backend, FrontendConfig(m=M, max_batch=16, queue_capacity=256,
                                    cache=True, pipeline_depth=3),
            obs=obs)
        rng = np.random.default_rng(3)
        for n in [1, 2, 3, 5, 7, 11, 13, 17, 23, 31, 43, 16, 6]:
            fe.search(w.emb[rng.integers(0, w.emb.shape[0], size=n)])
        assert backend.traces <= 7
        traces[tag] = backend.traces
    assert traces["on"] == traces["off"]


def test_queue_depth_and_time_in_queue_metrics():
    w = make_world()
    obs = Observability()
    fe = RetrievalFrontend(
        RuntimeBackend(w.teng),
        FrontendConfig(m=M, max_batch=4, queue_capacity=64, cache=False,
                       pipeline_depth=2),
        obs=obs)
    for i in range(6):
        fe.submit(w.emb[i])
    assert obs.registry.value("serve_queue_depth") == 6
    fe.step()
    assert obs.registry.value("serve_queue_depth") == 2
    fe.flush()
    assert obs.registry.value("serve_queue_depth") == 0
    assert obs.registry.value("serve_time_in_queue_us") == 6
    s = fe.stats.summary()
    assert fe.stats.staged == 6
    assert s["p99_queue_us"] >= s["p50_queue_us"] >= 0.0
    names = {e["name"] for e in obs.chrome_trace()["traceEvents"]}
    assert {"serve/intake", "serve/stage", "serve/compute",
            "serve/reap"} <= names
    assert len(obs.flight.records(kind="dispatch")) == 2


@pytest.mark.parametrize("rate,n,seed,det", [
    (1000.0, 500, 3, False), (100.0, 10, 0, True), (37.5, 64, 9, False)])
def test_poisson_arrivals_equal_jax(rate, n, seed, det):
    got = poisson_arrivals(rate, n, seed=seed, deterministic=det)
    np.testing.assert_array_equal(
        got, j_poisson_arrivals(rate, n, seed=seed, deterministic=det))
    assert got.shape == (n,) and np.all(np.diff(got) > 0)


def test_poisson_arrivals_refuse_a_zero_rate():
    with pytest.raises(ValueError):
        poisson_arrivals(0.0, 10)


@pytest.mark.parametrize("depth", [1, 2])
def test_open_loop_accounting_and_identity(depth):
    w = make_world()
    fe = _fe(RuntimeBackend(w.teng), max_batch=8, queue_capacity=256,
             cache=False, pipeline_depth=depth)
    n = 64
    rows = np.random.default_rng(5).integers(0, w.emb.shape[0], size=n)
    arr = poisson_arrivals(2000.0, n, deterministic=True)
    res = run_open_loop(fe, w.emb[rows], arr)
    assert res.completed == n and res.shed == 0
    assert set(res.ids) == set(range(n))
    assert res.latencies_ms.shape == (n,)
    assert res.p99_ms >= res.p50_ms > 0
    assert res.slo_ok(p99_slo_ms=1e9) and not res.slo_ok(p99_slo_ms=0.0)
    assert res.summary["completed"] == n
    ref = _fe(fe.backend, max_batch=8, queue_capacity=256, cache=False)
    got = np.stack([res.ids[i] for i in range(n)])
    np.testing.assert_array_equal(got, ref.search(w.emb[rows])[0])


def test_max_qps_at_slo_sweeps_the_ladder_as_jax_does():
    """The rate ladder: every rung runs `trials` fresh frontends on the
    same schedules and query picks as JAX's sweep; at feasible rates and
    a loose SLO every rung passes in both, the headline is the top rung,
    and an impossible SLO passes none.  A tick hook's writer is closed
    by the sweep."""
    w = make_world()
    rates = np.array([500.0, 1000.0])
    made = []

    def make_frontend():
        made.append(_fe(RuntimeBackend(w.teng), max_batch=8,
                        queue_capacity=256, cache=False))
        return made[-1]

    def make_jfrontend():
        return JFrontend(JBackend(w.jeng), JFrontendConfig(
            m=M, max_batch=8, queue_capacity=256, cache=False))

    def make_tick(fe):
        ChurnWriter(fe, inline=True)
        return None

    kw = dict(p99_slo_ms=1e9, n_arrivals=48, seed=4, trials=2)
    best, knee = max_qps_at_slo(make_frontend, w.emb, rates,
                                make_tick=make_tick, **kw)
    jbest, jknee = j_max_qps_at_slo(make_jfrontend, w.emb, rates, **kw)
    assert best == jbest == 1000.0
    assert [(r, s) for r, _, s in knee] == [(r, s) for r, _, s in jknee] \
        == [(500.0, 0), (1000.0, 0)]
    assert len(made) == 4 and all(fe.writer is None for fe in made)
    none, _ = max_qps_at_slo(make_frontend, w.emb, rates[:1],
                             **dict(kw, p99_slo_ms=0.0))
    assert none == 0.0


def test_exact_topm_and_recall_probe_match_jax():
    """The shadow-rescoring ground truth equals JAX's, and the sampled
    recall probe lands in the registry."""
    w = make_world()
    tb, jb = RuntimeBackend(w.teng), JBackend(w.jeng)
    for i in (0, 7, 123):
        np.testing.assert_array_equal(tb.exact_topm(w.emb[i], i, M),
                                      jb.exact_topm(w.emb[i], i, M))
    from repro_torch.obs import ObsConfig

    obs = Observability(ObsConfig(recall_probe_every=4))
    fe = RetrievalFrontend(tb, FrontendConfig(m=M, max_batch=8,
                                              cache=False), obs=obs)
    fe.search(w.emb[:16], exclude=np.arange(16))
    assert obs.registry.value("serve_recall_probes_total") == 4
    assert 0.0 <= obs.registry.value("serve_recall_probe",
                                     window="mean") <= 1.0
