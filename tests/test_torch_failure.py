"""The replication half of `repro_torch`'s runtime against the JAX package
(DESIGN.md Sec. 9-10), on the goldens world (N=1200, D=32, k=5, L=3,
C=64, m=10, 48 queries):

  * R-way replicas, first-responder and quorum reads, with every node
    live and with dead nodes (`live` masks), staged (`fused="off"`) and
    through the fused kernels' plain versions (`fused="on"`): ids,
    scores to 1e-6, contains hits and every `StepStats` field equal to
    JAX's staged 4-node mesh, run in one subprocess;
  * `replicate_store` and `kill_node` leave the stores JAX's leave, and
    `kill_node` leaves its inputs as they were;
  * a 1 -> 2 -> 4 -> 1 `reshard` round trip equals the goldens
    (`engine_v1.npz`, `runtime_2node_v1.npz`) bit for bit, the 4-node
    stop JAX's, and every `ReshardEvent` JAX's;
  * config checks, `_replica_targets`, and the argument errors.

The JAX package's fused Pallas calls do not run on this jax, so the
reference is its staged path.  The goldens' hyperplanes come from JAX's
PRNG with `threefry_partitionable` off, the mode they were drawn in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import run_in_subprocess

from repro.core import LshParams as JParams
from repro.core import make_hyperplanes as j_make_hyperplanes
from repro.core import runtime as jruntime
from repro.core.hashing import sketch_codes_batched
from repro.core.store import build_store_host as j_build_store_host
from repro_torch import convert
from repro_torch.core import runtime as truntime
from repro_torch.core.can import CanTopology
from repro_torch.core.hashing import LshParams
from repro_torch.core.runtime import (
    IndexRuntime, ReshardEvent, RuntimeConfig, gather_store, kill_node,
    reshard,
)
from repro_torch.core.store import BucketStore, make_store
from repro_torch.launch.mesh import make_zone_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
N, D, K, L, M, NQ = 1200, 32, 5, 3, 10, 48
STATS = ("dropped_probes", "probes_issued", "probes_routed",
         "nodes_contacted", "replica_fanout")
# (R, read mode, nodes killed before the reads)
REP_CELLS = [(2, "first", ()), (2, "first", (1,)), (2, "quorum", ()),
             (2, "quorum", (1,)), (3, "first", (1, 2)), (3, "quorum", (2,))]
REP_IDS = [f"R{r}-{mode}-dead{''.join(map(str, d)) or 'none'}"
           for r, mode, d in REP_CELLS]


def goldens_prng():
    """The PRNG mode the goldens' hyperplanes were drawn in."""
    mode = getattr(jax, "threefry_partitionable", None)
    return contextlib.nullcontext() if mode is None else mode(False)


REF = """
import contextlib, numpy as np, jax, jax.numpy as jnp
from repro.core import LshParams, make_hyperplanes
from repro.core.hashing import sketch_codes_batched
from repro.core.runtime import (IndexRuntime, RuntimeConfig, kill_node,
                                reshard)
from repro.core.store import build_store_host
from repro.launch.mesh import make_zone_mesh

N, D, K, L, M, NQ = {N}, {D}, {K}, {L}, {M}, {NQ}
rng = np.random.default_rng(17)
vecs = rng.standard_normal((N, D)).astype(np.float32)
vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
targets = rng.integers(0, N, size=NQ).astype(np.int32)
params = LshParams(d=D, k=K, L=L, seed=23)
mode = getattr(jax, "threefry_partitionable", None)
with contextlib.nullcontext() if mode is None else mode(False):
    h = make_hyperplanes(params)
store = build_store_host(sketch_codes_batched(jnp.asarray(vecs), h),
                         params.num_buckets, capacity=64, payload=vecs)
mesh4 = make_zone_mesh(4)
out = dict(h=np.asarray(h))
q = vecs[:NQ]

def stats(s):
    d = s.host()
    return np.asarray([d[f] for f in {STATS!r}] + list(d["dropped_by_dest"]))

def put_store(tag, st):
    for f in ("ids", "timestamps", "write_ptr", "payload", "generation"):
        out[tag + "/" + f] = np.asarray(getattr(st, f))

for R, read_mode, dead in {CELLS!r}:
    tag = f"{{R}}-{{read_mode}}-{{''.join(map(str, dead))}}"
    rt = IndexRuntime(RuntimeConfig(params=params, n_nodes=4, m=M,
                                    variant="cnb", cap_factor=4.0,
                                    replication=R, read_mode=read_mode),
                      mesh=mesh4)
    st = rt.shard_store(store)
    reps = rt.replicate_store(st)
    out[tag + "/rep_ids"] = np.asarray(reps[0])
    out[tag + "/rep_payload"] = np.asarray(reps[1])
    cache = rt.refresh_cache(st)  # announced before the kills, as in churn
    live = np.ones(4, np.int32)
    for node in dead:
        st, reps = kill_node(rt, st, reps, node)
        live[node] = 0
    if dead:
        put_store(tag + "/killed", st)
        out[tag + "/killed/rep_ids"] = np.asarray(reps[0])
        out[tag + "/killed/rep_payload"] = np.asarray(reps[1])
    ids, sc, s = rt.search(h, st, q, cache=cache, replicas=reps, live=live)
    hits, hs = rt.contains(h, st, q, targets, cache=cache, replicas=reps,
                           live=live)
    out.update({{tag + "/ids": np.asarray(ids), tag + "/scores": np.asarray(sc),
                tag + "/stats": stats(s), tag + "/hits": np.asarray(hits),
                tag + "/hstats": stats(hs)}})

# reshard round trip 1 -> 2 -> 4 -> 1
ex = np.arange(NQ, dtype=np.int32)
rt1 = IndexRuntime(RuntimeConfig(params=params, variant="cnb", m=M,
                                 cap_factor=float(L)))
events = []
ids, sc, _ = rt1.search(h, store, q, exclude=ex)
out["rs1/ids"], out["rs1/scores"] = np.asarray(ids), np.asarray(sc)
rt2, st2, ev = reshard(rt1, store, 2, mesh=make_zone_mesh(2))
events.append(ev)
ids, sc, s = rt2.search(h, st2, q, cache=rt2.refresh_cache(st2))
out["rs2/ids"], out["rs2/scores"], out["rs2/stats"] = (
    np.asarray(ids), np.asarray(sc), stats(s))
rt4, st4, ev = reshard(rt2, st2, 4, mesh=mesh4, cap_factor=4.0)
events.append(ev)
ids, sc, s = rt4.search(h, st4, q, cache=rt4.refresh_cache(st4))
out["rs4/ids"], out["rs4/scores"], out["rs4/stats"] = (
    np.asarray(ids), np.asarray(sc), stats(s))
rt1b, st1b, ev = reshard(rt4, st4, 1)
events.append(ev)
ids, sc, _ = rt1b.search(h, st1b, q, exclude=ex)
out["rs1b/ids"], out["rs1b/scores"] = np.asarray(ids), np.asarray(sc)
out["rs1b/generation"] = np.asarray(st1b.generation)
out["events"] = np.asarray([[e.old_n, e.new_n, e.moved_buckets,
                             e.handoff_bytes] for e in events])
np.savez(OUT, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    jparams = JParams(d=D, k=K, L=L, seed=23)
    with goldens_prng():
        jh = j_make_hyperplanes(jparams)
    jst = j_build_store_host(sketch_codes_batched(jnp.asarray(vecs), jh),
                             jparams.num_buckets, capacity=64, payload=vecs)
    return dict(
        vecs=vecs, targets=rng.integers(0, N, size=NQ).astype(np.int32),
        params=LshParams(d=D, k=K, L=L, seed=23),
        h=convert.hyperplanes_from(jh, device="cpu"),
        st=convert.store_from(jst, device="cpu"),
    )


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs on a 4-device JAX mesh."""
    path = str(tmp_path_factory.mktemp("ref_failure") / "ref.npz")
    code = f"OUT = {path!r}\n" + REF.format(
        N=N, D=D, K=K, L=L, M=M, NQ=NQ, STATS=STATS, CELLS=REP_CELLS)
    assert "ok" in run_in_subprocess(code, devices=4)
    return dict(np.load(path))


def _tag(R, mode, dead):
    return f"{R}-{mode}-{''.join(map(str, dead))}"


def stats_tuple(stats) -> tuple:
    h = stats.host()
    return tuple(h[f] for f in STATS) + tuple(h["dropped_by_dest"])


def _snapshot(store: BucketStore, reps) -> list:
    return [t.clone() for t in (store.ids, store.timestamps, store.write_ptr,
                                store.payload, store.generation, *reps)]


def _replicated(w, R, mode, dead, fused="off"):
    """(runtime, store, replicas, cache, live) of the port's 4-node mesh
    with `dead` killed after the announce, as the reference's cells."""
    rt = IndexRuntime(RuntimeConfig(params=w["params"], n_nodes=4, m=M,
                                    variant="cnb", cap_factor=4.0,
                                    replication=R, read_mode=mode,
                                    fused=fused),
                      mesh=make_zone_mesh(4, device="cpu"))
    st = rt.shard_store(w["st"])
    reps = rt.replicate_store(st)
    cache = rt.refresh_cache(st)
    live = np.ones(4, np.int32)
    for node in dead:
        st, reps = kill_node(rt, st, reps, node)
        live[node] = 0
    return rt, st, reps, cache, live


@pytest.mark.parametrize("fused", ["off", "on"], ids=["staged", "fused"])
@pytest.mark.parametrize("R,mode,dead", REP_CELLS, ids=REP_IDS)
def test_replicated_search_and_contains_match_jax(world, ref, R, mode, dead,
                                                  fused):
    w, tag = world, _tag(R, mode, dead)
    np.testing.assert_array_equal(w["h"].numpy(), ref["h"])
    rt, st, reps, cache, live = _replicated(w, R, mode, dead, fused)
    q = w["vecs"][:NQ]
    ids, sc, stats = rt.search(w["h"], st, q, cache=cache, replicas=reps,
                               live=live)
    hits, hstats = rt.contains(w["h"], st, q, w["targets"], cache=cache,
                               replicas=reps, live=live)
    np.testing.assert_array_equal(ids.numpy(), ref[tag + "/ids"])
    np.testing.assert_allclose(sc.numpy(), ref[tag + "/scores"], atol=1e-6)
    np.testing.assert_array_equal(hits.numpy(), ref[tag + "/hits"])
    assert stats_tuple(stats) == tuple(ref[tag + "/stats"].tolist())
    assert stats_tuple(hstats) == tuple(ref[tag + "/hstats"].tolist())
    assert int(stats) == 0 and stats.host()["replica_fanout"] == (
        R if mode == "quorum" else 1)


@pytest.mark.parametrize("R,mode,dead", REP_CELLS[:1] + REP_CELLS[4:5],
                         ids=[REP_IDS[0], REP_IDS[4]])
def test_replicate_store_matches_jax(world, ref, R, mode, dead):
    rt, st, _, _, _ = _replicated(world, R, mode, ())
    rep_ids, rep_payload = rt.replicate_store(st)
    tag = _tag(R, mode, dead)
    np.testing.assert_array_equal(rep_ids.numpy(), ref[tag + "/rep_ids"])
    np.testing.assert_array_equal(rep_payload.numpy(),
                                  ref[tag + "/rep_payload"])
    # slice r-1 holds, at zone i, the zone of node (i - r) % n
    topo = rt.topology
    for r in range(1, R):
        for i in range(4):
            s, e = topo.zone_range(i)
            ss, se = topo.zone_range((i - r) % 4)
            assert torch.equal(rep_ids[:, r - 1, s:e], st.ids[:, ss:se])


@pytest.mark.parametrize("R,mode,dead", [c for c in REP_CELLS if c[2]],
                         ids=[i for i, c in zip(REP_IDS, REP_CELLS) if c[2]])
def test_kill_node_matches_jax_and_keeps_its_inputs(world, ref, R, mode,
                                                    dead):
    rt, st, _, _, _ = _replicated(world, R, mode, ())
    reps = rt.replicate_store(st)
    before = _snapshot(st, reps)
    killed, kreps = st, reps
    for node in dead:
        killed, kreps = kill_node(rt, killed, kreps, node)
    for t0, t1 in zip(before, _snapshot(st, reps)):
        assert torch.equal(t0, t1)  # the inputs are untouched
    tag = _tag(R, mode, dead) + "/killed"
    for f in ("ids", "timestamps", "write_ptr", "payload", "generation"):
        np.testing.assert_array_equal(getattr(killed, f).numpy(),
                                      ref[f"{tag}/{f}"], err_msg=f)
    np.testing.assert_array_equal(kreps[0].numpy(), ref[tag + "/rep_ids"])
    np.testing.assert_array_equal(kreps[1].numpy(), ref[tag + "/rep_payload"])


def test_reshard_round_trip_matches_goldens_and_jax(world, ref):
    w = world
    q, ex = w["vecs"][:NQ], np.arange(NQ)
    eng_g = dict(np.load(os.path.join(HERE, "goldens", "engine_v1.npz")))
    two_g = dict(np.load(os.path.join(HERE, "goldens",
                                      "runtime_2node_v1.npz")))
    rt1 = IndexRuntime(RuntimeConfig(params=w["params"], variant="cnb", m=M,
                                     cap_factor=float(L)), device="cpu")
    store = w["st"]
    before = _snapshot(store, ())
    ids0, sc0, _ = rt1.search(w["h"], store, q, exclude=ex)
    np.testing.assert_array_equal(ids0.numpy(), eng_g["search_ids_cnb_full"])
    events = []
    rt2, st2, ev = reshard(rt1, store, 2,
                           mesh=make_zone_mesh(2, device="cpu"))
    events.append(ev)
    ids, sc, stats = rt2.search(w["h"], st2, q, cache=rt2.refresh_cache(st2))
    np.testing.assert_array_equal(ids.numpy(), two_g["search_ids_cnb"])
    np.testing.assert_array_equal(ids.numpy(), ref["rs2/ids"])
    np.testing.assert_allclose(sc.numpy(), ref["rs2/scores"], atol=1e-6)
    assert stats_tuple(stats) == tuple(ref["rs2/stats"].tolist())
    rt4, st4, ev = reshard(rt2, st2, 4, mesh=make_zone_mesh(4, device="cpu"),
                           cap_factor=4.0)
    events.append(ev)
    ids, sc, stats = rt4.search(w["h"], st4, q, cache=rt4.refresh_cache(st4))
    np.testing.assert_array_equal(ids.numpy(), ref["rs4/ids"])
    np.testing.assert_allclose(sc.numpy(), ref["rs4/scores"], atol=1e-6)
    assert stats_tuple(stats) == tuple(ref["rs4/stats"].tolist())
    rt1b, st1b, ev = reshard(rt4, st4, 1)
    events.append(ev)
    assert rt1b.mesh is None and rt1b.device == torch.device("cpu")
    ids1, sc1, _ = rt1b.search(w["h"], st1b, q, exclude=ex)
    np.testing.assert_array_equal(ids1.numpy(), ids0.numpy())
    np.testing.assert_array_equal(sc1.numpy(), sc0.numpy())
    np.testing.assert_array_equal(ids1.numpy(), ref["rs1b/ids"])
    assert int(st1b.generation) == int(ref["rs1b/generation"]) == 3
    got = [[e.old_n, e.new_n, e.moved_buckets, e.handoff_bytes]
           for e in events]
    assert got == ref["events"].tolist()
    for t0, t1 in zip(before, _snapshot(store, ())):
        assert torch.equal(t0, t1)


def test_reshard_reuses_runtimes_and_checks_arguments(world):
    w = world
    rt = IndexRuntime(RuntimeConfig(params=w["params"], variant="cnb", m=M),
                      device="cpu")
    st = w["st"]
    with pytest.raises(ValueError, match="new_n_nodes"):
        reshard(rt, st)
    with pytest.raises(ValueError, match="needs a mesh"):
        reshard(rt, st, 2)  # multi-node without a mesh
    rt2, st2, _ = reshard(rt, st, 2, mesh=make_zone_mesh(2, device="cpu"),
                          cap_factor=2.0)
    assert rt2.cfg.cap_factor == 2.0 and rt2.cfg.variant == "cnb"
    with pytest.raises(ValueError, match="asked for"):
        reshard(rt, st, 4, runtime=rt2)
    with pytest.raises(ValueError, match="prebuilt"):
        reshard(rt, st, runtime=rt2, cap_factor=4.0)
    other = IndexRuntime(dataclasses.replace(rt2.cfg, m=M + 1),
                         mesh=rt2.mesh)
    with pytest.raises(ValueError, match="beyond the topology"):
        reshard(rt, st, runtime=other)
    back, st1, ev = reshard(rt2, st2, runtime=rt)
    assert back is rt and (ev.old_n, ev.new_n) == (2, 1)
    assert ev == ReshardEvent(2, 1, L * (1 << K) // 2, ev.handoff_bytes)
    g = gather_store(st2)  # one device: the same tensors, no copy
    assert g.ids is st2.ids and g.payload is st2.payload


def test_runtime_config_replication_checks():
    p = LshParams(d=16, k=4, L=2, seed=0)
    ok = RuntimeConfig(params=p, n_nodes=4, replication=2,
                       read_mode="quorum")
    assert ok.replication == 2
    with pytest.raises(ValueError, match="replication"):
        RuntimeConfig(params=p, n_nodes=2, replication=3)
    with pytest.raises(ValueError, match="alltoall"):
        RuntimeConfig(params=p, n_nodes=4, routing="allgather",
                      replication=2)
    with pytest.raises(ValueError, match="read_mode"):
        RuntimeConfig(params=p, n_nodes=4, replication=2, read_mode="all")
    with pytest.raises(ValueError, match="nb"):
        RuntimeConfig(params=p, n_nodes=4, variant="nb", replication=2)
    with pytest.raises(ValueError, match=">= 1"):
        RuntimeConfig(params=p, n_nodes=4, replication=0)


@pytest.mark.parametrize("R,mode", [(2, "first"), (3, "first"),
                                    (2, "quorum"), (3, "quorum")])
def test_replica_targets_match_jax(R, mode):
    rng = np.random.default_rng(R)
    owner = rng.integers(0, 4, size=40).astype(np.int32)
    for live in ([1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 1, 1], [0, 0, 0, 0]):
        jcfg = jruntime.RuntimeConfig(params=JParams(d=8, k=4, L=2),
                                      n_nodes=4, replication=R,
                                      read_mode=mode)
        jd, js, jf = jruntime._replica_targets(
            jcfg, jnp.asarray(owner), jnp.asarray(live, jnp.int32))
        cfg = RuntimeConfig(params=LshParams(d=8, k=4, L=2), n_nodes=4,
                            replication=R, read_mode=mode)
        td, ts, tf = truntime._replica_targets(
            cfg, torch.from_numpy(owner)[None],
            torch.tensor(live, dtype=torch.int32))
        assert tf == jf
        np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js))


def test_replica_arguments_are_checked(world):
    w = world
    rt, st, reps, cache, _ = _replicated(w, 2, "first", ())
    q = w["vecs"][:8]
    with pytest.raises(ValueError, match="replicas="):
        rt.search(w["h"], st, q, cache=cache)
    with pytest.raises(ValueError, match="replicas="):
        rt.contains(w["h"], st, q, np.arange(8), cache=cache)
    plain = IndexRuntime(RuntimeConfig(params=w["params"], n_nodes=4, m=M,
                                       cap_factor=4.0),
                         mesh=make_zone_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="require cfg.replication"):
        plain.search(w["h"], st, q, cache=cache, live=[1, 1, 1, 1])
    with pytest.raises(ValueError, match="require cfg.replication"):
        plain.contains(w["h"], st, q, np.arange(8), cache=cache,
                       replicas=reps)
    assert plain.replicate_store(st) is None
    assert plain.make_replicate_step() is None
    with pytest.raises(ValueError, match="rep_ids/rep_payload/live"):
        truntime.search_kernel(rt.cfg, truntime.LOCAL, M, w["h"], st.ids,
                               st.payload, None, None,
                               torch.from_numpy(q))


def test_kill_node_blanks_zone_and_held_replicas():
    """The reference's blanking semantics, on a topology alone."""
    topo = CanTopology(k=4, n_nodes=4)
    rt = type("Rt", (), {"topology": topo})()
    Lt, nb, cap, d, R = 2, 16, 4, 8, 2
    base = make_store(Lt, nb, cap, payload_dim=d, device="cpu")
    store = BucketStore(
        ids=torch.zeros((Lt, nb, cap), dtype=torch.int32),
        timestamps=torch.ones((Lt, nb, cap), dtype=torch.int32),
        write_ptr=torch.ones((Lt, nb), dtype=torch.int32),
        payload=torch.ones((Lt, nb, cap, d)), generation=base.generation)
    reps = (torch.zeros((Lt, R - 1, nb, cap), dtype=torch.int32),
            torch.ones((Lt, R - 1, nb, cap, d)))
    store2, reps2 = kill_node(rt, store, reps, 1)
    s, e = topo.zone_range(1)
    zone = torch.zeros(nb, dtype=torch.bool)
    zone[s:e] = True
    assert bool((store2.ids[:, zone] == -1).all())
    assert bool((store2.timestamps[:, zone] == 0).all())
    assert bool((store2.write_ptr[:, zone] == 0).all())
    assert bool((store2.payload[:, zone] == 0).all())
    assert bool((reps2[0][:, :, zone] == -1).all())
    assert bool((reps2[1][:, :, zone] == 0).all())
    assert bool((store2.ids[:, ~zone] == 0).all())
    assert bool((reps2[0][:, :, ~zone] == 0).all())
    assert int(store2.generation) == int(store.generation) + 1
    assert bool((store.ids == 0).all()) and bool((reps[0] == 0).all())
    store3, none_reps = kill_node(rt, store, None, 0)
    assert none_reps is None
    s0, e0 = topo.zone_range(0)
    assert bool((store3.ids[:, s0:e0] == -1).all())
