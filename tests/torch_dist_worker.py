"""Gloo ranks for tests/test_torch_dist_mesh.py and
tests/test_torch_dist_p2p.py (not collected).

`spawn(job, world, outdir, world_npz, **kw)` starts `world` processes
with `torch.multiprocessing`, each initialising a gloo process group
through `repro_torch.launch.mesh.init_process_mesh(device="cpu")` and
running one job; rank r saves its outputs to `outdir/rank{r}.npz`.

The jobs:
  * `cells`: the index cells of `CELLS` (or `GOLDEN_CELLS`) on a
    `ProcessZoneMesh` of `data` rows of n nodes, the same `run_cell` the
    test runs on the one-process `ZoneMesh`;
  * `collectives`: every `BlockCollectives` method on random tensors,
    each rank's block of a node-leading tensor that the test holds
    against `MeshCollectives` on the whole of it; then the mesh
    helpers' shapes and refusals inside the world, and what `kill_node`
    and `reshard` give on a mesh of one node a rank;
  * `p2p`: the P2P cells of `p2p_cells` (replicated reads, kills, a
    reshard round trip through the prefix meshes, the churn drivers,
    the serve lifecycles, the dispatch guard, and serving under the
    controller rank: open-loop serving, a threaded writer whose preps
    issue the mesh's collectives, and the threaded writer of
    `run_serve_churn`), the same function the test runs in one
    process.

This module imports torch and the port only, never jax, so that a
spawned rank starts quickly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.can import CanTopology
from repro_torch.core.hashing import LshParams
from repro_torch.core.runtime import BlockCollectives, IndexRuntime, \
    RuntimeConfig
from repro_torch.core.store import BucketStore
from repro_torch.launch import mesh as mesh_mod

STATS = ("dropped_probes", "probes_issued", "probes_routed",
         "nodes_contacted", "replica_fanout")

# name -> RuntimeConfig keywords (+ "chain": insert -> payload sync ->
# expire -> refresh -> search after the first search)
CELLS = {
    f"{v}-{r}-{s}": dict(variant=v, routing=r, score=s, cap_factor=3.0)
    for v in ("lsh", "nb", "cnb") for r in ("alltoall", "allgather")
    for s in ("dot", "hamming")
}
CELLS.update({
    f"{v}-p2": dict(variant=v, score="dot", cap_factor=3.0, num_probes=2)
    for v in ("nb", "cnb")
})
CELLS.update({
    f"{v}-ranked3": dict(variant=v, score="dot", cap_factor=3.0,
                         num_probes=3, ranked_probes=True)
    for v in ("nb", "cnb")
})
CELLS["cnb-tinycap"] = dict(variant="cnb", score="hamming", cap_factor=0.25)
CELLS.update({
    f"chain-{s}": dict(variant="cnb", score=s, cap_factor=4.0, chain=True)
    for s in ("dot", "hamming")
})
GOLDEN_CELLS = {
    f"{v}-{s}-{mode}": dict(variant=v, score=s, cap_factor=3.0, **kw)
    for v in ("lsh", "nb", "cnb") for s in ("dot", "hamming")
    for mode, kw in (("staged", dict(fused="off")),
                     ("fused", dict(fused="on", use_kernels=True)))
}


def load_world(path: str) -> dict:
    """The world the test saved: params, hyperplanes, both stores, the
    queries, targets and the vectors a chain cell re-announces."""
    z = dict(np.load(path))
    t = {k: torch.from_numpy(v) for k, v in z.items()}

    def store(tag):
        return BucketStore(t[tag + "ids"], t[tag + "ts"], t[tag + "ptr"],
                           t[tag + "payload"], t[tag + "gen"])

    d, k, L, seed = (int(v) for v in z["params"])
    return dict(params=LshParams(d=d, k=k, L=L, seed=seed), h=t["h"],
                store=dict(dot=store("dot_"), hamming=store("ham_")),
                q=t["q"], targets=t["targets"], moved=t["moved"], m=int(z["m"]))


def _stats(s) -> np.ndarray:
    h = s.host()
    return np.asarray([h[f] for f in STATS] + list(h["dropped_by_dest"]))


def run_cell(mesh, w: dict, spec: dict) -> dict:
    """One cell on `mesh`: search and contains, and for a chain cell the
    maintenance steps and a second search.  Returns numpy outputs; on a
    process mesh the search results are the whole batch's, and the
    store and cache are this rank's zones."""
    spec = dict(spec)
    chain = spec.pop("chain", False)
    rt = IndexRuntime(RuntimeConfig(params=w["params"], n_nodes=mesh.n_model,
                                    m=w["m"], **spec), mesh=mesh)
    st = rt.shard_store(w["store"][spec["score"]])
    cache = rt.refresh_cache(st) if rt.cfg.variant == "cnb" else None
    q, h = w["q"], w["h"]
    ids, sc, s = rt.search(h, st, q, cache=cache)
    hits, hs = rt.contains(h, st, q, w["targets"], cache=cache)
    out = dict(ids=ids.numpy(), scores=sc.numpy(), stats=_stats(s),
               hits=hits.numpy(), hstats=_stats(hs))
    if chain:
        moved = w["moved"]
        st = rt.insert(h, st, moved[:96], torch.arange(96), 5)
        st = rt.payload_sync(st, moved, hyperplanes=h)
        st = rt.expire(st, 9, ttl=5)
        cache = rt.refresh_cache(st)
        ids, sc, s = rt.search(h, st, moved[:q.shape[0]], cache=cache)
        out.update(after_ids=ids.numpy(), after_scores=sc.numpy(),
                   after_stats=_stats(s), store_ids=st.ids.numpy(),
                   store_ts=st.timestamps.numpy(),
                   store_ptr=st.write_ptr.numpy(),
                   store_payload=st.payload.numpy(),
                   store_gen=st.generation.numpy(),
                   cache_ids=cache[0].numpy(),
                   cache_payload=cache[1].numpy())
    return out


def perms_of(n: int) -> dict:
    """Named (src, dst) pairings of n nodes: every node-bit flip, ring
    shifts, a partial pairing where node 3 receives nothing, and a swap
    inside the first block of two."""
    topo = CanTopology(max(n.bit_length() - 1, 1) + 2, n)
    perms = {f"bit{b}": topo.neighbor_perm(b) for b in range(topo.node_bits)}
    perms["ring1"] = [(i, (i + 1) % n) for i in range(n)]
    perms["ring3"] = [(i, (i + 3) % n) for i in range(n)]
    perms["pair01"] = [(0, 1), (1, 0)]
    if n >= 4:
        perms["partial"] = [(0, 1), (1, 2), (2, 0)]
    return perms


def collective_inputs(n: int, seed: int) -> dict:
    """Node-leading random tensors every rank draws alike."""
    g = torch.Generator().manual_seed(seed)
    return dict(
        a2a=torch.randint(-9, 9, (n, n, 3, 2), generator=g,
                          dtype=torch.int32),
        a2a_f=torch.randn((n, n, 5), generator=g),
        gather=torch.randn((n, 4, 3), generator=g),
        perm=torch.randint(0, 100, (n, 3, 2), generator=g,
                           dtype=torch.int32),
        perm_ax1=torch.randn((2, n, 3), generator=g),
        perm_bool=torch.rand((n, 5), generator=g) > 0.5,
        psum=torch.randint(0, 5, (n, 6), generator=g, dtype=torch.int32),
        live=torch.randint(0, 2, (n,), generator=g, dtype=torch.int32),
    )


def _job_collectives(mesh_kw: dict) -> dict:
    out = {}
    world = dist.get_world_size()
    for n in (world, 2 * world):
        mesh = mesh_mod.make_zone_mesh(n, device="cpu")
        cx = BlockCollectives(n=n, n_loc=mesh.n_loc, block=mesh.block,
                              device=mesh.device)
        x = collective_inputs(n, seed=n)
        mine = slice(cx.nodes.start, cx.nodes.stop)
        out[f"{n}/axis_index"] = cx.axis_index().numpy()
        out[f"{n}/local_index"] = cx.local_index().numpy()
        out[f"{n}/all_to_all"] = cx.all_to_all(x["a2a"][mine]).numpy()
        out[f"{n}/all_to_all_f"] = cx.all_to_all(x["a2a_f"][mine]).numpy()
        out[f"{n}/all_gather"] = cx.all_gather(x["gather"][mine]).numpy()
        out[f"{n}/all_gather_batch"] = cx.all_gather_batch(
            x["gather"][mine]).numpy()
        out[f"{n}/psum"] = cx.psum(x["psum"][mine]).numpy()
        out[f"{n}/alive"] = cx.alive(x["live"]).numpy()
        for name, perm in perms_of(n).items():
            out[f"{n}/ppermute/{name}"] = cx.ppermute(
                x["perm"][mine], perm).numpy()
            out[f"{n}/ppermute_ax1/{name}"] = cx.ppermute(
                x["perm_ax1"][:, mine], perm, axis=1).numpy()
            out[f"{n}/ppermute_bool/{name}"] = cx.ppermute(
                x["perm_bool"][mine], perm).numpy()
    return out


def _job_cells(mesh_kw: dict) -> dict:
    w = load_world(mesh_kw["world_npz"])
    mesh = mesh_mod.make_zone_mesh(mesh_kw["n"], mesh_kw.get("data", 1),
                                   device="cpu")
    cells = GOLDEN_CELLS if mesh_kw.get("golden") else CELLS
    out = dict(block=np.asarray([mesh.row, mesh.block, mesh.n_loc]))
    for name, spec in cells.items():
        for key, val in run_cell(mesh, w, spec).items():
            out[f"{name}/{key}"] = val
    return out


def _job_helpers(mesh_kw: dict) -> dict:
    world = dist.get_world_size()
    out = {}
    meshes = dict(host=mesh_mod.make_host_mesh(2, world // 2,
                                               device="cpu"),
                  pod=mesh_mod.make_host_mesh(1, world // 2, 2,
                                              device="cpu"))
    rows = [mesh_mod.make_zone_mesh(world, 2, device="cpu") for _ in range(2)]
    out["rows/shared"] = np.asarray(
        [m.model_group is rows[0].model_group and m.model_group is not None
         for m in rows + list(meshes.values())])
    for tag, mesh in meshes.items():
        out[f"{tag}/shape"] = np.asarray(list(mesh.shape.values()))
        out[f"{tag}/axes"] = np.asarray(list(mesh.shape))
        out[f"{tag}/batch_axes"] = np.asarray(mesh_mod.batch_axes(mesh))
        out[f"{tag}/place"] = np.asarray([mesh.row, mesh.block, mesh.n_loc])
    for what, fn in (
            ("production", lambda: mesh_mod.make_production_mesh(
                device="cpu")),
            ("too_wide", lambda: mesh_mod.make_zone_mesh(3, device="cpu")),
            ("nccl", lambda: mesh_mod.make_zone_mesh(
                world, device=torch.device("cuda", 0)))):
        try:
            fn()
            out[f"raises/{what}"] = np.asarray("")
        except (RuntimeError, ValueError) as e:
            out[f"raises/{what}"] = np.asarray(str(e))
    # kill_node and reshard on a mesh of one node a rank: the store's ids
    # are their slot numbers, so each rank's zone shows what it holds
    from repro_torch.core import runtime as runtime_mod

    rt = IndexRuntime(RuntimeConfig(params=LshParams(d=8, k=4, L=1),
                                    n_nodes=world),
                      mesh=mesh_mod.make_zone_mesh(world, device="cpu"))
    st = rt.shard_store(numbered_store(16, 2, 8))
    killed, _ = runtime_mod.kill_node(rt, st, None, 0)
    out["kill_node/ids"] = killed.ids.numpy()
    out["kill_node/gen"] = killed.generation.numpy()
    out["kill_node/input_ids"] = st.ids.numpy()
    _, moved, ev = runtime_mod.reshard(rt, st, world, mesh=rt.mesh)
    out["reshard/ids"] = moved.ids.numpy()
    out["reshard/gen"] = moved.generation.numpy()
    out["reshard/event"] = np.asarray([ev.old_n, ev.new_n, ev.moved_buckets,
                                       ev.handoff_bytes])
    return out


def numbered_store(nb: int, c: int, d: int) -> BucketStore:
    """A one-table store whose slot (b, j) holds id b*c + j."""
    from repro_torch.core.store import make_store

    st = make_store(1, nb, c, payload_dim=d, device="cpu")
    st.ids = torch.arange(nb * c, dtype=torch.int32).reshape(1, nb, c)
    return st


def _job_collectives_and_helpers(mesh_kw: dict) -> dict:
    return {**_job_collectives(mesh_kw), **_job_helpers(mesh_kw)}


# -- the P2P dynamics: replicas, kills, reshards, churn, serving -------------

# (R, read mode, nodes killed before the reads), tests/test_torch_failure.py's
REP_CELLS = [(2, "first", ()), (2, "first", (1,)), (2, "quorum", ()),
             (2, "quorum", (1,)), (3, "first", (1, 2)), (3, "quorum", (2,))]
# the time-based keys of a driver's result and of a serve summary
TIMED = ("epoch_ms", "reference_epoch_ms", "p50_us", "p99_us",
         "p50_queue_us", "p99_queue_us", "qps")


def rep_tag(R: int, mode: str, dead: tuple, fused: str) -> str:
    return f"R{R}-{mode}-dead{''.join(map(str, dead)) or 'none'}-{fused}"


def save_p2p_world(path: str, params, h, store: BucketStore, q, targets,
                   churn_hp, serve_hp) -> str:
    """The goldens world of tests/test_torch_failure.py as `p2p` loads it,
    with the JAX hyperplanes of the churn and the serving churn
    configurations."""
    np.savez(path, params=np.asarray([params.d, params.k, params.L,
                                      params.seed]),
             h=h.numpy(), ids=store.ids.numpy(), ts=store.timestamps.numpy(),
             ptr=store.write_ptr.numpy(), payload=store.payload.numpy(),
             gen=store.generation.numpy(), q=q, targets=targets,
             churn_hp=churn_hp, serve_hp=serve_hp)
    return path


def load_p2p_world(path: str) -> dict:
    z = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
    d, k, L, seed = (int(v) for v in z["params"])
    return dict(params=LshParams(d=d, k=k, L=L, seed=seed), h=z["h"],
                store=BucketStore(z["ids"], z["ts"], z["ptr"], z["payload"],
                                  z["gen"]),
                q=z["q"], targets=z["targets"], churn_hp=z["churn_hp"],
                serve_hp=z["serve_hp"])


def _rep_cell(w: dict, mesh, R: int, mode: str, dead: tuple,
              fused: str) -> dict:
    """Replicate, kill `dead`, then search and contains on a 4-node mesh;
    the replica slices are this rank's zones, the killed store is
    gathered over the world."""
    from repro_torch.core.runtime import gather_store, kill_node

    rt = IndexRuntime(RuntimeConfig(params=w["params"], n_nodes=4, m=10,
                                    variant="cnb", cap_factor=4.0,
                                    replication=R, read_mode=mode,
                                    fused=fused), mesh=mesh)
    st0 = rt.shard_store(w["store"])
    reps0 = rt.replicate_store(st0)
    cache = rt.refresh_cache(st0)
    out = dict(rep_ids=reps0[0].numpy(), rep_payload=reps0[1].numpy())
    before = [t.clone() for t in (st0.ids, st0.payload, *reps0)]
    st, reps, live = st0, reps0, np.ones(4, np.int32)
    for node in dead:
        st, reps = kill_node(rt, st, reps, node)
        live[node] = 0
    if dead:
        g = gather_store(st, rt.mesh, rt.cfg.params.num_buckets)
        out.update({f"killed_{f}": getattr(g, f).numpy() for f in (
            "ids", "timestamps", "write_ptr", "payload", "generation")})
        out.update(killed_rep_ids=reps[0].numpy(),
                   killed_rep_payload=reps[1].numpy(),
                   inputs_kept=np.asarray(all(torch.equal(a, b) for a, b in
                                              zip(before, (st0.ids,
                                                           st0.payload,
                                                           *reps0)))))
    q, h = w["q"], w["h"]
    ids, sc, s = rt.search(h, st, q, cache=cache, replicas=reps, live=live)
    hits, hs = rt.contains(h, st, q, w["targets"], cache=cache,
                           replicas=reps, live=live)
    out.update(ids=ids.numpy(), scores=sc.numpy(), stats=_stats(s),
               hits=hits.numpy(), hstats=_stats(hs))
    return out


def _reshard_trip(w: dict, mesh_for) -> dict:
    """1 -> 2 -> 4 -> 2 -> 1 nodes on the goldens world: a search at each
    stop (the 1-node ones with each query's own id excluded), the
    events, and the store back on one node."""
    from repro_torch.core.runtime import reshard

    h, q = w["h"], w["q"]
    ex = torch.arange(q.shape[0], dtype=torch.int32)
    rt1 = IndexRuntime(RuntimeConfig(params=w["params"], variant="cnb", m=10,
                                     cap_factor=float(w["params"].L)),
                       device="cpu")
    out, events = {}, []

    def search(tag, rt, st):
        if rt.mesh is None:
            ids, sc, s = rt.search(h, st, q, exclude=ex)
        else:
            ids, sc, s = rt.search(h, st, q, cache=rt.refresh_cache(st))
        out.update({f"{tag}/ids": ids.numpy(), f"{tag}/scores": sc.numpy(),
                    f"{tag}/stats": _stats(s),
                    f"{tag}/generation": st.generation.numpy()})

    st = w["store"]
    search("rs1", rt1, st)
    rt2, st, ev = reshard(rt1, st, 2, mesh=mesh_for(2))
    events.append(ev)
    search("rs2", rt2, st)
    out["mesh2/holds"] = np.asarray([rt2.mesh.active, st.ids.shape[1]])
    rt4, st, ev = reshard(rt2, st, 4, mesh=mesh_for(4), cap_factor=4.0)
    events.append(ev)
    search("rs4", rt4, st)
    rt2b, st, ev = reshard(rt4, st, runtime=rt2)
    events.append(ev)
    search("rs2b", rt2b, st)
    rt1b, st, ev = reshard(rt2b, st, 1)
    events.append(ev)
    search("rs1b", rt1b, st)
    out.update({f"rs1b/store_{f}": getattr(st, f).numpy() for f in (
        "ids", "timestamps", "write_ptr", "payload")})
    out["events"] = np.asarray([[e.old_n, e.new_n, e.moved_buckets,
                                 e.handoff_bytes] for e in events])
    out["rs1b/on_one_node"] = np.asarray(rt1b.mesh is None)
    return out


def _prefix_rows(w: dict, data: int) -> dict:
    """`data` rows of one node, on a prefix of `data` ranks of a process
    world: search, contains, an insert and an expire."""
    rt = IndexRuntime(RuntimeConfig(params=w["params"], n_nodes=1, m=10,
                                    variant="cnb", cap_factor=2.0),
                      mesh=mesh_mod.make_zone_mesh(1, data, device="cpu"))
    st = rt.shard_store(w["store"])
    q, h = w["q"], w["h"]
    ids, sc, s = rt.search(h, st, q)
    hits, hs = rt.contains(h, st, q, w["targets"])
    st = rt.insert(h, st, q, torch.arange(q.shape[0], dtype=torch.int32), 7)
    st = rt.expire(st, 9, ttl=5)
    after, _, _ = rt.search(h, st, q)
    return {"prefix/ids": ids.numpy(), "prefix/scores": sc.numpy(),
            "prefix/stats": _stats(s), "prefix/hits": hits.numpy(),
            "prefix/hstats": _stats(hs), "prefix/after_ids": after.numpy(),
            "prefix/generation": st.generation.numpy(),
            "prefix_holds": np.asarray([rt.mesh.active, st.ids.shape[1]])}


def flat_result(tag: str, res: dict, out: dict, obs=None) -> None:
    """A driver's result dict (and its obs) as npz arrays under `tag`;
    times left out."""
    for k, v in res.items():
        if k in TIMED or k == "stats":
            continue
        if k == "reshard_events":
            v = np.asarray([[e.old_n, e.new_n, e.moved_buckets,
                             e.handoff_bytes] for e in v]).reshape(-1, 4)
        elif k in ("recoveries", "kills"):
            v = np.asarray(v).reshape(-1, 3 if k == "recoveries" else 2)
        elif k == "summary":
            v = json.dumps({n: x for n, x in v.items() if n not in TIMED},
                           sort_keys=True)
        out[f"{tag}/{k}"] = np.asarray(v)
    if obs is not None:
        def rec(r):
            d = dataclasses.asdict(r)
            return {n: x for n, x in d.items()
                    if n not in ("t_us", "latency_us", "stage_us")}

        out[f"{tag}/flight"] = np.asarray(json.dumps(
            [rec(r) for r in obs.flight.records()], sort_keys=True))
        out[f"{tag}/dumps"] = np.asarray(json.dumps(
            [(d["reason"], d["detail"], d["n_records"])
             for d in obs.flight.dumps], sort_keys=True))
        out[f"{tag}/registry"] = np.asarray(json.dumps(
            obs.registry.snapshot(), sort_keys=True))


def _churn_cells(w: dict, churn_cfg: dict) -> dict:
    from repro_torch.core.churn import (
        ChurnConfig, FailureChurnConfig, NodeChurnConfig, run_churn_distributed,
        run_failure_churn, run_node_churn)
    from repro_torch.obs import Observability

    cfg, hp, out = ChurnConfig(**churn_cfg), w["churn_hp"], {}
    for mode in ("first", "quorum"):
        obs = Observability()
        flat_result(f"failure-{mode}", run_failure_churn(FailureChurnConfig(
            churn=cfg, n_nodes=4, replication=2, read_mode=mode,
            kills=((3, 1),)), obs=obs, device="cpu", hyperplanes=hp), out, obs)
    obs = Observability()
    flat_result("node", run_node_churn(NodeChurnConfig(
        churn=cfg, schedule=(1, 2, 4, 2, 1)), obs=obs, device="cpu",
        hyperplanes=hp), out, obs)
    flat_result("dist2", run_churn_distributed(cfg, n_shards=2, device="cpu",
                                               hyperplanes=hp), out)
    return out


@contextlib.contextmanager
def served_ids():
    """The ids of every `RetrievalFrontend.search` inside the block."""
    from repro_torch.serve import RetrievalFrontend

    got, real = [], RetrievalFrontend.search

    def spy(self, *a, **kw):
        res = real(self, *a, **kw)
        got.append(res[0])
        return res

    RetrievalFrontend.search = spy
    try:
        yield got
    finally:
        RetrievalFrontend.search = real


def _serve_cells(serve_cfg: dict) -> dict:
    from repro_torch.core.churn import ChurnConfig
    from repro_torch.serve import (
        ServeChurnConfig, ServeFailureConfig, run_serve_churn,
        run_serve_failure, run_serve_reshard)

    out = {}
    runs = dict(
        failure=lambda: run_serve_failure(ServeFailureConfig(
            churn=ChurnConfig(**serve_cfg["failure"]), n_nodes=4,
            replication=2), device="cpu"),
        reshard=lambda: run_serve_reshard(ServeChurnConfig(
            churn=ChurnConfig(**serve_cfg["churn"]), query_repeats=2,
            max_batch=16, queue_capacity=64), device="cpu"),
        writer=lambda: run_serve_churn(ServeChurnConfig(
            churn=ChurnConfig(**serve_cfg["churn"]), query_repeats=2,
            max_batch=16, queue_capacity=64, use_writer=True),
            device="cpu"))
    from repro_torch.serve import lifecycle

    real = lifecycle.ChurnWriter
    # the writer inline (prepared on the spot), as these cells ran it
    # before the threaded writer ran on a world of several processes;
    # `_serve_churn_threaded` runs it threaded
    lifecycle.ChurnWriter = lambda fe: real(fe, inline=True)
    try:
        for tag, run in runs.items():
            with served_ids() as ids:
                flat_result(f"serve-{tag}", run(), out)
            out[f"serve-{tag}/ids"] = np.concatenate(ids)
    finally:
        lifecycle.ChurnWriter = real
    return out


def _guard(w: dict) -> dict:
    """A rank fed another batch makes the dispatch guard raise on every
    rank."""
    from repro_torch.serve import RuntimeBackend

    out = {}
    rt = IndexRuntime(RuntimeConfig(params=w["params"], n_nodes=4, m=11,
                                    cap_factor=4.0),
                      mesh=mesh_mod.make_zone_mesh(4, device="cpu"))
    st = rt.shard_store(w["store"])
    backend = RuntimeBackend(rt, hyperplanes=w["h"], store=st,
                             cache=rt.refresh_cache(st))
    q = w["q"][:8].numpy().copy()
    ex = np.arange(8, dtype=np.int32)
    ids, _, _ = backend.dispatch(q, ex, 10)  # the same batch: served
    out["guard/same_ids"] = ids
    if dist.get_rank() == dist.get_world_size() - 1:
        q = q[::-1].copy()
    try:
        backend.dispatch(q, ex, 10)
        out["raises/guard"] = np.asarray("")
    except RuntimeError as e:
        out["raises/guard"] = np.asarray(f"{type(e).__name__}: {e}")
    return out


# -- serving under the controller rank (ROADMAP item 6c) ---------------------

WRITER_JOBS = 3


def openloop_args(*argv: str):
    """The serve_retrieval CLI's open-loop smoke arguments, on the CPU."""
    from repro_torch.launch import serve_retrieval as sr

    args = sr.build_parser().parse_args(
        ["--smoke", "--open-loop", "--device", "cpu", "--pipeline", "4",
         *argv])
    sr.smoke_preset(args)
    return args


def stream_arrays(tag: str, control) -> dict:
    """A controlled run's event stream as npz arrays under `tag`: rank 0
    its recorded stream (each dispatch's served ids and scores), a
    follower the ids of the dispatches it ran."""
    if not control.leads:
        return {f"{tag}/ids": np.concatenate(control.served)}
    rec = control.recorded()
    disp = [e for e in rec if e[0] == "dispatch"]
    return {f"{tag}/kinds": np.asarray([e[0] == "install" for e in rec]),
            f"{tag}/arg": np.asarray([e[1].shape[0] if e[0] == "dispatch"
                                      else e[1] for e in rec]),
            f"{tag}/m": np.asarray([e[3] if e[0] == "dispatch" else 0
                                    for e in rec]),
            f"{tag}/q": np.concatenate([e[1] for e in disp]),
            f"{tag}/ex": np.concatenate([e[2] for e in disp]),
            f"{tag}/ids": np.concatenate([e[4] for e in disp]),
            f"{tag}/scores": np.concatenate([e[5] for e in disp])}


def replay(stream: dict, tag: str, backend, updates=(),
           scores: bool = False):
    """Rank 0's recorded stream `tag` through `backend` in one process:
    each dispatch in turn, and at each install the prepared `updates`
    up to its job.  Returns the dispatches' ids, concatenated (with
    `scores`: ids and scores)."""
    got, got_s, done, row = [], [], 0, 0
    for install, arg, m in zip(stream[f"{tag}/kinds"], stream[f"{tag}/arg"],
                               stream[f"{tag}/m"]):
        if install:
            while done <= arg:
                backend.update(**updates[done])
                done += 1
            continue
        q = stream[f"{tag}/q"][row:row + arg]
        ex = stream[f"{tag}/ex"][row:row + arg]
        row += arg
        ids, sc, _ = backend.dispatch(q, ex, int(m))
        got.append(ids)
        got_s.append(sc)
    if scores:
        return np.concatenate(got), np.concatenate(got_s)
    return np.concatenate(got)


def writer_world(w: dict, data: int = 1, device="cpu",
                 use_kernels: bool | None = None):
    """A 4-node cnb mesh (`make_zone_mesh`: this rank's process mesh
    under a process group) on `device` behind a depth-2 frontend:
    (frontend, backend, the prep of write job j on a runtime, the
    queries).  On a card the mesh steps take their kernels, unless
    `use_kernels` is False."""
    from repro_torch.serve import FrontendConfig, RetrievalFrontend, \
        RuntimeBackend

    dev = torch.device(device)
    rt = IndexRuntime(RuntimeConfig(params=w["params"], n_nodes=4, m=11,
                                    variant="cnb", cap_factor=4.0,
                                    use_kernels=dev.type == "cuda"
                                    if use_kernels is None
                                    else use_kernels),
                      mesh=mesh_mod.make_zone_mesh(4, data, device=dev))
    st = rt.shard_store(w["store"])
    backend = RuntimeBackend(rt, hyperplanes=w["h"], store=st,
                             cache=rt.refresh_cache(st))
    fe = RetrievalFrontend(backend, FrontendConfig(
        m=10, max_batch=8, queue_capacity=64, pipeline_depth=2))
    state = dict(store=st)

    def prep(runtime, j: int) -> dict:
        """Write job j: re-announce 64 moved users (insert), expire, and
        the CNB cache refresh, each a collective of `runtime`'s mesh;
        chained on the previous job's store."""
        g = torch.Generator().manual_seed(100 + j)
        vecs = torch.nn.functional.normalize(
            torch.randn((64, w["h"].shape[-1]), generator=g), dim=1).to(dev)
        ids = torch.randint(0, 1200, (64,), generator=g,
                            dtype=torch.int32).to(dev)
        s = runtime.insert(w["h"], state["store"], vecs, ids, 5 + j)
        s = runtime.expire(s, 5 + j, ttl=8)
        state["store"] = s
        return dict(store=s, cache=runtime.refresh_cache(s))

    q = w["q"].cpu().numpy()
    return fe, backend, prep, q


def writer_under_control(w: dict, data: int = 1, device="cpu",
                         keep: list | None = None) -> dict:
    """Serving under the controller with a threaded writer on the process
    mesh: rank 0 submits 4 queries a tick, pumps, and hands the writer
    a job at ticks 2, 5 and 8 (installed at whichever stage boundary
    finds it ready); the followers submit the same jobs at once and
    serve what rank 0 announces.  `keep` (a list) receives the serving
    backend."""
    from repro_torch.serve.control import Controller
    from repro_torch.serve.writer import ChurnWriter

    fe, backend, prep, q = writer_world(w, data, device)
    control = Controller.of_world()
    writer = ChurnWriter(fe)
    try:
        if not control.leads:
            for j in range(WRITER_JOBS):
                writer.submit(lambda j=j: prep(writer.runtime, j))
            control.follow(backend, writer)
        else:
            with control.leading(backend):
                jobs = iter(range(WRITER_JOBS))
                for t in range(q.shape[0] // 4):
                    for i in range(4 * t, 4 * t + 4):
                        fe.submit(q[i], exclude=i)
                    if t in (2, 5, 8):
                        j = next(jobs)
                        writer.submit(lambda j=j: prep(writer.runtime, j))
                    fe.pump()
                fe.flush()
                writer.drain(timeout_s=300.0)
        out = stream_arrays("writer", control)
        out["writer/installed"] = np.asarray(writer.installed)
        out["writer/own_groups"] = np.asarray(
            writer.runtime.mesh.world_group is not None
            and writer.runtime.mesh is not backend.runtime.mesh)
        if keep is not None:
            keep.append(backend)
    finally:
        writer.close()
    return out


def _serve_churn_threaded(serve_cfg: dict, hp) -> dict:
    """`run_serve_churn` through the threaded writer (its default), in a
    closed loop on every rank, on the JAX hyperplanes `hp`."""
    from repro_torch.core.churn import ChurnConfig
    from repro_torch.serve import ServeChurnConfig, run_serve_churn

    out = {}
    with served_ids() as ids:
        flat_result("serve-threaded", run_serve_churn(ServeChurnConfig(
            churn=ChurnConfig(**serve_cfg["churn"]), query_repeats=2,
            max_batch=16, queue_capacity=64, pipeline_depth=4,
            use_writer=True), device="cpu", hyperplanes=hp), out)
    out["serve-threaded/ids"] = np.concatenate(ids)
    return out


def _serve_6c(w: dict, data: int, serve_cfg: dict) -> dict:
    from repro_torch.launch import serve_retrieval

    ol = serve_retrieval.run_openloop(openloop_args())
    out = stream_arrays("openloop", ol["control"])
    out["openloop/identical"] = np.asarray(ol["identical"])
    out["openloop/rate"] = np.asarray(ol["rate"])
    out.update(writer_under_control(w, data))
    out.update(_serve_churn_threaded(serve_cfg, w["serve_hp"]))
    return out


def p2p_cells(w: dict, parts, data: int = 1, churn_cfg=None,
              serve_cfg=None) -> dict:
    """The P2P cells of `parts` on meshes from `make_zone_mesh`: the
    one-process meshes without a process group, this rank's process
    meshes under one."""
    def mesh_for(n):
        return mesh_mod.make_zone_mesh(n, data, device="cpu")

    out = {}
    if "rep" in parts:
        mesh = mesh_for(4)
        out["place"] = np.asarray(
            [getattr(mesh, "row", 0), getattr(mesh, "block", 0),
             getattr(mesh, "n_loc", 4)])
        for R, mode, dead in REP_CELLS:
            for fused in ("off", "on"):
                tag = rep_tag(R, mode, dead, fused)
                for k, v in _rep_cell(w, mesh, R, mode, dead, fused).items():
                    out[f"{tag}/{k}"] = v
    if "prefix" in parts:
        out.update(_prefix_rows(w, data))
    if "reshard" in parts:
        out.update(_reshard_trip(w, mesh_for))
    if "churn" in parts:
        out.update(_churn_cells(w, churn_cfg))
    if "serve" in parts:
        out.update(_serve_cells(serve_cfg))
    if "guard" in parts:
        out.update(_guard(w))
    if "serve6c" in parts:
        out.update(_serve_6c(w, data, serve_cfg))
    return out


def _job_p2p(kw: dict) -> dict:
    return p2p_cells(load_p2p_world(kw["world_npz"]), kw["parts"],
                     kw.get("data", 1), kw.get("churn_cfg"),
                     kw.get("serve_cfg"))


JOBS = dict(cells=_job_cells, collectives=_job_collectives_and_helpers,
            p2p=_job_p2p)


def _entry(rank: int, world: int, port: int, job: str, outdir: str,
           kw: dict) -> None:
    torch.set_num_threads(1)
    mesh_mod.init_process_mesh(device="cpu",
                               init_method=f"tcp://127.0.0.1:{port}",
                               rank=rank, world_size=world)
    try:
        out = JOBS[job](kw)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: str, world: int, outdir: str, timeout: float = 600,
          **kw) -> list[dict]:
    """Run `job` on `world` gloo ranks; each rank's outputs, in rank
    order.  The ranks are killed, and TimeoutError raised, if they have
    not all ended within `timeout` seconds."""
    ctx = mp.spawn(_entry, args=(world, free_port(), job, outdir, kw),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{job} on {world} ranks: not done in "
                               f"{timeout} s")
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
            for r in range(world)]
