"""Gloo ranks for tests/test_torch_dist_mesh.py (not collected).

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
    helpers' shapes and refusals inside the world.

This module imports torch and the port only, never jax, so that a
spawned rank starts quickly.
"""

from __future__ import annotations

import os
import socket

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
    mesh = mesh_mod.make_zone_mesh(world, device="cpu")
    from repro_torch.core import runtime as runtime_mod

    for what in ("kill_node", "reshard"):
        try:
            rt = IndexRuntime(RuntimeConfig(params=LshParams(d=8, k=4, L=1),
                                            n_nodes=world), mesh=mesh)
            if what == "kill_node":
                runtime_mod.kill_node(rt, None, None, 0)
            else:
                runtime_mod.reshard(rt, None, world)
            out[f"raises/{what}"] = np.asarray("")
        except NotImplementedError as e:
            out[f"raises/{what}"] = np.asarray(str(e))
    return out


def _job_collectives_and_helpers(mesh_kw: dict) -> dict:
    return {**_job_collectives(mesh_kw), **_job_helpers(mesh_kw)}


JOBS = dict(cells=_job_cells, collectives=_job_collectives_and_helpers)


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


def spawn(job: str, world: int, outdir: str, **kw) -> list[dict]:
    """Run `job` on `world` gloo ranks; each rank's outputs, in rank
    order."""
    mp.spawn(_entry, args=(world, free_port(), job, outdir, kw),
             nprocs=world, join=True)
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
            for r in range(world)]
