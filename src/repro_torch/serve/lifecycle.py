"""Online updates: interleave churn maintenance with serving (DESIGN.md
Sec. 7 read/write epochs).

The churn module measures index freshness with the runtime's own search;
this driver measures it END-TO-END through the serving stack instead: ONE
long-lived `RetrievalFrontend` serves every epoch's queries while the
soft-state maintenance (`insert_batch` + `expire`, paper Sec. 4.1) runs
between read epochs.  Each write epoch bumps the store generation, which
is exactly what invalidates the sketch-keyed result cache — so the run
demonstrates the full contract: repeated queries hit the cache WITHIN a
store generation, never across a mutation, and recall under live churn
matches the reference trajectory (`core.churn.run_churn`) exactly.

Every driver runs on `device` (the CUDA card unless "cpu") over the
trajectory of `core.churn` (the JAX package's numpy RNG stream); in a
world of several processes every rank runs it alike, and the writer
runs inline (`ChurnWriter`).  The drivers use the port's own
hyperplanes unless `hyperplanes=` passes others (the reference's, to
compare trajectories).  On the card the serving engines
and runtimes take their kernels (`use_kernels`): simhash and bucket_topk
behind the engine, fused_query in every owner stage, bucket_topk in the
replicated mesh's cache stage.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import costmodel, hashing, metrics
from repro_torch.core.churn import (
    ChurnConfig, _lsh_setup, _pad_to, _trajectory, _zone_mesh,
    make_churn_runtime,
)
from repro_torch.core.corpus import DenseCorpus
from repro_torch.core.engine import EngineConfig, LshEngine
from repro_torch.core.runtime import IndexRuntime, RuntimeConfig, kill_node, \
    reshard
from repro_torch.core.store import expire, insert_batch, make_store
from repro_torch.serve.frontend import FrontendConfig, RetrievalFrontend, \
    RuntimeBackend
from repro_torch.serve.writer import ChurnWriter


@dataclasses.dataclass(frozen=True)
class ServeChurnConfig:
    churn: ChurnConfig = ChurnConfig()
    query_repeats: int = 2     # replays of each epoch's query batch — the
    #                            repeats exercise the cache within an epoch
    max_batch: int = 32
    queue_capacity: int = 512
    cache: bool = True
    variant: str = "cnb"
    pipeline_depth: int = 1    # staged device batches (DESIGN.md Sec. 13);
    #                            the trajectory is bit-identical at any depth
    use_writer: bool = False   # route write epochs through the background
    #                            ChurnWriter (prepare/install split) instead
    #                            of mutating the backend on the serving path


def _read_queries(vecs: torch.Tensor, qidx: np.ndarray) -> np.ndarray:
    """The epoch's query rows, as the host array the frontend takes."""
    return vecs[torch.from_numpy(qidx).to(vecs.device)].cpu().numpy()


def _announce_pads(rt: IndexRuntime, c: ChurnConfig, vecs: torch.Tensor):
    """(vectors, ids) of one announce, padded to the runtime's slices."""
    nu = -(-c.num_users // rt.n_devices) * rt.n_devices
    ids = torch.arange(c.num_users, dtype=torch.int32, device=vecs.device)
    return _pad_to(vecs, nu, 0.0), _pad_to(ids, nu, -1)


def run_serve_churn(cfg: ServeChurnConfig, obs=None, *, device=None,
                    hyperplanes=None) -> dict:
    """Drive the churn trajectory through the serving frontend.

    Write epochs: announce (insert_batch) + GC (expire) + backend.update —
    one generation bump per mutation, invalidating the cache.  Read
    epochs: the epoch's query batch is served `query_repeats` times; all
    repeats must return identical ids (cache hits are real results, never
    stale ones), and repeat recall is measured per epoch.  With `obs`
    (an `repro_torch.obs.Observability`) the frontend traces its pipeline
    spans and flight records per query (DESIGN.md Sec. 12).

    `cfg.use_writer` routes each write epoch through the `ChurnWriter`
    prepare/install split (DESIGN.md Sec. 13): the epoch's announce +
    expire build the new store inside the writer's prep function and the
    prepared update installs through `apply_update` at the next stage
    boundary — `drain()` is the per-epoch barrier, so the trajectory
    (and every recall number) stays bit-identical to the direct path.
    `cfg.pipeline_depth` deepens the device dispatch queue; depth changes
    batch OVERLAP, never batch composition, so the trajectory is
    bit-identical there too (tests/test_torch_pipeline.py).
    """
    c = cfg.churn
    dev = resolve_device(device)
    params, hp = _lsh_setup(c, dev, hyperplanes)
    store = make_store(c.L, params.num_buckets, c.capacity, device=dev)

    # one engine for the whole run; the backend swaps store/corpus per
    # write epoch (they are step arguments)
    engine = LshEngine(
        params, hp, store,
        DenseCorpus(torch.zeros((c.num_users, c.dim), device=dev)), None,
        EngineConfig(variant=cfg.variant, use_kernels=dev.type == "cuda"),
        device=dev,
    )
    backend = RuntimeBackend(engine)
    frontend = RetrievalFrontend(
        backend,
        FrontendConfig(
            m=c.m, max_batch=cfg.max_batch,
            queue_capacity=cfg.queue_capacity, cache=cfg.cache,
            pipeline_depth=cfg.pipeline_depth,
        ),
        obs=obs,
    )
    writer = ChurnWriter(frontend) if cfg.use_writer else None
    all_ids = torch.arange(c.num_users, dtype=torch.int32, device=dev)

    def prep_write(epoch, vecs):
        """One write epoch's heavy half: sketch + insert + expire.  Runs
        on the writer thread when `use_writer`; returns the update kwargs
        the install half applies at a stage boundary.  Chains the
        closed-over `store` so consecutive epochs compose (the writer
        runs preps FIFO on one thread); `insert_batch` clones it, so the
        installed store is never written."""
        nonlocal store
        codes = hashing.sketch_codes(vecs, hp)
        store = insert_batch(store, all_ids, codes, epoch)
        if epoch > 0:
            store = expire(store, epoch, ttl=c.ttl_epochs)
        return dict(store=store, corpus=DenseCorpus(vecs))

    recalls, generations, repeat_mismatches = [], [], 0
    for epoch, vecs, do_refresh, qidx, ideal in _trajectory(c, dev):
        if do_refresh:  # -- write epoch -----------------------------------
            # the trajectory updates `vecs` in place: announce a copy
            announced = vecs.clone()
            if writer is not None:
                ep = int(epoch)
                writer.submit(lambda v=announced, e=ep: prep_write(e, v))
                # per-epoch barrier: prepared AND installed before the
                # epoch's reads, so the trajectory matches the reference
                writer.drain()
            else:
                backend.update(**prep_write(epoch, announced))
        if epoch == 0:
            continue

        # -- read epoch -----------------------------------------------------
        q = _read_queries(vecs, qidx)
        first_ids = None
        for _ in range(max(cfg.query_repeats, 1)):
            ids, _scores = frontend.search(q, exclude=qidx)
            if first_ids is None:
                first_ids = ids
                recalls.append(metrics.recall_at_m(ids, ideal))
            elif not np.array_equal(ids, first_ids):
                repeat_mismatches += 1  # a cache hit diverged — must be 0
        generations.append(backend.generation)

    if writer is not None:
        writer.close()
    if obs is not None:
        frontend.stats.publish(obs.registry)
    return dict(
        recalls=np.asarray(recalls),
        final_recall=float(recalls[-1]),
        mean_recall=float(np.mean(recalls)),
        generations=np.asarray(generations),
        store_generation=int(store.generation),
        repeat_mismatches=repeat_mismatches,
        writer_installed=0 if writer is None else writer.installed,
        stats=frontend.stats,
        summary=frontend.stats.summary(),
        refresh_every=c.refresh_every,
    )


def run_serve_reshard(cfg: ServeChurnConfig, mesh=None, obs=None, *,
                      device=None, hyperplanes=None) -> dict:
    """Churn trajectory through the frontend with a LIVE topology swap at
    every read epoch (the serving half of elastic membership, DESIGN.md
    Sec. 9).

    One long-lived `RetrievalFrontend` over a payload-carrying store; the
    backend alternates between the 1-node runtime and a 1-node zone mesh
    (`make_zone_mesh(1)`, the routed step; in a world of several
    processes, on rank 0, the others receiving its results) — the two
    execution contexts of one node — via `runtime.reshard` +
    `frontend.update_backend`.
    Each read epoch serves its query batch three times: before the swap,
    right after it (every cached entry must be stale — the generation
    bump — and the recomputed ids must be IDENTICAL, the reshard
    bit-identity contract live on the serving path), and once more (hits
    again, same ids).  Soft-state maintenance runs between read epochs on
    whichever topology is current; recall matches the `run_churn`
    reference trajectory exactly.
    """
    c = cfg.churn
    dev = resolve_device(device) if mesh is None else mesh.device
    params, hp = _lsh_setup(c, dev, hyperplanes)
    if mesh is None:
        mesh = _zone_mesh(1, dev)
    # m+1 headroom: the mesh dispatch has no wire exclusion, the serving
    # layer filters the self id host-side (the churn drivers' convention)
    rcfg = RuntimeConfig(params=params, variant=cfg.variant, m=c.m + 1,
                         n_nodes=1, cap_factor=1.0)
    rt = IndexRuntime(rcfg, device=dev)
    rt_other = {False: IndexRuntime(rcfg, mesh=mesh), True: rt}
    store = make_store(c.L, params.num_buckets, c.capacity,
                       payload_dim=c.dim, device=dev)

    backend = RuntimeBackend(rt, hyperplanes=hp, store=store)
    frontend = RetrievalFrontend(
        backend,
        FrontendConfig(
            m=c.m, max_batch=cfg.max_batch,
            queue_capacity=cfg.queue_capacity, cache=cfg.cache,
        ),
        obs=obs,
    )

    recalls, generations = [], []
    repeat_mismatches = swaps = 0
    total_handoff = 0
    for epoch, vecs, do_refresh, qidx, ideal in _trajectory(c, dev):
        if do_refresh:  # -- write epoch (current topology) ---------------
            vpad, ids_pad = _announce_pads(rt, c, vecs)
            store = rt.insert(hp, store, vpad, ids_pad, epoch)
            if epoch > 0:
                store = rt.expire(store, epoch, ttl=c.ttl_epochs)
            store = rt.payload_sync(store, vpad)
            frontend.update_backend(store=store)
        if epoch == 0:
            continue

        # -- read epoch: serve, swap topology live, serve again ------------
        q = _read_queries(vecs, qidx)
        ids_pre, _ = frontend.search(q, exclude=qidx)
        recalls.append(metrics.recall_at_m(ids_pre, ideal))

        rt_new = rt_other[rt.is_distributed]
        rt, store, ev = reshard(rt, store, runtime=rt_new)
        total_handoff += ev.handoff_bytes
        swaps += 1
        if obs is not None:
            obs.flight.note_anomaly(
                "reshard", epoch=int(epoch), old_n=int(ev.old_n),
                new_n=int(ev.new_n), handoff_bytes=int(ev.handoff_bytes),
            )
        frontend.update_backend(runtime=rt, store=store)

        for _ in range(2):  # post-swap recompute, then cache-served
            ids_post, _ = frontend.search(q, exclude=qidx)
            if not np.array_equal(ids_post, ids_pre):
                repeat_mismatches += 1
        generations.append(backend.generation)

    if obs is not None:
        frontend.stats.publish(obs.registry)
    cache = frontend.cache
    return dict(
        recalls=np.asarray(recalls),
        final_recall=float(recalls[-1]),
        mean_recall=float(np.mean(recalls)),
        generations=np.asarray(generations),
        repeat_mismatches=repeat_mismatches,
        swaps=swaps,
        total_handoff_bytes=int(total_handoff),
        stale_evictions=0 if cache is None else cache.stale_evictions,
        cache_hits=0 if cache is None else cache.hits,
        stats=frontend.stats,
        summary=frontend.stats.summary(),
    )


@dataclasses.dataclass(frozen=True)
class ServeFailureConfig:
    """Serving through a fail-stop node loss (DESIGN.md Sec. 10): one
    node of an R-way replicated mesh dies MID-EPOCH with no handoff, the
    frontend keeps serving through the surviving replicas, and the next
    announce epoch revives the node."""

    churn: ChurnConfig = ChurnConfig()
    n_nodes: int = 4
    replication: int = 2
    read_mode: str = "first"        # first | quorum
    kill_epoch: int = 3             # read epoch the node dies in
    kill_node: int = 1
    max_batch: int = 32
    queue_capacity: int = 512
    cache: bool = True


def run_serve_failure(cfg: ServeFailureConfig, mesh=None, obs=None, *,
                      device=None, hyperplanes=None) -> dict:
    """Churn trajectory through ONE long-lived frontend while a node dies
    and revives under it.

    The backend is a replicated mesh runtime (`make_churn_runtime` with
    R > 1, its n nodes on one device, or over the processes of the
    world, each rank running this driver); every write epoch re-announces,
    refreshes the NB cache, re-replicates (`IndexRuntime.
    replicate_store`, bytes charged via the Sec. 10 closed form), and
    installs the lot through `frontend.update_backend`.  At `kill_epoch`
    the epoch's queries are served once at full liveness, then
    `kill_node` blanks the victim's zone and replica slices and the
    DEAD-node state installs as a plain `update(store=, replicas=,
    live=)` — no runtime swap, so the dispatch binding (and its
    m-headroom) survives while the generation bump kills every
    pre-failure cached result.  The same queries are served again
    through the survivors; the next announce revives the node (recovery
    bytes charged) and serving returns to full liveness.

    Returns per-epoch recalls plus the kill-epoch pair
    (`recall_before_kill` / `recall_after_kill`), generation trace, and
    the usual cache/stats evidence that repeats within a generation are
    bit-identical and nothing stale is ever served.
    """
    c = cfg.churn
    if not 1 <= cfg.kill_epoch <= c.epochs:
        raise ValueError(f"kill_epoch {cfg.kill_epoch} outside the "
                         f"trajectory's read epochs 1..{c.epochs}")
    if not 0 <= cfg.kill_node < cfg.n_nodes:
        raise ValueError(f"kill_node {cfg.kill_node} outside "
                         f"0..{cfg.n_nodes - 1}")
    if mesh is None:
        mesh = _zone_mesh(cfg.n_nodes, resolve_device(device))
    dev = mesh.device
    params, hp = _lsh_setup(c, dev, hyperplanes)
    rt = make_churn_runtime(
        c, cfg.n_nodes, mesh=mesh,
        replication=cfg.replication, read_mode=cfg.read_mode,
    )
    if dev.type == "cuda":  # the cache stage through bucket_topk
        rt = IndexRuntime(dataclasses.replace(rt.cfg, use_kernels=True),
                          mesh=mesh)
    store = rt.shard_store(make_store(c.L, params.num_buckets, c.capacity,
                                      payload_dim=c.dim, device=dev))
    live = np.ones((cfg.n_nodes,), np.int32)
    replicas = rt.replicate_store(store)
    nbcache = rt.refresh_cache(store)

    backend = RuntimeBackend(rt, hyperplanes=hp, store=store,
                             cache=nbcache, replicas=replicas)
    frontend = RetrievalFrontend(
        backend,
        FrontendConfig(
            m=c.m, max_batch=cfg.max_batch,
            queue_capacity=cfg.queue_capacity, cache=cfg.cache,
        ),
        obs=obs,
    )

    recalls, generations, degraded = [], [], []
    repeat_mismatches = 0
    replication_bytes = recovery_bytes = 0
    recall_before_kill = recall_after_kill = None
    per_rep = costmodel.estimate_replication_bytes(
        c.L, c.num_users, c.dim, cfg.replication)
    per_zone = costmodel.estimate_recovery_bytes(
        c.L, params.num_buckets // cfg.n_nodes, c.capacity, c.dim)
    for epoch, vecs, do_refresh, qidx, ideal in _trajectory(c, dev):
        if do_refresh:  # -- write epoch (revives any dead node) ----------
            if not live.all():
                recovery_bytes += per_zone * int((live == 0).sum())
                live[:] = 1
            vpad, ids_pad = _announce_pads(rt, c, vecs)
            store = rt.insert(hp, store, vpad, ids_pad, epoch)
            if epoch > 0:
                store = rt.expire(store, epoch, ttl=c.ttl_epochs)
            store = rt.payload_sync(store, vpad)
            nbcache = rt.refresh_cache(store)
            replicas = rt.replicate_store(store)
            replication_bytes += per_rep
            frontend.update_backend(store=store, cache=nbcache,
                                    replicas=replicas, live=live.copy())
        if epoch == 0:
            continue

        # -- read epoch ----------------------------------------------------
        q = _read_queries(vecs, qidx)
        if epoch == cfg.kill_epoch:
            # full-liveness pass first, then the node dies MID-EPOCH
            ids_pre, _ = frontend.search(q, exclude=qidx)
            recall_before_kill = metrics.recall_at_m(ids_pre, ideal)
            store, replicas = kill_node(rt, store, replicas, cfg.kill_node)
            live[cfg.kill_node] = 0
            if obs is not None:
                # the mid-epoch fail-stop: dump the flight ring so the
                # pre-failure query records are preserved for post-mortem
                obs.flight.note_anomaly(
                    "kill_node", node=int(cfg.kill_node), epoch=int(epoch),
                    live_nodes=int(live.sum()),
                )
            frontend.update_backend(store=store, replicas=replicas,
                                    live=live.copy())
        ids, _ = frontend.search(q, exclude=qidx)
        recalls.append(metrics.recall_at_m(ids, ideal))
        if epoch == cfg.kill_epoch:
            recall_after_kill = recalls[-1]
        ids2, _ = frontend.search(q, exclude=qidx)
        if not np.array_equal(ids2, ids):
            repeat_mismatches += 1  # a cache hit diverged — must be 0
        generations.append(backend.generation)
        degraded.append(bool((live == 0).any()))

    if obs is not None:
        frontend.stats.publish(obs.registry)
    cache = frontend.cache
    return dict(
        recalls=np.asarray(recalls),
        final_recall=float(recalls[-1]),
        generations=np.asarray(generations),
        degraded=np.asarray(degraded),
        recall_before_kill=recall_before_kill,
        recall_after_kill=recall_after_kill,
        repeat_mismatches=repeat_mismatches,
        replication_bytes=int(replication_bytes),
        recovery_bytes=int(recovery_bytes),
        stale_evictions=0 if cache is None else cache.stale_evictions,
        cache_hits=0 if cache is None else cache.hits,
        stats=frontend.stats,
        summary=frontend.stats.summary(),
    )
