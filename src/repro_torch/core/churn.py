"""Dynamic-OSN churn simulation (paper Sec. 2.2 + Sec. 4.1 soft state).

The paper's data model: users join/leave and update their interest
profiles; bucket nodes hold soft state that users re-announce
periodically, and entries older than a TTL are garbage-collected.  Each
epoch of the trajectory:

  1. a fraction `update_rate` of users mutate their interest vectors
     (their true buckets move);
  2. a fraction `churn_rate` of users leave and are replaced by fresh
     users (new vectors under reused ids);
  3. every `refresh_every` epochs, all live users re-announce and the
     store expires entries older than `ttl`;
  4. CNB-LSH recall@m is measured against the current ground truth.

One driver (`run_churn_runtime`) over one trajectory generator and one
execution layer (`repro_torch.core.runtime.IndexRuntime`): announces go
through the runtime's insert step, GC through expire, payload freshness
through payload sync, the CNB neighbour cache (when the topology has
node bits) through its refresh, and queries through its search step.

Under a `torch.distributed` process group every rank runs the same
driver on the same trajectory: the meshes come from `make_zone_mesh`
(blocks of nodes over the world, or a prefix of it where a topology has
fewer nodes than ranks), a 1-node topology runs whole on every rank,
and every rank returns the same, global, results.

  * `run_churn(cfg)`             - the 1-node topology (the reference);
  * `run_churn_distributed(cfg)` - the same loop on an n-node zone mesh;
  * `run_node_churn(cfg)`        - the node set joins and leaves on a
    schedule (`runtime.reshard` rounds, handoff bytes charged);
  * `run_failure_churn(cfg)`     - fail-stop kills (`runtime.kill_node`)
    served from R-way replicas, against a no-failure reference run.

The world trajectory is the JAX package's numpy RNG stream, draw for
draw, so vectors, churn events and query draws equal the reference's.
Its ground truth (each query's exact top m, own id excluded) is computed
on the runtime's device in query chunks, with ties to the lower id.
Hyperplanes come from the port's own generator unless the caller passes
`hyperplanes=` (the reference's, to compare trajectories).

Scoring uses the announced snapshot of each vector, not the live one:
the paper's LocalSimSearch runs at the bucket node against the copies
users last announced (Alg. 1), so between refreshes both the buckets and
the scores are stale, and recall against the current ground truth
measures that freshness cost.
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import costmodel, metrics
from repro_torch.core.hashing import LshParams, make_hyperplanes
from repro_torch.core.runtime import IndexRuntime, RuntimeConfig, kill_node, \
    reshard
from repro_torch.core.store import make_store
from repro_torch.obs.flight import QueryRecord


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    num_users: int = 4000
    dim: int = 64
    k: int = 6
    L: int = 4
    capacity: int = 128
    epochs: int = 12
    update_rate: float = 0.05     # users mutating their vector per epoch
    churn_rate: float = 0.02      # users replaced per epoch
    refresh_every: int = 2        # re-announce period (epochs)
    ttl_epochs: int = 4           # GC horizon
    mutation: float = 0.5         # vector drift magnitude on update
    num_queries: int = 128
    m: int = 10
    seed: int = 0


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _lsh_setup(cfg: ChurnConfig, device, hyperplanes=None):
    """(params, hyperplanes [L, k, d] on `device`): the port's own draw
    for `seed + 1`, or the given ones (e.g. the reference's)."""
    params = LshParams(d=cfg.dim, k=cfg.k, L=cfg.L, seed=cfg.seed + 1)
    if hyperplanes is None:
        return params, make_hyperplanes(params, device=device)
    hp = (hyperplanes if torch.is_tensor(hyperplanes) else torch.from_numpy(
        np.array(hyperplanes, np.float32))).to(device, torch.float32)
    if tuple(hp.shape) != (cfg.L, cfg.k, cfg.dim):
        raise ValueError(f"hyperplanes of shape {tuple(hp.shape)}, want "
                         f"{(cfg.L, cfg.k, cfg.dim)}")
    return params, hp


def _ideal_topm(vecs: torch.Tensor, qidx: np.ndarray, m: int,
                chunk: int = 256) -> np.ndarray:
    """int32 [nq, m]: each query's m most similar users by dot product,
    its own id excluded, best first, ties to the lower id.  On `vecs`'s
    device, `chunk` queries at a time: a [chunk, num_users] score block
    and a top-m, never a full sort (unless a tie straddles rank m)."""
    q_all = torch.from_numpy(np.asarray(qidx, np.int64)).to(vecs.device)
    out = []
    for s in range(0, q_all.numel(), chunk):
        qi = q_all[s:s + chunk]
        sims = vecs[qi] @ vecs.T
        sims[torch.arange(qi.numel(), device=vecs.device), qi] = -np.inf
        vals, idx = torch.topk(sims, m, dim=1)
        # best first, equal scores by id: sort by id, then stably by score
        by_id = torch.argsort(idx, dim=1)
        vals, idx = vals.gather(1, by_id), idx.gather(1, by_id)
        by_val = torch.argsort(vals, dim=1, descending=True, stable=True)
        idx = idx.gather(1, by_val)
        tied = (sims >= vals.gather(1, by_val)[:, -1:]).sum(1) > m
        for r in torch.nonzero(tied).flatten().tolist():
            idx[r] = torch.sort(sims[r], descending=True,
                                stable=True).indices[:m]
        out.append(idx)
    return torch.cat(out).to(torch.int32).cpu().numpy()


def _trajectory(cfg: ChurnConfig, device):
    """Yield the per-epoch world state: one numpy RNG stream shared by
    every driver (the reference's, draw for draw), so 1-node and mesh
    runs see identical vectors, churn events and query draws.

    Yields (epoch, vecs, do_refresh, qidx, ideal), `vecs` the current
    [num_users, dim] f32 vectors on `device`; epoch 0 is the initial
    announce (qidx and ideal None)."""
    rng = np.random.default_rng(cfg.seed)
    vecs = _unit(rng.standard_normal((cfg.num_users, cfg.dim))).astype(
        np.float32)
    dvecs = torch.from_numpy(vecs).to(device)
    yield 0, dvecs, True, None, None

    for epoch in range(1, cfg.epochs + 1):
        # 1. profile updates (vector drift)
        n_upd = int(cfg.update_rate * cfg.num_users)
        upd = rng.choice(cfg.num_users, n_upd, replace=False)
        vecs[upd] = _unit(
            vecs[upd] + cfg.mutation * rng.standard_normal((n_upd, cfg.dim))
        ).astype(np.float32)
        # 2. churn: replace users (id reused; semantics = leave + join)
        n_churn = int(cfg.churn_rate * cfg.num_users)
        rep = rng.choice(cfg.num_users, n_churn, replace=False)
        vecs[rep] = _unit(
            rng.standard_normal((n_churn, cfg.dim))).astype(np.float32)
        changed = np.concatenate([upd, rep])
        dvecs[torch.from_numpy(changed).to(device)] = torch.from_numpy(
            vecs[changed]).to(device)

        # 4. current ground truth for this epoch's query draw
        qidx = rng.choice(cfg.num_users, cfg.num_queries, replace=False)
        ideal = _ideal_topm(dvecs, qidx, cfg.m)

        yield epoch, dvecs, epoch % cfg.refresh_every == 0, qidx, ideal


def _pad_to(x, n: int, fill):
    """Pad the leading axis of an array or tensor to `n` rows."""
    if x.shape[0] == n:
        return x
    if torch.is_tensor(x):
        pad = torch.full((n - x.shape[0],) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        return torch.cat([x, pad])
    pad = np.full((n - x.shape[0],) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad], axis=0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_churn_runtime(
    cfg: ChurnConfig,
    n_shards: int = 1,
    mesh=None,
    cap_factor: float | None = None,
    replication: int = 1,
    read_mode: str = "first",
    *,
    device=None,
) -> IndexRuntime:
    """The runtime a churn trajectory executes on (on `mesh`'s device, or
    on `device`: the CUDA card unless "cpu").

    `m` carries one result of headroom: the routed search has no
    exclusion, so the driver drops the query's own id on the host, the
    same convention on every topology.  cap_factor = n_shards guarantees
    zero drops (the worst case routes every probe of a node to one
    owner)."""
    params = LshParams(d=cfg.dim, k=cfg.k, L=cfg.L, seed=cfg.seed + 1)
    rcfg = RuntimeConfig(
        params=params, n_nodes=n_shards, variant="cnb", m=cfg.m + 1,
        routing="alltoall",
        cap_factor=float(n_shards if cap_factor is None else cap_factor),
        replication=replication, read_mode=read_mode,
    )
    return IndexRuntime(rcfg, mesh=mesh, device=device)


def _expand_schedule(schedule, epochs: int) -> list[int]:
    """Per-epoch node counts (length epochs + 1, epoch 0 included): a
    short schedule holds its last value; a long one is clipped.  Every
    entry must be a power of two >= 1 (the `can.py` join/leave rounds)."""
    sched = [int(n) for n in schedule]
    if not sched:
        raise ValueError("empty membership schedule")
    for n in sched:
        if n < 1 or (n & (n - 1)):
            raise ValueError(f"schedule entries must be powers of two, "
                             f"got {n}")
    return (sched + [sched[-1]] * (epochs + 1))[: epochs + 1]


def _zone_mesh(n: int, device=None):
    from repro_torch.launch.mesh import make_zone_mesh

    return make_zone_mesh(n, device=device)


def _expand_kills(kills, epochs: int, n_nodes: int) -> dict[int, list[int]]:
    """Normalize a failure schedule ((epoch, node), ...) to epoch -> nodes.
    Kills fire at epoch start, before the epoch's announces and queries."""
    by_epoch: dict[int, list[int]] = {}
    for epoch, node in kills:
        epoch, node = int(epoch), int(node)
        if not (0 <= epoch <= epochs):
            raise ValueError(f"kill epoch {epoch} outside [0, {epochs}]")
        if not (0 <= node < n_nodes):
            raise ValueError(f"kill node {node} outside [0, {n_nodes})")
        by_epoch.setdefault(epoch, []).append(node)
    return by_epoch


def run_churn_runtime(
    cfg: ChurnConfig,
    rt: IndexRuntime,
    *,
    schedule=None,
    mesh_for=None,
    kills=None,
    obs=None,
    hyperplanes=None,
    on_read=None,
) -> dict:
    """Drive the churn trajectory on any topology (the one driver).

    Announce epochs: runtime insert + expire + payload sync (+ CNB cache
    refresh when the topology has node bits; between refreshes that
    cache is stale, the freshness/cost trade of the paper's periodic
    bucket exchange).  Read epochs: runtime search + host-side
    self-exclusion, recall against the current ground truth.

    `schedule` (per-epoch node counts, see `_expand_schedule`) churns
    the topology itself: whenever the scheduled count differs from the
    current runtime's, a membership round fires first (`runtime.reshard`:
    zone split/merge, bucket-state handoff, cache rewarm), with handoff
    and refresh bytes charged per epoch.  `mesh_for(n)` supplies the
    mesh of an n-node topology (default: a zone mesh on the runtime's
    device); runtimes are kept per node count and reused.

    `kills` ((epoch, node), ...) injects fail-stop losses with no handoff
    (`runtime.kill_node` at epoch start; exclusive with `schedule`): the
    zone is gone, the node's liveness bit drops to 0, and queries read
    through the R-way replicas until the next announce epoch revives the
    node and repopulates its zone (recovery bytes charged per revival).
    Needs `rt.cfg.replication > 1`; each announce's R-1-way fan-out is
    charged through `costmodel.estimate_replication_bytes`.

    With `obs` (an `repro_torch.obs.Observability`) the run feeds the
    flight recorder and metrics registry: one ``epoch`` record per epoch
    whose stats and byte charges sum exactly to the arrays returned
    here, an anomaly dump on every kill and reshard, and the drop and
    byte totals as registry counters.

    `on_read(state)`, if given, is called after each read epoch's search,
    outside the epoch's time, with a namespace of the epoch's state
    (`epoch`, `rt`, `hyperplanes`, `store`, `cache`, `replicas`, `live`,
    `queries`, `qidx`): a hook to inspect or profile the live state.

    Beside the reference's keys, the result has `epoch_ms`: the host
    time of each epoch (epoch 0 included), each ended by a device sync.
    """
    from repro_torch.core import distributed as dist_mod

    device = rt.device
    params, hp = _lsh_setup(cfg, device, hyperplanes)
    sched = (None if schedule is None
             else _expand_schedule(schedule, cfg.epochs))
    if sched is not None and sched[0] != rt.cfg.n_nodes:
        raise ValueError(
            f"schedule[0]={sched[0]} != initial runtime n_nodes="
            f"{rt.cfg.n_nodes}")
    kills_by_epoch = _expand_kills(kills or (), cfg.epochs, rt.cfg.n_nodes)
    if kills_by_epoch:
        if sched is not None:
            raise ValueError(
                "kills and schedule are mutually exclusive (a membership "
                "round re-keys zones; a fail-stop loss must not)")
        if rt.cfg.replication < 2:
            raise ValueError(
                "a failure schedule needs replication >= 2 (a killed zone "
                "with no replicas is simply gone until the next announce)")
    replication = rt.cfg.replication
    if sched is not None and replication > 1:
        raise ValueError(
            "membership schedules do not compose with replication > 1 "
            "(a zone split/merge re-keys the replica ring)")
    mesh_for = mesh_for or (lambda n: _zone_mesh(n, device))
    live = np.ones(rt.cfg.n_nodes, np.int32)
    reps = None
    runtimes = {rt.cfg.n_nodes: rt}

    store = rt.shard_store(make_store(cfg.L, params.num_buckets, cfg.capacity,
                                      payload_dim=cfg.dim, device=device))

    def _charge_refresh() -> int:
        if rt.cfg.node_bits == 0:
            return 0
        return dist_mod.estimate_refresh_bytes(rt.cfg, cfg.capacity, cfg.dim)

    cache = None
    last_refresh = 0
    recalls, staleness, dropped, epoch_ms = [], [], [], []
    handoff_b, refresh_b, nodes_traj, events = [], [], [], []
    repl_b, recov_b, live_traj, recoveries = [], [], [], []
    total_handoff = total_refresh = total_repl = total_recov = 0
    for epoch, vecs, do_refresh, qidx, ideal in _trajectory(cfg, device):
        t0 = time.perf_counter()
        ep_handoff = ep_refresh = ep_repl = ep_recov = 0
        for node in kills_by_epoch.get(epoch, ()):
            # fail-stop: the zone and the node's held replica slices are
            # gone; the replicas of its zone on ring successors survive
            if not live[node]:
                raise ValueError(f"node {node} killed while already dead")
            store, reps = kill_node(rt, store, reps, node)
            live[node] = 0
            if obs is not None:
                obs.flight.note_anomaly(
                    "kill_node", node=int(node), epoch=int(epoch),
                    live_nodes=int(live.sum()))
        if sched is not None and sched[epoch] != rt.cfg.n_nodes:
            # -- membership round: join/leave to the scheduled node count
            n_new = sched[epoch]
            tgt = runtimes.get(n_new)
            if tgt is not None:  # revisited topology: reuse its runtime
                rt, store, ev = reshard(rt, store, runtime=tgt)
            else:
                mesh = mesh_for(n_new) if n_new > 1 else None
                rt, store, ev = reshard(rt, store, n_new, mesh=mesh,
                                        cap_factor=float(n_new))
            runtimes[n_new] = rt
            events.append(ev)
            if obs is not None:
                obs.flight.note_anomaly(
                    "reshard", epoch=int(epoch), old_n=int(ev.old_n),
                    new_n=int(ev.new_n), handoff_bytes=int(ev.handoff_bytes))
            ep_handoff += ev.handoff_bytes
            total_handoff += ev.handoff_bytes
            # the new owners' caches are cold: rewarm now (charged as
            # refresh bytes), unless this epoch's announce rebuilds them
            cache = None
            if not do_refresh:
                cache = rt.refresh_cache(store)
                b = _charge_refresh()
                ep_refresh += b
                total_refresh += b
        n_dev = rt.n_devices
        nu_pad = -(-cfg.num_users // n_dev) * n_dev
        nq_pad = -(-cfg.num_queries // n_dev) * n_dev
        if do_refresh:
            # a re-announce revives dead nodes first: the owner rejoins and
            # this very announce repopulates its zone, charged as one
            # full-zone recovery per revival
            for node in np.flatnonzero(live == 0):
                b = costmodel.estimate_recovery_bytes(
                    cfg.L, rt.topology.buckets_per_node, cfg.capacity,
                    cfg.dim)
                recoveries.append((epoch, int(node), b))
                ep_recov += b
                total_recov += b
                live[node] = 1
            vpad = _pad_to(vecs, nu_pad, 0.0)
            all_ids = _pad_to(torch.arange(cfg.num_users, dtype=torch.int32,
                                           device=device), nu_pad, -1)
            store = rt.insert(hp, store, vpad, all_ids, epoch)
            if epoch > 0:
                store = rt.expire(store, epoch, ttl=cfg.ttl_epochs)
            # entries left in a mover's old buckets must score with its
            # latest announced vector (the id-keyed reference semantics)
            store = rt.payload_sync(store, vpad)
            cache = rt.refresh_cache(store)
            b = _charge_refresh()
            ep_refresh += b
            total_refresh += b
            if replication > 1:
                # the announce fans out to the R-1 replica owners
                reps = rt.replicate_store(store)
                b = costmodel.estimate_replication_bytes(
                    cfg.L, cfg.num_users, cfg.dim, replication)
                ep_repl += b
                total_repl += b
            last_refresh = epoch
        if epoch == 0:
            _sync(device)
            epoch_ms.append((time.perf_counter() - t0) * 1e3)
            if obs is not None:
                # the initial announce: byte charges but no queries, so
                # that the records sum to the run totals
                obs.flight.record(QueryRecord(
                    qid=0, kind="epoch",
                    extra=dict(
                        replication_bytes=ep_repl, recovery_bytes=ep_recov,
                        handoff_bytes=ep_handoff, refresh_bytes=ep_refresh,
                        live_nodes=int(live.sum()),
                    ),
                ))
            continue

        kw = {}
        if replication > 1:
            kw = dict(replicas=reps, live=live.copy())
        queries = _pad_to(vecs[torch.from_numpy(qidx).to(device)], nq_pad,
                          0.0)
        ids, _, drop = rt.search(hp, store, queries, cache=cache, **kw)
        ids = ids.cpu().numpy()[: cfg.num_queries]
        # host-side self-exclusion: drop the query's own id, keep top-m
        keep = ids != qidx[:, None]
        ids_m = np.full((cfg.num_queries, cfg.m), -1, np.int32)
        for i in range(cfg.num_queries):
            ids_m[i] = ids[i][keep[i]][: cfg.m]
        recalls.append(metrics.recall_at_m(ids_m, ideal))
        # epochs since the last announce: one convention for all topologies
        staleness.append(epoch - last_refresh)
        dropped.append(int(drop))
        handoff_b.append(ep_handoff)
        refresh_b.append(ep_refresh)
        repl_b.append(ep_repl)
        recov_b.append(ep_recov)
        nodes_traj.append(rt.cfg.n_nodes)
        live_traj.append(int(live.sum()))
        _sync(device)
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        if obs is not None:
            # one exact record per read epoch: the StepStats of the
            # epoch's search plus its byte charges
            obs.flight.record(QueryRecord(
                qid=int(epoch), kind="epoch", batch_size=cfg.num_queries,
                **drop.host(),
                extra=dict(
                    replication_bytes=ep_repl, recovery_bytes=ep_recov,
                    handoff_bytes=ep_handoff, refresh_bytes=ep_refresh,
                    recall=float(recalls[-1]), staleness=int(staleness[-1]),
                    live_nodes=int(live.sum()), n_nodes=rt.cfg.n_nodes,
                ),
            ))
        if on_read is not None:
            on_read(types.SimpleNamespace(
                epoch=epoch, rt=rt, hyperplanes=hp, store=store, cache=cache,
                replicas=reps, live=live.copy(), queries=queries,
                qidx=qidx))

    if obs is not None:
        reg = obs.registry
        reg.counter(
            "churn_dropped_probes_total",
            "router-overflow probe drops across all read epochs",
        ).inc(int(np.sum(dropped)))
        for name, total in (
            ("churn_replication_bytes_total", total_repl),
            ("churn_recovery_bytes_total", total_recov),
            ("churn_handoff_bytes_total", total_handoff),
            ("churn_refresh_bytes_total", total_refresh),
        ):
            reg.counter(name).inc(int(total))
        reg.gauge("churn_recall").set(float(recalls[-1]), window="last")
        reg.gauge("churn_recall").set(float(np.mean(recalls)), window="mean")
        reg.gauge("churn_live_nodes").set(int(live.sum()))

    stale_arr = np.asarray(staleness)
    return dict(
        recalls=np.asarray(recalls),
        # one measurement, two names: announce and cache rebuild share the
        # refresh schedule, so store staleness == cache staleness here
        staleness=stale_arr,
        cache_staleness=stale_arr,
        dropped_probes=np.asarray(dropped),
        final_recall=float(recalls[-1]),
        mean_recall=float(np.mean(recalls)),
        refresh_every=cfg.refresh_every,
        # membership accounting: per-read-epoch byte charges plus run
        # totals, which also hold the epoch-0 announce's cache warm-up
        n_nodes=np.asarray(nodes_traj),
        handoff_bytes=np.asarray(handoff_b, dtype=np.int64),
        refresh_bytes=np.asarray(refresh_b, dtype=np.int64),
        total_handoff_bytes=int(total_handoff),
        total_refresh_bytes=int(total_refresh),
        reshard_events=events,
        # failure accounting: announce fan-out to replicas, zone
        # repopulation on revival, and the live node count each read
        # epoch; totals include the epoch-0 announce
        replication=replication,
        live_nodes=np.asarray(live_traj),
        replication_bytes=np.asarray(repl_b, dtype=np.int64),
        recovery_bytes=np.asarray(recov_b, dtype=np.int64),
        total_replication_bytes=int(total_repl),
        total_recovery_bytes=int(total_recov),
        recoveries=recoveries,
        # the store's mutation counter after the run: the serving layer's
        # cache invalidation signal
        store_generation=int(store.generation),
        epoch_ms=np.asarray(epoch_ms),
    )


def run_churn(cfg: ChurnConfig, *, device=None, hyperplanes=None, obs=None,
              on_read=None) -> dict:
    """The reference trajectory: the driver on the 1-node topology
    (identity router, no collectives), on `device` (the CUDA card unless
    "cpu")."""
    return run_churn_runtime(cfg, make_churn_runtime(cfg, device=device),
                             hyperplanes=hyperplanes, obs=obs,
                             on_read=on_read)


def run_churn_distributed(
    cfg: ChurnConfig,
    n_shards: int = 2,
    mesh=None,
    cap_factor: float | None = None,
    obs=None,
    *,
    device=None,
    hyperplanes=None,
) -> dict:
    """The same trajectory on an n_shards-node zone mesh: `mesh`, or
    `make_zone_mesh(n_shards)` on `device` (one device, or the
    processes of the world)."""
    if mesh is None:
        mesh = _zone_mesh(n_shards, device)
    return run_churn_runtime(
        cfg, make_churn_runtime(cfg, n_shards, mesh, cap_factor), obs=obs,
        hyperplanes=hyperplanes)


@dataclasses.dataclass(frozen=True)
class NodeChurnConfig:
    """The elastic-membership scenario: content churn + queries while the
    node set itself joins and leaves on a schedule.

    `schedule[e]` is the node count during epoch e (0 = the initial
    announce epoch); a short schedule holds its last value.  Entries must
    be powers of two; each change is one `can.py` zone split/merge round.
    The world trajectory is the static drivers' RNG stream, so recalls
    compare directly with `run_churn` on the same `ChurnConfig`."""

    churn: ChurnConfig = ChurnConfig()
    schedule: tuple[int, ...] = (1, 2, 4, 2, 1)


def run_node_churn(cfg: NodeChurnConfig, mesh_for=None, obs=None, *,
                   device=None, hyperplanes=None, on_read=None) -> dict:
    """Interleave node join/leave epochs with content churn and queries.

    Membership rounds fire at the scheduled epochs (`runtime.reshard`:
    bucket-state handoff to the new zone owners, cache rewarm), with
    handoff bytes charged beside the refresh bytes.  An n-node topology
    runs on `mesh_for(n)`, by default `make_zone_mesh(n)` on `device`:
    its n nodes on one device, or over the processes of the world."""
    sched = _expand_schedule(cfg.schedule, cfg.churn.epochs)
    n0 = sched[0]
    dev = resolve_device(device)
    mesh_for = mesh_for or (lambda n: _zone_mesh(n, dev))
    mesh = None if n0 == 1 else mesh_for(n0)
    rt = make_churn_runtime(cfg.churn, n0, mesh=mesh,
                            device=dev if mesh is None else None)
    return run_churn_runtime(cfg.churn, rt, schedule=sched,
                             mesh_for=mesh_for, obs=obs,
                             hyperplanes=hyperplanes, on_read=on_read)


@dataclasses.dataclass(frozen=True)
class FailureChurnConfig:
    """The availability scenario: content churn + queries while nodes
    suffer fail-stop losses (no handoff) and reads survive on R-way
    replicas (DESIGN.md Sec. 10).

    `kills` is ((epoch, node), ...): each node vanishes at that epoch's
    start and revives at the next announce epoch, which repopulates its
    zone.  The world trajectory is the RNG stream every driver shares,
    so the no-failure reference run compares epoch by epoch."""

    churn: ChurnConfig = ChurnConfig()
    n_nodes: int = 4
    replication: int = 2
    read_mode: str = "first"        # first | quorum
    kills: tuple[tuple[int, int], ...] = ((3, 1),)


def run_failure_churn(cfg: FailureChurnConfig, mesh_for=None, obs=None, *,
                      device=None, hyperplanes=None, on_read=None) -> dict:
    """Measure recall degradation and recovery across fail-stop kills.

    Runs the same runtime (same mesh, R and read mode) twice over the
    shared trajectory: once with the failure schedule, once without (the
    reference: at full liveness the replica redirect is the identity).
    `obs` and `on_read` see the failure run only.  Returns the failure
    run's dict plus:

      reference_recalls   per-epoch recalls of the no-failure run
      recall_gap          reference - failure, per read epoch
      degraded            bool mask: epochs serving with a dead node
      degraded_gap        max gap over degraded epochs (0.0 if none)
      recovered_gap       max gap over post-recovery epochs (parity check)
      recovery_epochs     worst-case epochs from a kill to its revival
    """
    mesh = (mesh_for or (lambda n: _zone_mesh(n, device)))(cfg.n_nodes)
    rt = make_churn_runtime(
        cfg.churn, cfg.n_nodes, mesh=mesh,
        replication=cfg.replication, read_mode=cfg.read_mode,
    )
    # only the failure run feeds obs: the reference would double-count
    # every byte charge and drop in the flight totals
    failure = run_churn_runtime(cfg.churn, rt, kills=cfg.kills, obs=obs,
                                hyperplanes=hyperplanes, on_read=on_read)
    reference = run_churn_runtime(cfg.churn, rt, hyperplanes=hyperplanes)

    gap = reference["recalls"] - failure["recalls"]
    degraded = failure["live_nodes"] < cfg.n_nodes
    recovered = ~degraded
    # only epochs after the first kill can attest recovery to parity
    if degraded.any():
        recovered &= np.arange(degraded.size) > int(np.argmax(degraded))
    recovery_epochs = 0
    for kill_epoch, _node in cfg.kills:
        revived = [e for e, _n, _b in failure["recoveries"]
                   if e > kill_epoch]
        if revived:
            recovery_epochs = max(recovery_epochs,
                                  min(revived) - int(kill_epoch))
    failure.update(
        reference_recalls=reference["recalls"],
        reference_epoch_ms=reference["epoch_ms"],
        recall_gap=gap,
        degraded=degraded,
        degraded_gap=float(gap[degraded].max()) if degraded.any() else 0.0,
        recovered_gap=float(gap[recovered].max()) if recovered.any() else 0.0,
        recovery_epochs=int(recovery_epochs),
        kills=tuple(cfg.kills),
    )
    return failure
