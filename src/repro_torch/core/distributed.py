"""Mesh adapter for the IndexRuntime: the step functions over a
`ZoneMesh` (DESIGN.md Sec. 2, 8).

The query and maintenance logic lives in `repro_torch.core.runtime` as
step bodies written over a leading node axis; this module is only the
mesh side of that layer:

  * the geometry: node j owns the contiguous zone `zone_range(j)` of the
    global bucket array, so the global store IS the sharded store
    (`shard_store` only places it on the mesh's device), and the query
    batch shards over the batch axes in node order;
  * the step wrappers binding each body to `MeshCollectives`
    (`make_search_step`, `make_contains_step`, `make_insert_step`,
    `make_payload_sync`, `make_refresh_cache`, `make_replicate_store`)
    plus the sum of the per-node accounting (`_psum_stats`);
  * the wire byte model (`estimate_query_bytes`, `estimate_refresh_bytes`,
    `estimate_reshard_bytes`): the Table-1 analogue in bytes, the same
    closed forms as the reference's.

Per-variant communication on the query path (mirrors Table 1):
  lsh : route each (query, table) to its owner node  [all_to_all]
        and search the exact bucket only.
  nb  : lsh + forward to the log2(n) XOR-neighbours [2 ppermutes/bit]
        to cover node-bit near buckets; local-bit near buckets are free.
  cnb : lsh routing, with node-bit near buckets served from a local cache
        of the neighbours' zones, refreshed OFF the query path by
        `refresh_cache` (the paper's periodic bucket exchange).

Routing modes: `alltoall` (capacitated per-destination send buffers;
overflowed probes are counted in the step's stats, never silently
eaten) and `allgather` (every node sees every query; no overflow, more
bytes).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packed
from repro_torch.core import runtime as runtime_mod
from repro_torch.core.runtime import (
    MeshCollectives, RuntimeConfig, StepStats, _route_cap,
)
from repro_torch.core.store import BucketStore


def DistConfig(*, n_shards: int, **kw) -> RuntimeConfig:
    """A mesh RuntimeConfig with n_shards nodes, under the reference's
    constructor name.  The config is frozen: after a membership change,
    read the runtime's own `cfg`."""
    return RuntimeConfig(n_nodes=n_shards, **kw)


def _collectives(cfg: RuntimeConfig, mesh) -> MeshCollectives:
    return MeshCollectives(n=cfg.n_nodes, device=mesh.device)


def _batch_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [data, n, B/(data*n), ...]: the slice of each data row
    and node, in node order; a batch that does not divide raises."""
    shards = mesh.data * mesh.n_model
    if x.shape[0] % shards:
        raise ValueError(f"batch of {x.shape[0]} does not shard over "
                         f"{shards} mesh slices: pad it to a multiple")
    return x.reshape((mesh.data, mesh.n_model, -1) + x.shape[1:])


def _node_slices(mesh, x: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [n, B/n, ...] for a step that gathers the whole batch
    on every node (insert, payload sync): the gather over all batch axes
    gives back the batch in its order."""
    return _batch_rows(mesh, x).reshape((mesh.n_model, -1) + x.shape[1:])


# -----------------------------------------------------------------------------
# store placement and the CNB cache
# -----------------------------------------------------------------------------


def shard_store(mesh, store: BucketStore) -> BucketStore:
    """Place a host-built store on the mesh: zone j of its bucket axis is
    node j's shard, so placement is a move to the mesh's device."""
    def put(x):
        return None if x is None else x.to(mesh.device)

    return BucketStore(put(store.ids), put(store.timestamps),
                       put(store.write_ptr), put(store.payload),
                       put(store.generation))


def make_refresh_cache(cfg: RuntimeConfig, mesh):
    """CNB cache refresh: 1 ppermute per node bit, OFF the query path.

    Returns fn(ids, payload) -> (cache_ids [T, nbits, NB, C],
    cache_payload [T, nbits, NB, C, D|W]): zone j of slice b holds the
    zone of node j ^ 2^b, the layout of the reference's sharded cache."""
    cx = _collectives(cfg, mesh)
    perms = [cfg.topo.neighbor_perm(j) for j in range(cfg.node_bits)]

    def refresh(ids, payload):
        return (runtime_mod.permuted_zones(cx, ids, perms),
                runtime_mod.permuted_zones(cx, payload, perms))

    return refresh


def make_replicate_store(cfg: RuntimeConfig, mesh):
    """Replica-slice construction (R-way availability, DESIGN.md Sec. 10):
    one ppermute per replica rank, off the query path: the announce-time
    fan-out `costmodel.estimate_replication_bytes` charges.

    Returns fn(ids, payload) -> (rep_ids [T, R-1, NB, C], rep_payload
    [T, R-1, NB, C, D|W]), zone i of slice r-1 holding the zone of node
    (i - r) % n, as the reference's sharded slices do."""
    cx = _collectives(cfg, mesh)

    def replicate(ids, payload):
        return runtime_mod.replicate_kernel(cfg, cx, ids, payload)

    return replicate


# -----------------------------------------------------------------------------
# the step wrappers (runtime bodies bound to the mesh)
# -----------------------------------------------------------------------------


def _psum_stats(per_node: list[StepStats]) -> StepStats:
    """Global `StepStats`: sum the additive accounting fields over every
    node of every data row.  `replica_fanout` is a per-step constant,
    carried through rather than summed."""
    def total(name):
        return torch.cat([getattr(s, name) for s in per_node]).sum(
            dim=0, dtype=torch.int32)

    fields = {f.name: total(f.name) for f in dataclasses.fields(StepStats)
              if f.name != "replica_fanout"}
    return StepStats(replica_fanout=per_node[0].replica_fanout[0], **fields)


def make_search_step(cfg: RuntimeConfig, mesh):
    """Distributed search: fn(hyperplanes, store_ids, store_payload,
    [cache_ids, cache_payload,] [rep_ids, rep_payload, live,] q [B, d])
    -> (ids [B, m], scores [B, m], stats `StepStats`), with m = cfg.m;
    the replica arguments come with `cfg.replication > 1`.  The stats
    are global: `int(stats)` counts the (query, table) probes that
    overflowed the capacitated all_to_all buffers this step (0 under
    allgather routing)."""
    cx = _collectives(cfg, mesh)
    has_cache = cfg.variant == "cnb" and cfg.node_bits > 0
    has_reps = cfg.replication > 1

    def step(hyperplanes, ids, payload, *rest):
        rest = list(rest)
        c_ids = c_payload = None
        if has_cache:
            c_ids, c_payload = rest.pop(0), rest.pop(0)
        kw = {}
        if has_reps:
            kw = dict(rep_ids=rest.pop(0), rep_payload=rest.pop(0),
                      live=rest.pop(0))
        (q,) = rest
        outs = [runtime_mod.search_kernel(cfg, cx, cfg.m, hyperplanes, ids,
                                          payload, c_ids, c_payload, q_row,
                                          **kw)
                for q_row in _batch_rows(mesh, q)]
        return (torch.cat([o[0] for o in outs]).reshape(-1, cfg.m),
                torch.cat([o[1] for o in outs]).reshape(-1, cfg.m),
                _psum_stats([o[2] for o in outs]))

    return step


def make_contains_step(cfg: RuntimeConfig, mesh):
    """Distributed `contains` (paper Sec. 6.3 success probability):
    fn(hyperplanes, store_ids, [cache_ids,] [rep_ids, live,] q [B, d],
    targets [B]) -> (hits bool [B], stats `StepStats`).  Same planner
    and router as the search step."""
    cx = _collectives(cfg, mesh)
    has_cache = cfg.variant == "cnb" and cfg.node_bits > 0
    has_reps = cfg.replication > 1

    def step(hyperplanes, ids, *rest):
        rest = list(rest)
        c_ids = rest.pop(0) if has_cache else None
        kw = {}
        if has_reps:
            kw = dict(rep_ids=rest.pop(0), live=rest.pop(0))
        q, targets = rest
        outs = [runtime_mod.contains_kernel(cfg, cx, hyperplanes, ids, c_ids,
                                            q_row, t_row, **kw)
                for q_row, t_row in zip(_batch_rows(mesh, q),
                                        _batch_rows(mesh, targets))]
        return (torch.cat([o[0] for o in outs]).reshape(-1),
                _psum_stats([o[1] for o in outs]))

    return step


def make_insert_step(cfg: RuntimeConfig, mesh):
    """Distributed insert/refresh: vectors arrive sharded over the batch
    slices; each node takes the ones whose buckets it owns.  Returns the
    updated store."""
    cx = _collectives(cfg, mesh)

    def insert(hyperplanes, store: BucketStore, vec, vid, now):
        return runtime_mod.insert_kernel(
            cfg, cx, hyperplanes, store, _node_slices(mesh, vec),
            _node_slices(mesh, vid), now)

    return insert


def make_payload_sync(cfg: RuntimeConfig, mesh):
    """Payload re-sync (`runtime.payload_sync_kernel` on the mesh)."""
    cx = _collectives(cfg, mesh)

    def apply(store: BucketStore, vec):
        nodes = _node_slices(mesh, vec)
        # a payload rewrite changes scores, so it invalidates cached results
        # the same way insert/expire do: bump the store generation
        return dataclasses.replace(
            store,
            payload=runtime_mod.payload_sync_kernel(cx, store.ids,
                                                    store.payload, nodes),
            generation=store.generation + 1,
        )

    return apply


# -----------------------------------------------------------------------------
# wire byte model (the Table-1 analogue in the byte domain)
# -----------------------------------------------------------------------------


def estimate_query_bytes(cfg: RuntimeConfig, batch: int, d: int,
                         n_total: int) -> dict:
    """Closed-form wire bytes per search step.

    Under `score="hamming"` the routed query row is the bit-packed
    sketch: W 32-bit words instead of d f32 lanes, so every term that
    ships a query row charges `W*4` bytes."""
    n = cfg.n_nodes
    b_loc = batch // n_total
    m = cfg.m
    L = cfg.params.L
    row_lanes = (
        packed.num_words(cfg.params.k, L) if cfg.score == "hamming" else d
    )
    if cfg.routing == "alltoall":
        cap = _route_cap(cfg, b_loc)
        q_bytes = n * cap * row_lanes * 4 + n * cap * _META_INTS * 4
        r_bytes = 2 * n * cap * m * 4
    else:
        q_bytes = (n - 1) * b_loc * row_lanes * 4  # all_gather
        r_bytes = 2 * n * b_loc * L * m * 4
    nb_bytes = 0
    if cfg.variant == "nb":
        per_bit = (
            (n * cap if cfg.routing == "alltoall" else n * b_loc * L)
        )
        nb_bytes = cfg.node_bits * per_bit * (row_lanes * 4 + 8 + 2 * m * 4 * 2)
    return dict(query_routing=q_bytes, results=r_bytes, neighbor=nb_bytes,
                total=q_bytes + r_bytes + nb_bytes)


_META_INTS = 4  # (qidx, table, local, probe_mask) per routed probe


def estimate_refresh_bytes(cfg: RuntimeConfig, capacity: int, d: int) -> int:
    """Wire bytes of one CNB cache refresh per node: `node_bits`
    ppermutes of the node's whole zone (ids + payload).  A hamming
    store's payload is the packed words [.., W], so each slot ships W*4
    bytes."""
    slot_lanes = (
        packed.num_words(cfg.params.k, cfg.params.L)
        if cfg.score == "hamming" else d
    )
    nb_local = cfg.params.num_buckets // cfg.n_nodes
    per_permute = cfg.params.L * nb_local * capacity * (4 + slot_lanes * 4)
    return cfg.node_bits * per_permute


def estimate_reshard_bytes(cfg: RuntimeConfig, new_n: int, capacity: int,
                           d: int) -> int:
    """Wire bytes of one membership round `cfg.n_nodes -> new_n`: the
    overlay handoff model of `costmodel`."""
    from repro_torch.core import costmodel

    return costmodel.estimate_handoff_bytes(
        cfg.params.L, cfg.params.num_buckets, capacity, d, cfg.n_nodes,
        new_n,
    )
