"""One IndexRuntime over a CAN topology (DESIGN.md Sec. 8).

The five index operations (search, contains, insert, expire, payload
sync) as step functions parameterized by a `CanTopology`:

  * `n_nodes=1` without a mesh: the degenerate topology.  Every near
    bucket is a free local-bit probe, the router is the identity
    (`LOCAL`), and no collectives run.  The single-host `LshEngine` is a
    façade over it.
  * a mesh (`repro_torch.launch.mesh.make_zone_mesh`): buckets shard over
    the nodes, node j owning the contiguous zone `zone_range(j)` of the
    global bucket array.  The n nodes live in one process on one device;
    `MeshCollectives` exchanges tensors between their slices.  Step
    bodies are written over a leading node axis, so each stage launches
    its kernel once for all nodes' rows.  Routed steps run the
    capacitated all_to_all router (or the allgather fallback), the CNB
    neighbour cache and the NB forwards.

On a CUDA store, `fused="auto"` takes the fused query / contains kernels
for the owner stage, as the reference takes its Pallas kernels on a TPU;
the cache and NB stages stay staged (`hamming_words` / `bucket_topk`
through `scoring.score_topk`), as in the reference.

The P2P half (DESIGN.md Sec. 9-10): R-way replicas of every zone on its
ring successors (`replicate_kernel`), reads routed to the first live
replica or to all R (`read_mode`), with every node masking its rows by
its own `live` bit; fail-stop `kill_node`; and elastic membership
(`reshard`), which splits or merges zones of the one global bucket
array and charges the handoff in a `ReshardEvent`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import packed as packed_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core import routing as routing_mod
from repro_torch.core import scoring
from repro_torch.core import store as store_mod
from repro_torch.core.can import CanTopology
from repro_torch.core.corpus import DenseCorpus
from repro_torch.core.hashing import LshParams, popcount32, sketch_codes
from repro_torch.core.scoring import dedupe_topk
from repro_torch.core.store import BucketStore

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Static description of one index runtime (any topology)."""

    params: LshParams
    variant: str = "cnb"           # lsh | layered | nb | cnb
    m: int = 10                    # results per query (mesh steps bake it)
    n_nodes: int = 1               # topology nodes (power of two)
    routing: str = "alltoall"      # alltoall | allgather (mesh only)
    cap_factor: float = 2.0        # per-destination buffer slack (alltoall)
    probe_local_near: bool = True  # search local-bit near buckets (nb/cnb)
    num_probes: int | None = None  # None => all k 1-near buckets (the paper)
    ranked_probes: bool = False    # margin-ranked probe subset (beyond paper)
    use_kernels: bool = False      # simhash sketch + staged scoring kernels
    replication: int = 1           # R-way zone replication
    read_mode: str = "first"       # first | quorum (replicated reads)
    fused: str = "auto"            # fused query kernel: auto | on | off
    score: str = "dot"             # dot | hamming (packed sketch words)

    def __post_init__(self):
        if self.routing not in ("alltoall", "allgather"):
            raise ValueError(f"unknown routing {self.routing!r}")
        if self.read_mode not in ("first", "quorum"):
            raise ValueError(f"unknown read_mode {self.read_mode!r}")
        if self.fused not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused mode {self.fused!r}")
        if self.score not in ("dot", "hamming"):
            raise ValueError(f"unknown score mode {self.score!r}")
        if self.replication < 1:
            raise ValueError(
                f"replication must be >= 1, got {self.replication}")
        if self.replication > 1:
            if self.replication > self.n_nodes:
                raise ValueError(
                    f"replication R={self.replication} exceeds "
                    f"n_nodes={self.n_nodes} (need R distinct owners)")
            if self.routing != "alltoall":
                raise ValueError(
                    "replication > 1 requires alltoall routing (the "
                    "replica redirect rides the capacitated router)")
            if self.variant == "nb":
                raise ValueError(
                    "replication > 1 does not support the nb variant "
                    "(neighbor forwards assume the primary owner; use cnb)")

    @property
    def topo(self) -> CanTopology:
        return CanTopology(self.params.k, self.n_nodes)

    @property
    def node_bits(self) -> int:
        return self.topo.node_bits

    @property
    def local_bits(self) -> int:
        return self.topo.local_bits

    @property
    def probe_spec(self) -> plan_mod.ProbeSpec:
        """The shared probe discipline (same planner on every topology)."""
        return plan_mod.ProbeSpec(
            params=self.params,
            variant=self.variant,
            num_probes=self.num_probes,
            ranked_probes=self.ranked_probes,
        )


# -----------------------------------------------------------------------------
# collectives: the only topology-dependent operations
# -----------------------------------------------------------------------------


class LocalCollectives:
    """The 1-node mesh: every collective is the identity.  `routed=False`
    selects the identity router in the step functions, so probes
    structurally cannot be dropped."""

    n = 1
    routed = False

    def axis_index(self):
        return 0

    def all_gather_batch(self, x):
        return x


LOCAL = LocalCollectives()


@functools.lru_cache(maxsize=None)
def _perm_source(n: int, perm: tuple, device: torch.device):
    """(source node of each destination, int64 [n] on `device`; bool [n]
    mask of the destinations that receive, or None when all do) for a
    (src, dst) pairing, built once per pairing and device."""
    src = [-1] * n
    for s, d in perm:
        src[d] = s
    idx = torch.tensor([max(s, 0) for s in src], dtype=torch.int64,
                       device=device)
    if min(src) >= 0:
        return idx, None
    return idx, torch.tensor([s >= 0 for s in src], device=device)


@dataclasses.dataclass(frozen=True)
class MeshCollectives:
    """The collectives of n CAN nodes held on one device.

    A per-node tensor carries the nodes on its leading axis: slice j is
    what node j holds.  A value every node holds alike (the result of
    `all_gather` or `psum`) is returned once, without a node axis.  The
    semantics are the reference's `jax.lax` collectives over the `model`
    axis.  `routed=True`: even a 1-node mesh runs the capacitated router.
    """

    n: int
    device: torch.device
    routed = True

    def axis_index(self) -> torch.Tensor:
        """int64 [n]: each node's own index."""
        return torch.arange(self.n, device=self.device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """[n_src, n_dst, ...] -> [n_dst, n_src, ...]: node i's block for
        node j lands at position i of node j (the tiled all_to_all that
        splits and concatenates axis 0 of each node's buffer)."""
        return x.transpose(0, 1).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[n, a, ...] -> [n*a, ...]: the node-ordered concat every node
        holds."""
        return x.reshape((-1,) + x.shape[2:])

    all_gather_batch = all_gather  # one data row: the batch axes are the nodes

    def ppermute(self, x: torch.Tensor, perm, axis: int = 0) -> torch.Tensor:
        """Send slice `src` of the node axis to `dst` for each (src, dst)
        of `perm`; nodes that receive nothing get zeros."""
        src, keep = _perm_source(self.n, tuple(map(tuple, perm)), x.device)
        out = x.index_select(axis, src)
        if keep is not None:
            shape = [1] * x.dim()
            shape[axis] = self.n
            out = torch.where(keep.reshape(shape), out,
                              torch.zeros((), dtype=x.dtype, device=x.device))
        return out

    def alive(self, live: torch.Tensor) -> torch.Tensor:
        """bool [n]: each node's own bit of the liveness mask."""
        return live > 0

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the node axis: the total every node holds."""
        return x.sum(dim=0)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """Merge the node axis into the row axis: [n, R, ...] -> [n*R, ...]."""
    return x.reshape((-1,) + x.shape[2:])


def _zones(cx, store_ids: torch.Tensor, rows_per_node: int) -> torch.Tensor:
    """int64 [n*R]: first global bucket of the zone of each row's node."""
    nb_loc = store_ids.shape[1] // cx.n
    return (cx.axis_index() * nb_loc).repeat_interleave(rows_per_node)


# -----------------------------------------------------------------------------
# shard-local scoring helpers (identical on every topology)
# -----------------------------------------------------------------------------
#
# They take flat rows.  `zone` ([r] first global bucket of each row's
# node, or None on the 1-node topology) places a row's local bucket
# indices in the global [T, NB, C] store, whose zone j is node j's shard.


def _local_include_near(cfg: RuntimeConfig) -> bool:
    return cfg.variant not in ("lsh", "layered") and cfg.probe_local_near


def _node_bit_valid(cfg: RuntimeConfig, mask: torch.Tensor) -> torch.Tensor:
    """bool [r, node_bits]: is the flip of node bit j probed for each row?"""
    if cfg.node_bits == 0:
        return torch.zeros(mask.shape + (0,), dtype=torch.bool,
                           device=mask.device)
    return torch.stack(
        [plan_mod.node_bit_probe_valid(cfg.topo, mask, b)
         for b in range(cfg.node_bits)], dim=-1)


def _global_probes(cfg, nb: int, local_idx, mask, zone):
    """(global bucket indices [r, P], validity [r, P]) of each row's exact
    and masked local near buckets."""
    probes, pvalid = plan_mod.shard_local_probes(
        cfg.topo, local_idx, mask, include_near=_local_include_near(cfg))
    probes = (probes % (nb // cfg.n_nodes)).long()  # fold OOB codes
    if zone is not None:
        probes = probes + zone[:, None]
    return probes, pvalid


def _pool_topk(cfg, corpus, q, flat_ids, slot_vecs, m):
    """Score a flattened candidate pool and keep the top m distinct ids,
    with payloads from the id-keyed `corpus` (dense or sparse) or from
    the bucket slots.  A sparse corpus scores each row's candidates
    against the row's dense query in plain torch, as the reference
    does outside any kernel."""
    if corpus is not None:
        if isinstance(corpus, DenseCorpus):
            vecs = corpus.gather(flat_ids)
            return scoring.score_topk(q, flat_ids, vecs, m,
                                      use_kernels=cfg.use_kernels)
        scores = corpus.scores_against_dense(q, flat_ids)  # [r, K]
        scores = scores.masked_fill(flat_ids < 0, NEG_INF)
        return dedupe_topk(flat_ids, scores, m)
    return scoring.score_topk(q, flat_ids, slot_vecs, m,
                              use_kernels=cfg.use_kernels, score=cfg.score)


def _with_replicas(primary: torch.Tensor, replicas: torch.Tensor):
    """[T, R, NB, ...]: the primary store before its R-1 replica slices
    (rank 0 = primary), the view every replica read indexes.  A copy, as
    in the reference, made on every replicated read."""
    return torch.cat([primary[:, None], replicas], dim=1)


def _score_local(cfg, store_ids, store_payload, corpus, q, table, local_idx,
                 mask, exclude, m, zone=None, rep_ids=None, rep_payload=None,
                 rep_sel=None):
    """Top-m among the (exact + masked local near) buckets of each row:
    the staged gather -> score -> top-m path.

    With `rep_sel` (replication > 1) row i reads replica rank rep_sel[i]
    of its buckets: rank 0 is the primary store, rank r >= 1 the replica
    slice r-1, whose zone j holds the zone of node (j - r) % n at the
    same global bucket indices, so the probe set is unchanged."""
    probes, pvalid = _global_probes(cfg, store_ids.shape[1], local_idx, mask,
                                    zone)                  # [r, P] both
    tbl = table.long()[:, None]
    if rep_sel is None:
        cand_ids = store_ids[tbl, probes]                  # [r, P, C]
    else:
        rep = rep_sel.long()[:, None]
        cand_ids = _with_replicas(store_ids, rep_ids)[tbl, rep, probes]
    cand_ids = torch.where(pvalid[..., None], cand_ids, -1)
    r = q.shape[0]
    flat_ids = cand_ids.reshape(r, -1)
    if exclude is not None:
        flat_ids = torch.where(flat_ids == exclude[:, None], -1, flat_ids)
    slot_vecs = None
    if corpus is None:
        if rep_sel is None:
            slot_vecs = store_payload[tbl, probes]         # [r, P, C, D|W]
        else:
            slot_vecs = _with_replicas(store_payload, rep_payload)[
                tbl, rep, probes]
        slot_vecs = slot_vecs.reshape(r, flat_ids.shape[1], -1)
    return _pool_topk(cfg, corpus, q, flat_ids, slot_vecs, m)


# -----------------------------------------------------------------------------
# fused query kernel dispatch (DESIGN.md Sec. 11)
# -----------------------------------------------------------------------------


def _fused_on(cfg: RuntimeConfig, cx, *, has_payload: bool,
              has_corpus: bool, on_card: bool,
              need_payload: bool = True) -> bool:
    """Should this step take the fused kernel path?

    `auto` engages where the fused kernel is a strict drop-in (slot
    payloads, no id-keyed corpus) and the store lies on the CUDA card;
    on the CPU the staged path runs.  Routed steps fuse their owner
    stage, the rows the router delivers.  `on` forces the path (on the
    CPU through the kernel's plain version) and raises where it cannot
    apply."""
    if cfg.fused == "off":
        return False
    blockers = []
    if has_corpus:
        blockers.append("id-keyed corpus scoring")
    if need_payload and not has_payload:
        blockers.append("ids-only store (no payload to score)")
    if cfg.fused == "on":
        if blockers:
            raise ValueError(
                f"fused='on' unsupported here: {'; '.join(blockers)}")
        return True
    return not blockers and on_card


def _fused_probe_rows(cfg: RuntimeConfig, nb: int, table, local_idx, mask,
                      zone=None, rep_sel=None, n_rep: int = 1):
    """(fb int32 [r, P], pword int32 [r]) for the fused kernels.

    `fb` flattens (table, global bucket) to a row of the [T*NB, C] store
    view; `pword` packs the per-probe validity into one int32 bitfield
    (bit p = probe p valid; P <= 1 + k <= 31, so bit 31 stays clear).
    With `rep_sel` the view is the [T*R*NB, C] flatten of the primary +
    replica store, and fb = (table*R + rep_sel)*NB + zone + probe."""
    probes, pvalid = _global_probes(cfg, nb, local_idx, mask, zone)
    row = table.long() if rep_sel is None else \
        table.long() * n_rep + rep_sel.long()
    fb = row[:, None] * nb + probes
    shifts = torch.arange(pvalid.shape[1], dtype=torch.int32,
                          device=pvalid.device)
    pword = (pvalid.to(torch.int32) << shifts).sum(dim=1, dtype=torch.int32)
    return fb.to(torch.int32).contiguous(), pword


def _flat_view(store_ids, store_payload, rep_ids, rep_payload):
    """(ids [T*R*NB, C], payload [T*R*NB, C, D|W] or None, R): the row
    view the fused kernels gather from, R = 1 without replicas."""
    if rep_ids is not None:
        store_ids = _with_replicas(store_ids, rep_ids)
        if store_payload is not None:
            store_payload = _with_replicas(store_payload, rep_payload)
    n_rep = 1 if rep_ids is None else store_ids.shape[1]
    c = store_ids.shape[-1]
    pay = None if store_payload is None else store_payload.reshape(
        -1, c, store_payload.shape[-1])
    return store_ids.reshape(-1, c), pay, n_rep


def _fused_search_local(cfg, store_ids, store_payload, q, table, local_idx,
                        mask, exclude, m, zone=None, rep_ids=None,
                        rep_payload=None, rep_sel=None):
    """Fused twin of `_score_local`: one kernel replaces gather + score +
    top-m; no [r, P*C] candidate intermediate exists.  With `rep_sel` the
    kernel gathers from the flattened primary + replica view, the rows
    `_score_local` reads through its replica concat."""
    from repro_torch.kernels import ops

    nb = store_ids.shape[1]
    ids_flat, pay_flat, n_rep = _flat_view(store_ids, store_payload,
                                           rep_ids, rep_payload)
    fb, pword = _fused_probe_rows(cfg, nb, table, local_idx, mask, zone,
                                  rep_sel, n_rep)
    # -1 matches only empty slots == no exclusion
    excl = (torch.full_like(pword, -1) if exclude is None
            else exclude.to(torch.int32))
    meta = torch.stack([pword, excl], dim=1)
    return ops.fused_query(ids_flat, pay_flat, q.contiguous(), fb, meta,
                           m=m, score=cfg.score)


def _fused_contains_local(cfg, store_ids, table, local_idx, mask, target,
                          zone=None, rep_ids=None, rep_sel=None):
    """Fused twin of `_contains_local`: metadata only.  Replica reads
    flatten the primary + replica ids as `_fused_search_local` does."""
    from repro_torch.kernels import ops

    nb = store_ids.shape[1]
    ids_flat, _, n_rep = _flat_view(store_ids, None, rep_ids, None)
    fb, pword = _fused_probe_rows(cfg, nb, table, local_idx, mask, zone,
                                  rep_sel, n_rep)
    meta = torch.stack([pword, target.to(torch.int32)], dim=1)
    return ops.fused_contains(ids_flat, fb, meta)


def _owner_topk(cfg, fused, store_ids, store_payload, corpus, q, table,
                local_idx, mask, exclude, m, zone=None, reps=None,
                rep_sel=None):
    """The owner stage of a search: fused or staged.  `reps` is the
    (rep_ids, rep_payload) pair that rows with `rep_sel` read."""
    rep_ids, rep_payload = (None, None) if reps is None else reps
    if fused:
        return _fused_search_local(cfg, store_ids, store_payload, q, table,
                                   local_idx, mask, exclude, m, zone,
                                   rep_ids, rep_payload, rep_sel)
    return _score_local(cfg, store_ids, store_payload, corpus, q, table,
                        local_idx, mask, exclude, m, zone, rep_ids,
                        rep_payload, rep_sel)


def _score_cache(cfg, cache_ids, cache_payload, q, table, local_idx, mask, m,
                 zone):
    """CNB: score the masked node-bit near buckets from the neighbour cache.

    Flipping node bit j keeps the local index, so the near bucket of bit
    j is cache[table, j, zone + local]: a local gather, gated per row by
    node bit j of the probe mask.  Under `score="hamming"` the cache
    holds the neighbours' packed words and `q` the row's query words.
    """
    nbits = cache_ids.shape[1]
    jj = torch.arange(nbits, device=q.device)[None, :]
    tbl = table.long()[:, None]
    idx = (zone + local_idx.long())[:, None]
    cand_ids = cache_ids[tbl, jj, idx]                     # [r, nbits, C]
    cand_ids = torch.where(_node_bit_valid(cfg, mask)[..., None], cand_ids,
                           -1)
    cand_vec = cache_payload[tbl, jj, idx]                 # [r, nbits, C, DW]
    r = q.shape[0]
    cand_ids = cand_ids.reshape(r, -1)
    cand_vec = cand_vec.reshape(r, cand_ids.shape[1], -1)
    return scoring.score_topk(q, cand_ids, cand_vec, m,
                              use_kernels=cfg.use_kernels, score=cfg.score)


def _neighbor_parts(cfg, cx, store_ids, store_payload, rq, rtable, rlocal,
                    rmask, m):
    """NB: forward each node's routed rows to each XOR-neighbour; it scores
    ITS exact bucket at the same local index (a node-bit flip keeps the
    local bits) and sends the partial top-m back.  2 ppermutes per node
    bit each way; the probe mask gates each bit's contribution.  Inputs
    and outputs are node-leading [n, R, ...]."""
    n, R = rtable.shape
    zone = _zones(cx, store_ids, R)
    lsh = dataclasses.replace(cfg, variant="lsh")          # exact bucket only
    nbit_valid = _node_bit_valid(cfg, rmask)               # [n, R, nbits]
    ids_parts, sc_parts = [], []
    for j in range(cfg.node_bits):
        perm = cfg.topo.neighbor_perm(j)
        nq = cx.ppermute(rq, perm)
        nt = cx.ppermute(rtable, perm)
        nl = cx.ppermute(rlocal, perm)
        ids_j, sc_j = _score_local(
            lsh, store_ids, store_payload, None, _rows(nq), _rows(nt),
            _rows(nl), torch.zeros_like(_rows(nl)), None, m, zone)
        ids_j = cx.ppermute(ids_j.reshape(n, R, m), perm)
        sc_j = cx.ppermute(sc_j.reshape(n, R, m), perm)
        keep = nbit_valid[..., j, None]
        ids_parts.append(_rows(torch.where(keep, ids_j, -1)))
        sc_parts.append(_rows(torch.where(keep, sc_j, NEG_INF)))
    return ids_parts, sc_parts


def _merge_topk(ids_list, scores_list, m):
    return dedupe_topk(torch.cat(ids_list, dim=-1),
                       torch.cat(scores_list, dim=-1), m)


def _flat_plan(cfg: RuntimeConfig, cx, q: torch.Tensor,
               hyperplanes: torch.Tensor):
    """Run the shared planner and flatten to (query, table) rows.

    `q` is [b, d], or node-leading [n, b, d] on a mesh; the flat fields
    keep the leading axes, [..., b*L].  Routed steps sketch without the
    simhash kernel, as the reference's mesh steps do; the codes are the
    same either way."""
    L = cfg.params.L
    lead, b_loc = q.shape[:-2], q.shape[-2]
    plan = plan_mod.make_plan(
        cfg.probe_spec, q.reshape(-1, q.shape[-1]), hyperplanes, cfg.topo,
        use_kernels=cfg.use_kernels and not cx.routed,
    )
    dev = q.device
    shape = lead + (b_loc * L,)
    flat = dict(
        owner=plan.owner.reshape(shape),
        local=plan.local_idx.reshape(shape),
        mask=plan.probe_mask.reshape(shape),
        table=torch.arange(L, dtype=torch.int32,
                           device=dev).repeat(b_loc).expand(shape),
        qidx=torch.arange(b_loc, dtype=torch.int64,
                          device=dev).repeat_interleave(L).expand(shape),
    )
    return plan, flat


def _route_cap(cfg: RuntimeConfig, b_loc: int) -> int:
    cap = int(np.ceil(b_loc * cfg.params.L / cfg.n_nodes * cfg.cap_factor))
    return max(cap, 1)


def _replica_targets(cfg: RuntimeConfig, owner: torch.Tensor,
                     live: torch.Tensor):
    """Replica-aware destinations of each node's flat probes [n, F]
    (DESIGN.md Sec. 10).

    `first`: each probe goes to the first live owner on its bucket's
    replica ring (the primary, else successor 1, ...); a probe with no
    live replica keeps its dead primary, whose liveness mask turns its
    rows into fill.  `quorum`: each probe fans out to all R replica
    owners, live or not, and the origin merges every copy.  Returns
    (dest [n, F*fanout], rep_sel [n, F*fanout], fanout), tiled
    replica-major under quorum."""
    n, R = cfg.n_nodes, cfg.replication
    if cfg.read_mode == "quorum":
        dest = torch.cat([(owner + rr) % n for rr in range(R)], dim=-1)
        rep_sel = torch.arange(R, dtype=owner.dtype,
                               device=owner.device).repeat_interleave(
            owner.shape[-1]).expand(dest.shape)
        return dest, rep_sel, R
    live_b = live > 0
    dest = owner
    rep_sel = torch.zeros_like(owner)
    found = live_b[owner.long()]
    for rr in range(1, R):
        cand = (owner + rr) % n
        alive = live_b[cand.long()]
        take = ~found & alive
        dest = torch.where(take, cand, dest)
        rep_sel = torch.where(take, rr, rep_sel)
        found = found | alive
    return dest, rep_sel, 1


# -----------------------------------------------------------------------------
# per-step observability scalars
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepStats:
    """Per-step accounting, the aux output of the search / contains steps.

    Every field is an int32 0-dim tensor except `dropped_by_dest`
    ([n_nodes]).  A mesh step body returns them per node, with a leading
    node axis; the step wrappers sum them (`distributed._psum_stats`).
    `int(stats)` is the dropped-probe count.
    """

    dropped: torch.Tensor          # probes lost to router-buffer overflow
    probes_issued: torch.Tensor    # planned bucket probes: exact + near bits
    probes_routed: torch.Tensor    # (query, table) rows through the router
    nodes_contacted: torch.Tensor  # distinct (query, destination) deliveries
    replica_fanout: torch.Tensor   # quorum fan-out factor (1 = first)
    dropped_by_dest: torch.Tensor  # [n_nodes] per-destination overflow

    def __int__(self) -> int:
        return int(self.dropped)

    def host(self) -> dict:
        """Concretize to plain Python."""
        return dict(
            dropped_probes=int(self.dropped),
            probes_issued=int(self.probes_issued),
            probes_routed=int(self.probes_routed),
            nodes_contacted=int(self.nodes_contacted),
            replica_fanout=int(self.replica_fanout),
            dropped_by_dest=tuple(self.dropped_by_dest.tolist()),
        )

    @staticmethod
    def local(n: int, probes_issued, nodes_contacted,
              device=None) -> "StepStats":
        """Stats for an unrouted step (identity router or allgather):
        nothing enters a capacitated buffer, so nothing can drop.
        `probes_issued` may carry a leading node axis."""
        probes = torch.as_tensor(probes_issued, dtype=torch.int32,
                                 device=device)

        def i32(v):
            return torch.full(probes.shape, v, dtype=torch.int32,
                              device=device)

        return StepStats(
            dropped=i32(0),
            probes_issued=probes,
            probes_routed=i32(0),
            nodes_contacted=i32(nodes_contacted),
            replica_fanout=i32(1),
            dropped_by_dest=torch.zeros(probes.shape + (n,),
                                        dtype=torch.int32, device=device),
        )


def _probes_issued(flat_mask: torch.Tensor) -> torch.Tensor:
    """Planned bucket probes of each [..., F] flat mask row: one exact
    bucket per (query, table) row plus one near bucket per set mask
    bit."""
    return flat_mask.shape[-1] + popcount32(flat_mask).sum(
        dim=-1, dtype=torch.int32)


def _routed_stats(route, dest, qidx, b_loc: int, n: int,
                  probes_issued, fanout: int = 1) -> StepStats:
    """Per-node stats of an all_to_all step, from the route plan itself.

    `route.dest` is clamped (overflow rows are parked on destination 0),
    so per-destination drop counts come from the UNCLAMPED `dest` taken
    through `route.order`, the sorted frame `route.ok` lives in."""
    d_true = dest.gather(1, route.order).long()         # unclamped, sorted
    q_sorted = qidx.gather(1, route.order)
    ok = route.ok.to(torch.int32)
    g = dest.shape[0]
    grp = torch.arange(g, device=dest.device)[:, None].expand(d_true.shape)
    i32 = dict(dtype=torch.int32, device=dest.device)
    touch = torch.zeros((g, b_loc, n), **i32).index_put_(
        (grp, q_sorted, d_true), ok, accumulate=True)
    by_dest = torch.zeros((g, n), **i32).index_put_(
        (grp, d_true), 1 - ok, accumulate=True)
    return StepStats(
        dropped=route.dropped,
        probes_issued=probes_issued,
        probes_routed=torch.full((g,), dest.shape[1], **i32),
        nodes_contacted=(touch > 0).sum(dim=(1, 2), dtype=torch.int32),
        replica_fanout=torch.full((g,), fanout, **i32),
        dropped_by_dest=by_dest,
    )


# -----------------------------------------------------------------------------
# the search step
# -----------------------------------------------------------------------------


def search_kernel(
    cfg: RuntimeConfig,
    cx,
    m: int,
    hyperplanes: torch.Tensor,
    store_ids: torch.Tensor,
    store_payload: torch.Tensor | None,
    cache_ids: torch.Tensor | None,
    cache_payload: torch.Tensor | None,
    q: torch.Tensor,                       # [b, d], or [n, b_loc, d]
    *,
    corpus=None,                           # id-keyed corpus (1-node only)
    exclude: torch.Tensor | None = None,   # [b] self ids (1-node only)
    rep_ids: torch.Tensor | None = None,   # [T, R-1, NB, C] (replication)
    rep_payload: torch.Tensor | None = None,  # [T, R-1, NB, C, D|W]
    live: torch.Tensor | None = None,      # [n] int32 liveness mask
):
    """Body of the search step, for every node at once.

    1-node (cx = LOCAL): q [b, d] -> (ids int32 [b, m], scores f32
    [b, m], `StepStats`).  Mesh (cx = `MeshCollectives`): q [n, b_loc,
    d] holds node j's query slice at j; the store [T, NB, C] and cache
    [T, node_bits, NB, C] are the global arrays, zone j being node j's;
    returns ids and scores [n, b_loc, m] and per-node stats.  `int(stats)`
    counts the (query, table) probes that overflowed the all_to_all
    buffers (0 on one node and under allgather).

    With `cfg.replication > 1` the routed path reads through replicas:
    probes go to live replica owners (`_replica_targets`), are scored
    there against the selected replica slice, and every node masks the
    rows it returns with its own `live` bit, so a dead node contributes
    fill, never stale rows.
    """
    if (corpus is not None or exclude is not None) and cx.routed:
        raise ValueError("corpus scoring / wire exclusion are 1-node only")
    if cfg.score == "hamming" and corpus is not None:
        raise ValueError(
            "score='hamming' needs slot-embedded packed payloads, not an "
            "id-keyed corpus")
    reps_on = cfg.replication > 1
    if reps_on and (rep_ids is None or rep_payload is None or live is None):
        raise ValueError(
            "replication > 1 needs rep_ids/rep_payload/live "
            "(IndexRuntime.replicate_store builds the replica slices)")
    L = cfg.params.L
    b_loc = q.shape[-2]
    plan, flat = _flat_plan(cfg, cx, q, hyperplanes)
    probes = _probes_issued(flat["mask"])

    qs = q
    if cfg.score == "hamming":
        # hamming scores against the query's own packed sketch words; on a
        # mesh the [.., W] words, not the [.., d] f32 rows, ride the wire
        qs = packed_mod.pack_codes(plan.codes, cfg.params.k).reshape(
            q.shape[:-1] + (-1,))
    fused = _fused_on(cfg, cx, has_payload=store_payload is not None,
                      has_corpus=corpus is not None,
                      on_card=store_ids.is_cuda)

    if not cx.routed:
        # identity router: every probe is local, nothing can be dropped
        ex = None if exclude is None else exclude[flat["qidx"]]
        ids_r, sc_r = _owner_topk(
            cfg, fused, store_ids, store_payload, corpus, qs[flat["qidx"]],
            flat["table"], flat["local"], flat["mask"], ex, m,
        )                                                  # [b*L, m]
        ids, sc = dedupe_topk(
            ids_r.reshape(b_loc, L * m), sc_r.reshape(b_loc, L * m), m)
        return ids, sc, StepStats.local(cx.n, probes, b_loc, device=q.device)

    n = cx.n
    if cfg.routing == "allgather":
        ids, sc = _search_allgather(
            cfg, cx, fused, store_ids, store_payload, cache_ids,
            cache_payload, qs, flat, m)
        # every node answers every query's probes: b_loc * n contacts
        return ids, sc, StepStats.local(n, probes, b_loc * n,
                                        device=q.device)

    # ---- all_to_all routing (DHT-lookup analogue) ---------------------------
    dest = flat["owner"]                                   # [n, F]
    fanout = 1
    if reps_on:
        dest, rep_col, fanout = _replica_targets(cfg, dest, live)
        if fanout > 1:  # quorum: replica-major tiling, as rep_col's
            flat = {k: v.repeat(1, fanout) for k, v in flat.items()}
    cap = _route_cap(cfg, b_loc) * fanout
    route = routing_mod.plan_routes(dest, n, cap)
    cols = [flat["qidx"].to(torch.int32), flat["table"], flat["local"],
            flat["mask"]]
    if reps_on:
        cols.append(rep_col)
    meta = torch.stack(cols, dim=-1)
    nodes = cx.axis_index()[:, None]
    # hamming routes the packed word rows; fill 0 is safe either way, as
    # fill rows carry meta -1 and are masked by rvalid below
    send_q = routing_mod.build_send_buffer(route, n, cap,
                                           qs[nodes, flat["qidx"]], 0)
    send_meta = routing_mod.build_send_buffer(route, n, cap, meta, -1)

    recv_q = cx.all_to_all(send_q)                         # [n, n, cap, DW]
    recv_meta = cx.all_to_all(send_meta)
    rq = recv_q.reshape(n, n * cap, qs.shape[-1])
    rtable = recv_meta[..., 1].reshape(n, -1)
    rvalid = rtable >= 0
    rtable = rtable.clamp(min=0)
    rlocal = recv_meta[..., 2].reshape(n, -1).clamp(min=0)
    rmask = recv_meta[..., 3].reshape(n, -1).clamp(min=0)
    reps = rrep = None
    if reps_on:
        reps = (rep_ids, rep_payload)
        rrep = recv_meta[..., 4].reshape(n, -1).clamp(0, cfg.replication - 1)
        # a dead node's own rows are fill: liveness is enforced where the
        # data lives, so a survivor cannot resurrect a killed zone
        rvalid &= cx.alive(live)[:, None]

    # fill rows score clamped indices, staged or fused alike, and are
    # masked by rvalid below
    ids_r, sc_r = _node_stages(cfg, cx, fused, store_ids, store_payload,
                               cache_ids, cache_payload, rq, rtable, rlocal,
                               rmask, m, reps, rrep)       # [n, n*cap, m]
    ids_r = torch.where(rvalid[..., None], ids_r, -1)
    sc_r = torch.where(rvalid[..., None], sc_r, NEG_INF)

    # ---- return results to origin -------------------------------------------
    back_i = cx.all_to_all(ids_r.reshape(n, n, cap, m))
    back_s = cx.all_to_all(sc_r.reshape(n, n, cap, m))
    gather_i = routing_mod.return_to_origin(route, back_i, -1)  # [n, F*fan, m]
    gather_s = routing_mod.return_to_origin(route, back_s, NEG_INF)

    def per_query(x):  # a query's L*m rows from every replica copy
        x = x.reshape(n, fanout, b_loc, L * m)
        return x.transpose(1, 2).reshape(n, b_loc, fanout * L * m)

    ids, sc = dedupe_topk(per_query(gather_i), per_query(gather_s), m)
    return ids, sc, _routed_stats(route, dest, flat["qidx"], b_loc, n,
                                  probes, fanout)


def _node_stages(cfg, cx, fused, store_ids, store_payload, cache_ids,
                 cache_payload, rq, rtable, rlocal, rmask, m, reps=None,
                 rrep=None):
    """Each node's candidate stages over the rows it received, merged to
    the top m: the owner's buckets, then the node-bit near buckets from
    the CNB cache or the NB forwards.  Node-leading [n, R, ...] in and
    [n, R, m] out; each stage runs once over all nodes' rows.  Rows with
    a replica rank `rrep` > 0 read the replica slices `reps` and skip
    the cache, which mirrors the primary zones only."""
    n, R = rtable.shape
    zone = _zones(cx, store_ids, R)
    q, table, local, mask = _rows(rq), _rows(rtable), _rows(rlocal), \
        _rows(rmask)
    rep_sel = None if rrep is None else _rows(rrep)
    ids_o, sc_o = _owner_topk(cfg, fused, store_ids, store_payload, None, q,
                              table, local, mask, None, m, zone, reps,
                              rep_sel)
    ids_parts, sc_parts = [ids_o], [sc_o]
    if cfg.variant == "cnb" and cache_ids is not None and cfg.node_bits > 0:
        ids_c, sc_c = _score_cache(cfg, cache_ids, cache_payload, q, table,
                                   local, mask, m, zone)
        if rep_sel is not None:
            prim = (rep_sel == 0)[:, None]
            ids_c = torch.where(prim, ids_c, -1)
            sc_c = torch.where(prim, sc_c, NEG_INF)
        ids_parts.append(ids_c)
        sc_parts.append(sc_c)
    if cfg.variant == "nb":
        ids_n, sc_n = _neighbor_parts(cfg, cx, store_ids, store_payload, rq,
                                      rtable, rlocal, rmask, m)
        ids_parts += ids_n
        sc_parts += sc_n
    ids_r, sc_r = _merge_topk(ids_parts, sc_parts, m)      # [n*R, m]
    return ids_r.reshape(n, R, m), sc_r.reshape(n, R, m)


def _gather_flat_meta(cx, flat: dict, L: int, names):
    """all_gather the named per-(query, table) flat fields over the nodes.

    Shared prologue of the two allgather branches (search + contains).
    Returns ({name: [b_all*L]}, table index [b_all*L], b_all)."""
    gathered = {name: cx.all_gather(flat[name]) for name in names}
    b_all = next(iter(gathered.values())).shape[0] // L
    rtable = torch.arange(L, dtype=torch.int32,
                          device=gathered[names[0]].device).repeat(b_all)
    return gathered, rtable, b_all


def _per_node(n: int, x: torch.Tensor) -> torch.Tensor:
    """The node-leading copy [n, ...] of a value every node holds."""
    return x.expand((n,) + x.shape).contiguous()


def _search_allgather(cfg, cx, fused, store_ids, store_payload, cache_ids,
                      cache_payload, qs, flat, m):
    """Dense fallback: every node receives every query, scores the
    (query, table) rows it owns, and the results return via all_to_all.
    `qs` [n, b_loc, d|W] is the scoring-side query row."""
    L, n = cfg.params.L, cx.n
    b_loc = qs.shape[1]
    g, rtable, b_all = _gather_flat_meta(cx, flat, L,
                                         ("owner", "local", "mask"))
    rq = cx.all_gather(qs).repeat_interleave(L, dim=0)     # [b_all*L, d|W]
    mine = g["owner"][None, :] == cx.axis_index()[:, None]  # [n, b_all*L]
    ids_r, sc_r = _node_stages(
        cfg, cx, fused, store_ids, store_payload, cache_ids, cache_payload,
        _per_node(n, rq), _per_node(n, rtable), _per_node(n, g["local"]),
        _per_node(n, g["mask"]), m)                        # [n, b_all*L, m]
    ids_r = torch.where(mine[..., None], ids_r, -1)
    sc_r = torch.where(mine[..., None], sc_r, NEG_INF)

    # each origin needs the rows of its own queries from ALL nodes
    def to_origin(x):
        got = cx.all_to_all(x.reshape(n, n, b_loc * L * m))
        return got.reshape(n, n, b_loc, L * m).transpose(1, 2).reshape(
            n, b_loc, n * L * m)

    return dedupe_topk(to_origin(ids_r), to_origin(sc_r), m)


# -----------------------------------------------------------------------------
# the contains step (success-probability metric, paper Sec. 6.3)
# -----------------------------------------------------------------------------


def _contains_local(cfg, store_ids, table, local_idx, mask, target,
                    zone=None, rep_ids=None, rep_sel=None):
    """bool [r]: does `target` sit in the (exact + masked local near)
    buckets of each row?  Metadata only.  With `rep_sel` row i reads
    replica rank rep_sel[i] (as in `_score_local`)."""
    probes, pvalid = _global_probes(cfg, store_ids.shape[1], local_idx, mask,
                                    zone)
    tbl = table.long()[:, None]
    if rep_sel is None:
        cand = store_ids[tbl, probes]                      # [r, P, C]
    else:
        cand = _with_replicas(store_ids, rep_ids)[
            tbl, rep_sel.long()[:, None], probes]
    hit = (cand == target[:, None, None]) & pvalid[..., None]
    return hit.any(dim=2).any(dim=1)


def _owner_hits(cfg, fused, store_ids, table, local_idx, mask, target,
                zone=None, rep_ids=None, rep_sel=None):
    """The owner component of contains: fused or staged."""
    if fused:
        return _fused_contains_local(cfg, store_ids, table, local_idx, mask,
                                     target, zone, rep_ids, rep_sel)
    return _contains_local(cfg, store_ids, table, local_idx, mask, target,
                           zone, rep_ids, rep_sel)


def _contains_hits(cfg, cx, fused, store_ids, cache_ids, rtable, rlocal,
                   rmask, rtgt, rep_ids=None, rrep=None):
    """Membership across each node's received rows, [n, R] in and out:
    the owner's buckets plus node-bit coverage (cache or neighbour
    forwards), mirroring the search step's candidate pool.  The cache and
    NB components stay staged; they OR booleans in, so the result is the
    same either way.  Replica reads (`rrep` > 0) skip the cache."""
    n, R = rtable.shape
    zone = _zones(cx, store_ids, R)
    table, local, mask, tgt = _rows(rtable), _rows(rlocal), _rows(rmask), \
        _rows(rtgt)
    rep_sel = None if rrep is None else _rows(rrep)
    hit = _owner_hits(cfg, fused, store_ids, table, local, mask, tgt, zone,
                      rep_ids, rep_sel)
    if cfg.variant == "cnb" and cache_ids is not None and cfg.node_bits > 0:
        jj = torch.arange(cache_ids.shape[1], device=hit.device)[None, :]
        cand = cache_ids[table.long()[:, None], jj,
                         (zone + local.long())[:, None]]   # [r, nbits, C]
        valid = _node_bit_valid(cfg, mask)[..., None]
        if rep_sel is not None:
            valid = valid & (rep_sel == 0)[:, None, None]
        hit |= ((cand == tgt[:, None, None]) & valid).any(dim=2).any(dim=1)
    hit = hit.reshape(n, R)
    if cfg.variant == "nb":
        lsh = dataclasses.replace(cfg, variant="lsh")
        nbit_valid = _node_bit_valid(cfg, rmask)           # [n, R, nbits]
        for j in range(cfg.node_bits):
            perm = cfg.topo.neighbor_perm(j)
            nt = _rows(cx.ppermute(rtable, perm))
            nl = _rows(cx.ppermute(rlocal, perm))
            ntgt = _rows(cx.ppermute(rtgt, perm))
            hit_j = _contains_local(lsh, store_ids, nt, nl,
                                    torch.zeros_like(nl), ntgt, zone)
            hit_j = cx.ppermute(hit_j.reshape(n, R), perm)
            hit |= hit_j & nbit_valid[..., j]
    return hit


def contains_kernel(cfg: RuntimeConfig, cx, hyperplanes, store_ids,
                    cache_ids, q, targets, *, rep_ids=None, live=None):
    """Body of `contains`: was target y's id in ANY searched bucket of
    query x?  Routes only metadata.  1-node: q [b, d], targets [b] ->
    (hits bool [b], `StepStats`); mesh: node-leading [n, b_loc, ...] in,
    hits [n, b_loc] and per-node stats out.  With replication, `rep_ids`
    [T, R-1, NB, C] and `live` [n] route as the search step does."""
    reps_on = cfg.replication > 1
    if reps_on and (rep_ids is None or live is None):
        raise ValueError("replication > 1 needs rep_ids/live")
    L, n = cfg.params.L, cx.n
    b_loc = q.shape[-2]
    _, flat = _flat_plan(cfg, cx, q, hyperplanes)
    probes = _probes_issued(flat["mask"])
    flat_tgt = targets.to(torch.int32).repeat_interleave(L, dim=-1)
    # membership needs no payload, so the fused path also serves ids-only
    # stores (need_payload=False)
    fused = _fused_on(cfg, cx, has_payload=True, has_corpus=False,
                      on_card=store_ids.is_cuda, need_payload=False)

    if not cx.routed:
        hit = _owner_hits(cfg, fused, store_ids, flat["table"],
                          flat["local"], flat["mask"], flat_tgt)
        return (hit.reshape(b_loc, L).any(dim=-1),
                StepStats.local(n, probes, b_loc, device=q.device))

    if cfg.routing == "allgather":
        g, rtable, b_all = _gather_flat_meta(
            cx, dict(flat, target=flat_tgt), L,
            ("owner", "local", "mask", "target"))
        hit = _contains_hits(
            cfg, cx, fused, store_ids, cache_ids, _per_node(n, rtable),
            _per_node(n, g["local"]), _per_node(n, g["mask"]),
            _per_node(n, g["target"]))                     # [n, b_all*L]
        hit &= g["owner"][None, :] == cx.axis_index()[:, None]
        # OR across nodes == psum of disjoint indicators, then own slice
        hit_all = cx.psum(hit.reshape(n, b_all, L).any(dim=-1).to(
            torch.int32))
        return (hit_all.reshape(n, b_loc) > 0,
                StepStats.local(n, probes, b_loc * n, device=q.device))

    dest = flat["owner"]
    fanout = 1
    if reps_on:
        dest, rep_col, fanout = _replica_targets(cfg, dest, live)
        if fanout > 1:
            flat = {k: v.repeat(1, fanout) for k, v in flat.items()}
            flat_tgt = flat_tgt.repeat(1, fanout)
    cap = _route_cap(cfg, b_loc) * fanout
    route = routing_mod.plan_routes(dest, n, cap)
    cols = [flat["qidx"].to(torch.int32), flat["table"], flat["local"],
            flat["mask"], flat_tgt]
    if reps_on:
        cols.append(rep_col)
    meta = torch.stack(cols, dim=-1)
    send_meta = routing_mod.build_send_buffer(route, n, cap, meta, -1)
    recv_meta = cx.all_to_all(send_meta)                   # [n, n, cap, 5|6]

    def col(c):
        return recv_meta[..., c].reshape(n, -1)

    rep_kw = {}
    if reps_on:
        rep_kw = dict(rep_ids=rep_ids,
                      rrep=col(5).clamp(0, cfg.replication - 1))
    hit = _contains_hits(cfg, cx, fused, store_ids, cache_ids,
                         col(1).clamp(min=0), col(2).clamp(min=0),
                         col(3).clamp(min=0), col(4), **rep_kw)
    # empty-slot rows carry rtgt = -1, which DOES match empty bucket ids
    # (-1); this validity mask is what discards those spurious hits
    hit &= col(1) >= 0
    if reps_on:
        hit &= cx.alive(live)[:, None]
    back = cx.all_to_all(hit.reshape(n, n, cap).to(torch.int32))
    got = routing_mod.return_to_origin(route, back, 0)     # [n, F*fanout]
    return (got.reshape(n, fanout, b_loc, L).any(dim=-1).any(dim=1),
            _routed_stats(route, dest, flat["qidx"], b_loc, n, probes,
                          fanout))


# -----------------------------------------------------------------------------
# the insert / payload-sync steps (soft-state maintenance)
# -----------------------------------------------------------------------------


def _zone_view(st: BucketStore, s: int, e: int) -> BucketStore:
    """The store of one node's zone, as views that write through to `st`."""
    return BucketStore(
        st.ids[:, s:e], st.timestamps[:, s:e], st.write_ptr[:, s:e],
        None if st.payload is None else st.payload[:, s:e], st.generation)


def insert_kernel(cfg: RuntimeConfig, cx, hyperplanes, st: BucketStore, vec,
                  vid, now) -> BucketStore:
    """Body of insert/refresh: each node keeps the vectors whose exact
    buckets it owns (paper Sec. 2.2).  `vec` [nv, d] / `vid` [nv], or
    node-leading slices on a mesh, which every node gathers.  Returns a
    new store; every node bumps the generation by the same L."""
    vec_all = cx.all_gather_batch(vec)
    vid_all = cx.all_gather_batch(vid)
    plan = plan_mod.make_plan(
        # insert wants only the owner/local split of the exact bucket
        dataclasses.replace(cfg.probe_spec, variant="lsh"),
        vec_all, hyperplanes, cfg.topo,
    )
    payload = None
    if st.payload is not None:
        if cfg.score == "hamming":
            W = packed_mod.num_words(cfg.params.k, cfg.params.L)
            if st.payload.dtype != torch.int32 or st.payload.shape[-1] != W:
                raise ValueError(
                    "score='hamming' insert needs a packed int32 payload "
                    f"[..., {W}] — run pack_store_payload on stores built "
                    f"for dot scoring; got {st.payload.dtype} payload with "
                    f"shape {tuple(st.payload.shape)}")
            payload = packed_mod.pack_codes(plan.codes, cfg.params.k)
        else:
            payload = vec_all
    new = st.clone()
    for node in range(cx.n):
        zone = _zone_view(new, *cfg.topo.zone_range(node))
        mine = plan.owner == node                            # [nv, L]
        for l in range(cfg.params.L):
            sel = mine[:, l]
            store_mod._insert_masked_(
                zone, l, torch.where(sel, vid_all, -1),
                torch.where(sel, plan.local_idx[:, l], 0), now, payload)
    new.generation = st.generation + cfg.params.L
    return new


def payload_sync_kernel(cx, store_ids, store_payload, vec):
    """Point every live bucket entry's payload at the latest announced
    vector of its id (`vec` row i = vector of user id i, node-leading
    slices on a mesh).  Elementwise over the store, so each node's zone
    is synced by the same op."""
    vec_all = cx.all_gather_batch(vec)
    nv = vec_all.shape[0]
    live = (store_ids >= 0) & (store_ids < nv)
    gathered = vec_all[store_ids.clamp(0, nv - 1).long()]
    return torch.where(live[..., None], gathered, store_payload)


def permuted_zones(cx, x: torch.Tensor, perms) -> torch.Tensor:
    """[T, len(perms), NB, ...]: slice i holds the global array `x`
    [T, NB, ...] after each node sent its zone along pairing perms[i]
    (one ppermute over the zone axis each)."""
    t, nb = x.shape[:2]
    zones = x.reshape((t, cx.n, nb // cx.n) + x.shape[2:])
    out = x.new_empty((t, len(perms)) + x.shape[1:])
    for i, perm in enumerate(perms):
        out[:, i] = cx.ppermute(zones, perm, axis=1).reshape(x.shape)
    return out


def replicate_kernel(cfg: RuntimeConfig, cx, store_ids, store_payload):
    """Replica construction: each node ships its zone to its R-1 ring
    successors, one ppermute per replica rank.

    Replica rank r of node j's zone lands on node (j + r) % n
    (`CanTopology.replicas_of`), so zone i of slice r-1 holds the zone of
    node (i - r) % n, at the same bucket indices as on the primary.
    Returns (rep_ids [T, R-1, NB, C], rep_payload [T, R-1, NB, C, D|W]).

    Soft state keeps the replicas fresh (paper Sec. 4.1): the churn
    driver re-runs this after every announce round, which is the
    replication of those writes, and charges each fan-out through
    `costmodel.estimate_replication_bytes`."""
    n = cx.n
    perms = [[(i, (i + r) % n) for i in range(n)]
             for r in range(1, cfg.replication)]
    return (permuted_zones(cx, store_ids, perms),
            permuted_zones(cx, store_payload, perms))


# -----------------------------------------------------------------------------
# IndexRuntime: the host-level API over one topology
# -----------------------------------------------------------------------------


class IndexRuntime:
    """The five index operations bound to one topology.

    * ``IndexRuntime(cfg)`` with ``cfg.n_nodes == 1``: the single-host
      engine's execution context, on ``device`` (the CUDA card unless
      ``device="cpu"``).
    * ``IndexRuntime(cfg, mesh)``: the steps of `repro_torch.core.
      distributed` over a `ZoneMesh` of ``cfg.n_nodes`` nodes, on the
      mesh's device.

    Inputs given as numpy arrays or tensors move to the runtime's device.
    """

    def __init__(self, cfg: RuntimeConfig, mesh=None, *, device=None):
        if mesh is None and cfg.n_nodes != 1:
            raise ValueError(
                f"n_nodes={cfg.n_nodes} needs a mesh (make_zone_mesh); "
                "only the 1-node topology runs mesh-free")
        if mesh is not None:
            if mesh.shape["model"] != cfg.n_nodes:
                raise ValueError(f"cfg.n_nodes={cfg.n_nodes} != mesh model "
                                 f"axis {mesh.shape['model']}")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device={device} differs from the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh

    @property
    def topology(self) -> CanTopology:
        return self.cfg.topo

    @property
    def is_distributed(self) -> bool:
        return self.mesh is not None

    @property
    def n_devices(self) -> int:
        """Slices the query/vector batch shards over (pad batches to a
        multiple of this)."""
        if self.mesh is None:
            return 1
        return int(np.prod([self.mesh.shape[a]
                            for a in self.mesh.batch_axes]))

    def _dist(self):
        from repro_torch.core import distributed as dist

        return dist

    def _put(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x).to(self.device, dtype)

    def shard_store(self, store: BucketStore) -> BucketStore:
        if self.mesh is None:
            return store
        return self._dist().shard_store(self.mesh, store)

    def refresh_cache(self, store: BucketStore):
        """The CNB neighbour cache (cache_ids, cache_payload), or None on
        topologies without node bits."""
        if self.cfg.node_bits == 0:
            return None
        refresh = self._dist().make_refresh_cache(self.cfg, self.mesh)
        return refresh(store.ids, store.payload)

    def replicate_store(self, store: BucketStore):
        """The (rep_ids, rep_payload) slices of the current store, or None
        at replication 1.  Call after every announce round: replica
        freshness rides the soft-state re-announce cycle."""
        step = self.make_replicate_step()
        if step is None:
            return None
        return step(store.ids, store.payload)

    def make_replicate_step(self):
        """fn(ids, payload) -> replica slices (DESIGN.md Sec. 10), or None
        at replication 1."""
        if self.cfg.replication == 1:
            return None
        return self._dist().make_replicate_store(self.cfg, self.mesh)

    def _live(self, replicas, live) -> torch.Tensor | None:
        """The liveness mask [n] int32 on the device (all live by default)
        of a replicated read, or None at replication 1; raises the
        reference's argument errors."""
        if self.cfg.replication == 1:
            if replicas is not None or live is not None:
                raise ValueError("replicas/live require cfg.replication > 1")
            return None
        if replicas is None:
            raise ValueError(
                "replication > 1: pass replicas= (see replicate_store)")
        if live is None:
            return torch.ones(self.cfg.n_nodes, dtype=torch.int32,
                              device=self.device)
        return self._put(live, torch.int32)

    def _needs_cache(self) -> bool:
        return self.cfg.variant == "cnb" and self.cfg.node_bits > 0

    def _cache_args(self, cache, n: int) -> tuple:
        if not self._needs_cache():
            return ()
        if cache is None:
            raise ValueError("cnb on a mesh with node bits needs cache= "
                             "(see refresh_cache)")
        return tuple(cache)[:n]

    def search(self, hyperplanes, store: BucketStore, q, *, cache=None,
               corpus=None, exclude=None, m: int | None = None,
               replicas=None, live=None):
        """(ids [nq, m], scores [nq, m], `StepStats`) over this topology;
        `int(stats)` is the dropped-probe count.  On a mesh, `m` is
        cfg.m, and `corpus` / `exclude` (1-node only) are refused.  With
        `cfg.replication > 1`, `replicas` (from `replicate_store`) is
        required and `live` ([n_nodes] 0/1, all live by default) names
        the replica owners reads may land on."""
        live = self._live(replicas, live)
        qd = self._put(q, torch.float32)
        if self.mesh is None:
            m = self.cfg.m if m is None else m
            ex = None if exclude is None else self._put(exclude, torch.int32)
            payload = None if corpus is not None else store.payload
            return search_kernel(self.cfg, LOCAL, m, hyperplanes, store.ids,
                                 payload, None, None, qd, corpus=corpus,
                                 exclude=ex)
        if m is not None and m != self.cfg.m:
            raise ValueError(f"mesh steps bake m={self.cfg.m}; got m={m}")
        if corpus is not None or exclude is not None:
            raise ValueError("corpus scoring / exclusion are 1-node only")
        step = self._dist().make_search_step(self.cfg, self.mesh)
        reps = () if live is None else (*replicas, live)
        return step(hyperplanes, store.ids, store.payload,
                    *self._cache_args(cache, 2), *reps, qd)

    def contains(self, hyperplanes, store: BucketStore, q, targets, *,
                 cache=None, replicas=None, live=None):
        """(hits bool [nq], `StepStats`); `replicas` / `live` as in
        `search`."""
        live = self._live(replicas, live)
        qd = self._put(q, torch.float32)
        td = self._put(targets, torch.int32)
        if self.mesh is None:
            return contains_kernel(self.cfg, LOCAL, hyperplanes, store.ids,
                                   None, qd, td)
        step = self._dist().make_contains_step(self.cfg, self.mesh)
        reps = () if live is None else (replicas[0], live)
        return step(hyperplanes, store.ids, *self._cache_args(cache, 1),
                    *reps, qd, td)

    def insert(self, hyperplanes, store: BucketStore, vec, vid, now):
        vec = self._put(vec, torch.float32)
        vid = self._put(vid, torch.int32)
        if self.mesh is None:
            return insert_kernel(self.cfg, LOCAL, hyperplanes, store, vec,
                                 vid, now)
        step = self._dist().make_insert_step(self.cfg, self.mesh)
        return step(hyperplanes, store, vec, vid, now)

    def expire(self, store: BucketStore, now, ttl: int) -> BucketStore:
        # GC is elementwise over bucket state: the same op on every
        # topology (zone-local on a mesh store by construction)
        return store_mod.expire(store, now, ttl)

    def payload_sync(self, store: BucketStore, vec, *,
                     hyperplanes=None) -> BucketStore:
        vec = self._put(vec, torch.float32)
        if self.cfg.score == "hamming":
            if hyperplanes is None:
                raise ValueError(
                    "score='hamming' payload_sync needs hyperplanes= to "
                    "re-sketch the announced vectors into packed words")
            vec = packed_mod.pack_codes(sketch_codes(vec, hyperplanes),
                                        self.cfg.params.k)
        if self.mesh is not None:
            return self._dist().make_payload_sync(self.cfg, self.mesh)(
                store, vec)
        return dataclasses.replace(
            store,
            payload=payload_sync_kernel(LOCAL, store.ids, store.payload, vec),
            generation=store.generation + 1,
        )


# -----------------------------------------------------------------------------
# failure injection: fail-stop kill with no handoff (DESIGN.md Sec. 10)
# -----------------------------------------------------------------------------


def _blanked(x: torch.Tensor, axis: int, s: int, e: int, fill) -> torch.Tensor:
    """A copy of `x` with [s, e) of `axis` set to `fill`; `x` is kept."""
    out = x.clone()
    out.narrow(axis, s, e - s).fill_(fill)
    return out


def kill_node(rt: IndexRuntime, store: BucketStore, replicas, node: int):
    """Fail-stop loss of one node: its bucket zone and the replica slices
    it held vanish with no handoff (contrast `reshard`, the graceful
    path).

    The zone `zone_range(node)` is blanked in the primary store, and so
    is the node's share of the replica slices (copies of other nodes'
    zones it was holding); the replicas of its own zone, on its ring
    successors, survive, and first-responder or quorum reads serve from
    them.  Bumps `generation`, so caches drop results that may hold the
    dead node's rows.  Functional: returns a new (store, replicas) and
    leaves the inputs as they were.  Pair it with a 0 in the `live` mask
    until the next re-announce repopulates the zone."""
    s, e = rt.topology.zone_range(node)
    new_store = BucketStore(
        ids=_blanked(store.ids, 1, s, e, store_mod.EMPTY),
        timestamps=_blanked(store.timestamps, 1, s, e, 0),
        write_ptr=_blanked(store.write_ptr, 1, s, e, 0),
        payload=None if store.payload is None
        else _blanked(store.payload, 1, s, e, 0),
        generation=store.generation + 1,
    )
    new_reps = replicas
    if replicas is not None:
        rep_ids, rep_payload = replicas
        new_reps = (_blanked(rep_ids, 2, s, e, store_mod.EMPTY),
                    None if rep_payload is None
                    else _blanked(rep_payload, 2, s, e, 0))
    return new_store, new_reps


# -----------------------------------------------------------------------------
# elastic membership: reshard a runtime to a new node count (DESIGN.md Sec. 9)
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReshardEvent:
    """Ledger entry of one membership round (power-of-two join/leave).

    `moved_buckets` counts the bucket rows (across all L tables) whose
    owner changed; `handoff_bytes` is the Table-1 analogue byte charge of
    shipping those rows (ids + timestamps + embedded payloads + ring
    pointers) to the new owners."""

    old_n: int
    new_n: int
    moved_buckets: int
    handoff_bytes: int


def gather_store(store: BucketStore) -> BucketStore:
    """The global view of a (possibly mesh-placed) store.

    The zones are contiguous slices of one global bucket array, and on
    one device that array is the store itself: the view shares its
    tensors, with no copy and no trip to the host.  (Real deployments
    ship only the moved slices; `ReshardEvent` charges exactly those.)"""
    return BucketStore(store.ids, store.timestamps, store.write_ptr,
                       store.payload, store.generation)


def reshard(
    rt: IndexRuntime,
    store: BucketStore,
    new_n_nodes: int | None = None,
    *,
    mesh=None,
    runtime: IndexRuntime | None = None,
    cap_factor: float | None = None,
) -> tuple[IndexRuntime, BucketStore, ReshardEvent]:
    """Elastic node membership: split or merge the contiguous CAN zones to
    `new_n_nodes` owners and hand the bucket state off.

    Growing N -> rN splits every zone (the incumbent keeps the first
    subzone, r-1 joiners take the rest); shrinking merges sibling groups
    onto the group's first node.  The global bucket array is invariant
    under the round and the planner derives the same probes on every
    topology, so search results are the same before and after.

    `runtime=` reuses a built target runtime; otherwise one is built from
    this runtime's config with `n_nodes=new_n_nodes` (and `cap_factor`,
    default unchanged) on `mesh` (None: the 1-node runtime on this
    runtime's device).  CNB caches are not migrated: rebuild them with
    `new_rt.refresh_cache(new_store)`.  Returns (new_runtime,
    migrated_store, ReshardEvent); the store's generation is bumped."""
    from repro_torch.core import costmodel
    from repro_torch.core.can import moved_buckets

    if runtime is not None:
        if mesh is not None or cap_factor is not None:
            raise ValueError(
                "mesh=/cap_factor= don't apply to a prebuilt runtime — "
                "build the target runtime with them instead")
        if new_n_nodes is not None and new_n_nodes != runtime.cfg.n_nodes:
            raise ValueError(
                f"runtime has n_nodes={runtime.cfg.n_nodes}, "
                f"asked for {new_n_nodes}")
        # a membership round replaces only the topology knobs: any other
        # drift would change the query discipline mid-trajectory
        if dataclasses.replace(
            runtime.cfg, n_nodes=rt.cfg.n_nodes,
            cap_factor=rt.cfg.cap_factor,
        ) != rt.cfg:
            raise ValueError(
                "target runtime differs beyond the topology knobs: "
                f"{runtime.cfg} vs {rt.cfg}")
        new_rt = runtime
    else:
        if new_n_nodes is None:
            raise ValueError("need new_n_nodes or a prebuilt runtime")
        cfg = dataclasses.replace(
            rt.cfg, n_nodes=int(new_n_nodes),
            cap_factor=float(rt.cfg.cap_factor if cap_factor is None
                             else cap_factor))
        new_rt = IndexRuntime(cfg, mesh=mesh,
                              device=None if mesh is not None else rt.device)

    glob = gather_store(store)
    glob.generation = glob.generation + 1
    new_store = new_rt.shard_store(glob)
    d = 0 if glob.payload is None else int(glob.payload.shape[-1])
    event = ReshardEvent(
        old_n=rt.cfg.n_nodes,
        new_n=new_rt.cfg.n_nodes,
        moved_buckets=rt.cfg.params.L * moved_buckets(rt.cfg.topo,
                                                      new_rt.cfg.topo),
        handoff_bytes=costmodel.estimate_handoff_bytes(
            rt.cfg.params.L, glob.ids.shape[1], glob.ids.shape[2], d,
            rt.cfg.n_nodes, new_rt.cfg.n_nodes),
    )
    return new_rt, new_store, event
