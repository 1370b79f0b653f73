"""The IndexRuntime on the 1-node topology (DESIGN.md Sec. 8).

The five index operations (search, contains, insert, expire, payload
sync) as step functions parameterized by a `CanTopology`.  This slice
ports the degenerate mesh, `CanTopology(k, n_nodes=1)`: every near
bucket is a free local-bit probe, the router is the identity, and no
collectives run.  The single-host `LshEngine` is a façade over it.  The
routed mesh half (all_to_all / allgather routing, the CNB cache, NB
forwards, replication) arrives with the mesh runtime.

On a CUDA store, `fused="auto"` takes the fused query / contains kernels
where they apply, as the reference takes its Pallas kernels on a TPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import packed as packed_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core import scoring
from repro_torch.core import store as store_mod
from repro_torch.core.can import CanTopology
from repro_torch.core.corpus import DenseCorpus
from repro_torch.core.hashing import LshParams, popcount32, sketch_codes
from repro_torch.core.scoring import dedupe_topk
from repro_torch.core.store import BucketStore

NEG_INF = float("-inf")
_MESH_NOT_PORTED = "mesh runtime not yet ported"


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Static description of one index runtime.

    Only `n_nodes=1` runs in this port so far; the mesh-only fields of
    the reference (routing, cap_factor, replication, read_mode) arrive
    with the mesh runtime.
    """

    params: LshParams
    variant: str = "cnb"          # lsh | layered | nb | cnb
    m: int = 10                    # results per query
    n_nodes: int = 1               # topology nodes (power of two)
    probe_local_near: bool = True  # search local-bit near buckets (nb/cnb)
    num_probes: int | None = None  # None => all k 1-near buckets (the paper)
    ranked_probes: bool = False    # margin-ranked probe subset (beyond paper)
    use_kernels: bool = False      # simhash sketch + bucket_topk scoring
    fused: str = "auto"            # fused query kernel: auto | on | off
    score: str = "dot"             # dot | hamming (packed sketch words)

    def __post_init__(self):
        if self.fused not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused mode {self.fused!r}")
        if self.score not in ("dot", "hamming"):
            raise ValueError(f"unknown score mode {self.score!r}")
        if self.n_nodes > 1:
            raise NotImplementedError(_MESH_NOT_PORTED)

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


class LocalCollectives:
    """The 1-node mesh: every collective is the identity.  `routed=False`
    selects the identity router in the step functions, so probes
    structurally cannot be dropped."""

    n = 1
    routed = False

    def axis_index(self):
        return 0


LOCAL = LocalCollectives()


# -----------------------------------------------------------------------------
# shard-local scoring helpers
# -----------------------------------------------------------------------------


def _local_include_near(cfg: RuntimeConfig) -> bool:
    return cfg.variant not in ("lsh", "layered") and cfg.probe_local_near


def _pool_topk(cfg, corpus, q, flat_ids, slot_vecs, m):
    """Score a flattened candidate pool and keep the top m distinct ids,
    with payloads from the id-keyed `corpus` or from the bucket slots."""
    if corpus is not None:
        if not isinstance(corpus, DenseCorpus):
            raise NotImplementedError("SparseCorpus is not ported yet")
        vecs = corpus.gather(flat_ids)
        return scoring.score_topk(q, flat_ids, vecs, m,
                                  use_kernels=cfg.use_kernels)
    return scoring.score_topk(q, flat_ids, slot_vecs, m,
                              use_kernels=cfg.use_kernels, score=cfg.score)


def _score_local(cfg, store_ids, store_payload, corpus, q, table, local_idx,
                 mask, exclude, m):
    """Top-m among the (exact + masked local near) buckets of each row:
    the staged gather -> score -> top-m path."""
    probes, pvalid = plan_mod.shard_local_probes(
        cfg.topo, local_idx, mask, include_near=_local_include_near(cfg)
    )                                                      # [r, P] both
    probes = (probes % store_ids.shape[1]).long()  # fold OOB codes
    tbl = table.long()[:, None]
    cand_ids = store_ids[tbl, probes]                      # [r, P, C]
    cand_ids = torch.where(pvalid[..., None], cand_ids, -1)
    r = q.shape[0]
    flat_ids = cand_ids.reshape(r, -1)
    if exclude is not None:
        flat_ids = torch.where(flat_ids == exclude[:, None], -1, flat_ids)
    slot_vecs = None
    if corpus is None:
        slot_vecs = store_payload[tbl, probes].reshape(
            r, flat_ids.shape[1], -1)                      # [r, P*C, D|W]
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
    on the CPU the staged path runs.  `on` forces the path (on the CPU
    through the kernel's plain version) and raises where it cannot
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


def _fused_probe_rows(cfg: RuntimeConfig, nb: int, table, local_idx, mask):
    """(fb int32 [r, P], pword int32 [r]) for the fused kernels.

    `fb` flattens (table, bucket) to a row of the [T*NB, C] store view;
    `pword` packs the per-probe validity into one int32 bitfield (bit p
    = probe p valid; P <= 1 + k <= 31, so bit 31 stays clear)."""
    probes, pvalid = plan_mod.shard_local_probes(
        cfg.topo, local_idx, mask, include_near=_local_include_near(cfg)
    )
    probes = probes % nb
    fb = table[:, None] * nb + probes
    shifts = torch.arange(pvalid.shape[1], dtype=torch.int32,
                          device=pvalid.device)
    pword = (pvalid.to(torch.int32) << shifts).sum(dim=1, dtype=torch.int32)
    return fb.to(torch.int32).contiguous(), pword


def _fused_search_local(cfg, store_ids, store_payload, q, table, local_idx,
                        mask, exclude, m):
    """Fused twin of `_score_local`: one kernel replaces gather + score +
    top-m; no [r, P*C] candidate intermediate exists."""
    from repro_torch.kernels import ops

    t, nb, c = store_ids.shape
    ids_flat = store_ids.reshape(t * nb, c)
    pay_flat = store_payload.reshape(t * nb, c, store_payload.shape[-1])
    fb, pword = _fused_probe_rows(cfg, nb, table, local_idx, mask)
    # -1 matches only empty slots == no exclusion
    excl = (torch.full_like(pword, -1) if exclude is None
            else exclude.to(torch.int32))
    meta = torch.stack([pword, excl], dim=1)
    return ops.fused_query(ids_flat, pay_flat, q.contiguous(), fb, meta,
                           m=m, score=cfg.score)


def _fused_contains_local(cfg, store_ids, table, local_idx, mask, target):
    """Fused twin of `_contains_local`: metadata only."""
    from repro_torch.kernels import ops

    t, nb, c = store_ids.shape
    fb, pword = _fused_probe_rows(cfg, nb, table, local_idx, mask)
    meta = torch.stack([pword, target.to(torch.int32)], dim=1)
    return ops.fused_contains(store_ids.reshape(t * nb, c), fb, meta)


def _flat_plan(cfg: RuntimeConfig, cx, q: torch.Tensor,
               hyperplanes: torch.Tensor):
    """Run the shared planner and flatten to (query, table) rows."""
    L = cfg.params.L
    b_loc = q.shape[0]
    plan = plan_mod.make_plan(
        cfg.probe_spec, q, hyperplanes, cfg.topo,
        use_kernels=cfg.use_kernels and not cx.routed,
    )
    dev = q.device
    flat = dict(
        owner=plan.owner.reshape(-1),                   # [b_loc*L]
        local=plan.local_idx.reshape(-1),
        mask=plan.probe_mask.reshape(-1),
        table=torch.arange(L, dtype=torch.int32, device=dev).repeat(b_loc),
        qidx=torch.arange(b_loc, dtype=torch.int64,
                          device=dev).repeat_interleave(L),
    )
    return plan, flat


# -----------------------------------------------------------------------------
# per-step observability scalars
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepStats:
    """Per-step accounting, the aux output of the search / contains steps.

    Every field is an int32 0-dim tensor except `dropped_by_dest`
    ([n_nodes]).  `int(stats)` is the dropped-probe count.
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
        """Stats for an unrouted step: nothing enters a capacitated
        buffer, so nothing can drop."""
        def i32(v):
            return torch.as_tensor(v, dtype=torch.int32, device=device)

        return StepStats(
            dropped=i32(0),
            probes_issued=i32(probes_issued),
            probes_routed=i32(0),
            nodes_contacted=i32(nodes_contacted),
            replica_fanout=i32(1),
            dropped_by_dest=torch.zeros((n,), dtype=torch.int32,
                                        device=device),
        )


def _probes_issued(flat_mask: torch.Tensor) -> torch.Tensor:
    """Planned bucket probes: one exact bucket per (query, table) row
    plus one near bucket per set mask bit."""
    return flat_mask.shape[0] + popcount32(flat_mask).sum(dtype=torch.int32)


# -----------------------------------------------------------------------------
# the step functions
# -----------------------------------------------------------------------------


def search_kernel(
    cfg: RuntimeConfig,
    cx,
    m: int,
    hyperplanes: torch.Tensor,
    store_ids: torch.Tensor,
    store_payload: torch.Tensor | None,
    q: torch.Tensor,                       # [b_loc, d]
    *,
    corpus=None,                           # id-keyed corpus
    exclude: torch.Tensor | None = None,   # [b_loc] self ids to drop
):
    """Body of the search step on the 1-node topology.

    Returns (ids int32 [b_loc, m], scores f32 [b_loc, m], `StepStats`).
    """
    if cx.routed:
        raise NotImplementedError(_MESH_NOT_PORTED)
    if cfg.score == "hamming" and corpus is not None:
        raise ValueError(
            "score='hamming' needs slot-embedded packed payloads, not an "
            "id-keyed corpus")
    L = cfg.params.L
    b_loc = q.shape[0]
    plan, flat = _flat_plan(cfg, cx, q, hyperplanes)
    probes = _probes_issued(flat["mask"])

    qs = q
    if cfg.score == "hamming":
        # hamming scores against the query's own packed sketch words
        qs = packed_mod.pack_codes(plan.codes, cfg.params.k)

    ex = None if exclude is None else exclude[flat["qidx"]]
    if _fused_on(cfg, cx, has_payload=store_payload is not None,
                 has_corpus=corpus is not None, on_card=store_ids.is_cuda):
        ids_r, sc_r = _fused_search_local(
            cfg, store_ids, store_payload, qs[flat["qidx"]],
            flat["table"], flat["local"], flat["mask"], ex, m,
        )                                                  # [b_loc*L, m]
    else:
        ids_r, sc_r = _score_local(
            cfg, store_ids, store_payload, corpus, qs[flat["qidx"]],
            flat["table"], flat["local"], flat["mask"], ex, m,
        )                                                  # [b_loc*L, m]
    ids, sc = dedupe_topk(
        ids_r.reshape(b_loc, L * m), sc_r.reshape(b_loc, L * m), m)
    return ids, sc, StepStats.local(cx.n, probes, b_loc, device=q.device)


def _contains_local(cfg, store_ids, table, local_idx, mask, target):
    """bool [r]: does `target` sit in the (exact + masked local near)
    buckets of each row?  Metadata only."""
    probes, pvalid = plan_mod.shard_local_probes(
        cfg.topo, local_idx, mask, include_near=_local_include_near(cfg))
    probes = (probes % store_ids.shape[1]).long()
    cand = store_ids[table.long()[:, None], probes]        # [r, P, C]
    hit = (cand == target[:, None, None]) & pvalid[..., None]
    return hit.any(dim=2).any(dim=1)


def _contains_hits(cfg, store_ids, rtable, rlocal, rmask, rtgt,
                   fused=False):
    """Membership across the owner's buckets.  On the 1-node topology
    every probe is an owner probe, so there is no cache or neighbor
    component."""
    if fused:
        return _fused_contains_local(cfg, store_ids, rtable, rlocal, rmask,
                                     rtgt)
    return _contains_local(cfg, store_ids, rtable, rlocal, rmask, rtgt)


def contains_kernel(cfg: RuntimeConfig, cx, hyperplanes, store_ids, q,
                    targets):
    """Body of `contains`: was target y's id in ANY searched bucket of
    query x?  Returns (hits bool [b_loc], `StepStats`)."""
    if cx.routed:
        raise NotImplementedError(_MESH_NOT_PORTED)
    L = cfg.params.L
    b_loc = q.shape[0]
    _, flat = _flat_plan(cfg, cx, q, hyperplanes)
    probes = _probes_issued(flat["mask"])
    flat_tgt = targets.to(torch.int32).repeat_interleave(L)
    # membership needs no payload, so the fused path also serves
    # ids-only stores (need_payload=False)
    fused = _fused_on(cfg, cx, has_payload=True, has_corpus=False,
                      on_card=store_ids.is_cuda, need_payload=False)
    hit = _contains_hits(cfg, store_ids, flat["table"], flat["local"],
                         flat["mask"], flat_tgt, fused=fused)
    return (hit.reshape(b_loc, L).any(dim=-1),
            StepStats.local(cx.n, probes, b_loc, device=q.device))


def insert_kernel(cfg: RuntimeConfig, cx, hyperplanes, st: BucketStore, vec,
                  vid, now) -> BucketStore:
    """Body of insert/refresh: each node keeps the vectors whose exact
    buckets it owns (on one node, all of them).  Returns a new store."""
    plan = plan_mod.make_plan(
        # insert wants only the owner/local split of the exact bucket
        dataclasses.replace(cfg.probe_spec, variant="lsh"),
        vec, hyperplanes, cfg.topo,
    )
    mine = plan.owner == cx.axis_index()                     # [nv, L]
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
            payload = vec
    new = st.clone()
    for l in range(cfg.params.L):
        sel = mine[:, l]
        ids_l = torch.where(sel, vid, -1)
        codes_l = torch.where(sel, plan.local_idx[:, l], 0)
        store_mod._insert_masked_(new, l, ids_l, codes_l, now, payload)
    return new


def payload_sync_kernel(cx, store_ids, store_payload, vec):
    """Point every live bucket entry's payload at the latest announced
    vector of its id (`vec` row i = vector of user id i)."""
    nv = vec.shape[0]
    live = (store_ids >= 0) & (store_ids < nv)
    gathered = vec[store_ids.clamp(0, nv - 1).long()]
    return torch.where(live[..., None], gathered, store_payload)


# -----------------------------------------------------------------------------
# IndexRuntime: the host-level API over one topology
# -----------------------------------------------------------------------------


class IndexRuntime:
    """The five index operations bound to the 1-node topology.

    Inputs given as numpy arrays or tensors move to the runtime's device
    (the CUDA card unless `device="cpu"`).  A mesh is not ported yet.
    """

    def __init__(self, cfg: RuntimeConfig, mesh=None, *, device=None):
        if mesh is not None or cfg.n_nodes != 1:
            raise NotImplementedError(_MESH_NOT_PORTED)
        self.cfg = cfg
        self.device = resolve_device(device)

    def _put(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x).to(self.device, dtype)

    def search(self, hyperplanes, store: BucketStore, q, *, corpus=None,
               exclude=None, m: int | None = None):
        """(ids [nq, m], scores [nq, m], `StepStats`)."""
        m = self.cfg.m if m is None else m
        ex = None if exclude is None else self._put(exclude, torch.int32)
        payload = None if corpus is not None else store.payload
        return search_kernel(
            self.cfg, LOCAL, m, hyperplanes, store.ids, payload,
            self._put(q, torch.float32), corpus=corpus, exclude=ex)

    def contains(self, hyperplanes, store: BucketStore, q, targets):
        """(hits bool [nq], `StepStats`)."""
        return contains_kernel(
            self.cfg, LOCAL, hyperplanes, store.ids,
            self._put(q, torch.float32), self._put(targets, torch.int32))

    def insert(self, hyperplanes, store: BucketStore, vec, vid, now):
        return insert_kernel(
            self.cfg, LOCAL, hyperplanes, store,
            self._put(vec, torch.float32), self._put(vid, torch.int32), now)

    def expire(self, store: BucketStore, now, ttl: int) -> BucketStore:
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
        return dataclasses.replace(
            store,
            payload=payload_sync_kernel(LOCAL, store.ids, store.payload, vec),
            generation=store.generation + 1,
        )
