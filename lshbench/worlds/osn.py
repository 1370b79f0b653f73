"""The world of an OSN configuration: users' sparse interest vectors,
made on the device from the seed, and the program built on them.

The corpus follows the repository's model of the paper's social-network
statistics (`repro_torch.data.osn.generate`, frozen here and drawn in
bulk on the card instead of user by user on the host):

  * communities have Zipf popularity (exponent `community_zipf`); each
    owns a pool of interests, `max(3 * popularity * interests, 8)` of
    them, drawn without repeats;
  * a user joins `communities_per_user` communities drawn by popularity
    and draws Poisson(`interests_per_user`) interests, clipped to
    [2, nnz_max], with repeats, from their pools' concatenation; a
    share `global_interest_share` adds one interest drawn uniformly;
  * a share `twin_fraction` of users copies another user's interests,
    drops one of them (with probability 0.7, where more than 3) and adds
    a uniform one (with probability 0.5);
  * interest I weighs ln(N / (N_I + 1)) + 1, N_I its users (the paper's
    inverse user frequency); a row keeps its `nnz_max` heaviest
    interests and is scaled to unit length.

A user whose float64 projection on some hyperplane lies within `MARGIN`
of 0 is drawn again (from the first draw's weights), so that no bucket
depends on the order of a float32 sum.

The program gets the corpus as its `SparseCorpus` and derives the rest
itself: codes (`sketch_codes_batched`), the store (`build_store_host`),
packed words, zones and the CNB cache.  Queries reach it as dense rows:
on the host, the form its `RuntimeBackend` takes (`QueryRows`), or on
the device, the form its search step takes (`DeviceRows`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lshbench.reference.lsh import Reference

MARGIN = 1e-4


@dataclasses.dataclass
class Inputs:
    ids: torch.Tensor     # int32 [N, W]: interest ids, -1 padding
    vals: torch.Tensor    # float32 [N, W]: unit rows, 0 padding
    d: int                # interests
    h: torch.Tensor       # float32 [L, k, d] hyperplanes

    @property
    def n(self) -> int:
        return self.ids.shape[0]


class _Draw:
    """The generator's state: community popularity and interest pools."""

    def __init__(self, c: dict, g: torch.Generator, device):
        self.c, self.g, self.dev = c, g, device
        d, nc = int(c["interests"]), int(c["communities"])
        pop = 1.0 / torch.arange(1, nc + 1, dtype=torch.float64,
                                 device=device) ** float(c["community_zipf"])
        self.pop = pop / pop.sum()
        self.pool = (self.pop * d * 3).long().clamp(min=8, max=d)
        keys = torch.rand((nc, d), generator=g, device=device)
        self.order = keys.argsort(dim=1)[:, :int(self.pool.max())]
        self.d = d

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.g, device=self.dev)

    def _randint(self, hi: int, n: int):
        return torch.randint(0, hi, (n,), generator=self.g, device=self.dev)

    def rows(self, n: int) -> torch.Tensor:
        """int64 [n, nnz_max + 2] fresh users' interests, sorted, unique,
        `d` padding (one spare column stays padding)."""
        c, d = self.c, self.d
        nnz, cpu = int(c["nnz_max"]), int(c["communities_per_user"])
        comms = torch.multinomial(self.pop, n * cpu, replacement=True,
                                  generator=self.g).reshape(n, cpu)
        sizes = self.pool[comms]
        cum = sizes.cumsum(1)
        total = cum[:, -1]
        rate = torch.full((n,), float(c["interests_per_user"]),
                          device=self.dev)
        cnt = torch.poisson(rate, generator=self.g).long().clamp(2, nnz)
        cnt = torch.minimum(cnt, total)
        r = (self._rand(n, nnz) * total[:, None]).long()
        r = torch.minimum(r, total[:, None] - 1)
        which = (r[..., None] >= cum[:, None, :]).sum(-1)
        off = r - (cum - sizes).gather(1, which)
        ids = self.order[comms.gather(1, which), off]
        ids = torch.where(torch.arange(nnz, device=self.dev) < cnt[:, None],
                          ids, d)
        extra = torch.where(self._rand(n) < float(c["global_interest_share"]),
                            self._randint(d, n), d)
        pad = torch.full((n, 1), d, device=self.dev)
        return unique_rows(torch.cat([ids, extra[:, None], pad], 1), d)

    def twins(self, ids: torch.Tensor) -> torch.Tensor:
        n, d = ids.shape[0], self.d
        nt = int(float(self.c["twin_fraction"]) * n)
        twin = torch.randperm(n, generator=self.g, device=self.dev)[:nt]
        base = self._randint(n, nt)
        keep = twin != base
        twin, base = twin[keep], base[keep]
        rows = ids[base].clone()
        count = (rows < d).sum(1)
        drop = (count > 3) & (self._rand(rows.shape[0]) < 0.7)
        at = (self._rand(rows.shape[0]) * count).long()
        hit = drop[:, None] & (torch.arange(rows.shape[1], device=self.dev)
                               == at[:, None])
        rows = rows.masked_fill(hit, d)
        add = self._rand(rows.shape[0]) < 0.5
        rows[:, -1] = torch.where(add, self._randint(d, rows.shape[0]), d)
        out = ids.clone()
        out[twin] = unique_rows(rows, d)
        return out


def unique_rows(ids: torch.Tensor, pad: int) -> torch.Tensor:
    """Each row sorted with repeats turned into `pad` (sorted last)."""
    s = ids.sort(dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    return s.masked_fill(dup, pad).sort(dim=1).values


def weigh(ids: torch.Tensor, w: torch.Tensor, d: int, nnz: int):
    """(int32 ids [n, nnz], float32 unit vals [n, nnz]): each row's
    `nnz` heaviest interests, -1 / 0 padding."""
    wt = torch.where(ids < d, w[ids.clamp(max=d - 1)], -1.0)
    wt, order = wt.sort(dim=1, descending=True)
    ids = ids.gather(1, order)[:, :nnz]
    wt = wt[:, :nnz].clamp(min=0.0)
    vals = wt / wt.norm(dim=1, keepdim=True).clamp(min=1e-12)
    return torch.where(ids < d, ids, -1).to(torch.int32), vals


def near_plane(ids: torch.Tensor, vals: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """bool [n]: does a row's float64 projection on some hyperplane lie
    within MARGIN of 0?"""
    hm = h.double().reshape(-1, h.shape[-1]).T            # [d, L*k]
    out = []
    for s in range(0, ids.shape[0], 1 << 15):
        i = ids[s:s + (1 << 15)].long()
        v = vals[s:s + (1 << 15)].double()
        proj = (hm[i.clamp(min=0)] * v[..., None]).sum(1)
        out.append(proj.abs().amin(1) < MARGIN)
    return torch.cat(out)


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    c = cfg["corpus"]
    n, d, nnz = int(cfg["users"]), int(c["interests"]), int(c["nnz_max"])
    L, k = int(cfg["tables"]), int(cfg["k"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    h = torch.randn((L, k, d), generator=g, device=device)
    draw = _Draw(c, g, device)
    raw = draw.twins(draw.rows(n))
    freq = torch.bincount(raw[raw < d], minlength=d).double()
    w = (torch.log(n / (freq + 1.0)) + 1.0).float()
    ids, vals = weigh(raw, w, d, nnz)
    del raw
    todo = torch.nonzero(near_plane(ids, vals, h)).flatten()
    for _ in range(64):
        if todo.numel() == 0:
            return Inputs(ids, vals, d, h)
        ids[todo], vals[todo] = weigh(draw.rows(todo.numel()), w, d, nnz)
        todo = todo[near_plane(ids[todo], vals[todo], h)]
    raise RuntimeError("could not draw users clear of every hyperplane")


def reference(cfg: dict, inp: Inputs) -> Reference:
    return Reference(inp.ids, inp.vals, inp.d, inp.h,
                     capacity=int(cfg["bucket_capacity"]),
                     nodes=int(cfg["nodes"]), score=cfg["score"])


class QueryRows:
    """Dense float32 host rows of query users, the `RuntimeBackend`'s
    input, written into one buffer a batch size (the backend copies a
    batch before `dispatch_async` returns)."""

    def __init__(self, inp: Inputs):
        self.ids = inp.ids.cpu().numpy().astype(np.int64)
        self.vals = inp.vals.cpu().numpy()
        self.d = inp.d
        self._buf = {}

    def __call__(self, users: np.ndarray) -> np.ndarray:
        b = len(users)
        buf, last = self._buf.get(b, (None, None))
        if buf is None:
            buf = np.zeros((b, self.d), np.float32)
        else:
            buf[last] = 0.0
        ids = self.ids[users]
        rows = np.broadcast_to(np.arange(b)[:, None], ids.shape)
        live = ids >= 0
        where = (rows[live], ids[live])
        buf[where] = self.vals[users][live]
        self._buf[b] = (buf, where)
        return buf


class DeviceRows:
    """Dense float32 rows of query users on the device, written into one
    buffer a batch size: the input of the program's search step where a
    batch's users are already on the card."""

    def __init__(self, inp: Inputs):
        self.ids, self.vals, self.d = inp.ids.long(), inp.vals, inp.d
        self._buf = {}

    def __call__(self, users: torch.Tensor) -> torch.Tensor:
        b = users.shape[0]
        buf = self._buf.get(b)
        if buf is None:
            buf = self._buf[b] = torch.empty((b, self.d), dtype=torch.float32,
                                             device=self.ids.device)
        i = self.ids[users]
        buf.zero_()
        # a row's columns differ, and padding adds 0 into column 0
        return buf.scatter_add_(1, i.clamp(min=0),
                                self.vals[users].masked_fill(i < 0, 0.0))


@dataclasses.dataclass
class System:
    """The program built on a world: its runtime and the state its
    search step takes."""

    runtime: object             # repro_torch IndexRuntime
    hyperplanes: torch.Tensor
    store: object               # BucketStore (zoned on a mesh)
    cache: tuple | None         # the CNB cache (mesh)
    corpus: object | None       # SparseCorpus scored by id (one node)

    def backend(self):
        """The program's `RuntimeBackend` over this system."""
        from repro_torch.serve import RuntimeBackend

        return RuntimeBackend(self.runtime, hyperplanes=self.hyperplanes,
                              store=self.store, cache=self.cache,
                              corpus=self.corpus)

    def step(self):
        """`fn(q [b, d] on the device) -> (ids, scores, StepStats)`: the
        mesh's search step (`IndexRuntime.search_step_fn`), its
        `cfg.m` results a row, the user's own id not excluded."""
        fn = self.runtime.search_step_fn()
        args = (self.hyperplanes, self.store.ids, self.store.payload) \
            + tuple(self.cache or ())
        return lambda q: fn(*args, q)


def build_system(cfg: dict, inp: Inputs, device) -> System:
    """The program's index over the configuration: `score` `hamming`
    holds packed sketch words in the bucket slots (on a mesh: zones by
    `shard_store`, the CNB cache by `refresh_cache`); `dot` scores the
    id-keyed `SparseCorpus` on one node."""
    from repro_torch.core import packed
    from repro_torch.core.corpus import SparseCorpus
    from repro_torch.core.hashing import LshParams, sketch_codes_batched
    from repro_torch.core.runtime import IndexRuntime, RuntimeConfig
    from repro_torch.core.store import build_store_host
    from repro_torch.launch.mesh import make_zone_mesh

    L, k, d = inp.h.shape
    nodes, m = int(cfg["nodes"]), int(cfg["m"])
    corpus = SparseCorpus(inp.ids, inp.vals, d=d)
    codes = sketch_codes_batched(corpus, inp.h)
    hamming = cfg["score"] == "hamming"
    store = build_store_host(
        codes, 1 << k, int(cfg["bucket_capacity"]),
        payload=packed.pack_codes(codes, k) if hamming else None,
        device=device)
    del codes
    rcfg = RuntimeConfig(
        params=LshParams(d=d, k=k, L=L), variant=cfg["variant"],
        # a mesh step bakes m and leaves the user's own id in: one result
        # of headroom (the frontend's convention)
        m=m + 1 if nodes > 1 else m, n_nodes=nodes,
        routing=cfg.get("routing", "alltoall"),
        cap_factor=float(cfg.get("cap_factor", 2.0)),
        num_probes=cfg.get("num_probes"), use_kernels=True,
        fused=cfg.get("fused", "auto"), score=cfg["score"])
    if nodes > 1:
        rt = IndexRuntime(rcfg, mesh=make_zone_mesh(nodes, device=device))
        store = rt.shard_store(store)
        return System(rt, inp.h, store, rt.refresh_cache(store), None)
    return System(IndexRuntime(rcfg, device=device), inp.h, store, None,
                  None if hamming else corpus)
