"""NearBucket-LSH search, written plainly from its definition.

Given the corpus (row i is user i's sparse unit vector: its nonzero
columns `ids` [N, W], -1 padding, and values `vals` [N, W] over `d`
columns), the hyperplanes `h` [L, k, d], the bucket capacity C and the
CAN overlay's node count, a query by user u returns the m users with the
highest score among its candidates, u itself left out (or, for a search
step that does not exclude it, kept as one of them).  The candidates
are the users that, in some table t, sit in a bucket the query probes
and were not evicted from it:

  * a user's code in table t has bit j set where its projection on
    h[t, j] is >= 0 (computed here in float64);
  * a bucket keeps the last C users that hash to it, in id order (ids
    are the order in which users announce themselves);
  * the cnb variant probes, in each table, the query's own bucket and
    all k buckets one bit away.  Flipping one of the low k - log2(nodes)
    bits stays in the owner's zone; flipping one of the high bits
    reaches the neighbour whose zone differs in that bit, whose rows the
    owner's CNB cache holds.  The cache is filled from the store in
    set-up and the store does not change afterwards, so a cached row is
    the neighbour's row.

Scores: `dot` is the inner product of the two users' vectors (their
cosine); `hamming` is minus the number of differing bits over all L * k
code bits.

Nothing here imports the program or takes anything it made: the codes,
the store and the zones are worked out again from the corpus and `h`.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def popcount_table(bits: int, device) -> torch.Tensor:
    """uint8 [2**bits]: the number of set bits of each value."""
    v = torch.arange(1 << bits, device=device)
    out = torch.zeros_like(v)
    for j in range(bits):
        out += (v >> j) & 1
    return out.to(torch.uint8)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bfloat16 (to nearest, ties to even)."""
    return x.float().to(torch.bfloat16).float()


class Reference:
    """The reference's own world: codes, evictions, zones; and the exact
    top-m of any batch of query users."""

    def __init__(self, ids: torch.Tensor, vals: torch.Tensor, d: int,
                 h: torch.Tensor, *, capacity: int, nodes: int, score: str,
                 block: int = 1 << 15):
        if score not in ("dot", "hamming"):
            raise ValueError(f"unknown score {score!r}")
        L, k, _ = h.shape
        if nodes < 1 or nodes & (nodes - 1) or nodes > 1 << k:
            raise ValueError(f"nodes must be a power of two <= 2**k: {nodes}")
        self.ids, self.vals, self.d = ids.long(), vals, d
        self.L, self.k, self.C, self.score = L, k, capacity, score
        self.local_bits = k - (nodes.bit_length() - 1)
        dev = self.device = ids.device
        n = ids.shape[0]
        hm = h.double().reshape(L * k, d).T                 # [d, L*k]
        weights = (1 << torch.arange(k, device=dev)).repeat(L).reshape(L, k)
        codes = torch.empty((n, L), dtype=torch.int32, device=dev)
        for s in range(0, n, block):
            i = self.ids[s:s + block]
            v = vals[s:s + block].double().masked_fill(i < 0, 0.0)
            proj = (hm[i.clamp(min=0)] * v[..., None]).sum(1)
            bits = (proj >= 0).reshape(-1, L, k)
            codes[s:s + block] = (bits * weights).sum(-1).to(torch.int32)
        self.codes = codes
        # keep the last C ids of each bucket
        nb = 1 << k
        kept = torch.empty((n, L), dtype=torch.bool, device=dev)
        load = torch.empty((L, nb), dtype=torch.int64, device=dev)
        users = torch.arange(n, device=dev)
        for t in range(L):
            c = codes[:, t].long()
            order = torch.argsort(c * n + users)
            cs = c[order]
            counts = torch.bincount(c, minlength=nb)
            start = torch.cumsum(counts, 0) - counts
            from_end = counts[cs] - 1 - (users - start[cs])
            kept[order, t] = from_end < capacity
            load[t] = counts
        self.kept, self.load = kept, load
        self.pop = popcount_table(k, dev)

    def dense(self, users: torch.Tensor, dtype=torch.float64):
        """[S, d] dense rows of `users`."""
        i, v = self.ids[users.long()], self.vals[users.long()]
        out = torch.zeros((users.shape[0], self.d), dtype=dtype,
                          device=self.device)
        # a row's columns differ, and padding adds 0 into column 0
        out.scatter_add_(1, i.clamp(min=0),
                         v.to(dtype).masked_fill(i < 0, 0))
        return out

    def _dots(self, q: torch.Tensor, row: torch.Tensor,
              ids: torch.Tensor, bf16: bool = False) -> torch.Tensor:
        """Score of id `ids[p]` for the query whose dense row is
        q[row[p]]: float64, or, with `bf16`, from bfloat16-rounded
        operands summed in float32."""
        i = self.ids[ids]
        v = self.vals[ids].masked_fill(i < 0, 0.0)
        g = q[row[:, None], i.clamp(min=0)]
        if bf16:
            return (round_bf16(g) * round_bf16(v)).sum(-1).double()
        return (g * v.double()).sum(-1)

    def _probed(self, xor: torch.Tensor, node_probes: bool) -> torch.Tensor:
        """Is a bucket whose code differs from the query's by `xor`
        probed?  The exact bucket, every one-bit neighbour in the zone,
        and (with `node_probes`) every one-bit neighbour in the cache."""
        near = self.pop[xor.long()] <= 1
        if not node_probes:
            near &= xor < (1 << self.local_bits)
        return near

    def is_candidate(self, users: torch.Tensor, ids: torch.Tensor,
                     node_probes: bool = True,
                     with_self: bool = False) -> torch.Tensor:
        """bool [S, r]: is ids[s, i] a candidate of user users[s]?"""
        safe = ids.clamp(min=0).long()
        xor = self.codes[users.long()][:, None, :] ^ self.codes[safe]
        hit = (self._probed(xor, node_probes) & self.kept[safe]).any(-1)
        if not with_self:
            hit &= ids != users[:, None]
        return hit & (ids >= 0)

    def pair_scores(self, users: torch.Tensor, ids: torch.Tensor,
                    block: int = 512) -> torch.Tensor:
        """float64 [S, r]: the score of each (user, id) pair."""
        safe = ids.clamp(min=0).long()
        u = users.long()
        if self.score == "hamming":
            xor = self.codes[u][:, None, :] ^ self.codes[safe]
            return -self.pop[xor.long()].sum(-1, dtype=torch.int64).double()
        out = []
        for s in range(0, u.shape[0], block):
            q = self.dense(u[s:s + block])
            ids_b = safe[s:s + block]
            row = torch.arange(ids_b.shape[0], device=self.device)
            row = row[:, None].expand_as(ids_b).reshape(-1)
            out.append(self._dots(q, row, ids_b.reshape(-1))
                       .reshape(ids_b.shape))
        return torch.cat(out)

    def top(self, users: torch.Tensor, m: int, *, block: int = 128,
            precision: str = "float64", node_probes: bool = True,
            with_self: bool = False):
        """(ids int64 [S, m], scores float64 [S, m], n_candidates [S]):
        the exact top m of each query user, by brute force over the whole
        corpus, the user left out (kept with `with_self`, as a search
        step that does not exclude it answers).  -1 / -inf fill where a
        user has fewer candidates.

        `precision="bfloat16"` scores dot products from bfloat16-rounded
        operands summed in float32 (the control of a float32 cell);
        `node_probes=False` leaves out the buckets that the CNB cache
        serves (the control of the guarantee that no probe drops)."""
        out_i, out_s, out_n = [], [], []
        n = self.ids.shape[0]
        rows = torch.arange(n, device=self.device)
        for s in range(0, users.shape[0], block):
            u = users[s:s + block].long()
            cand = torch.zeros((n, u.shape[0]), dtype=torch.bool,
                               device=self.device)
            ham = None
            cu = self.codes[u]
            for t in range(self.L):
                xor = self.codes[:, t, None] ^ cu[None, :, t]
                cand |= self._probed(xor, node_probes) & self.kept[:, t, None]
                if self.score == "hamming":
                    d = self.pop[xor.long()].to(torch.int16)
                    ham = d if ham is None else ham + d
            if not with_self:
                cand &= rows[:, None] != u[None, :]
            if self.score == "hamming":
                sc = (-ham.double()).masked_fill(~cand, NEG_INF)
            else:
                who, col = torch.nonzero(cand, as_tuple=True)
                sc = torch.full((n, u.shape[0]), NEG_INF, dtype=torch.float64,
                                device=self.device)
                sc[who, col] = self._dots(self.dense(u), col, who,
                                          bf16=precision == "bfloat16")
            kk = min(m, n)
            top_s, top_i = torch.topk(sc, kk, dim=0)
            top_i = torch.where(torch.isfinite(top_s), top_i, -1)
            out_i.append(top_i.T)
            out_s.append(top_s.T)
            out_n.append(cand.sum(0))
        ids, scores = torch.cat(out_i), torch.cat(out_s)
        if ids.shape[1] < m:
            pad = m - ids.shape[1]
            ids = torch.cat([ids, ids.new_full((ids.shape[0], pad), -1)], 1)
            scores = torch.cat(
                [scores, scores.new_full((ids.shape[0], pad), NEG_INF)], 1)
        return ids, scores, torch.cat(out_n)
