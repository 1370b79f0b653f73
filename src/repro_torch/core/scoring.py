"""Shared bucket score + top-m stage (`LocalSimSearch`, Alg. 1 line 11).

Two interchangeable implementations:
  * reference — einsum (or packed hamming) + `dedupe_topk`;
  * kernel    — candidates sorted by id (so the kernel's "lowest index"
    tie-break is the reference's "lowest id"), repeats masked invalid,
    and the `bucket_topk` kernel scores and selects the top m; under
    `score="hamming"` the `hamming_words` kernel scores and
    `dedupe_topk` selects.

Ties: `torch.topk` does not order equal values by position, and
`torch.argsort` is unstable by default, while the reference relies on
both (`lax.top_k` takes the lowest position; `jnp.argsort` is stable).
So every sort here is `stable=True`, and top-m is a stable descending
sort cut to m.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def _sorted_dup_mask(ids: torch.Tensor):
    """Sort candidate ids ascending (stable); mark repeats of the previous
    entry.  Returns (order, ids_sorted, dup_mask)."""
    order = torch.argsort(ids, dim=-1, stable=True)
    ids_s = torch.gather(ids, -1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[..., 1:] = ids_s[..., 1:] == ids_s[..., :-1]
    return order, ids_s, dup


def dedupe_topk(ids: torch.Tensor, scores: torch.Tensor, m: int):
    """Top-m by score with duplicate ids collapsed to their first
    occurrence's score.

    ids/scores: [..., K]; invalid candidates are id -1 / score -inf.
    m may exceed K: the tail pads with id -1 / score -inf.  Equal scores
    come out lowest id first.  Returns (ids int32, scores f32) [..., m].
    """
    order, ids_s, dup = _sorted_dup_mask(ids)
    sc_s = torch.gather(scores, -1, order)
    sc_s = sc_s.masked_fill(dup | (ids_s < 0), NEG_INF)
    k = ids.shape[-1]
    if m > k:
        pad = ids.shape[:-1] + (m - k,)
        ids_s = torch.cat([ids_s, ids_s.new_full(pad, -1)], dim=-1)
        sc_s = torch.cat([sc_s, sc_s.new_full(pad, NEG_INF)], dim=-1)
    top_s, top_pos = torch.sort(sc_s, dim=-1, descending=True, stable=True)
    top_s, top_pos = top_s[..., :m], top_pos[..., :m]
    top_i = torch.gather(ids_s, -1, top_pos)
    live = torch.isfinite(top_s)
    top_i = torch.where(live, top_i, -1).to(torch.int32)
    top_s = top_s.masked_fill(~live, NEG_INF)
    return top_i, top_s


def score_topk(
    q: torch.Tensor,          # [b, d] unit queries (or [b, W] packed words)
    cand_ids: torch.Tensor,   # int32 [b, K] candidate ids, -1 = invalid
    cand_vecs: torch.Tensor,  # f32 [b, K, d] payloads (or int32 [b, K, W])
    m: int,
    *,
    use_kernels: bool = False,
    score: str = "dot",
):
    """Score candidates against their query and keep the best m distinct ids.

    `score="dot"` takes f32 payload vectors; `score="hamming"` takes
    packed sketch words on both sides and scores by negated popcount
    distance (the `hamming_words` kernel with `use_kernels`).  Returns
    (ids int32 [b, m], scores f32 [b, m]).
    """
    if score == "hamming":
        if use_kernels:
            from repro_torch.kernels import ops

            h = ops.hamming(q.contiguous(), cand_vecs.contiguous())
        else:
            from repro_torch.core.packed import hamming_words

            h = hamming_words(q[:, None, :], cand_vecs)
        scores = torch.where(cand_ids >= 0, -h.float(), NEG_INF)
        return dedupe_topk(cand_ids, scores, m)
    if not use_kernels:
        scores = torch.einsum("bkd,bd->bk", cand_vecs, q)
        scores = torch.where(cand_ids >= 0, scores, NEG_INF)
        return dedupe_topk(cand_ids, scores, m)
    return _score_topk_kernel(q, cand_ids, cand_vecs, m)


def _score_topk_kernel(q, cand_ids, cand_vecs, m):
    from repro_torch.kernels import ops

    order, ids_s, dup = _sorted_dup_mask(cand_ids)               # [b, K]
    vecs_s = torch.gather(
        cand_vecs, 1, order[..., None].expand(-1, -1, cand_vecs.shape[-1]))
    valid = (ids_s >= 0) & ~dup
    scores, idx = ops.bucket_topk(q, vecs_s, valid, m)
    top_i = torch.gather(ids_s, -1, idx.clamp(min=0).to(torch.int64))
    return torch.where(idx >= 0, top_i, -1).to(torch.int32), scores
