"""Plain PyTorch oracles for every kernel of the JAX package.

Torch twins of `repro.kernels.ref`: they define the semantics, and the
CUDA kernels must match them bit for bit (integer outputs) or to float
tolerance (dot scores).  Codes and words are int32 bit patterns.
Top-k ties go to the lowest index.
"""

from __future__ import annotations

import torch

from repro_torch.core.hashing import popcount32


def simhash_ref(x: torch.Tensor, hyperplanes: torch.Tensor) -> torch.Tensor:
    """Packed sign-random-projection sketches.

    x [n, d], hyperplanes [L, k, d] -> int32 [n, L]; bit j of table l is
    (x . h_{l,j} >= 0)."""
    proj = torch.einsum("nd,lkd->nlk", x.float(), hyperplanes.float())
    k = hyperplanes.shape[1]
    w = torch.arange(k, device=x.device, dtype=torch.int64)
    return torch.sum((proj >= 0).to(torch.int64) << w, dim=-1).to(torch.int32)


def bucket_topk_ref(q: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor,
                    m: int):
    """Candidate scoring + top-m.

    q [b, d], cand [b, kc, d], valid bool [b, kc].  Returns (scores f32
    [b, m], idx int32 [b, m]): idx into kc, -1 where no valid candidate;
    descending score, ties -> lowest index."""
    scores = torch.einsum("bd,bkd->bk", q.float(), cand.float())
    cur = scores.masked_fill(~valid, float("-inf"))
    out_s, out_i = [], []
    for _ in range(m):
        # first occurrence of the max: the lowest index
        best = torch.argmax(cur, dim=1)
        s = cur.gather(1, best[:, None])[:, 0]
        out_s.append(s)
        out_i.append(torch.where(torch.isfinite(s), best, -1).to(torch.int32))
        cur = cur.scatter(1, best[:, None], float("-inf"))
    return torch.stack(out_s, dim=1), torch.stack(out_i, dim=1)


def hamming_ref(codes: torch.Tensor, cand_codes: torch.Tensor):
    """Popcount Hamming distances: codes [n], cand_codes [n, kc] ->
    int32 [n, kc]."""
    return popcount32(torch.bitwise_xor(codes[:, None], cand_codes))


def hamming_words_ref(codes: torch.Tensor, cand_codes: torch.Tensor):
    """Multi-word distances: codes [n, W], cand_codes [n, kc, W] ->
    int32 [n, kc], popcount summed over the word axis."""
    x = torch.bitwise_xor(codes[:, None, :], cand_codes)
    return popcount32(x).sum(dim=-1, dtype=torch.int32)


def _probe_valid(pw: torch.Tensor, n_probes: int) -> torch.Tensor:
    shifts = torch.arange(n_probes, device=pw.device, dtype=torch.int32)
    return ((pw[:, None] >> shifts) & 1) > 0


def fused_query_ref(
    ids_flat: torch.Tensor,  # int32 [T*NB, KC]
    pay_flat: torch.Tensor,  # [T*NB, KC, DW] f32 vectors or int32 words
    q: torch.Tensor,         # [r, DW]
    fb: torch.Tensor,        # int32 [r, P] flattened bucket row per probe
    meta: torch.Tensor,      # int32 [r, 2] (probe-validity word, exclude id)
    *,
    m: int,
    score: str = "dot",
):
    """Oracle of the fused query kernel: the explicit staged pipeline.

    Gathers the probed bucket rows ([r, P, KC] intermediates), masks
    candidates by probe-validity bit / EMPTY / exclude id, scores, and
    reduces through `core.scoring.dedupe_topk`, so the oracle IS the
    staged path's semantics.  Returns (ids int32 [r, m], scores f32)."""
    from repro_torch.core.scoring import dedupe_topk

    r, n_probes = fb.shape
    kc = ids_flat.shape[-1]
    fb = fb.long()
    pw, excl = meta[:, 0], meta[:, 1]
    cand = ids_flat[fb]                                     # [r, P, KC]
    pvalid = _probe_valid(pw, n_probes)
    cand = torch.where(pvalid[:, :, None] & (cand >= 0), cand, -1)
    cand = torch.where(cand == excl[:, None, None], -1, cand)
    pay = pay_flat[fb]                                      # [r, P, KC, DW]
    if score == "dot":
        s = torch.einsum("rd,rpkd->rpk", q.float(), pay.float())
    elif score == "hamming":
        s = -hamming_words_ref(
            q.repeat_interleave(n_probes, dim=0),
            pay.reshape(r * n_probes, kc, -1),
        ).reshape(r, n_probes, kc).float()
    else:
        raise ValueError(f"unknown score mode: {score!r}")
    flat_ids = cand.reshape(r, n_probes * kc)
    flat_s = torch.where(flat_ids >= 0, s.reshape(r, n_probes * kc),
                         float("-inf"))
    return dedupe_topk(flat_ids, flat_s, m)


def fused_contains_ref(
    ids_flat: torch.Tensor,  # int32 [T*NB, KC]
    fb: torch.Tensor,        # int32 [r, P]
    meta: torch.Tensor,      # int32 [r, 2] (probe-validity word, target id)
) -> torch.Tensor:
    """Oracle of `fused_contains`: int32 [r, 1] hit flags."""
    r, n_probes = fb.shape
    pw, tgt = meta[:, 0], meta[:, 1]
    cand = ids_flat[fb.long()]                              # [r, P, KC]
    pvalid = _probe_valid(pw, n_probes)
    hit = ((cand == tgt[:, None, None]) & pvalid[:, :, None]).any(dim=(1, 2))
    return hit.to(torch.int32)[:, None]
