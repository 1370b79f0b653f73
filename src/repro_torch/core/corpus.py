"""Dense corpus + exact (oracle) similarity search.

`DenseCorpus` holds unit rows [n, d], so cosine == dot.  The sparse
layout of the JAX package (`SparseCorpus`) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class DenseCorpus:
    vectors: torch.Tensor  # [n, d], unit rows

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def d(self) -> int:
        return self.vectors.shape[1]

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows at idx (any shape), zeros for idx < 0."""
        rows = self.vectors[idx.clamp(min=0)]
        return rows.masked_fill_((idx < 0)[..., None], 0.0)

    def scores_against(self, q: torch.Tensor, idx: torch.Tensor):
        """Cosine of q [d] (unit) against rows at idx [...]."""
        return torch.einsum("...d,d->...", self.gather(idx), q)


def exact_topk_dense(corpus: DenseCorpus, queries: torch.Tensor, m: int,
                     chunk: int = 65536):
    """Oracle top-m over a dense corpus by brute force.

    Returns (scores f32 [nq, m], ids int64 [nq, m]) on the corpus's
    device, by descending score; equal scores keep the lower id first.
    """
    q = queries.to(corpus.vectors)
    nq = q.shape[0]
    best_s = torch.full((nq, m), float("-inf"), device=q.device)
    best_i = torch.full((nq, m), -1, dtype=torch.int64, device=q.device)
    for s0 in range(0, corpus.n, chunk):
        sc = q @ corpus.vectors[s0:s0 + chunk].T               # [nq, chunk]
        ids = torch.arange(s0, s0 + sc.shape[1], device=q.device)
        merged_s = torch.cat([best_s, sc], dim=1)
        merged_i = torch.cat([best_i, ids.expand(nq, -1)], dim=1)
        order = torch.sort(merged_s, dim=1, descending=True,
                           stable=True).indices[:, :m]
        best_s = merged_s.gather(1, order)
        best_i = merged_i.gather(1, order)
    return best_s, best_i
