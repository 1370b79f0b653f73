"""Corpus representations + exact (oracle) similarity search.

Two layouts, both unit-normalized so cosine == dot:
  * DenseCorpus : [n, d] float rows — model-produced embeddings.
  * SparseCorpus: padded rows (ids [n, nnz_max] int32 with -1 padding,
    vals [n, nnz_max] f32) — the paper's sparse OSN interest vectors
    (d in the tens of thousands, tens of interests a user).

The oracles (`exact_topk_dense`, `exact_topk_sparse`) are the ground
truth for recall@m / NCS@m; they run chunked on the corpus's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


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


@dataclasses.dataclass
class SparseCorpus:
    nnz_ids: torch.Tensor   # int32 [n, nnz_max], -1 padding
    nnz_vals: torch.Tensor  # f32   [n, nnz_max], zero padding; unit rows
    d: int

    @property
    def n(self) -> int:
        return self.nnz_ids.shape[0]

    def densify(self, idx: torch.Tensor) -> torch.Tensor:
        """Dense f32 [..., d] rows at idx (zeros for idx < 0), on the
        corpus's device: the input of the sketch."""
        idx = torch.as_tensor(idx, device=self.nnz_ids.device)
        safe = idx.clamp(min=0).long()
        ids = self.nnz_ids[safe]
        vals = self.nnz_vals[safe].masked_fill((idx < 0)[..., None], 0.0)
        out = torch.zeros(idx.shape + (self.d,), dtype=torch.float32,
                          device=ids.device)
        return _scatter_dense(out, ids, vals)

    def scores_against_dense(self, q_dense: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
        """Cosine of dense unit queries against the sparse rows at idx.

        q [d] with idx [...], or q [r, d] with idx [r, ...]: row i of q
        scores the rows idx[i] (the reference's `vmap` over rows).
        Entries with idx < 0 score 0."""
        safe = idx.clamp(min=0).long()
        ids = self.nnz_ids[safe]                           # [..., nnz]
        vals = self.nnz_vals[safe]
        cols = ids.clamp(min=0).long()
        if q_dense.dim() == 1:
            gathered = q_dense[cols]
        else:
            r = q_dense.shape[0]
            gathered = q_dense.gather(1, cols.reshape(r, -1)).reshape(
                cols.shape)
        gathered = gathered.masked_fill(ids < 0, 0.0)
        s = (gathered * vals).sum(dim=-1)
        return s.masked_fill(idx < 0, 0.0)


def _scatter_dense(out: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor):
    """Add vals [..., nnz] into out [..., d] at columns ids; padding lanes
    (-1) add 0.0 into column 0.  Ids are unique within a row, so each
    column receives at most one nonzero value and the sum is exact in
    any order."""
    valid = ids >= 0
    flat_out = out.reshape(-1, out.shape[-1])
    flat_ids = ids.clamp(min=0).long().reshape(flat_out.shape[0], -1)
    flat_vals = vals.masked_fill(~valid, 0.0).reshape(flat_out.shape[0], -1)
    flat_out.scatter_add_(1, flat_ids, flat_vals.to(flat_out.dtype))
    return flat_out.reshape(out.shape)


def normalize_rows_np(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, eps)


def sparse_from_lists(
    interest_ids: list[np.ndarray],
    interest_vals: list[np.ndarray],
    d: int,
    nnz_max: int,
    *,
    device=None,
) -> SparseCorpus:
    """Pack ragged per-user (ids, weights) lists; rows are L2-normalized."""
    n = len(interest_ids)
    ids = np.full((n, nnz_max), -1, np.int32)
    vals = np.zeros((n, nnz_max), np.float32)
    for i, (ii, vv) in enumerate(zip(interest_ids, interest_vals)):
        m = min(len(ii), nnz_max)
        # keep the heaviest interests if truncating
        order = np.argsort(-np.asarray(vv))[:m]
        ids[i, :m] = np.asarray(ii)[order]
        norm = np.linalg.norm(np.asarray(vv)[order])
        vals[i, :m] = np.asarray(vv)[order] / max(norm, 1e-12)
    dev = resolve_device(device)
    return SparseCorpus(torch.from_numpy(ids).to(dev),
                        torch.from_numpy(vals).to(dev), d=d)


def sparse_densify_host(c: SparseCorpus, rows: np.ndarray) -> np.ndarray:
    """Host-side dense rows (numpy f32 [len(rows), d])."""
    rows_t = torch.as_tensor(np.asarray(rows), device=c.nnz_ids.device)
    ids = c.nnz_ids[rows_t].cpu().numpy()
    vals = c.nnz_vals[rows_t].cpu().numpy()
    out = np.zeros((len(rows), c.d), np.float32)
    r = np.arange(len(rows))[:, None]
    valid = ids >= 0
    np.add.at(out, (np.broadcast_to(r, ids.shape)[valid], ids[valid]),
              vals[valid])
    return out


def _merge_topk(best_s, best_i, sc, s0, m):
    """Merge a chunk's scores [nq, c] (ids s0..s0+c) into the running
    top-m; equal scores keep the earlier, lower id first."""
    nq = sc.shape[0]
    ids = torch.arange(s0, s0 + sc.shape[1], device=sc.device)
    merged_s = torch.cat([best_s, sc], dim=1)
    merged_i = torch.cat([best_i, ids.expand(nq, -1)], dim=1)
    order = torch.sort(merged_s, dim=1, descending=True,
                       stable=True).indices[:, :m]
    return merged_s.gather(1, order), merged_i.gather(1, order)


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
        best_s, best_i = _merge_topk(best_s, best_i, sc, s0, m)
    return best_s, best_i


def exact_topk_sparse(corpus: SparseCorpus, q_dense, m: int,
                      chunk: int = 16384):
    """Oracle top-m over a sparse corpus given dense unit queries [nq, d].

    Scores each chunk of corpus rows by gathering the queries at the
    rows' interest ids ([nq, chunk, nnz_max] at once: callers keep nq
    small, e.g. 256).  Returns (scores f32 [nq, m], ids int64 [nq, m])
    on the corpus's device, by descending score; equal scores keep the
    lower id first.
    """
    dev = corpus.nnz_ids.device
    q = torch.as_tensor(q_dense).to(dev, torch.float32)
    nq = q.shape[0]
    best_s = torch.full((nq, m), float("-inf"), device=dev)
    best_i = torch.full((nq, m), -1, dtype=torch.int64, device=dev)
    for s0 in range(0, corpus.n, chunk):
        ids = corpus.nnz_ids[s0:s0 + chunk]
        vals = corpus.nnz_vals[s0:s0 + chunk]
        g = q[:, ids.clamp(min=0).long()]                   # [nq, c, nnz]
        g = g.masked_fill(ids < 0, 0.0)
        sc = torch.einsum("qcn,cn->qc", g, vals)
        best_s, best_i = _merge_topk(best_s, best_i, sc, s0, m)
    return best_s, best_i
