"""Carry state across from the JAX package.

The port's counterpart of loading weights: hyperplanes, a bucket store
and a dense or sparse corpus built by `repro` (JAX arrays, or numpy
arrays in the same layout) become the port's objects, so both packages
compute on the same state.  Nothing here imports JAX: `np.asarray` reads a JAX array
without it.  uint32 codes and words become int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.corpus import DenseCorpus, SparseCorpus
from repro_torch.core.store import BucketStore


def _tensor(x, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def hyperplanes_from(h, *, device=None) -> torch.Tensor:
    """Hyperplanes [L, k, d] -> f32 tensor."""
    return _tensor(h, resolve_device(device)).float()


def store_from(store, *, device=None) -> BucketStore:
    """A store with attributes ids, timestamps, write_ptr, payload (f32
    vectors, uint32 words or None) and generation -> `BucketStore`."""
    dev = resolve_device(device)
    payload = None if store.payload is None else _tensor(store.payload, dev)
    gen = getattr(store, "generation", 0)
    return BucketStore(
        ids=_tensor(store.ids, dev).to(torch.int32),
        timestamps=_tensor(store.timestamps, dev).to(torch.int32),
        write_ptr=_tensor(store.write_ptr, dev).to(torch.int32),
        payload=payload,
        generation=torch.tensor(int(np.asarray(gen)), dtype=torch.int32,
                                device=dev),
    )


def corpus_from(vectors, *, device=None) -> DenseCorpus:
    """Unit rows [n, d] (or a DenseCorpus-like with `.vectors`) ->
    `DenseCorpus`."""
    vectors = getattr(vectors, "vectors", vectors)
    return DenseCorpus(_tensor(vectors, resolve_device(device)).float())


def sparse_corpus_from(c=None, *, nnz_ids=None, nnz_vals=None, d=None,
                       device=None) -> SparseCorpus:
    """A SparseCorpus-like `c` (attributes nnz_ids, nnz_vals, d), or numpy
    `nnz_ids` int32 / `nnz_vals` f32 [n, nnz_max] and `d` ->
    `SparseCorpus`."""
    if c is not None:
        nnz_ids, nnz_vals, d = c.nnz_ids, c.nnz_vals, c.d
    dev = resolve_device(device)
    return SparseCorpus(_tensor(nnz_ids, dev).to(torch.int32),
                        _tensor(nnz_vals, dev).float(), d=int(d))
