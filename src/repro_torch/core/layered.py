"""Layered-LSH for cosine similarity (paper Sec. 3.3 + 5.2).

Layered-LSH maps *buckets* to nodes with a second, bucket-level LSH so
that near buckets land on the same node.  Over cosine-LSH sketches the
second level is Hamming-LSH: pick k_node of the k_inner sketch bits at
random.  Sec. 5.2: that just *selects k_node of the k_inner
hyperplanes*, so Layered-LSH IS cosine-LSH with parameter k_node, and
its result set and costs equal LSH(k_node, L)'s.

Codes are int32 bit patterns, as everywhere in the port; the bit
selection comes from numpy's generator, so it equals the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.hashing import LshParams


@dataclasses.dataclass(frozen=True)
class LayeredParams:
    inner: LshParams      # cosine-LSH mapping vectors -> buckets (k_inner bits)
    k_node: int           # Hamming-LSH output bits (buckets -> nodes)
    seed: int = 17

    def __post_init__(self):
        if self.k_node > self.inner.k:
            raise ValueError("k_node must be <= inner.k")


def make_bit_selection(params: LayeredParams) -> np.ndarray:
    """The Hamming-LSH: k_node bit positions per table, [L, k_node]."""
    rng = np.random.default_rng(params.seed)
    return np.stack(
        [
            rng.choice(params.inner.k, size=params.k_node, replace=False)
            for _ in range(params.inner.L)
        ]
    ).astype(np.int32)


def node_codes(sketch_codes: torch.Tensor,
               selection: np.ndarray) -> torch.Tensor:
    """Map inner bucket codes int32 [.., L] to node ids int32 [.., L] by
    bit selection."""
    L, k_node = selection.shape
    sel = torch.as_tensor(np.asarray(selection), dtype=torch.int64,
                          device=sketch_codes.device)
    codes = sketch_codes.to(torch.int64) & 0xFFFFFFFF
    out = torch.zeros_like(codes)
    for j in range(k_node):
        out = out | (((codes >> sel[:, j]) & 1) << j)
    return hashing.to_int32_bits(out)


def equivalent_hyperplanes(params: LayeredParams,
                           hyperplanes_inner: torch.Tensor,
                           selection: np.ndarray) -> torch.Tensor:
    """The cosine-LSH(k_node) family that Layered-LSH is equivalent to:
    row-select the chosen hyperplanes.  [L, k_node, d]."""
    return torch.stack([
        hyperplanes_inner[l, torch.as_tensor(
            selection[l], dtype=torch.int64, device=hyperplanes_inner.device)]
        for l in range(params.inner.L)
    ])


def layered_node_of(x: torch.Tensor, params: LayeredParams,
                    hyperplanes_inner: torch.Tensor,
                    selection: np.ndarray) -> torch.Tensor:
    """Node id of vector x under Layered-LSH: g_ham(g_cos(x)).  [.., L]."""
    inner_codes = hashing.sketch_codes(x, hyperplanes_inner)
    return node_codes(inner_codes, selection)
