"""CAN overlay geometry: bucket <-> node coordinates (paper Sec. 4.1).

With n nodes, each owns a contiguous sketch-prefix zone of 2^(k - a)
buckets, a = log2(n): the high a bits of a code select the node, the low
k - a bits the bucket within it.  This slice needs only the coordinates
the 1-node planner and runtime use; neighbors, replicas and membership
arrive with the mesh runtime.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _log2_exact(n: int) -> int:
    a = int(n).bit_length() - 1
    if (1 << a) != n:
        raise ValueError(f"expected a power of two, got {n}")
    return a


@dataclasses.dataclass(frozen=True)
class CanTopology:
    """Geometry of the bucket space over the node space."""

    k: int        # sketch bits; 2^k buckets per table
    n_nodes: int  # nodes owning bucket shards (power of two)

    def __post_init__(self):
        a = _log2_exact(self.n_nodes)
        if a > self.k:
            raise ValueError(f"n_nodes=2^{a} exceeds 2^k={1 << self.k} buckets")

    @property
    def node_bits(self) -> int:
        return _log2_exact(self.n_nodes)

    @property
    def local_bits(self) -> int:
        return self.k - self.node_bits

    @property
    def buckets_per_node(self) -> int:
        return 1 << self.local_bits

    def node_of(self, codes: torch.Tensor) -> torch.Tensor:
        """Owning node id of each (int32, k <= 30 bit) bucket code."""
        return codes.to(torch.int32) >> self.local_bits

    def node_of_np(self, codes) -> np.ndarray:
        """Host (numpy) twin of `node_of`."""
        return np.asarray(codes, dtype=np.uint32) >> np.uint32(self.local_bits)

    def local_of(self, codes: torch.Tensor) -> torch.Tensor:
        """Bucket index within the owning node's shard (low bits)."""
        return codes.to(torch.int32) & ((1 << self.local_bits) - 1)

    def local_of_np(self, codes) -> np.ndarray:
        """Host (numpy) twin of `local_of`."""
        mask = (1 << self.local_bits) - 1
        return np.asarray(codes, dtype=np.uint32) & np.uint32(mask)

    def lookup_hops(self, src_node: int, dst_node: int) -> int:
        """Greedy hypercube routing cost in CAN hops (= Hamming distance)."""
        return int(bin(int(src_node) ^ int(dst_node)).count("1"))
