"""CAN overlay geometry: bucket <-> node coordinates (paper Sec. 4.1).

With n nodes, each owns a contiguous sketch-prefix zone of 2^(k - a)
buckets, a = log2(n): the high a bits of a code select the node, the low
k - a bits the bucket within it.  Flips of the low bits stay on the node
("free" near buckets); a flip of node bit j lands on the XOR-neighbour
node ^ 2^j.  Neighbours, zones, replica placement and the join/leave
geometry are host-side (numpy) control-plane facts.
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

    def code_of(self, node, local):
        return (np.uint32(node) << np.uint32(self.local_bits)) | np.uint32(local)

    # -- neighbor structure -------------------------------------------------

    def node_neighbors(self, node: int) -> np.ndarray:
        """The `node_bits` XOR-neighbors of a node (paper's CAN neighbors
        restricted to the bits that select the node)."""
        return np.asarray(
            [node ^ (1 << j) for j in range(self.node_bits)], dtype=np.uint32
        )

    def neighbor_perm(self, bit: int) -> list[tuple[int, int]]:
        """(source, destination) pairing for flipping node-id `bit`: a
        perfect matching (i, i ^ 2^bit) over all nodes."""
        if not (0 <= bit < self.node_bits):
            raise ValueError(
                f"bit {bit} out of range for {self.node_bits} node bits")
        return [(i, i ^ (1 << bit)) for i in range(self.n_nodes)]

    # -- zones and replica placement -----------------------------------------

    def zone_range(self, node: int) -> tuple[int, int]:
        """[start, end) bucket codes of a node's contiguous prefix zone."""
        if not (0 <= int(node) < self.n_nodes):
            raise ValueError(f"node {node} out of range for {self.n_nodes}")
        return (
            int(node) * self.buckets_per_node,
            (int(node) + 1) * self.buckets_per_node,
        )

    def replicas_of(self, codes, R: int) -> np.ndarray:
        """Owner nodes of the R replicas of each bucket code: the primary
        owner followed by its R-1 ring successors.  [..., R] uint32.
        Replica r of node j's whole zone lands on node (j + r) % n, so
        local bucket indices are the same on every replica holder."""
        R = int(R)
        if not (1 <= R <= self.n_nodes):
            raise ValueError(
                f"replication R={R} out of range [1, {self.n_nodes}]")
        primary = self.node_of_np(codes)
        offsets = np.arange(R, dtype=np.uint32)
        return (primary[..., None] + offsets) % np.uint32(self.n_nodes)

    # -- routing cost (message unit, paper Table 1) --------------------------

    def lookup_hops(self, src_node: int, dst_node: int) -> int:
        """Greedy hypercube routing cost in CAN hops (= Hamming distance)."""
        return int(bin(int(src_node) ^ int(dst_node)).count("1"))

    @property
    def expected_lookup_hops(self) -> float:
        """Expected DHT lookup cost from a random source: node_bits / 2."""
        return self.node_bits / 2.0


def paper_topology(k: int) -> CanTopology:
    """The paper's exact setting: one bucket per node, N = 2^k."""
    return CanTopology(k=k, n_nodes=1 << k)


# -----------------------------------------------------------------------------
# elastic membership: power-of-two join/leave rounds between two topologies
# -----------------------------------------------------------------------------
#
# Growing N -> rN splits every zone into r subzones (the incumbent keeps
# the first, as node r*i); shrinking rN -> N merges each sibling group
# onto its first node, as node i.


def survivor_of(old: CanTopology, new: CanTopology, node) -> np.ndarray:
    """New node id an old node's surviving state lands on (vectorized
    over `node`)."""
    if old.k != new.k:
        raise ValueError(f"topologies disagree on k: {old.k} != {new.k}")
    node = np.asarray(node, dtype=np.uint32)
    if new.n_nodes >= old.n_nodes:
        return node * np.uint32(new.n_nodes // old.n_nodes)
    return node // np.uint32(old.n_nodes // new.n_nodes)


def moved_buckets(old: CanTopology, new: CanTopology) -> int:
    """Bucket rows PER TABLE changing owner in one join/leave round:
    NB * (1 - min/max) with prefix zones."""
    if old.k != new.k:
        raise ValueError(f"topologies disagree on k: {old.k} != {new.k}")
    nb = 1 << old.k
    lo, hi = sorted((old.n_nodes, new.n_nodes))
    return nb - nb * lo // hi
