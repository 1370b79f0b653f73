"""Shared probe planner: one query discipline (paper Sec. 4.2, 5.1).

Turns `(queries, LshParams, variant, num_probes, ranked_probes)` into a
`ProbePlan`: per-table probe codes (exact bucket first), the per-(query,
table) bitmask of probed 1-near buckets, and the CAN owner / local split
of each exact bucket.  All tensors are int32.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import costmodel, hashing, multiprobe
from repro_torch.core.can import CanTopology
from repro_torch.core.hashing import LshParams


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """Static description of the query discipline (what to probe)."""

    params: LshParams
    variant: str = "cnb"           # lsh | layered | nb | cnb
    num_probes: int | None = None  # None => all k 1-near buckets (the paper)
    ranked_probes: bool = False    # margin-ranked probe subset (beyond paper)

    def __post_init__(self):
        if self.variant not in costmodel.VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.num_probes is not None and self.num_probes < 0:
            raise ValueError(f"num_probes must be >= 0, got {self.num_probes}")

    @property
    def near_probes(self) -> int:
        """1-near buckets probed per table."""
        if self.variant in ("lsh", "layered"):
            return 0
        k = self.params.k
        return k if self.num_probes is None else min(self.num_probes, k)

    @property
    def probes_per_table(self) -> int:
        """Buckets searched per (query, table), exact bucket included."""
        return 1 + self.near_probes


@dataclasses.dataclass
class ProbePlan:
    """Per-query probe decisions; nq = leading query dims, L = tables,
    P = `ProbeSpec.probes_per_table`."""

    codes: torch.Tensor       # int32 [nq, L]    exact sketch codes
    probes: torch.Tensor      # int32 [nq, L, P] probe codes, exact first
    probe_mask: torch.Tensor  # int32 [nq, L]    bit j set => flip of bit j
    #                                            is probed
    owner: torch.Tensor       # int32 [nq, L]    owner shard of exact bucket
    local_idx: torch.Tensor   # int32 [nq, L]    bucket index within shard


def sketch(q: torch.Tensor, hyperplanes: torch.Tensor, *,
           use_kernels: bool = False) -> torch.Tensor:
    """int32 codes [..., L] — the simhash kernel or the plain sketch."""
    if use_kernels:
        from repro_torch.kernels import ops

        return ops.simhash(q, hyperplanes)
    return hashing.sketch_codes(q, hyperplanes)


def make_plan(
    spec: ProbeSpec,
    q: torch.Tensor,                    # [..., d] unit queries
    hyperplanes: torch.Tensor,          # [L, k, d]
    topology: CanTopology | None = None,
    *,
    use_kernels: bool = False,
) -> ProbePlan:
    """Plan the probes for a batch of queries."""
    k = spec.params.k
    topo = topology or CanTopology(k, 1 << k)  # paper: one bucket per node
    codes = sketch(q, hyperplanes, use_kernels=use_kernels)  # [..., L]

    p = spec.near_probes
    if p == 0:
        probes = codes[..., None]
        mask = torch.zeros_like(codes)
    elif p >= k:
        probes = multiprobe.probe_codes(codes, k)
        mask = torch.full_like(codes, (1 << k) - 1)
    elif spec.ranked_probes:
        margins = hashing.projection_margins(q, hyperplanes)  # [..., L, k]
        # stable, as jnp.argsort is: equal margins keep the lower bit first
        bits = torch.argsort(margins, dim=-1, stable=True)[..., :p]
        flips = torch.ones_like(bits, dtype=torch.int32) << bits.to(torch.int32)
        probes = torch.cat([codes[..., None], codes[..., None] ^ flips], dim=-1)
        # bits are distinct, so the sum of their powers of two == their OR
        mask = flips.sum(dim=-1, dtype=torch.int32)
    else:
        near = multiprobe.near_codes(codes, k)[..., :p]
        probes = torch.cat([codes[..., None], near], dim=-1)
        mask = torch.full_like(codes, (1 << p) - 1)

    return ProbePlan(
        codes=codes,
        probes=probes,
        probe_mask=mask,
        owner=topo.node_of(codes),
        local_idx=topo.local_of(codes),
    )


def shard_local_probes(
    topo: CanTopology,
    local_idx: torch.Tensor,   # int32 [...]
    probe_mask: torch.Tensor,  # int32 [...]
    *,
    include_near: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Local bucket indices to probe at the owner shard, with validity.

    Returns (buckets [..., P], valid bool [..., P]): exact bucket first,
    then one entry per local bit; entry 1 + j (the flip of local bit j)
    is valid iff bit j of `probe_mask` is set.
    """
    exact = local_idx[..., None]
    always = torch.ones_like(exact, dtype=torch.bool)
    if not include_near or topo.local_bits == 0:
        return exact, always
    bits = torch.arange(topo.local_bits, dtype=torch.int32,
                        device=local_idx.device)
    near = exact ^ (torch.ones_like(bits) << bits).to(local_idx.dtype)
    nvalid = ((probe_mask.to(torch.int32)[..., None] >> bits) & 1) > 0
    return torch.cat([exact, near], dim=-1), torch.cat([always, nvalid], dim=-1)


def node_bit_probe_valid(topo: CanTopology, probe_mask: torch.Tensor,
                         bit: int) -> torch.Tensor:
    """Is the near bucket reached by flipping node bit `bit` probed?"""
    return ((probe_mask.to(torch.int32) >> (topo.local_bits + bit)) & 1) > 0
