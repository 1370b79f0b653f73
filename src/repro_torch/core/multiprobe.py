"""Near-bucket enumeration (paper Sec. 4.2).

NearBucket-LSH probes, for every table l, the exact bucket g_l(q) plus
its k 1-near buckets (one flipped bit).  Probe planning lives in
`repro_torch.core.plan`.  `b_near_codes_host` enumerates b-near buckets
for the ablations of Prop. 3.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def near_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """All k 1-near bucket ids of each int32 code: [..., k], entry j
    flips bit j."""
    flips = torch.ones(k, dtype=torch.int32, device=codes.device) << \
        torch.arange(k, dtype=torch.int32, device=codes.device)
    return torch.bitwise_xor(codes.to(torch.int32)[..., None], flips)


def probe_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Exact + k near codes: [..., 1 + k]. Entry 0 is the exact bucket."""
    return torch.cat(
        [codes.to(torch.int32)[..., None], near_codes(codes, k)], dim=-1
    )


def b_near_codes_host(code: int, k: int, b: int) -> np.ndarray:
    """Host-side enumeration of all C(k, b) b-near buckets of one code
    (uint32, as the reference returns them)."""
    out = []
    for bits in itertools.combinations(range(k), b):
        mask = 0
        for j in bits:
            mask |= 1 << j
        out.append(code ^ mask)
    return np.asarray(out, dtype=np.uint32)


def probe_plan_size(k: int, L: int, variant: str,
                    num_probes: int | None = None) -> int:
    """Buckets searched per query, per Table 1 ('vectors searched' / B):
    a view over `plan.ProbeSpec` (deferred import: plan imports this
    module)."""
    from repro_torch.core.hashing import LshParams
    from repro_torch.core.plan import ProbeSpec

    spec = ProbeSpec(LshParams(d=1, k=k, L=L), variant, num_probes)
    return L * spec.probes_per_table
