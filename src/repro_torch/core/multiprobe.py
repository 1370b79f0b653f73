"""Near-bucket enumeration (paper Sec. 4.2).

NearBucket-LSH probes, for every table l, the exact bucket g_l(q) plus
its k 1-near buckets (one flipped bit).  Probe planning lives in
`repro_torch.core.plan`.
"""

from __future__ import annotations

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
