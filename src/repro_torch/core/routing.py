"""Capacitated compaction shared across the system.

This slice holds `run_ranks`, which the bucket store's ring append uses
to rank each entry within its destination bucket.  The all_to_all router
(`plan_routes`, send buffers) arrives with the mesh runtime.
"""

from __future__ import annotations

import torch


def run_ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal keys.

    Args:
      sorted_keys: int [n], sorted ascending (equal keys contiguous).
    Returns:
      int32 [n]; the j-th occurrence of a key gets rank j.
    """
    n = sorted_keys.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=sorted_keys.device)
    pos = torch.arange(n, dtype=torch.int64, device=sorted_keys.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    return (pos - run_start).to(torch.int32)
