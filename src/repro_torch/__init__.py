"""NearBucket-LSH on PyTorch and CUDA.

The PyTorch port of the `repro` package: the same modules under the same
names (`repro_torch.core.*`, `repro_torch.kernels.*`), computing on
`torch` tensors.  Every Pallas TPU kernel of the JAX package becomes a
CUDA kernel written by hand for Hopper (`kernels/csrc/*.cu`), with a
plain PyTorch version beside it that serves tensors on the CPU.

Codes, packed sketch words and validity bitfields travel as int32 bit
patterns: torch has no `>>`, `<<` or `topk` for uint32 on the CPU.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; `resolve_device` is the one place that rule lives.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point computes on.

    ``None`` means the CUDA card, and raises where there is none: a
    caller that wants the CPU says so with ``device="cpu"``, so nothing
    ever drops to the CPU unasked.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
