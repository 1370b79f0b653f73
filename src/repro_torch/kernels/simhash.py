"""simhash: fused sign-random-projection sketching.

`simhash_cuda` launches `csrc/simhash.cu` (the CUDA port of the TPU
kernel `repro/kernels/simhash.py::simhash_pallas`); `simhash_plain` is
the same function in plain PyTorch, which serves CPU tensors and is
what the kernel is held against.
"""

from __future__ import annotations

import torch

from repro_torch.core.packed import num_words, pack_codes
from repro_torch.kernels import _build, ref


def simhash_plain(x: torch.Tensor, hyperplanes: torch.Tensor, *,
                  packed: bool = False) -> torch.Tensor:
    """int32 codes [n, L], or packed words [n, W] with packed=True."""
    codes = ref.simhash_ref(x, hyperplanes)
    return pack_codes(codes, hyperplanes.shape[1]) if packed else codes


def simhash_cuda(x: torch.Tensor, hyperplanes: torch.Tensor, *,
                 packed: bool = False) -> torch.Tensor:
    """The kernel on contiguous f32 CUDA tensors x [n, d], H [L, k, d]."""
    n, d = x.shape
    L, k, _ = hyperplanes.shape
    width = num_words(k, L) if packed else L
    out = torch.empty((n, width), dtype=torch.int32, device=x.device)
    launch = _build.entry("simhash", "simhash_launch", [_build.P] * 3 + [
        _build.I] * 5 + [_build.P])
    _build.check(launch(x.data_ptr(), hyperplanes.data_ptr(), out.data_ptr(),
                        n, d, k, L, int(packed), _build.stream_of(x)),
                 f"simhash (d={d}, L*k={L * k})")
    return out
