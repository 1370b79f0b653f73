"""hamming: popcount Hamming distance of packed sketch words.

`hamming_words_cuda` and `hamming_cuda` launch `csrc/hamming.cu` (the
CUDA port of the TPU kernels `repro/kernels/hamming.py::
hamming_words_pallas` and `::hamming_pallas`); the `_plain` functions are
the same in plain PyTorch, the oracles of `kernels.ref`.  Words are int32
bit patterns.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def hamming_words_plain(codes: torch.Tensor, cand: torch.Tensor):
    """codes [n, W], cand [n, kc, W] -> int32 [n, kc]."""
    return ref.hamming_words_ref(codes, cand)


def hamming_plain(codes: torch.Tensor, cand: torch.Tensor):
    """codes [n], cand [n, kc] -> int32 [n, kc]."""
    return ref.hamming_ref(codes, cand)


def hamming_words_cuda(codes: torch.Tensor, cand: torch.Tensor):
    """The kernel on contiguous int32 CUDA tensors codes [n, W], cand
    [n, kc, W]."""
    n, kc, w = cand.shape
    out = torch.empty((n, kc), dtype=torch.int32, device=cand.device)
    launch = _build.entry("hamming", "hamming_words_launch",
                          [_build.P] * 3 + [_build.I] * 3 + [_build.P])
    _build.check(launch(codes.data_ptr(), cand.data_ptr(), out.data_ptr(),
                        n, kc, w, _build.stream_of(cand)),
                 f"hamming_words (n={n}, kc={kc}, W={w})")
    return out


def hamming_cuda(codes: torch.Tensor, cand: torch.Tensor):
    """The kernel on contiguous int32 CUDA tensors codes [n], cand
    [n, kc]."""
    n, kc = cand.shape
    out = torch.empty((n, kc), dtype=torch.int32, device=cand.device)
    launch = _build.entry("hamming", "hamming_launch",
                          [_build.P] * 3 + [_build.I] * 2 + [_build.P])
    _build.check(launch(codes.data_ptr(), cand.data_ptr(), out.data_ptr(),
                        n, kc, _build.stream_of(cand)),
                 f"hamming (n={n}, kc={kc})")
    return out
