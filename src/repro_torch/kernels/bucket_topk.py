"""bucket_topk: candidate scoring + top-m selection.

`bucket_topk_cuda` launches `csrc/bucket_topk.cu` (the CUDA port of the
TPU kernel `repro/kernels/bucket_topk.py::bucket_topk_pallas`);
`bucket_topk_plain` is the same function in plain PyTorch.  Both take
validity as bitfield words int32 [b, ceil(kc/32)]: bit i of word w is
lane w*32 + i.
"""

from __future__ import annotations

import torch

from repro_torch.core.hashing import to_int32_bits
from repro_torch.kernels import _build, ref


def pack_valid(valid: torch.Tensor) -> torch.Tensor:
    """bool [b, kc] -> bitfield words int32 [b, ceil(kc/32)]."""
    b, kc = valid.shape
    nw = -(-kc // 32)
    bits = torch.zeros((b, nw * 32), dtype=torch.int64, device=valid.device)
    bits[:, :kc] = valid
    shifts = torch.arange(32, dtype=torch.int64, device=valid.device)
    return to_int32_bits((bits.reshape(b, nw, 32) << shifts).sum(dim=-1))


def unpack_valid(vwords: torch.Tensor, kc: int) -> torch.Tensor:
    """Inverse of `pack_valid`."""
    shifts = torch.arange(32, dtype=torch.int32, device=vwords.device)
    bits = (vwords[:, :, None] >> shifts) & 1
    return bits.reshape(vwords.shape[0], -1)[:, :kc] > 0


def bucket_topk_plain(q, cand, vwords, m: int):
    """(scores f32 [b, m], idx int32 [b, m]); ties -> lowest index."""
    return ref.bucket_topk_ref(q, cand, unpack_valid(vwords, cand.shape[1]), m)


def bucket_topk_cuda(q, cand, vwords, m: int):
    """The kernel on contiguous CUDA tensors: q f32 [b, d], cand f32
    [b, kc, d], vwords int32 [b, ceil(kc/32)]."""
    b, kc, d = cand.shape
    scores = torch.empty((b, m), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, m), dtype=torch.int32, device=q.device)
    launch = _build.entry("bucket_topk", "bucket_topk_launch",
                          [_build.P] * 5 + [_build.I] * 5 + [_build.P])
    _build.check(launch(q.data_ptr(), cand.data_ptr(), vwords.data_ptr(),
                        scores.data_ptr(), idx.data_ptr(), b, kc, d,
                        vwords.shape[1], m, _build.stream_of(q)),
                 f"bucket_topk (kc={kc}, d={d})")
    return scores, idx
