"""fused_query / fused_contains: gather -> score -> dedup -> top-m of the
probed buckets of each (query, table) row in one kernel.

`fused_query_cuda` and `fused_contains_cuda` launch `csrc/fused_query.cu`
(the CUDA port of the TPU kernels `repro/kernels/fused_query.py::
fused_query_pallas` and `::fused_contains_pallas`); the `_plain`
functions are the same in plain PyTorch: the staged pipeline of
`kernels.ref`, whose top-m runs through `core.scoring.dedupe_topk`.

Row layout: `fb[r, p]` is the flat bucket row ([T*NB, C] view of the
store) of probe p; `meta[r] = (probe-validity word, exclude or target
id)`, where bit p of the word marks probe p valid.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_PROBES = 31  # the validity word is an int32 with bit 31 clear


def fused_query_plain(ids_flat, pay_flat, q, fb, meta, *, m: int,
                      score: str = "dot"):
    """(ids int32 [r, m], scores f32 [r, m])."""
    return ref.fused_query_ref(ids_flat, pay_flat, q, fb, meta, m=m,
                               score=score)


def fused_contains_plain(ids_flat, fb, meta) -> torch.Tensor:
    """bool [r]: is the target id in any valid probed bucket row?"""
    return ref.fused_contains_ref(ids_flat, fb, meta)[:, 0] > 0


def fused_query_cuda(ids_flat, pay_flat, q, fb, meta, *, m: int,
                     score: str = "dot"):
    """The kernel on contiguous CUDA tensors (see `ops.fused_query`)."""
    n_rows, c = ids_flat.shape
    r, n_probes = fb.shape
    dw = pay_flat.shape[-1]
    ids = torch.empty((r, m), dtype=torch.int32, device=q.device)
    scores = torch.empty((r, m), dtype=torch.float32, device=q.device)
    launch = _build.entry("fused_query", "fused_query_launch",
                          [_build.P] * 7 + [_build.I] * 7 + [_build.P])
    _build.check(launch(ids_flat.data_ptr(), pay_flat.data_ptr(),
                        q.data_ptr(), fb.data_ptr(), meta.data_ptr(),
                        ids.data_ptr(), scores.data_ptr(), r, n_rows, c, dw,
                        n_probes, m, int(score == "hamming"),
                        _build.stream_of(q)),
                 f"fused_query (P*C = {n_probes}*{c} candidates)")
    return ids, scores


def fused_contains_cuda(ids_flat, fb, meta) -> torch.Tensor:
    """The kernel on contiguous CUDA tensors (see `ops.fused_contains`)."""
    n_rows, c = ids_flat.shape
    r, n_probes = fb.shape
    hit = torch.empty((r,), dtype=torch.int32, device=fb.device)
    launch = _build.entry("fused_query", "fused_contains_launch",
                          [_build.P] * 4 + [_build.I] * 4 + [_build.P])
    _build.check(launch(ids_flat.data_ptr(), fb.data_ptr(), meta.data_ptr(),
                        hit.data_ptr(), r, n_rows, c, n_probes,
                        _build.stream_of(fb)),
                 "fused_contains")
    return hit > 0
