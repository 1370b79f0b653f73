"""Inputs that exercise each rule of fused_query's semantics, shared by
the CUDA tests (`test_torch_cuda.py`) and `chip_smoke.py`, which hold the
kernels against `fused_query_plain` on them."""

from __future__ import annotations

import numpy as np
import torch


def edge_case_rows(score: str = "dot", *, seed: int = 0, n_fill: int = 40,
                   device="cpu"):
    """A small input that exercises each rule of the semantics, for
    holding the kernels against the plain version: (ids_flat, pay_flat,
    q, fb, meta), P = 3, C = 64, nine bucket rows.

    Row 0 finds id 77 in its probe 0 (scoring low) and again in probe 1
    (scoring highest): the first copy's score must win.  Row 1 has no
    valid probe.  Row 2 probes one bucket twice and excludes an id that
    bucket holds.  Rows 3 and 4 see 32 ids twice, first scoring lowest
    and then highest: in one bucket (row 3, a single probe) and across
    two (row 4), so that the best 32 entries are all later copies.  Rows
    5.. (`n_fill` of them) all probe bucket 4, which holds exact score
    ties.  Every row has fewer than 200 live candidates, so a large m
    pads."""
    gen = np.random.default_rng(seed)
    n_rows, c = 9, 64
    dw = 128 if score == "dot" else 2
    ids = gen.permutation(np.arange(1000, 2000))[:n_rows * c].reshape(n_rows, c)
    ids[gen.random((n_rows, c)) < 0.4] = -1
    ids[0, 5], ids[1, 3] = 77, 77
    ids[6, :32] = ids[6, 32:] = ids[8, :32] = ids[7, :32] = 600 + np.arange(32)
    r = 5 + n_fill
    if score == "dot":
        pay = gen.standard_normal((n_rows, c, dw)).astype(np.float32)
        pay /= np.linalg.norm(pay, axis=-1, keepdims=True)
        q = gen.standard_normal((r, dw)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    else:
        pay = gen.integers(-2**31, 2**31, (n_rows, c, dw)).astype(np.int32)
        q = gen.integers(-2**31, 2**31, (r, dw)).astype(np.int32)
    low = (lambda v: -v) if score == "dot" else (lambda v: ~v)
    pay[0, 5], pay[1, 3] = low(q[0]), q[0]
    pay[6, :32], pay[6, 32:] = low(q[3]), q[3]
    pay[8, :32], pay[7, :32] = low(q[4]), q[4]
    pay[4, 10:20] = pay[4, 9]  # equal scores: lowest id first
    ids[4, 9:20] = gen.permutation(np.arange(500, 511))
    fb = np.full((r, 3), 4, np.int32)
    fb[:5] = (0, 1, 2), (0, 1, 2), (2, 3, 2), (6, 6, 6), (8, 7, 5)
    pw = np.full(r, 0b111, np.int32)
    pw[0], pw[1], pw[3] = 0b011, 0, 0b001
    excl = np.full(r, -1, np.int32)
    excl[2] = ids[2][ids[2] >= 0][0]
    excl[5] = ids[4][ids[4] >= 0][1]
    meta = np.stack([pw, excl], axis=1)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (ids.astype(np.int32), pay, q, fb, meta))
