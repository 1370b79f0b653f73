"""Inputs that exercise each rule of fused_query's and fused_contains's
semantics.  The CUDA tests (`test_torch_cuda.py`) hold the kernels
against their plain versions on them, `chip_smoke.py` holds fused_query
on `edge_case_rows`, and `test_torch_contains.py` holds fused_contains's
plain path on `contains_case` against JAX."""

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


# fused_contains cases: name -> (rows r, probes P, ids a bucket row C)
CONTAINS_CASES = {
    "hit": (300, 13, 64), "miss": (300, 13, 64),
    "empty_target": (60, 13, 64), "no_valid_probe": (60, 13, 64),
    "one_valid_probe": (60, 13, 64), "probe_twice": (60, 13, 64),
    "hot_bucket": (60, 13, 64), "c33": (200, 13, 33),
    "misaligned": (200, 13, 64), "no_rows": (0, 13, 64),
    "p1": (200, 1, 64), "p31": (200, 31, 64),
    "main_hit": (4096, 13, 512), "main_miss": (4096, 13, 512),
}


def contains_case(name: str, *, seed: int = 0, device="cpu"):
    """(ids_flat, fb, meta) of fused_contains case `name`, for holding the
    kernel against the plain version and the plain version against JAX.

    A store of distinct ids (a third of the slots empty, -1; bucket row 0
    full) probed by random rows under random validity words.  "hit" rows
    (and "main_hit", at the main path's shape) look for an id in one of
    their valid probes, "miss" rows for ids that no bucket holds; the
    other cases mix both and add one rule each: target -1 (found only in
    a valid probe with an empty slot), rows with no valid probe whose
    buckets hold the target, rows with exactly one valid probe (the
    target in it, or only in an invalid one), a bucket probed twice, 40
    rows on one bucket, C = 33 and an `ids_flat` view 4 bytes off a
    16-byte boundary (both take single-id loads), no rows, P = 1 and
    P = 31."""
    r, n_probes, c = CONTAINS_CASES[name]
    gen = np.random.default_rng(seed)
    n_rows = 16 * 1024 if name.startswith("main") else 50
    ids = gen.permutation(2 * n_rows * c)[:n_rows * c].reshape(n_rows, c)
    ids[gen.random((n_rows, c)) < 1 / 3] = -1
    ids[0] = gen.permutation(np.arange(2 * n_rows * c, 2 * n_rows * c + c))
    fb = gen.integers(0, n_rows, (r, n_probes))
    full = (1 << n_probes) - 1
    pw = full if name.startswith("main") else gen.integers(1, full + 1, r)
    pw = np.broadcast_to(pw, (r,)).copy()
    # a target from a random valid probe's random live slot, or one that
    # no bucket holds (ids run below 2 * n_rows * c + c)
    tgt = np.full(r, 10 ** 9, dtype=np.int64) + np.arange(r)
    for i in range(r):
        valid = [p for p in range(n_probes) if (pw[i] >> p) & 1]
        row = ids[fb[i, gen.choice(valid)]]
        live = row[row >= 0]
        if live.size and name not in ("miss", "main_miss") and (
                name in ("hit", "main_hit") or gen.random() < 0.5):
            tgt[i] = gen.choice(live)
    if name == "empty_target":
        tgt[:] = -1
        fb[::2] = 0  # every probe on the full row: no empty slot, a miss
    elif name == "no_valid_probe":
        pw[::2] = 0
        tgt[::2] = ids[fb[::2, 0], 0]
    elif name == "one_valid_probe":
        pw[:] = 1 << gen.integers(0, n_probes, r)
        pw[::4] = 1
        fb[:, 0] = 0
        tgt[::2] = ids[0, 7]  # in probe 0's bucket, valid in some rows
    elif name == "probe_twice":
        fb[:, 1] = fb[:, 0]
        pw[:] = 0b10
        tgt[::3] = ids[fb[::3, 0], c - 1]
    elif name == "hot_bucket":
        fb[:40, 0] = 0
        pw[:40] |= 1
        tgt[:40:2] = ids[0, gen.integers(0, c, 20)]
    meta = np.stack([pw, tgt], axis=1).astype(np.int32)
    ids = ids.astype(np.int32)
    if name == "misaligned":  # 4 bytes past a 16-byte boundary
        flat = torch.from_numpy(np.concatenate([[0], ids.ravel()]).astype(
            np.int32))
        flat = flat.to(device)
        ids_t = flat[1:].view(n_rows, c)
    else:
        ids_t = torch.from_numpy(ids).to(device)
    return (ids_t, torch.from_numpy(fb.astype(np.int32)).to(device),
            torch.from_numpy(meta).to(device))
