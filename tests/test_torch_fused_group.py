"""What the CUDA fused_query rests on, on the CPU.

The kernels run only on the card (`test_torch_cuda.py` holds them
against `fused_query_plain`).  Here: the grouping step's plain version
(`fused_query.group_pairs`, the oracle of the grouping kernels) against
a Python loop; the host's sizing of the score buffer; and the plain
version itself on the edge cases the kernels are held to, against the
JAX reference and the rules those cases were built to exercise.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import fused_query as fq
from torch_fused_cases import edge_case_rows


def _rows(seed, r, n_probes, n_rows, hot=0):
    """fb / meta with random probes, some out of range, some rows with
    no valid probe, and `hot` rows whose probes all name bucket 1."""
    gen = np.random.default_rng(seed)
    fb = gen.integers(-2, n_rows + 2, (r, n_probes)).astype(np.int32)
    pw = gen.integers(0, 1 << n_probes, r).astype(np.int64)
    pw[::7] = 0
    fb[:hot] = 1
    pw[:hot] = (1 << n_probes) - 1
    meta = np.stack([pw.astype(np.int32), np.full(r, -1, np.int32)], axis=1)
    return torch.from_numpy(fb), torch.from_numpy(meta)


@pytest.mark.parametrize("seed,r,n_probes,n_rows,hot,item_rows", [
    (0, 1, 1, 1, 0, 16), (1, 50, 13, 20, 0, 16), (2, 200, 5, 3, 120, 16),
    (3, 64, 31, 40, 10, 4), (4, 300, 13, 8, 300, 16), (5, 9, 3, 4, 0, 1),
])
def test_group_pairs_matches_loop(seed, r, n_probes, n_rows, hot, item_rows):
    fb, meta = _rows(seed, r, n_probes, n_rows, hot)
    g = fq.group_pairs(fb, meta, n_rows, item_rows=item_rows)
    n_pairs, n_small = g.sizes.tolist()
    n_items = int(g.n_items)
    fbn, pw = fb.numpy(), meta[:, 0].numpy()
    want, row_ptr = [], [0]
    for row in range(r):
        for p in range(n_probes):
            if (pw[row] >> p) & 1:
                want.append((row, len(want),
                             min(max(int(fbn[row, p]), 0), n_rows - 1)))
        row_ptr.append(len(want))
    assert g.row_ptr.tolist() == row_ptr
    assert n_pairs == len(want)
    # rows with at most one valid pair first, then the rest, in row order
    counts = np.diff(row_ptr)
    assert g.row_order.tolist() == (np.nonzero(counts <= 1)[0].tolist()
                                    + np.nonzero(counts > 1)[0].tolist())
    assert n_small == int((counts <= 1).sum())
    got = list(zip(g.by_row[:n_pairs].tolist(), g.by_pair[:n_pairs].tolist(),
                   g.by_bucket[:n_pairs].tolist()))
    # every valid pair once, none lost or doubled, invalid ones absent
    assert sorted(got) == sorted(want)
    assert (g.by_bucket[n_pairs:] == n_rows).all()
    assert g.by_bucket[:n_pairs].tolist() == sorted(b for *_, b in want)
    starts = g.item_start[:n_items].tolist() + [n_pairs]
    assert starts[0] == 0 or n_pairs == 0
    buckets = g.by_bucket[:n_pairs].tolist()
    for a, b in zip(starts[:-1], starts[1:]):
        assert 0 < b - a <= item_rows
        assert len(set(buckets[a:b])) == 1
    # a bucket's pairs split only into full items before its last one
    for a, b, nxt in zip(starts[:-2], starts[1:-1], starts[2:]):
        if buckets[a] == buckets[b]:
            assert b - a == item_rows
    if hot:
        assert n_items >= -(-hot * n_probes // item_rows)
    g = fq.group_pairs(fb, meta, n_rows, split_small=False)
    assert g.row_order.tolist() == list(range(r)) and int(g.sizes[1]) == 0


@pytest.mark.parametrize("r,n_probes,c,want", [
    (4096, 13, 512, 53248),   # the 1-node main path: every pair, no wait
    (8192, 13, 512, 106496),  # the 16-node mesh at cap_factor 2
    (65536, 13, 512, None),   # the 16-node owner stage at cap_factor 16
    (0, 13, 512, 0), (40, 31, 2048, 1240),
])
def test_score_buffer_rows(r, n_probes, c, want):
    """The score buffer holds every (row, probe) pair up to
    SCORE_BUFFER_BYTES; beyond it the count of valid pairs is read back."""
    assert fq.score_buffer_rows(r, n_probes, c) == want
    if want is not None:
        assert want * c * 4 <= fq.SCORE_BUFFER_BYTES


@pytest.mark.parametrize("score", ["dot", "hamming"])
@pytest.mark.parametrize("m", [1, 10, 32, 33, 700])
def test_edge_cases_plain_matches_jax_and_rules(score, m):
    """`fused_query_plain` on the edge cases equals the JAX reference, and
    shows the rules they were built for: a later copy of an id never
    lends its score, a row with no valid probe pads, the exclude id is
    absent, no id repeats, equal scores go to the lowest id first."""
    ids, pay, q, fb, meta = edge_case_rows(score)
    gi, gs = fq.fused_query_plain(ids, pay, q, fb, meta, m=m, score=score)
    j = (lambda a: jnp.asarray(a.numpy().view(np.uint32))) \
        if score == "hamming" else (lambda a: jnp.asarray(a.numpy()))
    wi, ws = jref.fused_query_ref(jnp.asarray(ids.numpy()), j(pay), j(q),
                                  jnp.asarray(fb.numpy()),
                                  jnp.asarray(meta.numpy()), m=m, score=score)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-6)
    gi, gs = gi.numpy(), gs.numpy()
    low = -1.0 if score == "dot" else -32.0 * pay.shape[-1]
    for row in range(gi.shape[0]):
        live = gi[row] >= 0
        n = int(live.sum())
        assert live[:n].all() and np.isneginf(gs[row][~live]).all()
        got_i, got_s = gi[row][:n], gs[row][:n]
        assert len(set(got_i.tolist())) == n
        assert int(meta[row, 1]) not in got_i.tolist()
        assert all(a > b or (a == b and x < y) for a, b, x, y in
                   zip(got_s, got_s[1:], got_i, got_i[1:]))
    assert (gi[1] < 0).all()  # no valid probe
    first = {77: (0, ), 600: (3, 4)}  # ids whose later copy scores highest
    for i0, rows in first.items():
        for row in rows:
            hit = (gi[row] >= i0) & (gi[row] < i0 + (1 if i0 == 77 else 32))
            np.testing.assert_allclose(gs[row][hit], low, atol=1e-5)
    if m == 700:  # the row holds every first occurrence
        assert ((gi[3] >= 600) & (gi[3] < 632)).sum() == 32
        assert 77 in gi[0].tolist()
