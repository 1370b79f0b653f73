"""What the CUDA simhash and bucket_topk kernels rest on, on the CPU.

The kernels run only on the card (`test_torch_cuda.py` holds them against
their plain versions).  Here: the grids the host picks for them, as pure
functions of the shapes and the SM count, and bucket_topk's two phases
(the m best of each part of a row, then of the parts' entries) in plain
PyTorch against the plain version and the JAX reference.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import bucket_topk as bt
from repro_torch.kernels import ref
from repro_torch.kernels import simhash as sh

# SM counts of an H100 SXM (132), an H100 PCIe (114) and a larger part
SM_COUNTS = (114, 132, 144)


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("packed", [False, True])
def test_simhash_grid_fills_the_card_at_a_search_batch(sms, packed):
    """1024 queries (the main path's batch): a block for every SM."""
    g = sh.grid(1024, 128, 12, 4, packed, sms)
    assert not g.stream
    assert g.blocks >= sms


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("n", [1_100_000, 67_584, 16_384])
def test_simhash_grid_streams_x_once_at_large_n(sms, n):
    """The corpus build: one block column (x read once), a block an SM at
    most, every warp with a chunk, within the shared-memory budget."""
    g = sh.grid(n, 128, 12, 4, False, sms)
    if n < sh.WARP_ROWS_PER_SM * sms:
        assert not g.stream
        return
    assert g.stream and g.col_splits == 1 and g.elems_per_block == 4
    assert g.grid_rows <= sms and 1 <= g.warps <= sh.MAX_WARPS
    chunks = -(-n // g.chunk_rows)
    assert (g.grid_rows - 1) * g.warps < chunks  # no block without a chunk
    assert g.smem == sh.stream_smem_bytes(128, g.warps, g.chunk_rows)
    assert g.smem <= sh.SMEM_BLOCK


@pytest.mark.parametrize("n,d,k,L,packed", [
    (1, 128, 12, 4, False), (7, 128, 12, 4, True), (2000, 128, 5, 5, True),
    (300, 37, 7, 2, False), (202_789, 64, 30, 9, False),
    (202_789, 64, 30, 9, True), (202_789, 37, 7, 2, True),
    (1_100_000, 256, 12, 4, False), (50_000, 128, 16, 8, False),
])
def test_simhash_grid_covers_every_element_once(n, d, k, L, packed):
    """Stream blocks along the output elements cover them exactly once,
    each block's hyperplanes fit the kernel's 4 groups of 12, and the
    shared memory fits a block."""
    g = sh.grid(n, d, k, L, packed, 132)
    spans = sh.element_spans(k, L, packed)
    if g.stream:
        cover = [e for c in range(g.col_splits)
                 for e in range(c * g.elems_per_block,
                                min(len(spans), (c + 1) * g.elems_per_block))]
        assert cover == list(range(len(spans)))
        for c in range(g.col_splits):
            lo = spans[c * g.elems_per_block][0]
            hi = spans[min(len(spans), (c + 1) * g.elems_per_block) - 1][1]
            assert hi - lo <= sh.STREAM_GROUPS * sh.GROUP
        assert g.smem == sh.stream_smem_bytes(d, g.warps, g.chunk_rows)
        assert g.smem <= sh.SMEM_BLOCK
    else:
        assert max(hi - lo for lo, hi in spans) <= 64 // g.chunk_rows
        warps = -(-n // g.chunk_rows) * len(spans)
        assert g.grid_rows == -(-warps // g.warps)


def test_simhash_element_spans_follow_the_packed_layout():
    """Codes: table l is hyperplanes [l*k, l*k + k); words: word w is
    global bits [32w, 32w + 32) of the `core.packed` layout."""
    assert sh.element_spans(12, 4, False) == [(0, 12), (12, 24), (24, 36),
                                              (36, 48)]
    assert sh.element_spans(12, 4, True) == [(0, 32), (32, 48)]
    assert sh.element_spans(7, 5, True) == [(0, 32), (32, 35)]


@pytest.mark.parametrize("sms", SM_COUNTS)
def test_bucket_topk_grid_fills_the_card_at_the_engine_chunk(sms):
    """b = 32*L = 128 rows of KC = 6656 lanes: blocks several times the
    SM count, parts of whole validity words."""
    g = bt.grid(128, 6656, 10, sms)
    assert g.blocks == 128 * g.parts >= 4 * sms


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("b,kc,m", [
    (128, 6656, 10), (4096, 1024, 10), (4096, 512, 10), (1, 1, 1),
    (16, 33, 50), (1, 6656, 50), (7, 1000, 1), (2, 6656, 700), (0, 9, 3),
    (529, 16416, 50), (600, 26624, 50), (4096, 60000, 33),
    (10_000, 200_000, 40),
])
def test_bucket_topk_grid_parts_cover_the_lanes_once(sms, b, kc, m):
    """Parts (part p: the lanes of validity words p, p + parts, ...)
    cover [0, kc) exactly once, none empty (with fewer words than parts
    wanted, a part a word), a block a (row, part), and the m > 32
    kernels' shared memory within a block's budget."""
    g = bt.grid(b, kc, m, sms)
    nw = -(-kc // 32)
    lanes = np.arange(kc)
    parts = [lanes[(lanes // 32) % g.parts == p] for p in range(g.parts)]
    assert sorted(np.concatenate(parts).tolist()) == lanes.tolist()
    assert all(len(p) > 0 for p in parts)
    assert max(len(p) for p in parts) <= 32 * g.words_per_part
    assert g.parts <= nw and g.blocks == b * g.parts
    if m > bt.FAST_M:
        assert g.parts * m <= max(bt.MERGE_KEYS, m)
        assert max(bt.sort_smem_bytes(g, m)) <= bt.SMEM_BLOCK


@pytest.mark.parametrize("b,kc,m", [
    (529, 16416, 50), (600, 26624, 50), (4096, 60000, 33),
    (10_000, 200_000, 40),
])
def test_bucket_topk_grid_splits_rows_whose_sort_overflows(b, kc, m):
    """m > 32 with more rows than the card's blocks: one part a row would
    sort more keys than a block holds, so the grid takes the fewest parts
    whose sort fits (within MERGE_KEYS // m)."""
    g = bt.grid(b, kc, m, 132)
    nw = -(-kc // 32)
    one = bt.BucketTopkGrid(1, nw, b)
    assert bt.sort_smem_bytes(one, m)[0] > bt.SMEM_BLOCK
    assert 1 < g.parts <= bt.MERGE_KEYS // m
    assert max(bt.sort_smem_bytes(g, m)) <= bt.SMEM_BLOCK
    fewer = bt.BucketTopkGrid(g.parts - 1, -(-nw // (g.parts - 1)), b)
    assert bt.sort_smem_bytes(fewer, m)[0] > bt.SMEM_BLOCK


def _topk_rows(seed, b, kc, m, d=16):
    """Random rows whose best score is tied exactly across part
    boundaries (every 97th lane copies lane 0), an all-invalid row,
    all-invalid parts, a row with one valid lane, a row valid only in
    its last third."""
    gen = np.random.default_rng(seed)
    q = gen.standard_normal((b, d)).astype(np.float32)
    cand = gen.standard_normal((b, kc, d)).astype(np.float32)
    cand[:, 0] = 3 * q  # the best score of the row, copied every 97 lanes
    cand[:, ::97] = cand[:, :1]
    valid = gen.random((b, kc)) < 0.6
    valid[0] = False
    if b > 1:
        valid[1, : kc // 2] = False
    if b > 2:
        valid[2] = False
        valid[2, kc - 1] = True
    if b > 3:  # valid lanes last, as in the engine's id-sorted rows
        valid[3, : 2 * kc // 3] = False
    return q, cand, valid


@pytest.mark.parametrize("b,kc,m,sms", [
    (8, 6656, 10, 132), (8, 6656, 10, 1), (6, 1000, 50, 132),
    (5, 33, 50, 132), (3, 1, 1, 132), (4, 97 * 3 + 5, 7, 132),
    (9, 2000, 1, 114), (5, 700, 33, 132),
])
def test_two_phase_selection_matches_references(b, kc, m, sms):
    """The kernels' two phases in plain PyTorch on the grid the host
    picks equal the one-phase plain version and the JAX reference: ids
    exactly, ties across parts to the lowest lane."""
    q, cand, valid = _topk_rows(b * kc + m, b, kc, m)
    tq, tc, tv = map(torch.from_numpy, (q, cand, valid))
    g = bt.grid(b, kc, m, sms)
    gs, gi = bt.two_phase_plain(tq, tc, bt.pack_valid(tv), m, g)
    ws, wi = ref.bucket_topk_ref(tq, tc, tv, m)
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gs, ws, atol=1e-6, rtol=0)
    js, ji = jref.bucket_topk_ref(jnp.asarray(q), jnp.asarray(cand),
                                  jnp.asarray(valid), m)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(gs.numpy(), np.asarray(js), atol=1e-5)
    assert (gi[0] == -1).all() and torch.isinf(gs[0]).all()
    if b > 2 and m > 1:
        assert gi[2, 0] == kc - 1 and (gi[2, 1:] == -1).all()
