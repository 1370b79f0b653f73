"""`repro_torch.core.scoring` against `repro.core.scoring`: the edge cases
of tests/test_scoring.py on the staged path (`dedupe_topk`,
`score_topk`) and on the fused path's plain version (`ops.fused_query`
on CPU tensors) held against the staged JAX oracle."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scoring as jscoring
from repro.kernels import ref as jref
from repro_torch.core import scoring as tscoring
from repro_torch.kernels import ops as tops

NEG = float("-inf")


def t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def check_dedupe(ids, scores, m):
    ids = np.asarray(ids, np.int32)
    scores = np.asarray(scores, np.float32)
    wi, ws = jscoring.dedupe_topk(jnp.asarray(ids), jnp.asarray(scores), m)
    gi, gs = tscoring.dedupe_topk(t(ids), t(scores), m)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    return gi.numpy(), gs.numpy()


def test_all_empty_rows():
    gi, gs = check_dedupe(np.full((3, 8), -1), np.full((3, 8), NEG), 4)
    assert np.all(gi == -1) and np.all(np.isneginf(gs))


def test_m_larger_than_k():
    gi, _ = check_dedupe([[3, 7, 3]], [[1.0, 2.0, 0.5]], 6)
    np.testing.assert_array_equal(gi[0], [7, 3, -1, -1, -1, -1])


def test_m_larger_than_live_count():
    gi, gs = check_dedupe([[5, -1, 5, 2, -1, -1]],
                          [[1.0, NEG, 9.0, 0.5, NEG, NEG]], 5)
    np.testing.assert_array_equal(gi[0], [5, 2, -1, -1, -1, -1][:5])
    np.testing.assert_array_equal(gs[0][:2], [1.0, 0.5])


def test_first_occurrence_keeps_its_score():
    gi, gs = check_dedupe([[9, 4, 9, 4]], [[1.0, 3.0, 8.0, 7.0]], 2)
    np.testing.assert_array_equal(gi[0], [4, 9])
    np.testing.assert_array_equal(gs[0], [3.0, 1.0])


def test_score_ties_break_to_lowest_id():
    gi, _ = check_dedupe([[30, 10, 20, 40, 10]], [[2.0] * 5], 4)
    np.testing.assert_array_equal(gi[0], [10, 20, 30, 40])


@pytest.mark.parametrize("seed", range(4))
def test_random_rows_with_forced_ties(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 12, size=(16, 30))
    scores = rng.integers(-3, 3, size=(16, 30)).astype(np.float32)  # ties
    scores[ids < 0] = NEG
    check_dedupe(ids, scores, 7)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("m", [4, 9])
def test_score_topk_dot_matches_jax(use_kernels, m):
    rng = np.random.default_rng(m)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    vecs = rng.standard_normal((5, 7, 16)).astype(np.float32)
    vecs[:, 3] = vecs[:, 1]  # equal scores
    ids = rng.integers(-1, 6, size=(5, 7)).astype(np.int32)
    wi, ws = jscoring.score_topk(jnp.asarray(q), jnp.asarray(ids),
                                 jnp.asarray(vecs), m)
    gi, gs = tscoring.score_topk(t(q), t(ids), t(vecs), m,
                                 use_kernels=use_kernels)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_score_topk_hamming_matches_jax(use_kernels):
    rng = np.random.default_rng(1)
    b, kk, w = 6, 9, 2
    q = rng.integers(0, 2**32, size=(b, w), dtype=np.uint64).astype(np.uint32)
    cand = rng.integers(0, 2**32, size=(b, kk, w),
                        dtype=np.uint64).astype(np.uint32)
    ids = rng.integers(-1, 20, size=(b, kk)).astype(np.int32)
    wi, ws = jscoring.score_topk(jnp.asarray(q), jnp.asarray(ids),
                                 jnp.asarray(cand), 4, score="hamming")
    gi, gs = tscoring.score_topk(t(q), t(ids), t(cand), 4, score="hamming",
                                 use_kernels=use_kernels)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# -- the fused path's plain version against the staged JAX oracle ----------


def _fused_case(ids_flat, pay_flat, q, fb, meta, m, score="dot"):
    want_i, want_s = jref.fused_query_ref(
        jnp.asarray(ids_flat), jnp.asarray(pay_flat), jnp.asarray(q),
        jnp.asarray(fb), jnp.asarray(meta), m=m, score=score)
    got_i, got_s = tops.fused_query(t(ids_flat), t(pay_flat), t(q), t(fb),
                                    t(meta), m=m, score=score)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6)
    return got_i.numpy(), got_s.numpy()


def test_fused_all_empty_rows():
    c, d = 4, 8
    ids_flat = np.full((6, c), -1, np.int32)
    pay_flat = np.zeros((6, c, d), np.float32)
    meta = np.asarray([[0, -1], [3, -1], [0, -1]], np.int32)
    gi, gs = _fused_case(ids_flat, pay_flat, np.ones((3, d), np.float32),
                         np.zeros((3, 2), np.int32), meta, 3)
    assert np.all(gi == -1) and np.all(np.isneginf(gs))


def test_fused_duplicate_across_probe_blocks():
    c, d = 4, 8
    rng = np.random.default_rng(2)
    ids_flat = np.full((6, c), -1, np.int32)
    pay_flat = np.zeros((6, c, d), np.float32)
    ids_flat[0, :3] = [7, 1, 2]
    ids_flat[3, :2] = [7, 5]
    pay_flat[0, :3] = rng.standard_normal((3, d)) * 0.1
    pay_flat[3, 0] = 10.0  # the stale duplicate scores much higher
    pay_flat[3, 1] = rng.standard_normal(d)
    gi, gs = _fused_case(ids_flat, pay_flat, np.ones((1, d), np.float32),
                         np.asarray([[0, 3]], np.int32),
                         np.asarray([[0b11, -1]], np.int32), 4)
    assert list(gi[0]).count(7) == 1
    assert gs[0][list(gi[0]).index(7)] < 1.0


def test_fused_m_larger_than_live():
    c, d = 4, 8
    ids_flat = np.full((6, c), -1, np.int32)
    pay_flat = np.zeros((6, c, d), np.float32)
    ids_flat[1, 0] = 3
    pay_flat[1, 0] = 1.0
    gi, _ = _fused_case(ids_flat, pay_flat, np.ones((2, d), np.float32),
                        np.asarray([[1, 2], [2, 2]], np.int32),
                        np.asarray([[0b11, -1], [0b11, -1]], np.int32), 5)
    np.testing.assert_array_equal(gi[0], [3, -1, -1, -1, -1])
    np.testing.assert_array_equal(gi[1], -1)


def test_fused_exclude_sentinel():
    c, d = 4, 8
    ids_flat = np.full((2, c), -1, np.int32)
    pay_flat = np.zeros((2, c, d), np.float32)
    ids_flat[0, :2] = [11, 12]
    pay_flat[0, :2] = 1.0
    gi, _ = _fused_case(ids_flat, pay_flat, np.ones((2, d), np.float32),
                        np.asarray([[0], [0]], np.int32),
                        np.asarray([[1, 11], [1, -1]], np.int32), 2)
    assert 11 not in gi[0] and 12 in gi[0]
    assert set(gi[1]) == {11, 12}
