"""The port's OSN data and sparse corpus against the JAX package.

  * `repro_torch.data.osn.generate` equals `repro.data.osn.generate` bit
    for bit (`nnz_ids`, `nnz_vals`, `d`) on `tiny_spec(0)`, `tiny_spec(1)`
    and a 5 000-user cut of the LIVEJOURNAL_S shape: both draw numpy's
    rng stream in the same order;
  * the generator's statistics (the port's `test_osn_generator_statistics`);
  * `SparseCorpus.densify` / `scores_against_dense`, `sparse_from_lists`,
    `sparse_densify_host` and `exact_topk_sparse` against JAX: exact where
    no float sum is involved, scores to 1e-6 where one is, and the oracle's
    ids under the near-tie rule of `torch_parity_rules.py`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import corpus as jcorpus
from repro.data import osn as josn
from repro_torch import convert
from repro_torch.core import corpus as tcorpus
from repro_torch.data import osn as tosn
from torch_parity_rules import topk_swaps

SPECS = {
    "tiny0": lambda o: o.tiny_spec(0),
    "tiny1": lambda o: o.tiny_spec(1),
    "livejournal_5000": lambda o: dataclasses.replace(o.LIVEJOURNAL_S,
                                                      num_users=5_000),
}


@pytest.fixture(scope="module")
def tiny():
    jc = josn.generate(josn.tiny_spec())
    return jc, tosn.generate(tosn.tiny_spec(), device="cpu")


@pytest.mark.parametrize("name", list(SPECS))
def test_generate_equals_reference_bit_for_bit(name):
    jspec, tspec = SPECS[name](josn), SPECS[name](tosn)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    jc = josn.generate(jspec)
    tc = tosn.generate(tspec, device="cpu")
    assert tc.d == jc.d and tc.n == jc.n
    assert tc.nnz_ids.dtype == torch.int32
    assert tc.nnz_vals.dtype == torch.float32
    np.testing.assert_array_equal(tc.nnz_ids.numpy(), np.asarray(jc.nnz_ids))
    # bit for bit: compare the f32 bit patterns, not the values
    np.testing.assert_array_equal(tc.nnz_vals.numpy().view(np.int32),
                                  np.asarray(jc.nnz_vals).view(np.int32))


def test_dataset_registry_equals_reference():
    assert list(tosn.DATASETS) == list(josn.DATASETS)
    for name, spec in tosn.DATASETS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            josn.DATASETS[name])


def test_osn_generator_statistics():
    spec = tosn.tiny_spec()
    corpus = tosn.generate(spec, device="cpu")
    assert corpus.n == spec.num_users
    ids = corpus.nnz_ids.numpy()
    vals = corpus.nnz_vals.numpy()
    # rows unit-norm over valid entries
    norms = np.sqrt((vals ** 2).sum(1))
    assert np.allclose(norms[norms > 0], 1.0, atol=1e-5)
    # every user has >= 2 interests (generator contract)
    assert ((ids >= 0).sum(1) >= 2).all()
    # ids unique within a row (densify's exact scatter rests on it)
    for row in ids:
        live = row[row >= 0]
        assert len(np.unique(live)) == len(live)
    # determinism
    corpus2 = tosn.generate(spec, device="cpu")
    assert torch.equal(corpus.nnz_ids, corpus2.nnz_ids)


@pytest.mark.parametrize("shape", [(7,), (3, 4)])
def test_densify_matches_jax(tiny, shape):
    jc, tc = tiny
    idx = np.random.default_rng(1).integers(-1, jc.n, size=shape).astype(
        np.int32)
    idx.flat[0] = -1  # a padding index densifies to zeros
    want = np.asarray(jc.densify(jnp.asarray(idx)))
    got = tc.densify(torch.from_numpy(idx))
    assert got.shape == shape + (jc.d,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scores_against_dense_matches_jax(tiny):
    jc, tc = tiny
    rng = np.random.default_rng(2)
    qrows = rng.integers(0, jc.n, size=6)
    q = np.array(jc.densify(jnp.asarray(qrows, jnp.int32)))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    idx = rng.integers(-1, jc.n, size=(6, 50)).astype(np.int32)
    # one query against [...] rows
    want1 = np.asarray(jc.scores_against_dense(jnp.asarray(q[0]),
                                               jnp.asarray(idx[:2])))
    got1 = tc.scores_against_dense(torch.from_numpy(q[0]),
                                   torch.from_numpy(idx[:2]))
    np.testing.assert_allclose(got1.numpy(), want1, atol=1e-6)
    # rows of queries against rows of candidates: the reference's vmap
    want = np.asarray(jax.vmap(jc.scores_against_dense)(jnp.asarray(q),
                                                        jnp.asarray(idx)))
    got = tc.scores_against_dense(torch.from_numpy(q), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert (got.numpy()[idx < 0] == 0).all()


def test_sparse_from_lists_matches_jax():
    rng = np.random.default_rng(3)
    ids, vals = [], []
    for n in (1, 2, 5, 9, 14):  # 9 and 14 pass nnz_max = 8: truncated
        ids.append(rng.choice(100, size=n, replace=False).astype(np.int32))
        vals.append(rng.random(n).astype(np.float32) + 0.1)
    want = jcorpus.sparse_from_lists(ids, vals, d=100, nnz_max=8)
    got = tcorpus.sparse_from_lists(ids, vals, d=100, nnz_max=8,
                                    device="cpu")
    np.testing.assert_array_equal(got.nnz_ids.numpy(),
                                  np.asarray(want.nnz_ids))
    np.testing.assert_array_equal(got.nnz_vals.numpy(),
                                  np.asarray(want.nnz_vals))
    assert got.d == want.d == 100


def test_sparse_densify_host_matches_jax(tiny):
    jc, tc = tiny
    rows = np.array([0, 5, 1999, 5, 17])
    np.testing.assert_array_equal(tcorpus.sparse_densify_host(tc, rows),
                                  jcorpus.sparse_densify_host(jc, rows))
    np.testing.assert_array_equal(
        tcorpus.normalize_rows_np(np.array([[3.0, 4.0], [0.0, 0.0]])),
        jcorpus.normalize_rows_np(np.array([[3.0, 4.0], [0.0, 0.0]])))


def test_sparse_corpus_from_carries_the_reference(tiny):
    jc, tc = tiny
    a = convert.sparse_corpus_from(jc, device="cpu")
    b = convert.sparse_corpus_from(nnz_ids=np.asarray(jc.nnz_ids),
                                   nnz_vals=np.asarray(jc.nnz_vals), d=jc.d,
                                   device="cpu")
    for c in (a, b):
        assert c.d == tc.d
        assert torch.equal(c.nnz_ids, tc.nnz_ids)
        assert torch.equal(c.nnz_vals, tc.nnz_vals)


@pytest.mark.parametrize("m,chunk", [(11, 16384), (11, 300), (2, 777)])
def test_exact_topk_sparse_matches_jax(tiny, m, chunk):
    """Scores to 1e-6; ids under the near-tie rule, since the reference
    orders equal scores by `argpartition` / `argsort`, which are not
    stable, and the port keeps the lower id first."""
    jc, tc = tiny
    rows = np.random.default_rng(4).choice(jc.n, 48, replace=False)
    q = jcorpus.sparse_densify_host(jc, rows)
    q = jcorpus.normalize_rows_np(q)
    ws, wi = jcorpus.exact_topk_sparse(jc, q, m, chunk=chunk)
    gs, gi = tcorpus.exact_topk_sparse(tc, q, m, chunk=chunk)
    assert gs.shape == gi.shape == (48, m)
    topk_swaps(ws, wi, gs.numpy(), gi.numpy())
    # each query finds itself first (a twin of it may tie)
    assert np.allclose(gs.numpy()[:, 0], 1.0, atol=1e-5)
