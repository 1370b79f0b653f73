"""The port's metrics, closed forms, Layered-LSH and the rest of hashing /
multiprobe against the JAX package.

`metrics` and `analysis` are numpy in both packages, so they agree
exactly.  `layered` takes its bit selection from numpy's generator and
so selects the same bits; its node codes equal JAX's on the same codes,
and the port holds Sec. 5.2's equivalence itself (the port's
`test_engine.py::test_layered_equivalence`).  `hamming_distance`,
`b_near_codes_host` and `probe_plan_size` agree exactly,
`collision_probability` to float tolerance, and `sketch_codes_batched`
equals the plain sketch on the CPU for dense and sparse input.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analysis as janalysis
from repro.core import hashing as jhashing
from repro.core import layered as jlayered
from repro.core import metrics as jmetrics
from repro.core import multiprobe as jmultiprobe
from repro_torch import convert
from repro_torch.core import analysis, hashing, layered, metrics, multiprobe
from repro_torch.core.hashing import LshParams
from repro_torch.data import osn

S = np.linspace(0.5, 1.0, 41)
T = np.linspace(-1.0, 1.0, 41)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    nq, m = 30, 10
    ideal = rng.integers(-1, 60, size=(nq, m))
    approx = rng.integers(-1, 60, size=(nq, m))
    approx[:5] = ideal[:5]
    ideal[7] = -1  # a query with no ideal result
    assert metrics.recall_at_m(approx, ideal) == jmetrics.recall_at_m(
        approx, ideal)
    sa = rng.random((nq, m)).astype(np.float32)
    si = rng.random((nq, m)).astype(np.float32)
    sa[3, 4:] = -np.inf  # missing results
    assert metrics.ncs_at_m(sa, si) == jmetrics.ncs_at_m(sa, si)
    found = rng.random(200) < 0.6
    sims = rng.random(200) ** 0.5
    for got, want in zip(
            metrics.success_probability_by_interval(found, sims, 10),
            jmetrics.success_probability_by_interval(found, sims, 10)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,L", [(6, 4), (11, 4), (12, 10)])
def test_analysis_closed_forms_equal_jax(k, L):
    for name in ("sp_lsh", "sp_layered", "sp_nearbucket",
                 "sp_nearbucket_b2"):
        np.testing.assert_array_equal(getattr(analysis, name)(S, k, L),
                                      getattr(janalysis, name)(S, k, L))
    np.testing.assert_array_equal(analysis.sp_nearbucket(S, k, L, 3),
                                  janalysis.sp_nearbucket(S, k, L, 3))
    np.testing.assert_array_equal(analysis.sp_exact_bucket(S, k),
                                  janalysis.sp_exact_bucket(S, k))
    for b in (0, 1, 2):
        np.testing.assert_array_equal(analysis.sp_b_near_bucket(S, k, b),
                                      janalysis.sp_b_near_bucket(S, k, b))
        np.testing.assert_array_equal(analysis.near_dominates(S, k, b, b + 1),
                                      janalysis.near_dominates(S, k, b, b + 1))
    np.testing.assert_array_equal(analysis.angular_from_cosine(T),
                                  janalysis.angular_from_cosine(T))
    np.testing.assert_array_equal(analysis.cosine_from_angular(S),
                                  janalysis.cosine_from_angular(S))
    for alg in ("lsh", "layered", "nb", "cnb"):
        for got, want in zip(analysis.sp_curve(alg, k, L),
                             janalysis.sp_curve(alg, k, L)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        analysis.sp_curve("flood", k, L)


@pytest.mark.parametrize("k_node,seed", [(4, 3), (6, 17), (11, 5)])
def test_layered_matches_jax(k_node, seed):
    jparams = jhashing.LshParams(d=32, k=11, L=4, seed=0)
    params = LshParams(d=32, k=11, L=4, seed=0)
    jlp = jlayered.LayeredParams(inner=jparams, k_node=k_node, seed=seed)
    lp = layered.LayeredParams(inner=params, k_node=k_node, seed=seed)
    sel = layered.make_bit_selection(lp)
    np.testing.assert_array_equal(sel, jlayered.make_bit_selection(jlp))
    codes = np.random.default_rng(seed).integers(0, 1 << 11, size=(50, 4),
                                                 dtype=np.uint32)
    want = np.asarray(jlayered.node_codes(jnp.asarray(codes), sel))
    got = layered.node_codes(torch.from_numpy(codes.view(np.int32)), sel)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    jh = jhashing.make_hyperplanes(jparams)
    h = convert.hyperplanes_from(jh, device="cpu")
    np.testing.assert_array_equal(
        layered.equivalent_hyperplanes(lp, h, sel).numpy(),
        np.asarray(jlayered.equivalent_hyperplanes(jlp, jh, sel)))
    with pytest.raises(ValueError):
        layered.LayeredParams(inner=params, k_node=12)


def test_layered_equivalence():
    """Sec. 5.2: Hamming-LSH over cosine sketches == cosine-LSH(k_node)."""
    params = LshParams(d=32, k=5, L=3, seed=23)
    h = hashing.make_hyperplanes(params, device="cpu")
    q = hashing.normalize(torch.randn((64, 32),
                                      generator=torch.Generator().manual_seed(1)))
    lp = layered.LayeredParams(inner=params, k_node=4, seed=3)
    sel = layered.make_bit_selection(lp)
    node_of = layered.layered_node_of(q, lp, h, sel)
    h_eq = layered.equivalent_hyperplanes(lp, h, sel)
    direct = hashing.sketch_codes(q, h_eq)
    assert torch.equal(node_of, direct)


def test_hamming_distance_and_collision_probability_match_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**32, size=100, dtype=np.uint32)
    b = rng.integers(0, 2**32, size=100, dtype=np.uint32)
    want = np.asarray(jhashing.hamming_distance(jnp.asarray(a),
                                                jnp.asarray(b)))
    got = hashing.hamming_distance(torch.from_numpy(a.view(np.int32)),
                                   torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    u = rng.standard_normal((20, 16)).astype(np.float32)
    v = rng.standard_normal((20, 16)).astype(np.float32)
    v[0] = 2.0 * u[0]  # parallel: probability 1
    want = np.asarray(jhashing.collision_probability(jnp.asarray(u),
                                                     jnp.asarray(v)))
    got = hashing.collision_probability(torch.from_numpy(u),
                                        torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert abs(float(got[0]) - 1.0) < 1e-3


@pytest.mark.parametrize("k,b", [(6, 1), (6, 2), (11, 2), (12, 3)])
def test_b_near_codes_host_equals_jax(k, b):
    for code in (0, 5, (1 << k) - 1):
        got = multiprobe.b_near_codes_host(code, k, b)
        want = jmultiprobe.b_near_codes_host(code, k, b)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["lsh", "layered", "nb", "cnb"])
def test_probe_plan_size_equals_jax(variant):
    for k, L, p in ((6, 4, None), (11, 4, None), (12, 10, 3), (12, 2, 0)):
        assert multiprobe.probe_plan_size(k, L, variant, p) == \
            jmultiprobe.probe_plan_size(k, L, variant, p)


def test_sketch_codes_batched_equals_the_plain_sketch():
    """Dense input in chunks, and a sparse corpus densified in chunks,
    both equal the one-shot plain sketch (the CPU path of `ops.simhash`),
    and JAX's batched sketch on the same hyperplanes."""
    corpus = osn.generate(osn.tiny_spec(), device="cpu")
    params = LshParams(d=corpus.d, k=6, L=4, seed=13)
    h = hashing.make_hyperplanes(params, device="cpu")
    dense = corpus.densify(torch.arange(corpus.n))
    want = hashing.sketch_codes(dense, h)
    for x, batch in ((dense, 300), (dense, 65536), (corpus, 512)):
        got = hashing.sketch_codes_batched(x, h, batch=batch)
        assert got.dtype == torch.int32 and got.shape == (corpus.n, 4)
        assert torch.equal(got, want)
    jwant = jhashing.sketch_codes_batched(jnp.asarray(dense.numpy()),
                                          jnp.asarray(h.numpy()), batch=700)
    np.testing.assert_array_equal(want.numpy().view(np.uint32), jwant)
