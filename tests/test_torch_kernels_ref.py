"""The PyTorch oracles (`repro_torch.kernels.ref`) and the CPU path of the
kernel wrappers (`repro_torch.kernels.ops`) against the JAX oracles.

Inputs are made with numpy from a seed and handed to both packages;
uint32 codes and words cross as int32 bit patterns.  Integer outputs
must match exactly, dot scores to float tolerance.  The simhash and
bucket_topk wrappers are also held against the JAX Pallas kernels in
interpret mode, which run on this jax.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.hashing import popcount32
from repro_torch.kernels import bucket_topk as tbt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def t(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def u32(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def words(rng, *shape) -> np.ndarray:
    """Random uint32 words; about half have bit 31 set."""
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("n,d,k,L", [(64, 32, 5, 3), (40, 24, 12, 4),
                                     (17, 8, 30, 2)])
def test_simhash_ref_matches_jax(n, d, k, L):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    h = rng.standard_normal((L, k, d)).astype(np.float32)
    want = u32(jref.simhash_ref(jnp.asarray(x), jnp.asarray(h)))
    np.testing.assert_array_equal(u32(tref.simhash_ref(t(x), t(h))), want)
    np.testing.assert_array_equal(u32(tops.simhash(t(x), t(h))), want)
    # the JAX Pallas kernel (interpret mode) agrees too, packed and not
    np.testing.assert_array_equal(
        u32(jops.simhash(jnp.asarray(x), jnp.asarray(h))), want)
    np.testing.assert_array_equal(
        u32(tops.simhash(t(x), t(h), packed=True)),
        u32(jops.simhash(jnp.asarray(x), jnp.asarray(h), packed=True)))


def _bucket_case(seed, b=6, kc=40, d=16, ties=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    cand = rng.standard_normal((b, kc, d)).astype(np.float32)
    if ties:  # equal candidate vectors give exactly equal scores
        cand[:, 1::3] = cand[:, 0:1]
    valid = rng.random((b, kc)) < 0.7
    valid[0] = False  # a row with no valid candidate
    return q, cand, valid


@pytest.mark.parametrize("m", [1, 5, 30])
@pytest.mark.parametrize("ties", [False, True])
def test_bucket_topk_ref_matches_jax(m, ties):
    q, cand, valid = _bucket_case(7, ties=ties)
    ws, wi = jref.bucket_topk_ref(jnp.asarray(q), jnp.asarray(cand),
                                  jnp.asarray(valid), m)
    for got_s, got_i in (
        tref.bucket_topk_ref(t(q), t(cand), t(valid), m),
        tops.bucket_topk(t(q), t(cand), t(valid), m),
    ):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(wi))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(ws), atol=1e-6)
    ks, ki = jops.bucket_topk(jnp.asarray(q), jnp.asarray(cand),
                              jnp.asarray(valid), m)
    np.testing.assert_array_equal(np.asarray(ki), np.asarray(wi))
    assert np.all(np.asarray(wi)[0] == -1)


@pytest.mark.parametrize("kc", [1, 31, 32, 33, 70])
def test_validity_words_round_trip(kc):
    rng = np.random.default_rng(kc)
    valid = torch.from_numpy(rng.random((3, kc)) < 0.5)
    valid[0] = True  # every bit of the first word, bit 31 included
    vw = tbt.pack_valid(valid)
    assert vw.dtype == torch.int32 and vw.shape == (3, -(-kc // 32))
    np.testing.assert_array_equal(tbt.unpack_valid(vw, kc).numpy(),
                                  valid.numpy())
    want = jops._pack_bits(jnp.asarray(
        np.pad(valid.numpy(), ((0, 0), (0, (-kc) % 32)))))
    np.testing.assert_array_equal(u32(vw), np.asarray(want))


def test_popcount_on_words_with_bit_31():
    rng = np.random.default_rng(3)
    w = words(rng, 256)
    w[:4] = [0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0]
    want = np.array([bin(int(v)).count("1") for v in w])
    np.testing.assert_array_equal(popcount32(t(w)).numpy(), want)


def test_hamming_ref_matches_jax():
    rng = np.random.default_rng(4)
    codes, cand = words(rng, 9), words(rng, 9, 13)
    want = np.asarray(jref.hamming_ref(jnp.asarray(codes), jnp.asarray(cand)))
    np.testing.assert_array_equal(tref.hamming_ref(t(codes), t(cand)).numpy(),
                                  want)


@pytest.mark.parametrize("w", [1, 2, 5])
def test_hamming_words_ref_matches_jax(w):
    rng = np.random.default_rng(5 + w)
    codes, cand = words(rng, 7, w), words(rng, 7, 11, w)
    want = np.asarray(jref.hamming_words_ref(jnp.asarray(codes),
                                             jnp.asarray(cand)))
    got = tref.hamming_words_ref(t(codes), t(cand))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _fused_case(seed, score, rows=12, nb=10, c=8, p=3, dw=6):
    """A flat store with a duplicate id across probe rows, empty slots,
    rows with no valid probe and an exclude id that is present."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 25, size=(nb, c)).astype(np.int32)
    ids[3, :] = -1
    ids[1, 0] = ids[2, 5] = 7  # id 7 in two buckets, different payloads
    if score == "dot":
        pay = rng.standard_normal((nb, c, dw)).astype(np.float32)
        q = rng.standard_normal((rows, dw)).astype(np.float32)
    else:
        pay = words(rng, nb, c, 2)
        q = words(rng, rows, 2)
    fb = rng.integers(0, nb, size=(rows, p)).astype(np.int32)
    fb[0] = [1, 2, 3]
    pw = rng.integers(0, 1 << p, size=rows).astype(np.int32)
    pw[0], pw[1] = (1 << p) - 1, 0
    excl = np.where(rng.random(rows) < 0.5, ids[fb[:, 0], 1], -1)
    meta = np.stack([pw, excl.astype(np.int32)], axis=1)
    return ids, pay, q, fb, meta


@pytest.mark.parametrize("score", ["dot", "hamming"])
@pytest.mark.parametrize("m", [3, 40])
def test_fused_query_ref_matches_jax(score, m):
    ids, pay, q, fb, meta = _fused_case(11, score)
    wi, ws = jref.fused_query_ref(
        jnp.asarray(ids), jnp.asarray(pay), jnp.asarray(q), jnp.asarray(fb),
        jnp.asarray(meta), m=m, score=score)
    for gi, gs in (
        tref.fused_query_ref(t(ids), t(pay), t(q), t(fb), t(meta), m=m,
                             score=score),
        tops.fused_query(t(ids), t(pay), t(q), t(fb), t(meta), m=m,
                         score=score),
    ):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        if score == "hamming":
            np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        else:
            np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-6)
    assert np.all(np.asarray(wi)[1] == -1)  # probe word 0: nothing valid


def test_fused_contains_ref_matches_jax():
    ids, _, _, fb, meta = _fused_case(12, "dot", rows=40)
    meta[:, 1] = np.where(np.arange(40) % 2, ids[fb[:, 1], 2], 7)
    want = np.asarray(jref.fused_contains_ref(
        jnp.asarray(ids), jnp.asarray(fb), jnp.asarray(meta)))
    got = tref.fused_contains_ref(t(ids), t(fb), t(meta))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.fused_contains(t(ids), t(fb), t(meta)).numpy(), want[:, 0] > 0)


def test_wrappers_reject_malformed_inputs():
    ids, pay, q, fb, meta = _fused_case(13, "dot")
    with pytest.raises(TypeError):
        tops.fused_query(t(ids), t(pay), t(q), t(fb), t(meta), m=2,
                         score="hamming")
    with pytest.raises(ValueError):
        tops.fused_query(t(ids), t(pay), t(q)[:, :3], t(fb), t(meta), m=2)
    with pytest.raises(ValueError):
        tops.fused_contains(t(ids), torch.zeros((2, 32), dtype=torch.int32),
                            torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.simhash(torch.zeros(4, 8), torch.zeros(2, 3, 9))
