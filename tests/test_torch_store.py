"""Bucket store of `repro_torch.core.store` against `repro.core.store`:
the same insert/expire sequences, bucket overflow included, leave equal
ids, timestamps, write pointers, payloads and generations."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed as jpacked
from repro.core import routing as jrouting
from repro.core import store as jstore
from repro_torch.core import packed as tpacked
from repro_torch.core import routing as trouting
from repro_torch.core import store as tstore


def t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def assert_same(tst, jst):
    for f in ("ids", "timestamps", "write_ptr"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    if jst.payload is None:
        assert tst.payload is None
    else:
        want = np.asarray(jst.payload)
        got = tst.payload.numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want)
    assert int(tst.generation) == int(jst.generation)


def _batches(seed, n_batches=5, n=40, nb=6, T=2, d=3, n_ids=30):
    """Batches over few buckets (capacity overflows), with re-announced
    ids that move buckets, in-batch duplicate ids and skipped rows."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ids = rng.integers(-1, n_ids, size=n).astype(np.int32)
        codes = rng.integers(0, nb, size=(n, T)).astype(np.uint32)
        pay = rng.standard_normal((n, d)).astype(np.float32)
        out.append((ids, codes, pay, b + 1))
    return out


@pytest.mark.parametrize("with_payload", [False, True])
@pytest.mark.parametrize("cap", [2, 5, 64])
def test_insert_expire_sequence_matches_jax(with_payload, cap):
    nb, T, d = 6, 2, 3
    js = jstore.make_store(T, nb, cap, payload_dim=d if with_payload else None)
    ts = tstore.make_store(T, nb, cap, payload_dim=d if with_payload else None,
                           device="cpu")
    for ids, codes, pay, now in _batches(cap):
        jp = jnp.asarray(pay) if with_payload else None
        tp = t(pay) if with_payload else None
        js = jstore.insert_batch(js, jnp.asarray(ids), jnp.asarray(codes),
                                 jnp.int32(now), jp)
        ts_new = tstore.insert_batch(ts, t(ids), t(codes), now, tp)
        assert int(ts.generation) == int(ts_new.generation) - T  # functional
        ts = ts_new
        assert_same(ts, js)
        js = jstore.expire(js, jnp.int32(now), ttl=2)
        ts = tstore.expire(ts, now, ttl=2)
        assert_same(ts, js)


def test_insert_masked_one_table_matches_jax():
    rng = np.random.default_rng(1)
    js = jstore.make_store(2, 4, 3, payload_dim=2)
    ts = tstore.make_store(2, 4, 3, payload_dim=2, device="cpu")
    ids = np.array([5, 5, -1, 2, 9, 9, 9, 1, 3], np.int32)
    b = rng.integers(0, 4, size=ids.shape).astype(np.int32)
    b[:] = 1  # one bucket, overflowing: the last writer of each slot wins
    pay = rng.standard_normal((len(ids), 2)).astype(np.float32)
    js = jstore.insert_masked(js, 1, jnp.asarray(ids), jnp.asarray(b),
                              jnp.int32(4), jnp.asarray(pay))
    ts = tstore.insert_masked(ts, 1, t(ids), t(b), 4, t(pay))
    assert_same(ts, js)


def test_ring_eviction_keeps_last_writers():
    st = tstore.make_store(1, 2, 3, device="cpu")
    st = tstore.insert_batch(st, torch.arange(5, dtype=torch.int32),
                             torch.zeros((5, 1), dtype=torch.int32), 0)
    assert set(st.ids[0, 0].tolist()) == {2, 3, 4}


def test_expire_noop_keeps_generation():
    st = tstore.make_store(1, 4, 4, device="cpu")
    st = tstore.insert_batch(st, torch.arange(3, dtype=torch.int32),
                             torch.zeros((3, 1), dtype=torch.int32), 5)
    g = int(st.generation)
    assert int(tstore.expire(st, 6, ttl=5).generation) == g
    assert int(tstore.expire(st, 20, ttl=5).generation) == g + 1


@pytest.mark.parametrize("cap", [4, 64])
def test_build_store_host_matches_jax_and_insert_batch(cap):
    rng = np.random.default_rng(cap)
    n, T, nb, d = 300, 3, 16, 5
    codes = rng.integers(0, nb, size=(n, T)).astype(np.uint32)
    pay = rng.standard_normal((n, d)).astype(np.float32)
    js = jstore.build_store_host(codes, nb, cap, payload=pay, timestamp=2)
    ts = tstore.build_store_host(codes, nb, cap, payload=pay, timestamp=2,
                                 device="cpu")
    assert_same(ts, js)
    ins = tstore.insert_batch(
        tstore.make_store(T, nb, cap, payload_dim=d, device="cpu"),
        torch.arange(n, dtype=torch.int32), t(codes), 2, t(pay))
    for f in ("ids", "timestamps", "write_ptr", "payload"):
        assert torch.equal(getattr(ins, f), getattr(ts, f)), f


def test_pack_store_payload_matches_jax():
    rng = np.random.default_rng(2)
    n, k, L, nb, d = 200, 6, 3, 64, 8
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    h = rng.standard_normal((L, k, d)).astype(np.float32)
    codes = rng.integers(0, nb, size=(n, L)).astype(np.uint32)
    js = jpacked.pack_store_payload(
        jstore.build_store_host(codes, nb, 8, payload=vecs), jnp.asarray(h))
    ts = tpacked.pack_store_payload(
        tstore.build_store_host(codes, nb, 8, payload=vecs, device="cpu"),
        t(h))
    assert_same(ts, js)
    with pytest.raises(ValueError, match=r"\[L, k, d\]"):
        tpacked.pack_store_payload(ts, t(h)[:, :, :4])


@pytest.mark.parametrize("keys", [[], [0], [0, 0, 1, 1, 1, 4], [3, 3, 3]])
def test_run_ranks_matches_jax(keys):
    k = np.asarray(keys, np.int32)
    np.testing.assert_array_equal(
        trouting.run_ranks(t(k)).numpy(),
        np.asarray(jrouting.run_ranks(jnp.asarray(k))))
