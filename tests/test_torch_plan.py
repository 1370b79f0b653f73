"""Hashing, packing, multiprobe, CAN coordinates and the probe planner of
`repro_torch.core` against `repro.core`, on the goldens world
(tests/goldens/make_goldens.py: N=1200, D=32, k=5, L=3) and on random
codes.  Codes and words compare as uint32 bit patterns.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import can as jcan
from repro.core import hashing as jhash
from repro.core import multiprobe as jmp
from repro.core import packed as jpacked
from repro.core import plan as jplan
from repro_torch.core import can as tcan
from repro_torch.core import hashing as thash
from repro_torch.core import multiprobe as tmp
from repro_torch.core import packed as tpacked
from repro_torch.core import plan as tplan

N, D, K, L, NQ = 1200, 32, 5, 3, 48
PROBE_CELLS = [
    ("full", dict()),
    ("p2", dict(num_probes=2)),
    ("ranked3", dict(num_probes=3, ranked_probes=True)),
]


def u32(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def goldens_prng():
    """The PRNG mode the goldens' hyperplanes were drawn in: threefry
    not partitionable (the default before jax 0.5)."""
    mode = getattr(jax, "threefry_partitionable", None)
    return contextlib.nullcontext() if mode is None else mode(False)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    params = jhash.LshParams(d=D, k=K, L=L, seed=23)
    # the PRNG mode the goldens were drawn in
    with goldens_prng():
        h = np.asarray(jhash.make_hyperplanes(params))
    return vecs[:NQ], h


@pytest.mark.parametrize("n_nodes", [1, 4, 1 << K])
@pytest.mark.parametrize("cell,pkw", PROBE_CELLS, ids=[c for c, _ in PROBE_CELLS])
@pytest.mark.parametrize("variant", ["lsh", "nb", "cnb"])
def test_plan_fields_match_jax(world, variant, cell, pkw, n_nodes):
    q, h = world
    jspec = jplan.ProbeSpec(jhash.LshParams(d=D, k=K, L=L, seed=23),
                            variant, **pkw)
    tspec = tplan.ProbeSpec(thash.LshParams(d=D, k=K, L=L, seed=23),
                            variant, **pkw)
    want = jplan.make_plan(jspec, jnp.asarray(q), jnp.asarray(h),
                           jcan.CanTopology(K, n_nodes))
    got = tplan.make_plan(tspec, t(q), t(h), tcan.CanTopology(K, n_nodes))
    for field in ("codes", "probes", "probe_mask", "owner", "local_idx"):
        g = getattr(got, field)
        assert g.dtype == torch.int32, field
        np.testing.assert_array_equal(u32(g), u32(getattr(want, field)),
                                      err_msg=field)
    assert tspec.probes_per_table == jspec.probes_per_table


@pytest.mark.parametrize("n_nodes", [1, 2, 8])
def test_shard_local_probes_match_jax(n_nodes):
    rng = np.random.default_rng(n_nodes)
    local = rng.integers(0, (1 << K) // n_nodes, size=(20,)).astype(np.int32)
    mask = rng.integers(0, 1 << K, size=(20,)).astype(np.int32)
    jt, tt = jcan.CanTopology(K, n_nodes), tcan.CanTopology(K, n_nodes)
    for near in (False, True):
        wb, wv = jplan.shard_local_probes(jt, jnp.asarray(local),
                                          jnp.asarray(mask), include_near=near)
        gb, gv = tplan.shard_local_probes(tt, t(local), t(mask),
                                          include_near=near)
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    for bit in range(tt.node_bits):
        np.testing.assert_array_equal(
            tplan.node_bit_probe_valid(tt, t(mask), bit).numpy(),
            np.asarray(jplan.node_bit_probe_valid(jt, jnp.asarray(mask), bit)))


def test_sketch_and_margins_match_jax(world):
    q, h = world
    np.testing.assert_array_equal(
        u32(thash.sketch_codes(t(q), t(h))),
        u32(jhash.sketch_codes(jnp.asarray(q), jnp.asarray(h))))
    np.testing.assert_allclose(
        thash.projection_margins(t(q), t(h)).numpy(),
        np.asarray(jhash.projection_margins(jnp.asarray(q), jnp.asarray(h))),
        atol=1e-6)
    np.testing.assert_array_equal(
        u32(tplan.sketch(t(q), t(h), use_kernels=True)),
        u32(jplan.sketch(jnp.asarray(q), jnp.asarray(h))))


@pytest.mark.parametrize("k", [1, 12, 30])
def test_bits_and_near_codes_match_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << k, size=(6, 3)).astype(np.uint32)
    bits = thash.unpack_bits(t(codes), k)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jhash.unpack_bits(jnp.asarray(codes), k)))
    np.testing.assert_array_equal(u32(thash.pack_bits(bits)), codes)
    np.testing.assert_array_equal(
        u32(tmp.near_codes(t(codes), k)),
        u32(jmp.near_codes(jnp.asarray(codes), k)))
    np.testing.assert_array_equal(
        u32(tmp.probe_codes(t(codes), k)),
        u32(jmp.probe_codes(jnp.asarray(codes), k)))


@pytest.mark.parametrize("k,L", [(5, 3), (12, 4), (30, 1), (30, 5), (7, 9)])
def test_packed_round_trip_matches_jax(k, L):
    rng = np.random.default_rng(k * L)
    codes = rng.integers(0, 1 << k, size=(16, L)).astype(np.uint32)
    codes[0] = (1 << k) - 1  # all bits: the top packed bit is bit 31
    got = tpacked.pack_codes(t(codes), k)
    assert got.shape[-1] == tpacked.num_words(k, L) == jpacked.num_words(k, L)
    np.testing.assert_array_equal(
        u32(got), u32(jpacked.pack_codes(jnp.asarray(codes), k)))
    np.testing.assert_array_equal(u32(tpacked.unpack_codes(got, k, L)), codes)
    other = tpacked.pack_codes(t(codes[::-1].copy()), k)
    np.testing.assert_array_equal(
        tpacked.hamming_words(got, other).numpy(),
        np.asarray(jpacked.hamming_words(jnp.asarray(u32(got)),
                                         jnp.asarray(u32(other)))))


@pytest.mark.parametrize("k", [0, 31])
def test_packed_rejects_k_out_of_range(k):
    codes = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="k in"):
        tpacked.num_words(k, 3)
    with pytest.raises(ValueError, match="k in"):
        tpacked.pack_codes(codes, k)
    with pytest.raises(ValueError, match="k in"):
        tpacked.unpack_codes(codes, k, 3)
    with pytest.raises(ValueError):
        thash.LshParams(d=4, k=k, L=2)


def test_can_coordinates_match_jax():
    codes = np.arange(0, 1 << 8, 7, dtype=np.uint32)
    for n in (1, 2, 16):
        jt, tt = jcan.CanTopology(8, n), tcan.CanTopology(8, n)
        np.testing.assert_array_equal(u32(tt.node_of(t(codes))),
                                      u32(jt.node_of(codes)))
        np.testing.assert_array_equal(u32(tt.local_of(t(codes))),
                                      u32(jt.local_of(codes)))
        np.testing.assert_array_equal(tt.node_of_np(codes), jt.node_of_np(codes))
        np.testing.assert_array_equal(tt.local_of_np(codes),
                                      jt.local_of_np(codes))
    with pytest.raises(ValueError):
        tcan.CanTopology(4, 3)


def test_probe_spec_validates():
    p = thash.LshParams(d=4, k=5, L=2)
    with pytest.raises(ValueError):
        tplan.ProbeSpec(p, "bogus")
    with pytest.raises(ValueError):
        tplan.ProbeSpec(p, "cnb", num_probes=-1)
    assert tplan.ProbeSpec(p, "lsh").probes_per_table == 1
    assert tplan.ProbeSpec(p, "cnb", num_probes=9).probes_per_table == 6


def test_make_hyperplanes_seeded_and_device_rule():
    p = thash.LshParams(d=6, k=4, L=2, seed=5)
    a = thash.make_hyperplanes(p, device="cpu")
    b = thash.make_hyperplanes(p, torch.Generator().manual_seed(5),
                               device="cpu")
    assert a.shape == (2, 4, 6) and torch.equal(a, b)
    if torch.cuda.is_available():
        pytest.skip("the no-card rule needs a host without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thash.make_hyperplanes(p)
