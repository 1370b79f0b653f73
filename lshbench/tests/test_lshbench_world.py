"""The OSN world: the frozen generator's statistics on a small corpus,
its determinism in the seed, and the dense query rows the program
gets."""

import numpy as np
import pytest
import torch

from lshbench import spec, traffic
from tiny import tiny_config

OSN = spec.world("osn")


@pytest.fixture(scope="module")
def world():
    cfg = tiny_config("lj1m-1node-sparse")
    return cfg, OSN.make_inputs(cfg, 2_147_483_659, "cpu")


def test_rows_are_sparse_unique_and_unit(world):
    cfg, inp = world
    c = cfg["corpus"]
    ids, vals = inp.ids.long(), inp.vals
    assert ids.shape == (cfg["users"], c["nnz_max"])
    live = ids >= 0
    assert ((vals == 0) | live).all() and (vals[live] > 0).all()
    assert (live.sum(1) >= 2).all() and (ids < c["interests"]).all()
    # live ids first, none repeated in a row
    assert (live[:, :-1] | ~live[:, 1:]).all()
    s = ids.masked_fill(~live, -1).sort(1).values
    assert not ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any()
    assert torch.allclose(vals.norm(dim=1), torch.ones(len(vals)),
                          atol=1e-6)
    mean = live.sum(1).float().mean()
    assert 12 < mean < 20, mean


def test_interests_and_buckets_are_skewed(world):
    cfg, inp = world
    ids = inp.ids.long()
    freq = torch.bincount(ids[ids >= 0], minlength=inp.d).float()
    # popular interests: the most held is held far above the mean
    assert freq.max() > 2 * freq.mean()
    ref = OSN.reference(cfg, inp)
    assert ref.load.max() > 3 * ref.load.double().mean()
    # near-duplicate users
    dup = np.unique(inp.ids.numpy(), axis=0).shape[0]
    assert dup < cfg["users"]


def test_the_seed_fixes_the_world(world):
    cfg, inp = world
    again = OSN.make_inputs(cfg, 2_147_483_659, "cpu")
    assert torch.equal(again.ids, inp.ids) and torch.equal(again.vals,
                                                             inp.vals)
    assert torch.equal(again.h, inp.h)
    other = OSN.make_inputs(cfg, 7, "cpu")
    assert not torch.equal(other.ids, inp.ids)


def test_no_user_lies_on_a_hyperplane(world):
    _, inp = world
    assert not OSN.near_plane(inp.ids, inp.vals, inp.h).any()


def test_query_rows_are_the_users_dense_rows(world):
    cfg, inp = world
    ref = OSN.reference(cfg, inp)
    rows = OSN.QueryRows(inp)
    for seed in (1, 2):             # the buffer is reused between batches
        u = traffic.users({"order": "uniform"}, seed, inp.n, 16)
        got = rows(u)
        want = ref.dense(torch.from_numpy(u), torch.float32).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("order", ["permutation", "uniform", "zipf"])
def test_traffic_orders(order):
    mix = {"order": order, "pool": 50, "zipf_s": 1.0}
    u = traffic.users(mix, 3, 1000, 3000)
    assert u.shape == (3000,) and u.min() >= 0 and u.max() < 1000
    assert np.array_equal(u, traffic.users(mix, 3, 1000, 3000))
    if order == "permutation":
        assert np.array_equal(np.sort(u[:1000]), np.arange(1000))
    if order == "zipf":
        assert len(np.unique(u)) <= 50


def _stats(ids: np.ndarray, d: int) -> dict:
    live = ids >= 0
    freq = np.bincount(ids[live], minlength=d)
    rows = [tuple(sorted(r[r >= 0])) for r in ids]
    return dict(nnz=live.sum(1).mean(), top=freq.max() / freq.mean(),
                dup=1 - len(set(rows)) / len(rows))


def test_the_copy_draws_as_the_programs_generator_does():
    """The frozen copy against `repro_torch.data.osn.generate` (users
    drawn one by one on the host) at the same parameters."""
    from repro_torch.data.osn import OsnSpec, generate

    cfg = dict(tiny_config("lj1m-1node-sparse"), users=4000)
    c = cfg["corpus"]
    ours = OSN.make_inputs(cfg, 5, "cpu").ids.numpy()
    theirs = generate(OsnSpec(
        "copy", 4000, c["interests"], c["communities"],
        c["interests_per_user"], c["communities_per_user"], c["nnz_max"],
        k=cfg["k"], seed=5, twin_fraction=c["twin_fraction"]),
        device="cpu").nnz_ids
    a, b = _stats(ours, c["interests"]), _stats(theirs.numpy(),
                                                c["interests"])
    assert abs(a["nnz"] - b["nnz"]) < 0.05 * b["nnz"], (a, b)
    assert 0.67 < a["top"] / b["top"] < 1.5, (a, b)
    assert 0.5 < a["dup"] / b["dup"] < 2.0, (a, b)


def test_device_rows_are_the_users_dense_rows(world):
    cfg, inp = world
    ref = OSN.reference(cfg, inp)
    rows = OSN.DeviceRows(inp)
    for seed in (1, 2):             # the buffer is reused between batches
        u = torch.from_numpy(traffic.users({"order": "uniform"}, seed,
                                           inp.n, 16))
        assert torch.equal(rows(u), ref.dense(u, torch.float32))
