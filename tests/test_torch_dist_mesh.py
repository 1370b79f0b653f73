"""The process mesh: `repro_torch`'s mesh runtime over `torch.distributed`,
one process a block of CAN nodes, run here in gloo ranks spawned with
`torch.multiprocessing` (tests/torch_dist_worker.py).

Held, bit for bit (ids, scores of both kinds, contains hits, every
`StepStats` field, the store and cache zones each rank holds):

  * every rank's outputs against the one-process `ZoneMesh` at the same
    n and data rows, on the world of the reference's 8-device EQUIV test
    (tests/test_distributed.py: N 3000, D 64, k 5, L 3, m 10, 64
    queries, capacity 512): lsh / nb / cnb x alltoall / allgather x dot
    / hamming, the probe-budget cells, a tiny `cap_factor` with its
    drops, and insert -> payload sync -> expire -> refresh -> search, in
    three layouts: 2 ranks of 2 nodes, 4 ranks of 1 node, and 2 data
    rows of 2 ranks of 2 nodes;
  * the last layout against JAX's 8-device 2 x 4 mesh on the same world
    (ids, hamming scores, hits and stats exactly; dot scores to 1e-6,
    the rule of tests/test_torch_mesh.py for JAX's floats);
  * 2 ranks of one node against the `runtime_2node_v1.npz` /
    `runtime_2node_packed_v1.npz` goldens, staged and fused: ids, hits
    and hamming scores exactly, dot scores to 1e-6 (the goldens hold
    JAX's floats; the one-process mesh is held to them the same way);
  * `BlockCollectives` against `MeshCollectives` on random tensors at
    worlds 2 and 4, for every method;
  * the mesh helpers, `kill_node` and `reshard` on one node a rank, and
    the example `examples/torch_distributed_search.py` under torchrun
    with 2 gloo ranks against the one-process mesh.

The goldens' and EQUIV's hyperplanes are drawn with JAX's
`threefry_partitionable` off, the mode the goldens were drawn in.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
from conftest import run_in_subprocess

from repro.core import LshParams as JParams
from repro.core import make_hyperplanes as j_make_hyperplanes
from repro.core import packed as jpacked
from repro.core.hashing import sketch_codes_batched
from repro.core.store import build_store_host as j_build_store_host
from repro_torch import convert
from repro_torch.core.runtime import MeshCollectives
from repro_torch.launch import mesh as mesh_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

LAYOUTS = {
    "w2-n4": dict(world=2, n=4, data=1),
    "w4-n4": dict(world=4, n=4, data=1),
    "w4-d2-n4": dict(world=4, n=4, data=2),
}
MAIN = [name for name in worker.CELLS if name.count("-") == 2
        and not name.startswith(("chain", "cnb-tiny"))]


def goldens_prng():
    mode = getattr(jax, "threefry_partitionable", None)
    return contextlib.nullcontext() if mode is None else mode(False)


def save_world(path, params, h, jst, q, targets, moved, m):
    """The world as the ranks load it (`worker.load_world`)."""
    arrays = dict(params=np.asarray([params.d, params.k, params.L,
                                     params.seed]),
                  h=np.asarray(h), q=q, targets=targets, moved=moved,
                  m=np.asarray(m))
    for tag, js in (("dot_", jst), ("ham_", jpacked.pack_store_payload(jst,
                                                                       h))):
        st = convert.store_from(js, device="cpu")
        arrays.update({tag + "ids": st.ids.numpy(),
                       tag + "ts": st.timestamps.numpy(),
                       tag + "ptr": st.write_ptr.numpy(),
                       tag + "payload": st.payload.numpy(),
                       tag + "gen": st.generation.numpy()})
    np.savez(path, **arrays)
    return str(path)


@pytest.fixture(scope="module")
def equiv(tmp_path_factory):
    """The reference's EQUIV world (tests/test_distributed.py)."""
    rng = np.random.default_rng(0)
    N, D, k, L = 3000, 64, 5, 3
    params = JParams(d=D, k=k, L=L, seed=3)
    with goldens_prng():
        h = j_make_hyperplanes(params)
    vecs = np.abs(rng.standard_normal((N, D))).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    jst = j_build_store_host(sketch_codes_batched(jnp.asarray(vecs), h),
                             params.num_buckets, capacity=512, payload=vecs)
    q = vecs[rng.choice(N, 64, replace=False)]
    targets = rng.integers(0, N, size=64).astype(np.int32)
    path = save_world(tmp_path_factory.mktemp("equiv") / "world.npz", params,
                      h, jst, q, targets, np.roll(vecs, 1, axis=0), 10)
    return dict(path=path, w=worker.load_world(path), h=np.asarray(h))


@pytest.fixture(scope="module")
def golden_world(tmp_path_factory):
    """tests/test_torch_mesh.py's goldens world, with the goldens'
    targets."""
    g = dict(np.load(os.path.join(HERE, "goldens", "runtime_2node_v1.npz")))
    rng = np.random.default_rng(17)
    N, D, k, L, NQ = 1200, 32, 5, 3, 48
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    params = JParams(d=D, k=k, L=L, seed=23)
    with goldens_prng():
        h = j_make_hyperplanes(params)
    jst = j_build_store_host(sketch_codes_batched(jnp.asarray(vecs), h),
                             params.num_buckets, capacity=64, payload=vecs)
    path = save_world(tmp_path_factory.mktemp("golden") / "world.npz",
                      params, h, jst, vecs[:NQ], g["targets"],
                      np.roll(vecs, 1, axis=0), 10)
    return dict(path=path, w=worker.load_world(path))


class Runs:
    """Each spawn once per module, on first use."""

    def __init__(self, tmp_path_factory):
        self.tmp = tmp_path_factory
        self.done = {}

    def get(self, key, job, world, **kw):
        if key not in self.done:
            out = str(self.tmp.mktemp(key))
            self.done[key] = worker.spawn(job, world, out, **kw)
        return self.done[key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return Runs(tmp_path_factory)


@pytest.fixture(scope="module")
def one_process():
    """The one-process mesh's outputs per (world, n, data, cell)."""
    cache = {}

    def get(w, n, data, name, cells=worker.CELLS):
        key = (id(w), n, data, name)
        if key not in cache:
            mesh = mesh_mod.make_zone_mesh(n, data, device="cpu")
            cache[key] = worker.run_cell(mesh, w, cells[name])
        return cache[key]

    return get


def layout_runs(runs, equiv, layout):
    lay = LAYOUTS[layout]
    return runs.get(layout, "cells", lay["world"], world_npz=equiv["path"],
                    n=lay["n"], data=lay["data"])


def assert_rank_equals(rank_out, want, name, nb):
    """Rank outputs of one cell equal the one-process ones; the store and
    cache keys are compared on the zones the rank holds."""
    row, block, n_loc = (int(v) for v in rank_out["block"])
    for key, val in want.items():
        got = rank_out[f"{name}/{key}"]
        if key.startswith(("store_", "cache_")) and key != "store_gen":
            w = nb * n_loc
            axis = 2 if key.startswith("cache_") else 1
            val = np.take(val, np.arange(block * w, (block + 1) * w),
                          axis=axis)
        assert got.dtype == val.dtype, (name, key)
        np.testing.assert_array_equal(got, val, err_msg=f"{name}/{key}")


# -- the process mesh equals the one-process mesh ------------------------


@pytest.mark.parametrize("name", list(worker.CELLS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_process_mesh_equals_one_process(runs, equiv, one_process, layout,
                                         name):
    lay = LAYOUTS[layout]
    ranks = layout_runs(runs, equiv, layout)
    want = one_process(equiv["w"], lay["n"], lay["data"], name)
    nb = (1 << equiv["w"]["params"].k) // lay["n"]
    for rank_out in ranks:
        assert_rank_equals(rank_out, want, name, nb)
    if name == "cnb-tinycap":  # the drops are real and counted alike
        assert want["stats"][0] > 0
        assert want["stats"][0] == want["stats"][len(worker.STATS):].sum()


@pytest.mark.parametrize("name", list(worker.GOLDEN_CELLS))
def test_two_ranks_match_goldens(runs, golden_world, one_process, name):
    spec = worker.GOLDEN_CELLS[name]
    ranks = runs.get("golden", "cells", 2, world_npz=golden_world["path"],
                     n=2, golden=True)
    variant, score = spec["variant"], spec["score"]
    g = dict(np.load(os.path.join(
        HERE, "goldens", "runtime_2node_packed_v1.npz" if score == "hamming"
        else "runtime_2node_v1.npz")))
    want = one_process(golden_world["w"], 2, 1, name, worker.GOLDEN_CELLS)
    for rank_out in ranks:
        assert_rank_equals(rank_out, want, name, 16)
        assert rank_out[f"{name}/stats"][0] == 0
        np.testing.assert_array_equal(rank_out[f"{name}/ids"],
                                      g[f"search_ids_{variant}"])
        got, want_s = rank_out[f"{name}/scores"], g[f"search_scores_{variant}"]
        if score == "hamming":
            np.testing.assert_array_equal(got, want_s)
        else:  # JAX's floats, under tests/test_torch_mesh.py's rule
            np.testing.assert_allclose(got, want_s, atol=1e-6)
        np.testing.assert_array_equal(rank_out[f"{name}/hits"],
                                      g[f"contains_{variant}"])


# -- the 2 x 2 x 2 layout against JAX's 8-device 2 x 4 mesh ---------------


REF8 = """
import contextlib, numpy as np, jax, jax.numpy as jnp
from repro.core import LshParams, make_hyperplanes, packed
from repro.core.hashing import sketch_codes_batched
from repro.core.runtime import IndexRuntime, RuntimeConfig
from repro.core.store import build_store_host
from repro.launch.mesh import make_zone_mesh

rng = np.random.default_rng(0)
N, D, k, L, m = 3000, 64, 5, 3, 10
params = LshParams(d=D, k=k, L=L, seed=3)
mode = getattr(jax, "threefry_partitionable", None)
with contextlib.nullcontext() if mode is None else mode(False):
    h = make_hyperplanes(params)
vecs = np.abs(rng.standard_normal((N, D))).astype(np.float32)
vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
store = build_store_host(sketch_codes_batched(jnp.asarray(vecs), h),
                         params.num_buckets, capacity=512, payload=vecs)
q = vecs[rng.choice(N, 64, replace=False)]
targets = rng.integers(0, N, size=64).astype(np.int32)
stores = dict(dot=store, hamming=packed.pack_store_payload(store, h))
mesh = make_zone_mesh(4, data=2)
out = dict(h=np.asarray(h))

def stats(s):
    d = s.host()
    return np.asarray([d[f] for f in STATS] + list(d["dropped_by_dest"]))

for name, (variant, routing, score) in CELLS.items():
    rt = IndexRuntime(RuntimeConfig(params=params, n_nodes=4, m=m,
                                    variant=variant, routing=routing,
                                    score=score, cap_factor=3.0), mesh=mesh)
    st = rt.shard_store(stores[score])
    cache = rt.refresh_cache(st) if variant == "cnb" else None
    ids, sc, s = rt.search(h, st, q, cache=cache)
    hits, hs = rt.contains(h, st, q, targets, cache=cache)
    out.update({name + "/ids": np.asarray(ids),
                name + "/scores": np.asarray(sc),
                name + "/stats": stats(s), name + "/hits": np.asarray(hits),
                name + "/hstats": stats(hs)})
np.savez(OUT, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax8") / "ref.npz")
    cells = {name: (worker.CELLS[name]["variant"],
                    worker.CELLS[name]["routing"],
                    worker.CELLS[name]["score"]) for name in MAIN}
    code = (f"OUT = {path!r}\nSTATS = {worker.STATS!r}\nCELLS = {cells!r}\n"
            + REF8)
    assert "ok" in run_in_subprocess(code, devices=8)
    return dict(np.load(path))


@pytest.mark.parametrize("name", MAIN)
def test_data_rows_of_blocks_match_jax_8_devices(runs, equiv, jax8, name):
    np.testing.assert_array_equal(equiv["h"], jax8["h"])
    for rank_out in layout_runs(runs, equiv, "w4-d2-n4"):
        for key in ("ids", "hits", "stats", "hstats"):
            np.testing.assert_array_equal(
                rank_out[f"{name}/{key}"], jax8[f"{name}/{key}"],
                err_msg=f"{name}/{key}")
        got, want = rank_out[f"{name}/scores"], jax8[f"{name}/scores"]
        if worker.CELLS[name]["score"] == "hamming":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6)


# -- the collectives ------------------------------------------------------


COLLECTIVE_METHODS = ("axis_index", "local_index", "all_to_all",
                      "all_gather", "all_gather_batch", "psum", "alive",
                      "ppermute")


@pytest.mark.parametrize("method", COLLECTIVE_METHODS)
@pytest.mark.parametrize("world", [2, 4])
def test_block_collectives_equal_mesh_collectives(runs, world, method):
    ranks = runs.get(f"collectives{world}", "collectives", world)
    for n in (world, 2 * world):
        mc = MeshCollectives(n=n, device=torch.device("cpu"))
        x = worker.collective_inputs(n, seed=n)
        n_loc = n // world
        for rank, out in enumerate(ranks):
            mine = slice(rank * n_loc, (rank + 1) * n_loc)

            def check(key, want):
                np.testing.assert_array_equal(out[f"{n}/{key}"], want,
                                              err_msg=f"rank {rank} {key}")

            if method == "axis_index":
                check(method, mc.axis_index()[mine].numpy())
            elif method == "local_index":
                check(method, np.arange(n_loc))
            elif method == "all_to_all":
                check(method, mc.all_to_all(x["a2a"])[mine].numpy())
                check("all_to_all_f", mc.all_to_all(x["a2a_f"])[mine].numpy())
            elif method in ("all_gather", "all_gather_batch"):
                check(method, mc.all_gather(x["gather"]).numpy())
            elif method == "psum":
                check(method, mc.psum(x["psum"]).numpy())
            elif method == "alive":
                check(method, mc.alive(x["live"])[mine].numpy())
            else:
                for pname, perm in worker.perms_of(n).items():
                    check(f"ppermute/{pname}",
                          mc.ppermute(x["perm"], perm)[mine].numpy())
                    check(f"ppermute_ax1/{pname}", mc.ppermute(
                        x["perm_ax1"], perm, axis=1)[:, mine].numpy())
                    check(f"ppermute_bool/{pname}", mc.ppermute(
                        x["perm_bool"], perm)[mine].numpy())


# -- the mesh helpers -----------------------------------------------------


def test_mesh_helpers_without_a_process_group():
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        mesh_mod.require_host_devices(4)
    mesh_mod.require_host_devices(1)
    with pytest.raises(RuntimeError, match="nproc-per-node 256"):
        mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="nproc-per-node 512"):
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
    mesh = mesh_mod.make_host_mesh(device="cpu")
    assert isinstance(mesh, mesh_mod.ZoneMesh)
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh_mod.batch_axes(mesh) == ("data",)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_helpers_in_a_world(runs, world):
    ranks = runs.get(f"collectives{world}", "collectives", world)
    half = world // 2
    for rank, out in enumerate(ranks):
        assert out["host/axes"].tolist() == ["data", "model"]
        assert out["host/shape"].tolist() == [2, half]
        assert out["host/batch_axes"].tolist() == ["data"]
        # a node a rank: row r // half, block r % half
        assert out["host/place"].tolist() == [rank // half, rank % half, 1]
        assert out["pod/axes"].tolist() == ["pod", "data", "model"]
        assert out["pod/shape"].tolist() == [2, 1, half]
        assert out["pod/batch_axes"].tolist() == ["pod", "data"]
        assert "torchrun --nproc-per-node 256" in str(out["raises/production"])
        assert "does not split" in str(out["raises/too_wide"])
        assert "runs over nccl" in str(out["raises/nccl"])
        # kill_node and reshard on one node a rank: node 0's zone blanked
        # on rank 0 alone, the generation bumped on every rank, the input
        # kept; the reshard to the same count moves nothing
        w = 16 // world
        mine = np.arange(rank * w * 2, (rank + 1) * w * 2).reshape(1, w, 2)
        np.testing.assert_array_equal(out["kill_node/input_ids"], mine)
        np.testing.assert_array_equal(out["kill_node/ids"],
                                      -np.ones_like(mine) if rank == 0
                                      else mine)
        np.testing.assert_array_equal(out["reshard/ids"], mine)
        assert int(out["kill_node/gen"]) == int(out["reshard/gen"]) == 1
        assert out["reshard/event"].tolist() == [world, world, 0, 0]
        # every data-2 mesh (host, pod, two zone meshes) shares one set
        # of row groups
        assert out["rows/shared"].all()


# -- the example under torchrun -------------------------------------------


def test_example_under_torchrun_matches_one_process(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import torch_distributed_search as example
    finally:
        sys.path.pop(0)
    out = tmp_path / "ids.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         os.path.join(ROOT, "examples", "torch_distributed_search.py"),
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "top-1 self-hit rate" in proc.stdout
    got = dict(np.load(out))
    want = example.run(mesh_mod.make_zone_mesh(4, data=2, device="cpu"))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
