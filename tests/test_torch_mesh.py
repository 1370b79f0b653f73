"""The routed mesh half of `repro_torch`'s runtime against the JAX package,
on the goldens world (tests/goldens/make_goldens.py: N=1200, D=32, k=5,
L=3, C=64, m=10, 48 queries).

The port holds the n CAN nodes of a mesh in one process on one device;
the JAX package runs them as n host devices under `shard_map`.  Held
against the reference:

  * (a) the 2-node goldens `runtime_2node_v1.npz` (dot) and
    `runtime_2node_packed_v1.npz` (hamming): lsh, nb and cnb search and
    contains, staged and fused;
  * (b) JAX's in-process (1, 1) mesh, including the `cap_factor = 1/L`
    cell with exactly nq·(L-1) drops;
  * (c) JAX's 4-node mesh in one subprocess: alltoall and allgather, nb
    and cnb, dot and hamming, a tiny-`cap_factor` cell, and a chain of
    insert -> payload_sync -> expire -> refresh_cache -> search;
  * (d) mesh results equal to 1-node results at n in {2, 4, 8}, and the
    geometry, router and byte model equal to the reference's.

Ids, hamming scores, contains hits and every `StepStats` field match
exactly; dot scores to 1e-6.  The goldens' hyperplanes come from JAX's
PRNG with `threefry_partitionable` off, the mode they were drawn in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import run_in_subprocess

from repro.core import LshParams as JParams
from repro.core import can as jcan
from repro.core import distributed as jdist
from repro.core import make_hyperplanes as j_make_hyperplanes
from repro.core import packed as jpacked
from repro.core import routing as jrouting
from repro.core.hashing import sketch_codes_batched
from repro.core.runtime import IndexRuntime as JRuntime
from repro.core.runtime import RuntimeConfig as JConfig
from repro.core.store import build_store_host as j_build_store_host
from repro_torch import convert
from repro_torch.core import can as tcan
from repro_torch.core import distributed as tdist
from repro_torch.core import routing as trouting
from repro_torch.core import runtime as runtime_mod
from repro_torch.core.hashing import LshParams
from repro_torch.core.runtime import IndexRuntime, MeshCollectives, \
    RuntimeConfig
from repro_torch.launch.mesh import make_zone_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
N, D, K, L, M, NQ = 1200, 32, 5, 3, 10, 48
STATS = ("dropped_probes", "probes_issued", "probes_routed",
         "nodes_contacted", "replica_fanout")


def goldens_prng():
    """The PRNG mode the goldens' hyperplanes were drawn in."""
    mode = getattr(jax, "threefry_partitionable", None)
    return contextlib.nullcontext() if mode is None else mode(False)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    jparams = JParams(d=D, k=K, L=L, seed=23)
    with goldens_prng():
        jh = j_make_hyperplanes(jparams)
    jst = j_build_store_host(sketch_codes_batched(jnp.asarray(vecs), jh),
                             jparams.num_buckets, capacity=64, payload=vecs)
    jst_h = jpacked.pack_store_payload(jst, jh)
    return dict(
        vecs=vecs, jparams=jparams, jh=jh, jst=jst, jst_h=jst_h,
        targets=rng.integers(0, N, size=NQ).astype(np.int32),
        params=LshParams(d=D, k=K, L=L, seed=23),
        h=convert.hyperplanes_from(jh, device="cpu"),
        st=convert.store_from(jst, device="cpu"),
        st_h=convert.store_from(jst_h, device="cpu"),
    )


def port_mesh(w, n, score="dot", **kw):
    """(runtime, store, cache) of the port's n-node mesh on the CPU."""
    rt = IndexRuntime(RuntimeConfig(params=w["params"], n_nodes=n, m=M,
                                    score=score, **kw),
                      mesh=make_zone_mesh(n, device="cpu"))
    st = rt.shard_store(w["st_h"] if score == "hamming" else w["st"])
    cache = rt.refresh_cache(st) if rt.cfg.variant == "cnb" else None
    return rt, st, cache


def stats_tuple(stats) -> tuple:
    h = stats.host()
    return tuple(h[f] for f in STATS) + tuple(h["dropped_by_dest"])


def assert_scores(got, want, score):
    if score == "hamming":  # exact integers
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-6)


# -- (a) the 2-node goldens -------------------------------------------------


@pytest.mark.parametrize("fused,use_kernels", [("off", False), ("on", True)],
                         ids=["staged", "fused-kernels"])
@pytest.mark.parametrize("score", ["dot", "hamming"])
@pytest.mark.parametrize("variant", ["lsh", "nb", "cnb"])
def test_two_node_matches_goldens(world, variant, score, fused, use_kernels):
    name = "runtime_2node_packed_v1.npz" if score == "hamming" \
        else "runtime_2node_v1.npz"
    g = dict(np.load(os.path.join(HERE, "goldens", name)))
    rt, st, cache = port_mesh(world, 2, score, variant=variant,
                              cap_factor=float(L), fused=fused,
                              use_kernels=use_kernels)
    q = world["vecs"][:NQ]
    ids, sc, stats = rt.search(world["h"], st, q, cache=cache)
    assert int(stats) == 0
    np.testing.assert_array_equal(ids.numpy(), g[f"search_ids_{variant}"])
    assert_scores(sc.numpy(), g[f"search_scores_{variant}"], score)
    hits, cstats = rt.contains(world["h"], st, q, g["targets"], cache=cache)
    assert int(cstats) == 0
    np.testing.assert_array_equal(hits.numpy(), g[f"contains_{variant}"])


# -- (b) JAX's in-process (1, 1) mesh ----------------------------------------


ONE_NODE_CELLS = [
    (v, s, "alltoall", 1.0 * L) for v in ("lsh", "nb", "cnb")
    for s in ("dot", "hamming")
] + [("cnb", "hamming", "allgather", 2.0), ("nb", "dot", "allgather", 2.0),
     ("cnb", "hamming", "alltoall", 1.0 / L)]


@pytest.mark.parametrize(
    "variant,score,routing,cap_factor", ONE_NODE_CELLS,
    ids=[f"{v}-{s}-{r}-cap{c:.2f}" for v, s, r, c in ONE_NODE_CELLS])
def test_one_node_mesh_matches_jax(world, single_mesh, variant, score,
                                   routing, cap_factor):
    w = world
    q, tgt = w["vecs"][:NQ], w["targets"]
    kw = dict(variant=variant, m=M, score=score, routing=routing,
              cap_factor=cap_factor)
    jrt = JRuntime(JConfig(params=w["jparams"], **kw), mesh=single_mesh)
    jst = jrt.shard_store(w["jst_h"] if score == "hamming" else w["jst"])
    wi, ws, wstats = jrt.search(w["jh"], jst, q)
    whits, whstats = jrt.contains(w["jh"], jst, q, tgt)
    rt, st, cache = port_mesh(w, 1, score, **{k: v for k, v in kw.items()
                                              if k not in ("m", "score")})
    gi, gs, gstats = rt.search(w["h"], st, q, cache=cache)
    ghits, ghstats = rt.contains(w["h"], st, q, tgt, cache=cache)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert_scores(gs.numpy(), ws, score)
    np.testing.assert_array_equal(ghits.numpy(), np.asarray(whits))
    assert gstats.host() == wstats.host()
    assert ghstats.host() == whstats.host()
    if cap_factor < 1:  # cap = nq: exactly nq of the nq*L probes survive
        assert int(gstats) == NQ * (L - 1)


# -- (c) JAX's 4-node mesh, in one subprocess ---------------------------------


REF4 = """
import contextlib, numpy as np, jax, jax.numpy as jnp
from repro.core import LshParams, make_hyperplanes, packed
from repro.core.hashing import sketch_codes_batched
from repro.core.runtime import IndexRuntime, RuntimeConfig
from repro.core.store import build_store_host
from repro.launch.mesh import make_zone_mesh

N, D, K, L, M, NQ = {N}, {D}, {K}, {L}, {M}, {NQ}
rng = np.random.default_rng(17)
vecs = rng.standard_normal((N, D)).astype(np.float32)
vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
targets = rng.integers(0, N, size=NQ).astype(np.int32)
params = LshParams(d=D, k=K, L=L, seed=23)
mode = getattr(jax, "threefry_partitionable", None)
with contextlib.nullcontext() if mode is None else mode(False):
    h = make_hyperplanes(params)
store = build_store_host(sketch_codes_batched(jnp.asarray(vecs), h),
                         params.num_buckets, capacity=64, payload=vecs)
stores = dict(dot=store, hamming=packed.pack_store_payload(store, h))
mesh = make_zone_mesh(4)
out = dict(h=np.asarray(h))
q = vecs[:NQ]

def stats(s):
    d = s.host()
    return np.asarray([d[f] for f in {STATS!r}] + list(d["dropped_by_dest"]))

def cell(tag, score, **kw):
    rt = IndexRuntime(RuntimeConfig(params=params, n_nodes=4, m=M,
                                    score=score, **kw), mesh=mesh)
    st = rt.shard_store(stores[score])
    cache = rt.refresh_cache(st) if rt.cfg.variant == "cnb" else None
    ids, sc, s = rt.search(h, st, q, cache=cache)
    hits, hs = rt.contains(h, st, q, targets, cache=cache)
    out.update({{tag + "/ids": np.asarray(ids), tag + "/scores": np.asarray(sc),
                tag + "/stats": stats(s), tag + "/hits": np.asarray(hits),
                tag + "/hstats": stats(hs)}})
    return rt, st

for score in ("dot", "hamming"):
    for variant in ("nb", "cnb"):
        for routing in ("alltoall", "allgather"):
            cell(f"{{score}}-{{variant}}-{{routing}}", score, variant=variant,
                 routing=routing, cap_factor=4.0)
cell("tinycap", "hamming", variant="cnb", cap_factor=0.25)

moved = np.roll(vecs, 1, axis=0)
for score in ("dot", "hamming"):
    rt, st = cell("chain-" + score, score, variant="cnb", cap_factor=4.0)
    vid = np.arange(96, dtype=np.int32)
    st = rt.insert(h, st, moved[:96], vid, 5)
    st = rt.payload_sync(st, moved, hyperplanes=h)
    st = rt.expire(st, 9, ttl=5)
    cache = rt.refresh_cache(st)
    ids, sc, s = rt.search(h, st, moved[:NQ], cache=cache)
    tag = "chain-" + score
    out.update({{tag + "/store_ids": np.asarray(st.ids),
                tag + "/store_ts": np.asarray(st.timestamps),
                tag + "/store_ptr": np.asarray(st.write_ptr),
                tag + "/store_payload": np.asarray(st.payload),
                tag + "/store_gen": np.asarray(st.generation),
                tag + "/cache_ids": np.asarray(cache[0]),
                tag + "/after_ids": np.asarray(ids),
                tag + "/after_scores": np.asarray(sc),
                tag + "/after_stats": stats(s)}})
np.savez(OUT, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    """The reference's outputs on a 4-device JAX mesh."""
    path = str(tmp_path_factory.mktemp("ref4") / "ref4.npz")
    code = f"OUT = {path!r}\n" + REF4.format(N=N, D=D, K=K, L=L, M=M, NQ=NQ,
                                              STATS=STATS)
    assert "ok" in run_in_subprocess(code, devices=4)
    return dict(np.load(path))


def _check_cell(world, ref, tag, score, **kw):
    rt, st, cache = port_mesh(world, 4, score, **kw)
    q = world["vecs"][:NQ]
    ids, sc, stats = rt.search(world["h"], st, q, cache=cache)
    hits, hstats = rt.contains(world["h"], st, q, world["targets"],
                               cache=cache)
    np.testing.assert_array_equal(ids.numpy(), ref[tag + "/ids"])
    assert_scores(sc.numpy(), ref[tag + "/scores"], score)
    np.testing.assert_array_equal(hits.numpy(), ref[tag + "/hits"])
    assert stats_tuple(stats) == tuple(ref[tag + "/stats"].tolist())
    assert stats_tuple(hstats) == tuple(ref[tag + "/hstats"].tolist())
    return rt, st, stats


FOUR_NODE_CELLS = [(s, v, r) for s in ("dot", "hamming")
                   for v in ("nb", "cnb") for r in ("alltoall", "allgather")]


@pytest.mark.parametrize("score,variant,routing", FOUR_NODE_CELLS,
                         ids=["-".join(c) for c in FOUR_NODE_CELLS])
def test_four_node_mesh_matches_jax(world, ref4, score, variant, routing):
    np.testing.assert_array_equal(world["h"].numpy(), ref4["h"])
    _check_cell(world, ref4, f"{score}-{variant}-{routing}", score,
                variant=variant, routing=routing, cap_factor=4.0)


def test_four_node_drop_accounting_matches_jax(world, ref4):
    _, _, stats = _check_cell(world, ref4, "tinycap", "hamming",
                              variant="cnb", cap_factor=0.25)
    assert int(stats) > 0 and int(stats.dropped_by_dest.sum()) == int(stats)


@pytest.mark.parametrize("score", ["dot", "hamming"])
def test_four_node_insert_sync_refresh_search_matches_jax(world, ref4, score):
    tag = "chain-" + score
    rt, st, _ = _check_cell(world, ref4, tag, score, variant="cnb",
                            cap_factor=4.0)
    moved = np.roll(world["vecs"], 1, axis=0)
    st = rt.insert(world["h"], st, moved[:96], np.arange(96), 5)
    st = rt.payload_sync(st, moved, hyperplanes=world["h"])
    st = rt.expire(st, 9, ttl=5)
    cache = rt.refresh_cache(st)
    ids, sc, stats = rt.search(world["h"], st, moved[:NQ], cache=cache)
    for field, key in (("ids", "store_ids"), ("timestamps", "store_ts"),
                       ("write_ptr", "store_ptr")):
        np.testing.assert_array_equal(getattr(st, field).numpy(),
                                      ref4[f"{tag}/{key}"], err_msg=field)
    want_pay = ref4[f"{tag}/store_payload"]
    np.testing.assert_array_equal(st.payload.numpy().view(want_pay.dtype),
                                  want_pay)
    assert int(st.generation) == int(ref4[f"{tag}/store_gen"])
    np.testing.assert_array_equal(cache[0].numpy(), ref4[f"{tag}/cache_ids"])
    np.testing.assert_array_equal(ids.numpy(), ref4[f"{tag}/after_ids"])
    assert_scores(sc.numpy(), ref4[f"{tag}/after_scores"], score)
    assert stats_tuple(stats) == tuple(ref4[f"{tag}/after_stats"].tolist())


# -- (d) the mesh equals one node; geometry, router and byte model ----------


@pytest.mark.parametrize("variant", ["lsh", "nb", "cnb"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_equals_one_node(world, n, variant):
    q, tgt = world["vecs"][:NQ], world["targets"]
    for score in ("dot", "hamming"):
        one = IndexRuntime(RuntimeConfig(params=world["params"], m=M,
                                         variant=variant, score=score),
                           device="cpu")
        st1 = world["st_h"] if score == "hamming" else world["st"]
        i1, s1, _ = one.search(world["h"], st1, q)
        h1, _ = one.contains(world["h"], st1, q, tgt)
        for routing in ("alltoall", "allgather"):
            rt, st, cache = port_mesh(world, n, score, variant=variant,
                                      routing=routing, cap_factor=float(n))
            ids, sc, stats = rt.search(world["h"], st, q, cache=cache)
            hits, hstats = rt.contains(world["h"], st, q, tgt, cache=cache)
            assert int(stats) == 0 and int(hstats) == 0
            np.testing.assert_array_equal(ids.numpy(), i1.numpy())
            assert_scores(sc.numpy(), s1.numpy(), score)
            np.testing.assert_array_equal(hits.numpy(), h1.numpy())


def test_data_rows_serve_their_batch_slices(world):
    """A 2 x 2 mesh: each data row of 2 nodes answers its half of the
    batch, and the stats sum over both rows."""
    rt = IndexRuntime(RuntimeConfig(params=world["params"], n_nodes=2, m=M,
                                    variant="nb", cap_factor=2.0),
                      mesh=make_zone_mesh(2, data=2, device="cpu"))
    assert rt.n_devices == 4 and rt.is_distributed
    one = IndexRuntime(RuntimeConfig(params=world["params"], m=M,
                                     variant="nb"), device="cpu")
    q = world["vecs"][:NQ]
    ids, _, stats = rt.search(world["h"], world["st"], q)
    np.testing.assert_array_equal(ids.numpy(),
                                  one.search(world["h"], world["st"], q)[0])
    assert stats.host()["probes_routed"] == NQ * L
    with pytest.raises(ValueError, match="does not shard"):
        rt.search(world["h"], world["st"], q[:6])


def test_runtime_refuses_what_the_mesh_cannot_take(world):
    p = world["params"]
    with pytest.raises(ValueError, match="needs a mesh"):
        IndexRuntime(RuntimeConfig(params=p, n_nodes=2), device="cpu")
    with pytest.raises(ValueError, match="model axis"):
        IndexRuntime(RuntimeConfig(params=p, n_nodes=2),
                     mesh=make_zone_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="unknown routing"):
        RuntimeConfig(params=p, routing="gossip")
    rt, st, _ = port_mesh(world, 2, variant="cnb")
    q = world["vecs"][:4]
    with pytest.raises(ValueError, match="needs cache="):
        rt.search(world["h"], st, q)
    with pytest.raises(ValueError, match="bake m"):
        rt.search(world["h"], st, q, cache=rt.refresh_cache(st), m=M + 1)
    with pytest.raises(ValueError, match="1-node only"):
        rt.search(world["h"], st, q, cache=rt.refresh_cache(st),
                  exclude=np.arange(4))


def test_refresh_cache_holds_the_neighbours_zones(world):
    rt, st, cache = port_mesh(world, 4, variant="cnb")
    topo = rt.topology
    for node in range(4):
        s, e = topo.zone_range(node)
        for b, nbr in enumerate(topo.node_neighbors(node)):
            ns, ne = topo.zone_range(int(nbr))
            assert torch.equal(cache[0][:, b, s:e], st.ids[:, ns:ne])
            assert torch.equal(cache[1][:, b, s:e], st.payload[:, ns:ne])


def test_collectives_semantics():
    cx = MeshCollectives(n=4, device=torch.device("cpu"))
    x = torch.arange(4 * 4 * 2).reshape(4, 4, 2)       # [src, dst, cap]
    y = cx.all_to_all(x)
    for src in range(4):
        for dst in range(4):
            assert torch.equal(y[dst, src], x[src, dst])
    v = torch.arange(8).reshape(4, 2) + 1
    # a partial permutation: node 3 receives nothing and gets zeros
    got = cx.ppermute(v, [(0, 1), (1, 2), (2, 0)])
    assert got.tolist() == [[5, 6], [1, 2], [3, 4], [0, 0]]
    assert torch.equal(cx.all_gather(v), v.reshape(-1))
    assert torch.equal(cx.psum(v), v.sum(0))
    assert cx.alive(torch.tensor([1, 0, 1, 1])).tolist() == [True, False,
                                                            True, True]


def test_can_geometry_matches_jax():
    for k, n in ((5, 1), (5, 4), (12, 16), (6, 64)):
        jt, tt = jcan.CanTopology(k, n), tcan.CanTopology(k, n)
        codes = np.arange(1 << k, dtype=np.uint32)
        for node in range(n):
            assert tt.zone_range(node) == jt.zone_range(node)
            np.testing.assert_array_equal(tt.node_neighbors(node),
                                          jt.node_neighbors(node))
            assert tt.code_of(node, 3 % tt.buckets_per_node) == \
                jt.code_of(node, 3 % jt.buckets_per_node)
        for b in range(tt.node_bits):
            assert tt.neighbor_perm(b) == jt.neighbor_perm(b)
        for R in range(1, min(n, 3) + 1):
            np.testing.assert_array_equal(tt.replicas_of(codes, R),
                                          jt.replicas_of(codes, R))
        assert tt.expected_lookup_hops == jt.expected_lookup_hops
        for n2 in (1, 2, 4):
            if n2 <= 1 << k:
                old, new = (jcan.CanTopology(k, n), jcan.CanTopology(k, n2))
                told, tnew = (tcan.CanTopology(k, n), tcan.CanTopology(k, n2))
                assert tcan.moved_buckets(told, tnew) == \
                    jcan.moved_buckets(old, new)
                nodes = np.arange(n)
                np.testing.assert_array_equal(
                    tcan.survivor_of(told, tnew, nodes),
                    jcan.survivor_of(old, new, nodes))
    assert tcan.paper_topology(7) == tcan.CanTopology(7, 128)
    with pytest.raises(ValueError):
        tcan.CanTopology(5, 4).neighbor_perm(2)


@pytest.mark.parametrize("n_dests,cap", [(4, 6), (4, 2), (3, 1), (2, 0)])
def test_router_matches_jax_per_group(n_dests, cap):
    """The batched router equals the reference's, group by group, with
    overflow counted and never scattered over a survivor."""
    rng = np.random.default_rng(n_dests * 10 + cap)
    G, F = 3, 17
    dest = rng.integers(0, n_dests, size=(G, F)).astype(np.int32)
    vals = rng.integers(0, 1000, size=(G, F, 2)).astype(np.int32)
    route = trouting.plan_routes(torch.from_numpy(dest), n_dests, cap)
    buf = trouting.build_send_buffer(route, n_dests, cap,
                                     torch.from_numpy(vals), -1)
    back = trouting.return_to_origin(route, buf, -7)
    for g in range(G):
        jr = jrouting.plan_routes(jnp.asarray(dest[g]), n_dests, cap)
        for f in ("order", "dest", "slot", "ok"):
            np.testing.assert_array_equal(getattr(route, f)[g].numpy(),
                                          np.asarray(getattr(jr, f)),
                                          err_msg=f)
        assert int(route.dropped[g]) == int(jr.dropped)
        jbuf = jrouting.build_send_buffer(jr, n_dests, cap,
                                          jnp.asarray(vals[g]), -1)
        np.testing.assert_array_equal(buf[g].numpy(), np.asarray(jbuf))
        np.testing.assert_array_equal(
            back[g].numpy(),
            np.asarray(jrouting.return_to_origin(jr, jbuf, -7)))
    empty = trouting.plan_routes(torch.zeros((2, 0), dtype=torch.int32),
                                 n_dests, cap)
    assert empty.order.shape == (2, 0) and empty.dropped.tolist() == [0, 0]


def test_byte_estimators_match_jax():
    for n in (1, 2, 4, 16):
        for routing in ("alltoall", "allgather"):
            for variant in ("lsh", "nb", "cnb"):
                for score in ("dot", "hamming"):
                    kw = dict(variant=variant, n_nodes=n, routing=routing,
                              score=score, cap_factor=1.5, m=7)
                    jc = JConfig(params=JParams(d=128, k=12, L=4), **kw)
                    tc = RuntimeConfig(params=LshParams(d=128, k=12, L=4),
                                       **kw)
                    for batch, n_total in ((1024, n), (256, 2 * n)):
                        assert tdist.estimate_query_bytes(
                            tc, batch, 128, n_total) == \
                            jdist.estimate_query_bytes(jc, batch, 128,
                                                       n_total)
                    assert tdist.estimate_refresh_bytes(tc, 512, 128) == \
                        jdist.estimate_refresh_bytes(jc, 512, 128)
                    for new_n in (1, 2, 8):
                        assert tdist.estimate_reshard_bytes(
                            tc, new_n, 512, 128) == \
                            jdist.estimate_reshard_bytes(jc, new_n, 512, 128)
    cfg = RuntimeConfig(params=LshParams(d=128, k=12, L=4), n_nodes=4)
    assert dataclasses.replace(cfg, n_nodes=2).node_bits == 1


@pytest.mark.parametrize("kw", [
    dict(n_shards=1),
    dict(n_shards=4, variant="nb", routing="allgather"),
    dict(n_shards=16, variant="cnb", score="hamming", cap_factor=2.0, m=7),
])
def test_dist_config_matches_jax(kw):
    """`DistConfig` builds the config the reference's factory builds."""
    jc = jdist.DistConfig(params=JParams(d=32, k=8, L=3), **kw)
    tc = tdist.DistConfig(params=LshParams(d=32, k=8, L=3), **kw)
    for f in dataclasses.fields(tc):
        got, want = getattr(tc, f.name), getattr(jc, f.name, None)
        if f.name == "params":
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert (tc.n_nodes, tc.node_bits) == (jc.n_nodes, jc.node_bits)


def test_ppermute_builds_its_index_once():
    """A perfect matching (every NB forward and cache refresh) reuses one
    device index per pairing and needs no zero-fill mask."""
    cx = MeshCollectives(n=4, device=torch.device("cpu"))
    perm = tcan.CanTopology(6, 4).neighbor_perm(1)
    v = torch.arange(8).reshape(4, 2)
    assert cx.ppermute(v, perm).tolist() == [[4, 5], [6, 7], [0, 1], [2, 3]]
    src, keep = runtime_mod._perm_source(4, tuple(perm), v.device)
    assert keep is None
    assert runtime_mod._perm_source(4, tuple(perm), v.device)[0] is src
