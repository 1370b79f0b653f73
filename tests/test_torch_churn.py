"""`repro_torch.core.churn` and the churn CLIs against the JAX package.

The trajectory (vectors, churn events, query draws and the ground truth)
equals the reference's draw for draw, and every driver's output equals
JAX's array by array on the same `ChurnConfig` and hyperplanes: recalls,
staleness, live nodes, node counts, byte arrays and totals, recoveries,
drops, reshard events and the store generation.  1-node runs compare
in-process; mesh runs (`run_node_churn` over 1 -> 2 -> 4 -> 2 -> 1
nodes, `run_failure_churn` in both read modes, `run_churn_distributed`)
against one 4-device JAX subprocess.  The port runs every mesh on the
CPU device, its nodes in one process.

Recalls are held exactly.  The runs use `tests/test_churn.py`'s and
`tests/test_failure.py`'s small configurations.  The reference runs
announce private copies of the trajectory's vectors
(`torch_parity_rules.race_free_announces`): without them its first
epochs depend on the host's load.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from conftest import run_in_subprocess

from repro.core import churn as jchurn
from repro_torch.core import churn as tchurn
from repro_torch.core.churn import (
    ChurnConfig, FailureChurnConfig, NodeChurnConfig, run_churn,
    run_churn_distributed, run_churn_runtime, run_failure_churn,
    run_node_churn,
)
from repro_torch.core.hashing import LshParams
from repro_torch.core.runtime import IndexRuntime, RuntimeConfig
from repro_torch.launch import failure_churn as failure_cli
from repro_torch.launch import node_churn as node_cli
from repro_torch.launch.mesh import make_zone_mesh
from repro_torch.obs import Observability
from torch_parity_rules import race_free_announces

CFG = dict(num_users=1200, dim=32, k=5, L=2, capacity=64, epochs=6,
           num_queries=64, update_rate=0.1, churn_rate=0.03, refresh_every=2,
           seed=3)
# the reference's array outputs, and its scalar ones
ARRAYS = ("recalls", "staleness", "cache_staleness", "dropped_probes",
          "n_nodes", "handoff_bytes", "refresh_bytes", "live_nodes",
          "replication_bytes", "recovery_bytes")
SCALARS = ("final_recall", "mean_recall", "refresh_every",
           "total_handoff_bytes", "total_refresh_bytes", "replication",
           "total_replication_bytes", "total_recovery_bytes",
           "store_generation")
FAILURE_ARRAYS = ("reference_recalls", "recall_gap", "degraded")
FAILURE_SCALARS = ("degraded_gap", "recovered_gap", "recovery_epochs")

REF = """
import numpy as np
from repro.core import churn

_pad_to = churn._pad_to  # announce private copies (race_free_announces)
churn._pad_to = lambda x, n, fill: np.array(_pad_to(x, n, fill))

cfg = churn.ChurnConfig(**{CFG!r})
out = dict(hp=np.asarray(churn._lsh_setup(cfg)[1]))

def put(tag, res):
    for k, v in res.items():
        if k == "reshard_events":
            v = np.asarray([[e.old_n, e.new_n, e.moved_buckets,
                             e.handoff_bytes] for e in v]).reshape(-1, 4)
        elif k in ("recoveries", "kills"):
            v = np.asarray(v).reshape(-1, 3 if k == "recoveries" else 2)
        out[tag + "/" + k] = np.asarray(v)

put("node", churn.run_node_churn(churn.NodeChurnConfig(
    churn=cfg, schedule=(1, 2, 4, 2, 1))))
for mode in ("first", "quorum"):
    put("failure-" + mode, churn.run_failure_churn(churn.FailureChurnConfig(
        churn=cfg, n_nodes=4, replication=2, read_mode=mode,
        kills=((3, 1),))))
put("dist2", churn.run_churn_distributed(cfg, n_shards=2))
np.savez(OUT, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's mesh trajectories, on 4 JAX host devices."""
    path = str(tmp_path_factory.mktemp("ref_churn") / "ref.npz")
    assert "ok" in run_in_subprocess(f"OUT = {path!r}\n"
                                     + REF.format(CFG=CFG), devices=4)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def hp(ref):
    """The reference's hyperplanes for CFG (`churn._lsh_setup`)."""
    return ref["hp"]


def _events(res) -> list:
    return [[e.old_n, e.new_n, e.moved_buckets, e.handoff_bytes]
            for e in res["reshard_events"]]


def assert_same(got: dict, want: dict, failure: bool = False) -> None:
    """Every output of a port run equals the reference's (`want` a JAX
    result dict, or one loaded from the subprocess's npz)."""
    for k in ARRAYS + (FAILURE_ARRAYS if failure else ()):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
        assert got[k].dtype.kind == np.asarray(want[k]).dtype.kind, k
    for k in SCALARS + (FAILURE_SCALARS if failure else ()):
        assert got[k] == np.asarray(want[k]).item(), k
    ev = want["reshard_events"]
    want_ev = (ev.tolist() if isinstance(ev, np.ndarray)
               else [[e.old_n, e.new_n, e.moved_buckets, e.handoff_bytes]
                     for e in ev])
    assert _events(got) == want_ev
    rec = np.asarray(want["recoveries"]).reshape(-1, 3).tolist()
    assert [list(r) for r in got["recoveries"]] == rec


def _npz(ref, tag) -> dict:
    pre = tag + "/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


# -- the trajectory -----------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(seed=5, refresh_every=3,
                                             update_rate=0.15,
                                             churn_rate=0.05, m=7)],
                         ids=["cfg", "cfg-seed5-m7"])
def test_trajectory_matches_jax(kw):
    jcfg = jchurn.ChurnConfig(**dict(CFG, **kw))
    tcfg = ChurnConfig(**dict(CFG, **kw))
    got = list(tchurn._trajectory(tcfg, torch.device("cpu")))
    want = list(jchurn._trajectory(jcfg))
    assert len(got) == len(want) == tcfg.epochs + 1
    # both generators update their vectors in place: compare as they go
    for (e1, v1, r1, q1, i1), (e2, v2, r2, q2, i2) in zip(
            jchurn._trajectory(jcfg),
            tchurn._trajectory(tcfg, torch.device("cpu"))):
        assert (e1, r1) == (e2, r2)
        np.testing.assert_array_equal(v2.numpy(), v1)
        if q1 is None:
            assert q2 is None and i2 is None
            continue
        np.testing.assert_array_equal(q2, q1)
        np.testing.assert_array_equal(i2, i1)
        assert i2.dtype == np.int32


def test_ideal_top_m_breaks_ties_to_the_lower_id():
    vecs = torch.tensor([[1.0, 0.0], [0.6, 0.8], [0.6, 0.8], [0.6, 0.8],
                         [0.0, 1.0], [1.0, 0.0]])
    # query 0: id 5 equals it (1.0), then ids 1, 2, 3 tie at 0.6 across
    # the rank-3 boundary: the lower ids win
    got = tchurn._ideal_topm(vecs, np.array([0, 4]), 3)
    assert got.tolist() == [[5, 1, 2], [1, 2, 3]]
    # a chunk smaller than the batch gives the same rows
    assert tchurn._ideal_topm(vecs, np.array([0, 4]), 3, chunk=1).tolist() \
        == got.tolist()


def test_schedule_and_kill_validation_match_jax():
    for sched, epochs in (((1, 2), 4), ((1, 2, 4, 2, 1, 2, 1, 4), 3),
                          ((4,), 2)):
        assert tchurn._expand_schedule(sched, epochs) == \
            jchurn._expand_schedule(sched, epochs)
    for bad in ((1, 3), ()):
        with pytest.raises(ValueError) as e1:
            jchurn._expand_schedule(bad, 4)
        with pytest.raises(ValueError) as e2:
            tchurn._expand_schedule(bad, 4)
        assert str(e1.value) == str(e2.value)
    kills = ((3, 1), (3, 2), (5, 0))
    assert tchurn._expand_kills(kills, 6, 4) == \
        jchurn._expand_kills(kills, 6, 4)
    for bad in (((9, 0),), ((2, 4),)):
        with pytest.raises(ValueError, match="outside"):
            tchurn._expand_kills(bad, 6, 4)


def test_driver_refuses_what_the_reference_refuses(hp):
    cfg = ChurnConfig(**dict(CFG, epochs=2, num_queries=8))
    one = IndexRuntime(RuntimeConfig(params=LshParams(d=32, k=5, L=2),
                                     n_nodes=1), device="cpu")
    with pytest.raises(ValueError, match="replication"):
        run_churn_runtime(cfg, one, kills=((1, 0),), hyperplanes=hp)
    with pytest.raises(ValueError, match="schedule\\[0\\]"):
        run_churn_runtime(cfg, one, schedule=(2,), hyperplanes=hp)
    with pytest.raises(ValueError, match="powers of two"):
        run_node_churn(NodeChurnConfig(churn=cfg, schedule=(6,)),
                       device="cpu")
    rep = tchurn.make_churn_runtime(cfg, 4, make_zone_mesh(4, device="cpu"),
                                    replication=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_churn_runtime(cfg, rep, schedule=(4,), kills=((1, 0),))
    with pytest.raises(ValueError, match="do not compose"):
        run_churn_runtime(cfg, rep, schedule=(4,))
    with pytest.raises(ValueError, match="hyperplanes of shape"):
        run_churn(cfg, device="cpu", hyperplanes=hp[:, :2])


# -- the drivers against JAX --------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(refresh_every=3, seed=5,
                                             update_rate=0.15,
                                             churn_rate=0.05)],
                         ids=["cfg", "cfg-refresh3-seed5"])
def test_run_churn_matches_jax(kw, monkeypatch):
    race_free_announces(monkeypatch, jchurn)
    jcfg = jchurn.ChurnConfig(**dict(CFG, **kw))
    want = jchurn.run_churn(jcfg)
    got = run_churn(ChurnConfig(**dict(CFG, **kw)), device="cpu",
                    hyperplanes=np.asarray(jchurn._lsh_setup(jcfg)[1]))
    assert_same(got, want)
    assert got["epoch_ms"].shape == (jcfg.epochs + 1,)


def test_static_node_schedule_is_run_churn(hp, monkeypatch):
    """A one-node schedule runs no round and leaves the trajectory as
    `run_churn`'s, deterministically."""
    race_free_announces(monkeypatch, jchurn)
    cfg = ChurnConfig(**CFG)
    static = run_churn(cfg, device="cpu", hyperplanes=hp)
    elastic = run_node_churn(NodeChurnConfig(churn=cfg, schedule=(1,)),
                             device="cpu", hyperplanes=hp)
    np.testing.assert_array_equal(elastic["recalls"], static["recalls"])
    assert elastic["reshard_events"] == []
    assert int(elastic["handoff_bytes"].sum()) == 0
    assert np.all(elastic["n_nodes"] == 1)
    want = jchurn.run_node_churn(jchurn.NodeChurnConfig(
        churn=jchurn.ChurnConfig(**CFG), schedule=(1,)))
    assert_same(elastic, want)


def test_node_churn_matches_jax(ref, hp):
    cfg = ChurnConfig(**CFG)
    obs = Observability()
    got = run_node_churn(NodeChurnConfig(churn=cfg, schedule=(1, 2, 4, 2, 1)),
                         obs=obs, device="cpu", hyperplanes=hp)
    assert_same(got, _npz(ref, "node"))
    assert got["n_nodes"].tolist() == [2, 4, 2, 1, 1, 1]
    assert sum(d["reason"] == "reshard" for d in obs.flight.dumps) == 4
    # the membership round trip leaves the static trajectory unchanged
    static = run_churn(cfg, device="cpu", hyperplanes=hp)
    np.testing.assert_array_equal(got["recalls"], static["recalls"])


@pytest.mark.parametrize("mode", ["first", "quorum"])
def test_failure_churn_matches_jax(ref, hp, mode):
    cfg = ChurnConfig(**CFG)
    obs = Observability()
    got = run_failure_churn(FailureChurnConfig(
        churn=cfg, n_nodes=4, replication=2, read_mode=mode,
        kills=((3, 1),)), obs=obs, device="cpu", hyperplanes=hp)
    want = _npz(ref, "failure-" + mode)
    assert_same(got, want, failure=True)
    assert got["kills"] == ((3, 1),)
    # the run holds the reference's failure gates, and the flight
    # records sum to the aggregate arrays
    failure_cli.smoke_gates(got, obs.flight, cfg.L, cfg.num_users, cfg.dim,
                            2, (1 << cfg.k) // 4, cfg.capacity,
                            cfg.refresh_every, cfg.epochs, 1)


def test_distributed_churn_matches_jax_and_one_node(ref, hp):
    cfg = ChurnConfig(**CFG)
    got = run_churn_distributed(cfg, n_shards=2, device="cpu",
                                hyperplanes=hp)
    assert_same(got, _npz(ref, "dist2"))
    one = run_churn(cfg, device="cpu", hyperplanes=hp)
    np.testing.assert_array_equal(got["recalls"], one["recalls"])
    assert int(got["cache_staleness"].max()) >= 1
    assert int(got["cache_staleness"].min()) == 0


def test_failure_run_leaves_the_reference_run_intact(hp):
    """The failure and reference runs share one runtime: the kill must
    not reach the reference (the reference equals a fresh runtime's)."""
    cfg = ChurnConfig(**CFG)
    got = run_failure_churn(FailureChurnConfig(churn=cfg, kills=((1, 0),)),
                            device="cpu", hyperplanes=hp)
    fresh = run_churn_runtime(
        cfg, tchurn.make_churn_runtime(
            cfg, 4, make_zone_mesh(4, device="cpu"), replication=2),
        hyperplanes=hp)
    np.testing.assert_array_equal(got["reference_recalls"], fresh["recalls"])
    assert got["degraded"].tolist() == [True] + [False] * 5


def test_on_read_sees_each_read_epoch(hp):
    cfg = ChurnConfig(**dict(CFG, epochs=3))
    seen = []
    run_failure_churn(FailureChurnConfig(churn=cfg, kills=((1, 2),)),
                      device="cpu", hyperplanes=hp,
                      on_read=lambda s: seen.append(
                          (s.epoch, s.live.tolist(), s.queries.shape,
                           s.replicas[0].shape)))
    assert seen == [(e, [1, 1, 0, 1] if e == 1 else [1, 1, 1, 1], (64, 32),
                     (2, 1, 32, 64)) for e in (1, 2, 3)]


# -- the CLIs -----------------------------------------------------------------


def test_node_churn_cli_smoke(capsys, tmp_path):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    out = node_cli.main(["--smoke", "--device", "cpu", "--trace-out",
                         str(trace), "--metrics-out", str(metrics)])
    text = capsys.readouterr().out
    assert "[smoke] OK" in text and trace.exists() and metrics.exists()
    assert out["reference_gap"] <= 0.02
    assert len(out["reshard_events"]) == 6


def test_failure_churn_cli_smoke(capsys):
    for mode in ("first", "quorum"):
        out = failure_cli.main(["--smoke", "--device", "cpu",
                                "--read-mode", mode])
        assert "[smoke] OK" in capsys.readouterr().out
        assert out["degraded"].any() and not out["degraded"][-1]


def test_cli_parsers_match_the_reference():
    from repro.launch import failure_churn as jfailure
    from repro.launch import node_churn as jnode

    assert node_cli._parse_schedule("1, 2,4") == jnode._parse_schedule(
        "1, 2,4")
    assert failure_cli._parse_kills("3:1, 5:2") == jfailure._parse_kills(
        "3:1, 5:2")
    for bad in ("x", ""):
        with pytest.raises(SystemExit):
            node_cli._parse_schedule(bad)
    with pytest.raises(SystemExit):
        failure_cli._parse_kills("3-1")
    assert dataclasses.asdict(FailureChurnConfig()) == dataclasses.asdict(
        jchurn.FailureChurnConfig())
    assert dataclasses.asdict(NodeChurnConfig()) == dataclasses.asdict(
        jchurn.NodeChurnConfig())
