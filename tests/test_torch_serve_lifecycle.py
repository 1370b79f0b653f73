"""`repro_torch.serve.lifecycle` and the `serve_retrieval` CLI against the
JAX package, on the CPU.

At the reference tests' churn configuration (tests/test_serve.py,
tests/test_pipeline.py: 400 users, D = 16, 4 epochs) and on JAX's
hyperplanes:

  * `run_serve_churn` — direct at depth 1, and through the writer at
    depths 2 and 4 (inline and threaded) — and `run_serve_reshard` give
    recalls equal to JAX's `run_churn` exactly (the reference announces
    private copies: `torch_parity_rules.race_free_announces`), with
    repeats identical, and `run_serve_churn` equals JAX's
    `run_serve_churn` in generations and cache counts too;
  * `run_serve_failure` passes the reference's SERVE_FAILURE assertions
    (tests/test_failure.py) on 4 nodes held on the CPU device, in both
    read modes;
  * the CLI's `--smoke --device cpu` runs in-process, closed loop (with
    and without the cache, with a trace and a metrics file) and open
    loop.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import churn as jchurn
from repro.serve import lifecycle as jlifecycle
from repro_torch.core.churn import ChurnConfig
from repro_torch.launch import serve_retrieval as cli
from repro_torch.obs import Observability
from repro_torch.serve import (
    FrontendConfig, ServeChurnConfig, ServeFailureConfig, run_serve_churn,
    run_serve_failure, run_serve_reshard,
)
from torch_parity_rules import race_free_announces

CHURN = dict(num_users=400, dim=16, k=5, L=3, capacity=32, epochs=4,
             num_queries=32, m=8, refresh_every=2, ttl_epochs=3, seed=5)
FAILURE = dict(num_users=1200, dim=32, k=5, L=2, capacity=64, epochs=6,
               num_queries=64, update_rate=0.1, churn_rate=0.03,
               refresh_every=2, seed=3)


@pytest.fixture(scope="module")
def ref():
    """JAX's `run_churn` and `run_serve_churn` on CHURN, and its
    hyperplanes."""
    jcfg = jchurn.ChurnConfig(**CHURN)
    with pytest.MonkeyPatch.context() as mp:
        race_free_announces(mp, jchurn)
        churn = jchurn.run_churn(jcfg)
    serve = jlifecycle.run_serve_churn(jlifecycle.ServeChurnConfig(
        churn=jcfg, query_repeats=2, max_batch=16, queue_capacity=64))
    return dict(churn=churn, serve=serve,
                hp=np.asarray(jchurn._lsh_setup(jcfg)[1]))


@pytest.mark.parametrize("depth,writer", [(1, None), (2, "inline"),
                                          (4, "thread")])
def test_serve_churn_recalls_equal_jax_run_churn(ref, depth, writer,
                                                 monkeypatch):
    cfg = ServeChurnConfig(churn=ChurnConfig(**CHURN), query_repeats=2,
                           max_batch=16, queue_capacity=64,
                           pipeline_depth=depth,
                           use_writer=writer is not None)
    if writer == "inline":
        # the writer's inline mode: prepare on the spot, install at the
        # next stage boundary
        from repro_torch.serve import lifecycle

        real = lifecycle.ChurnWriter
        monkeypatch.setattr(lifecycle, "ChurnWriter",
                            lambda fe: real(fe, inline=True))
    out = run_serve_churn(cfg, device="cpu", hyperplanes=ref["hp"])
    np.testing.assert_array_equal(out["recalls"], ref["churn"]["recalls"])
    assert out["repeat_mismatches"] == 0
    assert out["summary"]["hit_rate"] > 0.3
    gens = out["generations"]
    assert np.all(np.diff(gens) >= 0) and gens[-1] > gens[0]
    assert out["store_generation"] == gens[-1]
    want = ref["serve"]
    np.testing.assert_array_equal(gens, want["generations"])
    assert out["store_generation"] == want["store_generation"]
    for key in ("cache_hits", "cache_misses", "batches", "completed"):
        assert out["summary"][key] == want["summary"][key], key
    if writer is not None:
        assert out["writer_installed"] == 3  # every write epoch


def test_serve_churn_with_obs_publishes(ref):
    obs = Observability()
    out = run_serve_churn(ServeChurnConfig(
        churn=ChurnConfig(**CHURN), max_batch=16, queue_capacity=64),
        obs=obs, device="cpu", hyperplanes=ref["hp"])
    np.testing.assert_array_equal(out["recalls"], ref["churn"]["recalls"])
    assert obs.registry.value("serve_completed") == \
        out["summary"]["completed"]
    assert len(obs.flight.records(kind="dispatch")) > 0


def test_serve_reshard_tracks_jax_run_churn(ref):
    out = run_serve_reshard(
        ServeChurnConfig(churn=ChurnConfig(**CHURN), max_batch=16,
                         queue_capacity=64),
        device="cpu", hyperplanes=ref["hp"])
    np.testing.assert_array_equal(out["recalls"], ref["churn"]["recalls"])
    assert out["repeat_mismatches"] == 0
    assert out["swaps"] == 4  # one per read epoch
    assert out["stale_evictions"] >= 4 * 32
    assert out["cache_hits"] >= 4 * 32
    assert out["total_handoff_bytes"] == 0


@pytest.mark.parametrize("mode", ["first", "quorum"])
def test_serve_failure_meets_the_reference_assertions(mode):
    cfg = ServeFailureConfig(
        churn=ChurnConfig(**FAILURE), n_nodes=4, replication=2,
        read_mode=mode, kill_epoch=3, kill_node=1)
    obs = Observability()
    out = run_serve_failure(cfg, obs=obs, device="cpu")
    # tests/test_failure.py SERVE_FAILURE, as the reference states it
    assert out["repeat_mismatches"] == 0
    assert out["degraded"][cfg.kill_epoch - 1] and not out["degraded"][-1]
    assert out["recall_after_kill"] >= out["recall_before_kill"] - 0.05
    g = out["generations"]
    assert g[cfg.kill_epoch - 1] > g[cfg.kill_epoch - 2]
    assert out["stale_evictions"] > 0 and out["cache_hits"] > 0
    assert out["replication_bytes"] > 0 and out["recovery_bytes"] > 0
    assert out["stats"].dropped_probes == 0
    assert sum(d["reason"] == "kill_node" for d in obs.flight.dumps) == 1


def test_serve_failure_checks_its_schedule():
    with pytest.raises(ValueError, match="kill_epoch"):
        run_serve_failure(ServeFailureConfig(
            churn=ChurnConfig(**FAILURE), kill_epoch=9), device="cpu")
    with pytest.raises(ValueError, match="kill_node"):
        run_serve_failure(ServeFailureConfig(
            churn=ChurnConfig(**FAILURE), kill_node=4), device="cpu")


def test_configs_match_the_reference():
    from repro.serve import FrontendConfig as JFrontendConfig

    assert dataclasses.asdict(ServeChurnConfig()) == dataclasses.asdict(
        jlifecycle.ServeChurnConfig())
    assert dataclasses.asdict(ServeFailureConfig()) == dataclasses.asdict(
        jlifecycle.ServeFailureConfig())
    assert dataclasses.asdict(FrontendConfig()) == dataclasses.asdict(
        JFrontendConfig())


# -- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--no-cache"],
                                   ["--pipeline", "4"]])
def test_cli_closed_loop_smoke(capsys, extra):
    s = cli.main(["--smoke", "--device", "cpu"] + extra)
    assert "[smoke] OK" in capsys.readouterr().out
    assert s["completed"] + s["rejected"] + s["ring_full"] == 400
    if not extra:
        assert s["hit_rate"] > 0.2


def test_cli_closed_loop_smoke_with_trace_and_metrics(capsys, tmp_path):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    cli.main(["--smoke", "--device", "cpu", "--trace-out", str(trace),
              "--metrics-out", str(metrics)])
    text = capsys.readouterr().out
    assert "[smoke] OK" in text and "shadow recall probe" in text
    assert json.loads(trace.read_text())["traceEvents"]
    assert "serve_completed" in json.loads(metrics.read_text())


def test_cli_open_loop_smoke(capsys):
    # the offered rate is half the capacity the run measures, so it
    # follows the host's load; one intra-op thread keeps a loaded host
    # from slowing each batch by far more than its share
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ol = cli.main(["--smoke", "--device", "cpu", "--open-loop",
                       "--pipeline", "4"])
    finally:
        torch.set_num_threads(threads)
    text = capsys.readouterr().out
    assert "[smoke] OK" in text and "(depth 4)" in text
    assert ol["identical"] and ol["rate"] == pytest.approx(
        0.5 * ol["capacity"])
    assert ol["sync"].completed == ol["pipelined"].completed == 400
