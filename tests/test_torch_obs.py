"""`repro_torch.obs` (a copy of the JAX package's `repro.obs`) behaves as
the reference on the same calls: the metrics registry's snapshot and
Prometheus text, the tracer's events and Chrome trace, the flight
recorder's records, dumps, totals and exports, and the bundle's merged
exports are equal, wall-clock stamps aside.  The churn driver feeds both
the same epoch records and registry counters on the same trajectory.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.core import churn as jchurn
from repro_torch.core import churn as tchurn
from torch_parity_rules import race_free_announces

PACKAGES = [jobs, tobs]
STAMPS = ("t_us", "ts", "dur")


def unstamped(x):
    """`x` with every wall-clock field (t_us, ts, dur) removed, nested."""
    if isinstance(x, dict):
        return {k: unstamped(v) for k, v in x.items() if k not in STAMPS}
    if isinstance(x, (list, tuple)):
        return [unstamped(v) for v in x]
    return x


def both(script):
    """Run `script(obs_package)` on the reference and on the copy."""
    return [script(pkg) for pkg in PACKAGES]


def registry_script(pkg):
    reg = pkg.Registry()
    c = reg.counter("c_total", "help text")
    c.inc(4, node="0")
    c.inc(2, node="1")
    c.inc(1, node="0")
    reg.gauge("g").set(1.5)
    reg.gauge("g").set(2.5, window="last")
    h = reg.histogram("h", buckets=(10.0, 100.0))
    for v in (3.0, 30.0, 300.0):
        h.observe(v, op="q")
    h.observe_many(np.array([1.0, 50.0, 5000.0]), op="r")
    errors = []
    for make in (lambda: reg.gauge("c_total"),
                 lambda: reg.histogram("g")):
        try:
            make()
        except TypeError as e:
            errors.append(str(e))
    return dict(snapshot=reg.snapshot(), text=reg.prometheus_text(),
                q=[h.quantile(p, op="q") for p in (0.1, 0.5, 0.99)],
                count=h.value(op="r"), same=reg.counter("c_total") is c,
                value=reg.value("c_total", node="0"),
                labels=c.labelsets(), missing=reg.get("nope"),
                errors=errors)


def tracer_script(pkg):
    tr = pkg.Tracer(capacity=4)
    with tr.span("outer", cat="a", x=1):
        with tr.span("inner", y=2):
            tr.instant("mark", z=3)
        depth = tr.depth
    try:
        with tr.span("raises"):
            raise KeyError("boom")
    except KeyError:
        pass
    for i in range(3):  # wraps the ring
        with tr.span(f"s{i}"):
            pass
    off = pkg.Tracer(enabled=False)
    with off.span("quiet") as sp:
        pass
    null = pkg.span_or_null(None, "x")
    # events: (ph, name, cat, ts, dur, depth, args), less ts and dur
    return dict(events=[e[:3] + e[5:] for e in tr.events()],
                depth=depth, chrome=unstamped(tr.to_chrome_trace()),
                off=off.events(), timed=sp.duration_s >= 0.0,
                null=type(null).__name__)


def flight_script(pkg):
    Q = pkg.QueryRecord
    fl = pkg.FlightRecorder(capacity=3, drop_spike=2)
    fl.record(Q(qid=0, kind="query", dropped_probes=99, latency_us=5.0,
                t_us=10.0))
    fl.record(Q(qid=1, kind="dispatch", dropped_probes=1))
    fl.record(Q(qid=2, kind="dispatch", dropped_probes=2,
                extra=dict(replication_bytes=7)))
    fl.record(Q(qid=3, kind="epoch", dropped_probes=0,
                extra=dict(replication_bytes=5), stage_us=dict(a=1.0)))
    fl.note_anomaly("kill_node", node=3, epoch=2)
    totals = {f: fl.total(f) for f in ("dropped_probes", "replication_bytes",
                                       "never_charged")}
    totals["dispatch"] = fl.total("dropped_probes", kind="dispatch")
    return dict(
        records=unstamped([dataclasses.asdict(r) for r in fl.records()]),
        epochs=len(fl.records(kind="epoch")), length=len(fl),
        dumps=unstamped(fl.dumps), totals=totals,
        chrome=unstamped(fl.to_chrome_trace()),
        schema=[(f.name, f.default if f.default is not dataclasses.MISSING
                 else None) for f in dataclasses.fields(Q)])


def test_registry_matches_the_reference():
    want, got = both(registry_script)
    assert got == want
    json.dumps(got["snapshot"])


def test_tracer_matches_the_reference():
    want, got = both(tracer_script)
    assert got == want
    assert [e[1] for e in got["events"]] == ["raises", "s0", "s1", "s2"]


def test_flight_recorder_matches_the_reference(tmp_path):
    want, got = both(flight_script)
    assert got == want
    assert [d["reason"] for d in got["dumps"]] == ["drop_spike", "kill_node"]


def test_bundle_exports_match_the_reference(tmp_path):
    blobs = []
    for pkg in PACKAGES:
        obs = pkg.Observability(pkg.ObsConfig(flight_capacity=8))
        with obs.tracer.span("stage", cat="serve"):
            pass
        obs.flight.record(pkg.QueryRecord(qid=1, kind="query",
                                          latency_us=10.0))
        obs.registry.counter("c").inc(2)
        tp = tmp_path / f"{pkg.__name__}-t.json"
        mp = tmp_path / f"{pkg.__name__}-m.json"
        obs.export_trace(str(tp))
        obs.export_metrics(str(mp))
        with pytest.raises(ValueError, match="capacities"):
            pkg.ObsConfig(trace_capacity=0)
        blobs.append((unstamped(json.loads(tp.read_text())),
                      json.loads(mp.read_text()), sorted(pkg.__all__)))
    assert blobs[1] == blobs[0]


def test_churn_feeds_the_same_records_as_the_reference(monkeypatch):
    """The 1-node churn driver, run with observability on, leaves the
    same epoch records and registry counters as the reference's, and the
    records sum exactly to the aggregate arrays."""
    race_free_announces(monkeypatch, jchurn)
    kw = dict(num_users=600, dim=16, k=4, L=2, capacity=32, epochs=4,
              num_queries=32, seed=2)
    jcfg = jchurn.ChurnConfig(**kw)
    jo = jobs.Observability()
    want = jchurn.run_churn_runtime(jcfg, jchurn.make_churn_runtime(jcfg),
                                    obs=jo)
    to = tobs.Observability()
    tcfg = tchurn.ChurnConfig(**kw)
    got = tchurn.run_churn(tcfg, device="cpu", obs=to,
                           hyperplanes=np.asarray(jchurn._lsh_setup(jcfg)[1]))
    np.testing.assert_array_equal(got["recalls"], want["recalls"])
    recs = [unstamped(dataclasses.asdict(r))
            for r in to.flight.records(kind="epoch")]
    assert recs == [unstamped(dataclasses.asdict(r))
                    for r in jo.flight.records(kind="epoch")]
    assert to.registry.snapshot() == jo.registry.snapshot()
    assert to.flight.total("refresh_bytes") == got["total_refresh_bytes"]
    assert to.flight.total("dropped_probes") == int(
        got["dropped_probes"].sum())
    assert len(recs) == tcfg.epochs + 1
