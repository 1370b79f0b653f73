"""Unified observability layer (DESIGN.md Sec. 12), a copy of the JAX
package's `repro.obs` (numpy and the standard library only).

Three small host-side pieces, shared by serving, the churn drivers, and
the benchmarks:

  * `registry` — labeled counters / gauges / histograms with JSON and
    Prometheus-text snapshots.  THE sink every producer publishes into
    (`ServeStats.publish`, `MessageCounter.publish`, churn drivers),
    replacing the per-subsystem ad-hoc dict formats as the machine
    interface;
  * `trace` — a span API on `time.perf_counter` (monotonic — the repo's
    one timer, also used by the launch drivers and benchmarks for their
    wall-clock numbers), exportable as Chrome-trace-event JSON that
    loads directly in Perfetto / chrome://tracing;
  * `flight` — a bounded ring of structured per-query / per-dispatch
    `QueryRecord`s, dumped automatically on anomalies (drop spike,
    `kill_node`, reshard) so the records AROUND a failure survive it.

Everything here is host-side plain Python: enabling observability never
changes what the runtime computes (the `StepStats` output of the runtime
steps is always computed); tests/test_torch_obs.py holds the copies
against the reference's on the same calls.
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.obs.flight import FlightRecorder, QueryRecord
from repro_torch.obs.registry import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
from repro_torch.obs.trace import Span, Tracer, span_or_null

__all__ = [
    "REGISTRY",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "ObsConfig",
    "Observability",
    "QueryRecord",
    "Registry",
    "Span",
    "Tracer",
    "span_or_null",
]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Static observability knobs.

    Frozen on purpose: a consumer reads it once at construction, so the
    obs configuration cannot change what a run computes.
    """

    trace_capacity: int = 65536     # span ring (events, not bytes)
    flight_capacity: int = 4096     # flight-recorder ring (records)
    drop_spike: int = 1             # auto-dump when a dispatch/epoch record
    #                                 drops >= this many probes (<=0: off)
    recall_probe_every: int = 0     # shadow-rescore 1-in-N served queries
    #                                 (0 disables the recall probe)

    def __post_init__(self):
        if self.trace_capacity < 1 or self.flight_capacity < 1:
            raise ValueError("obs ring capacities must be >= 1")


class Observability:
    """One bundle of (config, registry, tracer, flight recorder).

    Pass it to `RetrievalFrontend(obs=...)` or the churn drivers; pass
    None (the default everywhere) and nothing is recorded.
    """

    def __init__(
        self,
        config: ObsConfig = ObsConfig(),
        registry: Registry | None = None,
        tracer: Tracer | None = None,
        flight: FlightRecorder | None = None,
    ):
        self.config = config
        self.registry = Registry() if registry is None else registry
        self.tracer = (
            Tracer(capacity=config.trace_capacity) if tracer is None
            else tracer
        )
        self.flight = (
            FlightRecorder(
                capacity=config.flight_capacity,
                drop_spike=config.drop_spike,
            )
            if flight is None
            else flight
        )

    def chrome_trace(self) -> dict:
        """Spans + flight records as one Chrome-trace-event document."""
        doc = self.tracer.to_chrome_trace()
        doc["traceEvents"].extend(self.flight.to_chrome_trace()["traceEvents"])
        return doc

    def export_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def export_metrics(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.registry.snapshot(), f, indent=1, sort_keys=True)
