"""Flight recorder: a bounded ring of structured query/dispatch records,
dumped automatically on anomalies (DESIGN.md Sec. 12).

The serving frontend and the churn drivers append `QueryRecord`s as they
run; the ring keeps only the most recent `capacity` records, so a
long-lived process carries a fixed-size black box.  When something goes
wrong — a dispatch drops probes (`drop_spike`), a node is killed, a
reshard fires — `note_anomaly` (or the automatic drop-spike trigger)
snapshots the ring into `dumps`, preserving exactly the records that
led up to the event even after the ring has wrapped past them.

Record kinds and their accounting contract:

  * ``kind="query"`` — one per served query: latency breakdown, cache
    hit/miss + generation, and its dispatch batch number.  Per-query
    cost fields are its batch's uniform per-row share.
  * ``kind="dispatch"`` / ``kind="epoch"`` — one per backend dispatch
    (or churn epoch): the EXACT `StepStats` totals for that step.
    Summing a stats field over these records reproduces the aggregate
    counters bit-for-bit (asserted by `failure_churn --smoke` against
    the driver's per-epoch arrays).
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque


@dataclasses.dataclass(slots=True)
class QueryRecord:
    """One flight-recorder entry; see the module docstring for kinds.

    `slots=True`: one record is appended per served query on the serving
    hot path, so construction cost is part of the obs overhead budget."""

    qid: int = -1                 # ticket (query) / sequence (dispatch/epoch)
    kind: str = "query"           # "query" | "dispatch" | "epoch" | "event"
    t_us: float = 0.0             # completion time, µs since recorder start
    latency_us: float = 0.0       # submit -> respond (query records)
    cache_hit: bool | None = None
    generation: int = -1          # store generation served under
    batch: int = -1               # dispatch sequence this query rode (-1: hit)
    batch_size: int = 0           # padded rows in that dispatch
    probes_issued: int = 0        # planned bucket probes (exact + near)
    probes_routed: int = 0        # rows sent through the capacitated router
    dropped_probes: int = 0       # router-overflow drops
    dropped_by_dest: tuple = ()   # per-destination overflow counts
    nodes_contacted: int = 0      # distinct (query, destination) deliveries
    replica_fanout: int = 1       # quorum fan-out (1 = first-responder)
    stage_us: dict = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)


class FlightRecorder:
    """Bounded record ring + anomaly dumps; see the module docstring."""

    def __init__(self, capacity: int = 4096, drop_spike: int = 1):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.drop_spike = drop_spike
        self._ring: deque[QueryRecord] = deque(maxlen=capacity)
        self.dumps: list[dict] = []
        self._t0 = time.perf_counter()

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def to_us(self, t_perf: float) -> float:
        """Map an absolute `time.perf_counter()` stamp onto this
        recorder's µs-since-start clock — lets a hot loop stamp a whole
        batch of records from one clock read (pass the result as
        `t_us=`) instead of paying `now_us()` per record."""
        return (t_perf - self._t0) * 1e6

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, rec: QueryRecord) -> QueryRecord:
        """Append one record; auto-dumps on a drop spike (a dispatch/epoch
        record losing >= `drop_spike` probes)."""
        if not rec.t_us:
            rec.t_us = self.now_us()
        self._ring.append(rec)
        if (
            self.drop_spike > 0
            and rec.kind in ("dispatch", "epoch")
            and rec.dropped_probes >= self.drop_spike
        ):
            self.note_anomaly(
                "drop_spike", qid=rec.qid, kind=rec.kind,
                dropped_probes=rec.dropped_probes,
            )
        return rec

    def records(self, kind: str | None = None) -> list[QueryRecord]:
        if kind is None:
            return list(self._ring)
        return [r for r in self._ring if r.kind == kind]

    def total(self, field: str, kind: str = "epoch"):
        """Sum a stats field (or an `extra` entry under that name) over
        the authoritative dispatch/epoch records of the ring."""
        direct = field in QueryRecord.__dataclass_fields__
        return sum(
            getattr(r, field) if direct else r.extra.get(field, 0)
            for r in self.records(kind)
        )

    def note_anomaly(self, reason: str, **detail) -> dict:
        """Snapshot the ring into `dumps` (kill_node, reshard, drop spike)."""
        dump = dict(
            reason=reason,
            detail=detail,
            t_us=self.now_us(),
            n_records=len(self._ring),
            records=[dataclasses.asdict(r) for r in self._ring],
        )
        self.dumps.append(dump)
        return dump

    # -- exports --------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """Records as Chrome trace events: queries become complete events
        on a `flight` track (ts at submit, dur = latency), dispatch/epoch
        records and dumps become instants."""
        import os

        pid = os.getpid()
        out = []
        for r in self._ring:
            args = {
                f.name: getattr(r, f.name)
                for f in dataclasses.fields(r)
                if f.name not in ("stage_us", "extra")
            }
            args.update(r.stage_us)
            args.update(r.extra)
            if r.kind == "query":
                out.append(dict(
                    name=f"query:{r.qid}", cat="flight", ph="X",
                    ts=max(r.t_us - r.latency_us, 0.0), dur=r.latency_us,
                    pid=pid, tid=1, args=args,
                ))
            else:
                out.append(dict(
                    name=f"{r.kind}:{r.qid}", cat="flight", ph="i",
                    ts=r.t_us, pid=pid, tid=1, s="t", args=args,
                ))
        for d in self.dumps:
            out.append(dict(
                name=f"anomaly:{d['reason']}", cat="flight", ph="i",
                ts=d["t_us"], pid=pid, tid=1, s="p",
                args=dict(d["detail"], n_records=d["n_records"]),
            ))
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                dict(
                    capacity=self.capacity,
                    records=[dataclasses.asdict(r) for r in self._ring],
                    dumps=self.dumps,
                ),
                f,
            )
