"""Serving telemetry for the online retrieval frontend (DESIGN.md Sec. 7).

One mutable `ServeStats` object rides along with a `RetrievalFrontend` and
aggregates everything the per-step objects only report individually:

  * request accounting — accepted / rejected (admission shed) /
    ring_full (transient backpressure, retryable) / completed, cache
    hits vs misses, dispatched batch sizes and padding overhead;
  * latency — per-request microseconds from submit to result, with
    p50/p99 read out of the recorded population, plus time-in-queue
    (submit to device stage) for the pipelined frontend;
  * network cost — the Table-1 `QueryCost` closed form is charged per
    *dispatched* (cache-miss) query and averaged over ALL completed
    queries, so a cache hit genuinely shows up as saved messages;
  * `dropped_probes` — router-overflow counts from the distributed steps,
    summed across batches (the PR-2 counted-never-silent discipline,
    surfaced at the serving summary instead of per-`SearchResult`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import costmodel


@dataclasses.dataclass
class ServeStats:
    """Mutable aggregate counters for one serving run."""

    accepted: int = 0        # requests admitted into the ring
    rejected: int = 0        # admission-control rejects (counted, not silent)
    ring_full: int = 0       # transient full-ring pushback (retryable —
    #                          distinct from `rejected`, which is a shed)
    completed: int = 0       # results delivered (hit or miss)
    cache_hits: int = 0
    cache_misses: int = 0
    batches: int = 0         # backend dispatches
    dispatched: int = 0      # cache-miss queries sent to the backend
    padded: int = 0          # dead rows added by pow-2 batch padding
    dropped_probes: int = 0  # router overflow across all dispatches
    # Table-1 cost accumulators (charged per dispatched query)
    messages: float = 0.0
    vectors_searched: float = 0.0
    nodes_contacted: float = 0.0
    # latency samples live in a fixed ring of the most recent
    # `latency_window` requests, so a long-lived frontend's memory stays
    # O(window), not O(total requests served)
    latency_window: int = 65536
    _lat: np.ndarray | None = None
    # time-in-queue samples (submit -> device stage), same ring discipline
    staged: int = 0
    _queue: np.ndarray | None = None
    _t_first: float | None = None
    _t_last: float | None = None

    # -- recording hooks (called by the frontend) ----------------------------

    def record_submit(self, admitted: bool) -> None:
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now
        if admitted:
            self.accepted += 1
        else:
            self.rejected += 1

    def record_ring_full(self) -> None:
        """One transient full-ring pushback — the RETRYABLE submit outcome
        (the caller may step/retry), kept apart from `rejected` so the
        two failure modes never collapse into one count again."""
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now
        self.ring_full += 1

    def record_queue_time(self, queue_us: float) -> None:
        """Time one request spent in the ring before its batch was staged
        onto the device queue."""
        if self._queue is None:
            self._queue = np.empty((self.latency_window,), np.float64)
        self._queue[self.staged % self.latency_window] = queue_us
        self.staged += 1

    def record_done(self, latency_us: float, *, hit: bool) -> None:
        if hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        if self._lat is None:
            self._lat = np.empty((self.latency_window,), np.float64)
        self._lat[self.completed % self.latency_window] = latency_us
        self.completed += 1
        self._t_last = time.perf_counter()

    def record_batch(
        self,
        n_queries: int,
        n_padded: int,
        dropped_probes: int,
        cost: costmodel.QueryCost | None,
    ) -> None:
        """One backend dispatch: `n_queries` live rows, `n_padded` dead
        rows, the router drop count, and the per-query Table-1 cost in
        effect (None when the backend has no closed form)."""
        self.batches += 1
        self.dispatched += int(n_queries)
        self.padded += int(n_padded)
        self.dropped_probes += int(dropped_probes)
        if cost is not None:
            self.messages += cost.messages * n_queries
            self.vectors_searched += cost.vectors_searched * n_queries
            self.nodes_contacted += cost.nodes_contacted * n_queries

    # -- read-out -------------------------------------------------------------

    @property
    def latencies_us(self) -> np.ndarray:
        """The retained latency samples (most recent `latency_window`)."""
        if self._lat is None:
            return np.empty((0,), np.float64)
        return self._lat[: min(self.completed, self.latency_window)]

    def percentile(self, p: float) -> float:
        """Latency percentile in microseconds over the retained window
        (0.0 when nothing completed — summaries must stay printable, and
        a nan would poison any downstream arithmetic silently)."""
        lat = self.latencies_us
        if lat.size == 0:
            return 0.0
        return float(np.percentile(lat, p))

    def queue_percentile(self, p: float) -> float:
        """Time-in-queue percentile in microseconds (same no-nan
        contract as `percentile`)."""
        if self._queue is None:
            return 0.0
        q = self._queue[: min(self.staged, self.latency_window)]
        if q.size == 0:
            return 0.0
        return float(np.percentile(q, p))

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / max(self.completed, 1)

    @property
    def wall_seconds(self) -> float:
        if self._t_first is None or self._t_last is None:
            return 0.0
        return max(self._t_last - self._t_first, 0.0)

    @property
    def qps(self) -> float:
        """Completed queries per wall second (0.0 before any completion —
        same no-nan contract as `percentile`)."""
        w = self.wall_seconds
        return self.completed / w if w > 0 else 0.0

    @property
    def messages_per_query(self) -> float:
        """Average overlay messages per COMPLETED query — cache hits cost 0,
        so this drops below the Table-1 closed form as the hit rate rises."""
        return self.messages / max(self.completed, 1)

    @property
    def nodes_contacted_per_query(self) -> float:
        """Average overlay nodes contacted per COMPLETED query (Table 1's
        first column, hit-rate discounted like `messages_per_query`)."""
        return self.nodes_contacted / max(self.completed, 1)

    def publish(self, registry, **labels) -> None:
        """Mirror the summary into an `repro_torch.obs` metrics registry — the
        machine-readable export surface (DESIGN.md Sec. 12); `summary()`
        stays as the in-process dict view.  Gauges, not counters: this
        object is already the accumulator, so publishing is an idempotent
        snapshot, safe to repeat mid-run."""
        for key, val in self.summary().items():
            registry.gauge(f"serve_{key}").set(float(val), **labels)

    def summary(self) -> dict:
        return dict(
            accepted=self.accepted,
            rejected=self.rejected,
            ring_full=self.ring_full,
            completed=self.completed,
            cache_hits=self.cache_hits,
            cache_misses=self.cache_misses,
            hit_rate=self.hit_rate,
            batches=self.batches,
            dispatched=self.dispatched,
            padded=self.padded,
            mean_batch=self.dispatched / max(self.batches, 1),
            dropped_probes=self.dropped_probes,
            messages_per_query=self.messages_per_query,
            nodes_contacted_per_query=self.nodes_contacted_per_query,
            vectors_searched_per_query=(
                self.vectors_searched / max(self.completed, 1)
            ),
            p50_us=self.percentile(50),
            p99_us=self.percentile(99),
            p50_queue_us=self.queue_percentile(50),
            p99_queue_us=self.queue_percentile(99),
            qps=self.qps,
        )

    def format_summary(self) -> str:
        s = self.summary()
        return (
            f"[serve] completed={s['completed']} rejected={s['rejected']} "
            f"ring_full={s['ring_full']} qps={s['qps']:.0f}\n"
            f"[serve] latency p50={s['p50_us']:.0f}us "
            f"p99={s['p99_us']:.0f}us  "
            f"batches={s['batches']} (mean size {s['mean_batch']:.1f}, "
            f"{s['padded']} padded rows)\n"
            f"[serve] cache hit rate={s['hit_rate']:.2f} "
            f"({s['cache_hits']}/{s['completed']})  "
            f"messages/query={s['messages_per_query']:.1f}  "
            f"nodes/query={s['nodes_contacted_per_query']:.1f}  "
            f"dropped_probes={s['dropped_probes']}"
        )
