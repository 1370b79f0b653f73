"""Open-loop load generation: offered load decoupled from completion
(DESIGN.md Sec. 13).

A closed-loop driver submits the next request only after an earlier one
finishes, so its "qps" is just the service rate and its latency hides
queueing behind the submit gate — the coordinated-omission trap: the
slower the server, the less load the measurement applies.  The open-loop
generator instead draws a Poisson arrival schedule at a FIXED offered
rate before the run, stamps every query with its SCHEDULED arrival time,
and measures latency from that stamp.  If the serving loop was blocked
when an arrival came due, the late submission counts against the server,
exactly as a real client would experience it.

`run_open_loop` drives one `RetrievalFrontend` (any `pipeline_depth`)
through a schedule; `max_qps_at_slo` sweeps a rate ladder and reports
the highest offered rate whose p99 (measured from schedule) meets the
SLO with nothing shed — the "max qps at SLO" headline plus the full
qps-vs-p99 knee curve.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serve.frontend import NO_EXCLUDE, SubmitReject


def poisson_arrivals(rate_qps: float, n: int, seed: int = 0,
                     deterministic: bool = False) -> np.ndarray:
    """Scheduled arrival times (seconds from t0) for `n` queries at
    `rate_qps` offered.  Poisson process (exponential gaps) by default;
    `deterministic=True` spaces them uniformly — the low-variance
    schedule the smoke tests use."""
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    if deterministic:
        return (np.arange(n) + 1.0) / rate_qps
    gaps = np.random.default_rng(seed).exponential(1.0 / rate_qps, size=n)
    return np.cumsum(gaps)


@dataclasses.dataclass
class OpenLoopResult:
    """One open-loop run: latency population measured from the arrival
    SCHEDULE, plus the shed count (ring-full pushback and admission
    rejects both count — an unserved arrival is an SLO event, whatever
    the frontend called it)."""

    offered_qps: float
    completed: int
    shed: int
    duration_s: float
    latencies_ms: np.ndarray          # per completed arrival, schedule->done
    ids: dict                          # arrival index -> served ids
    summary: dict                      # the frontend's ServeStats summary

    @property
    def served_qps(self) -> float:
        return self.completed / self.duration_s if self.duration_s > 0 else 0.0

    def percentile_ms(self, p: float) -> float:
        if self.latencies_ms.size == 0:
            return float("inf")
        return float(np.percentile(self.latencies_ms, p))

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50)

    @property
    def p99_ms(self) -> float:
        return self.percentile_ms(99)

    def slo_ok(self, p99_slo_ms: float) -> bool:
        """SLO = p99 under the bound AND nothing shed."""
        return self.shed == 0 and self.p99_ms <= p99_slo_ms


def run_open_loop(frontend, queries: np.ndarray,
                  arrivals: np.ndarray,
                  exclude: np.ndarray | None = None,
                  on_tick=None) -> OpenLoopResult:
    """Serve `queries[i]` at scheduled time `arrivals[i]` through
    `frontend`; returns the latency population measured from schedule.

    The loop alternates three duties: submit every due arrival, advance
    the step machine (`frontend.pump` — blocking per batch at
    `pipeline_depth=1`, non-blocking staging above it), and drain
    completed tickets.  Between duties it SLEEPS to the next arrival
    rather than spinning — a spin would steal the core from the device
    compute it is supposedly waiting for.

    `on_tick(now_s)`, called once per loop iteration with elapsed time,
    is the maintenance hook: a churn driver uses it to fire write epochs
    mid-run — either INLINE (prep + apply on this thread: the epoch's
    full cost lands as a serving stall, the synchronous architecture) or
    via a background `ChurnWriter` (hand the prep off-thread; the
    prepared update installs at the next stage boundary)."""
    n = len(arrivals)
    if len(queries) != n:
        raise ValueError(f"{len(queries)} queries for {n} arrivals")
    lat_ms = np.full(n, np.nan)
    ids: dict = {}
    ticket_arrival: dict = {}
    shed = 0
    i = 0
    t0 = time.perf_counter()

    def drain():
        done = frontend.take_results()
        if done:
            now = time.perf_counter() - t0
            for tk, (r_ids, _scores) in done.items():
                a = ticket_arrival.pop(tk, None)
                if a is not None:
                    lat_ms[a] = (now - arrivals[a]) * 1e3
                    ids[a] = r_ids

    while i < n or frontend.pending or frontend.inflight or ticket_arrival:
        now = time.perf_counter() - t0
        if on_tick is not None:
            on_tick(now)
        while i < n and arrivals[i] <= now:
            ex = NO_EXCLUDE if exclude is None else int(exclude[i])
            t = frontend.submit(queries[i], ex)
            if isinstance(t, SubmitReject):
                shed += 1
            else:
                ticket_arrival[t] = i
            i += 1
        frontend.pump()
        drain()
        if i < n:
            gap = arrivals[i] - (time.perf_counter() - t0)
            if gap > 0.0002 and not (
                frontend.pending >= frontend.cfg.max_batch
            ):
                time.sleep(min(gap - 0.0001, 0.002))
        elif not (frontend.pending or frontend.inflight):
            break
    frontend.flush()
    drain()
    duration = time.perf_counter() - t0
    done_mask = ~np.isnan(lat_ms)
    return OpenLoopResult(
        offered_qps=float(n / arrivals[-1]) if n else 0.0,
        completed=int(done_mask.sum()),
        shed=shed,
        duration_s=duration,
        latencies_ms=lat_ms[done_mask],
        ids=ids,
        summary=frontend.stats.summary(),
    )


def max_qps_at_slo(make_frontend, queries: np.ndarray,
                   rates: np.ndarray, *, p99_slo_ms: float,
                   n_arrivals: int, seed: int = 0, trials: int = 2,
                   exclude: np.ndarray | None = None, make_tick=None):
    """Sweep a rate ladder; returns (max_passing_qps, knee).

    `make_frontend()` builds a FRESH frontend per trial (steady-state
    stats, cold result cache) over the shared warm runtime;
    `make_tick(frontend)`, when given, builds that trial's maintenance
    hook (see `run_open_loop`).  Each rate runs `trials` independent
    schedules and keeps the MEDIAN p99 — one descheduled trial on a
    noisy host cannot flip a rung by itself — and the worst (max) shed
    count, so shedding can never be averaged away.  `knee` is the
    [(rate, p99_ms, shed), ...] curve; the headline is the highest rung
    that met the SLO."""
    knee = []
    best = 0.0
    nq = len(queries)
    for r_i, rate in enumerate(rates):
        p99s, sheds = [], 0
        for t_i in range(trials):
            arr = poisson_arrivals(float(rate), n_arrivals,
                                   seed=seed + 1000 * r_i + t_i)
            pick = np.random.default_rng(seed + t_i).integers(
                0, nq, size=n_arrivals)
            fe = make_frontend()
            res = run_open_loop(fe, queries[pick], arr,
                                exclude=None if exclude is None
                                else exclude[pick],
                                on_tick=None if make_tick is None
                                else make_tick(fe))
            if fe.writer is not None:  # tick attached a ChurnWriter:
                fe.writer.close()      # the sweep owns the teardown
            p99s.append(res.p99_ms)
            sheds = max(sheds, res.shed)
        p99 = float(np.median(p99s))
        knee.append((float(rate), p99, int(sheds)))
        if sheds == 0 and p99 <= p99_slo_ms:
            best = max(best, float(rate))
    return best, knee
