"""Open-loop load against the retrieval frontend, and the sweep for the
highest rate that meets a latency limit.

A copy of `repro_torch.serve.loadgen` (`run_open_loop`,
`max_qps_at_slo`), kept here so that a change to the program cannot move
the yardstick.  Latency is measured from each query's SCHEDULED arrival,
so a loop that was busy when a query came due charges the wait to the
server, and shed queries are counted.  Changes from the program's copy:
the loop runs inside the harness's `spans`, keeps each answer's scores
beside its ids for the check, and `p99_ms` counts every shed query as
one that missed any limit.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serve.frontend import NO_EXCLUDE, SubmitReject


def poisson_arrivals(rate_qps: float, n: int, seed: int = 0) -> np.ndarray:
    """Scheduled arrival times (seconds from t0) of `n` queries offered
    at `rate_qps`: a Poisson process."""
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    gaps = np.random.default_rng(seed).exponential(1.0 / rate_qps, size=n)
    return np.cumsum(gaps)


@dataclasses.dataclass
class OpenLoopResult:
    """One open-loop run: latencies measured from the schedule, the shed
    count, and each served arrival's answer."""

    offered_qps: float
    arrivals: int
    completed: int
    shed: int
    duration_s: float
    latencies_ms: np.ndarray          # per arrival, schedule -> done; nan
    #                                   where no answer came
    answers: dict                     # arrival index -> (ids, scores)
    summary: dict                     # the frontend's ServeStats summary

    def percentile_ms(self, p: float) -> float:
        """The p-th percentile over EVERY arrival, a shed or unanswered
        one counted as infinitely late."""
        if self.latencies_ms.size == 0:
            return float("inf")
        lat = np.where(np.isnan(self.latencies_ms), np.inf,
                       self.latencies_ms)
        with np.errstate(invalid="ignore"):
            v = float(np.percentile(lat, p))
        return v if v == v else float("inf")

    @property
    def p99_ms(self) -> float:
        return self.percentile_ms(99)

    def slo_ok(self, p99_slo_ms: float) -> bool:
        """The limit: p99 under the bound AND nothing shed."""
        return self.shed == 0 and self.p99_ms <= p99_slo_ms


def run_open_loop(frontend, queries: np.ndarray, arrivals: np.ndarray,
                  exclude: np.ndarray | None = None,
                  spans=None) -> OpenLoopResult:
    """Serve `queries[i]` at scheduled time `arrivals[i]` through
    `frontend`: submit every due arrival, advance the step machine
    (`frontend.pump`), drain completed tickets, and sleep to the next
    arrival rather than spin.  Runs until every admitted query has its
    answer."""
    import contextlib

    span = spans or (lambda name: contextlib.nullcontext())
    n = len(arrivals)
    if len(queries) != n:
        raise ValueError(f"{len(queries)} queries for {n} arrivals")
    lat_ms = np.full(n, np.nan)
    answers: dict = {}
    ticket_arrival: dict = {}
    shed = 0
    i = 0
    t0 = time.perf_counter()

    def drain():
        with span("lshbench/readback"):
            done = frontend.take_results()
        if done:
            now = time.perf_counter() - t0
            for tk, ans in done.items():
                a = ticket_arrival.pop(tk, None)
                if a is not None:
                    lat_ms[a] = (now - arrivals[a]) * 1e3
                    answers[a] = ans

    while i < n or frontend.pending or frontend.inflight or ticket_arrival:
        now = time.perf_counter() - t0
        if i < n and arrivals[i] <= now:
            with span("lshbench/submit"):
                while i < n and arrivals[i] <= now:
                    ex = NO_EXCLUDE if exclude is None else int(exclude[i])
                    t = frontend.submit(queries[i], ex)
                    if isinstance(t, SubmitReject):
                        shed += 1
                    else:
                        ticket_arrival[t] = i
                    i += 1
        with span("lshbench/pump"):
            frontend.pump()
        drain()
        if i < n:
            gap = arrivals[i] - (time.perf_counter() - t0)
            if gap > 0.0002 and not (
                frontend.pending >= frontend.cfg.max_batch
            ):
                with span("lshbench/sleep"):
                    time.sleep(min(gap - 0.0001, 0.002))
        elif not (frontend.pending or frontend.inflight):
            break
    with span("lshbench/pump"):
        frontend.flush()
    drain()
    duration = time.perf_counter() - t0
    return OpenLoopResult(
        offered_qps=float(n / arrivals[-1]) if n else 0.0,
        arrivals=n,
        completed=int((~np.isnan(lat_ms)).sum()),
        shed=shed,
        duration_s=duration,
        latencies_ms=lat_ms,
        answers=answers,
        summary=frontend.stats.summary(),
    )


def max_qps_at_slo(make_frontend, queries: np.ndarray, rates, *,
                   p99_slo_ms: float, n_arrivals, seed: int = 0,
                   trials: int = 2, exclude: np.ndarray | None = None,
                   on_result=None):
    """Sweep a rate ladder; returns (highest passing rate, knee).

    `make_frontend()` builds a fresh frontend per trial over the shared
    warm runtime.  Each rate runs `trials` schedules and keeps the median
    p99 and the largest shed count; `knee` is [(rate, p99_ms, shed)].
    `n_arrivals(rate)` sizes each trial; `on_result(rate, frontend,
    result)` sees every trial."""
    knee = []
    best = 0.0
    nq = len(queries)
    for r_i, rate in enumerate(rates):
        p99s, sheds = [], 0
        n = int(n_arrivals(rate))
        for t_i in range(trials):
            arr = poisson_arrivals(float(rate), n,
                                   seed=seed + 1000 * r_i + t_i)
            pick = np.random.default_rng(seed + t_i).integers(0, nq, size=n)
            fe = make_frontend()
            res = run_open_loop(fe, queries[pick], arr,
                                exclude=None if exclude is None
                                else exclude[pick])
            if on_result is not None:
                on_result(float(rate), fe, res)
            p99s.append(res.p99_ms)
            sheds = max(sheds, res.shed)
        p99 = float(np.median(p99s))
        knee.append((float(rate), p99, int(sheds)))
        if sheds == 0 and p99 <= p99_slo_ms:
            best = max(best, float(rate))
    return best, knee
