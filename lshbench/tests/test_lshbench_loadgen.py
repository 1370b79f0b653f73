"""The copied open-loop arithmetic: latency from the schedule, and the
p99 taken over every request of the window, a shed one counted as
missing any limit."""

import numpy as np

from lshbench import loadgen
from lshbench.loadgen import OpenLoopResult


def result(lat, shed=0):
    lat = np.asarray(lat, dtype=float)
    return OpenLoopResult(1.0, lat.size, int((~np.isnan(lat)).sum()), shed,
                          1.0, lat, {}, {})


def test_p99_is_over_every_request():
    lat = np.arange(1, 1001, dtype=float)
    assert result(lat).p99_ms == np.percentile(lat, 99)
    assert result(lat).percentile_ms(50) == np.percentile(lat, 50)


def test_a_shed_request_misses_any_limit():
    lat = np.arange(1, 1001, dtype=float)
    lat[:20] = np.nan                     # 2 % never answered
    r = result(lat, shed=20)
    assert r.p99_ms == float("inf") and not r.slo_ok(1e9)
    lat = np.arange(1, 1001, dtype=float)
    lat[:5] = np.nan                      # 0.5 %: the tail is finite
    assert np.isfinite(result(lat, shed=5).p99_ms)
    assert not result(lat, shed=5).slo_ok(1e9)


class FakeFrontend:
    """Answers each query on the pump after it was submitted; refuses
    every seventh submission."""

    class cfg:
        max_batch = 8

    def __init__(self):
        self.pending = 0
        self.inflight = 0
        self._queue, self._done, self._n = [], {}, 0

    def submit(self, q, ex):
        self._n += 1
        if self._n % 7 == 0:
            return loadgen.SubmitReject("ring_full", True)
        self._queue.append((self._n, ex))
        self.pending = len(self._queue)
        return self._n

    def pump(self):
        for t, ex in self._queue:
            self._done[t] = (np.array([ex]), np.array([1.0]))
        self._queue = []
        self.pending = 0

    def take_results(self):
        out, self._done = self._done, {}
        return out

    def flush(self):
        self.pump()

    class stats:
        @staticmethod
        def summary():
            return {}


def test_every_arrival_gets_a_latency_or_counts_as_shed():
    arr = np.linspace(0.001, 0.05, 35)
    q = np.zeros((35, 4), np.float32)
    res = loadgen.run_open_loop(FakeFrontend(), q, arr,
                                exclude=np.arange(35))
    assert res.shed == 5 and res.completed == 30 and res.arrivals == 35
    answered = ~np.isnan(res.latencies_ms)
    assert answered.sum() == 30 and (res.latencies_ms[answered] >= 0).all()
    for a, (ids, _) in res.answers.items():
        assert ids[0] == a



def test_the_sweeps_rows_are_made_when_asked_for():
    import importlib.util
    from pathlib import Path

    path = Path(loadgen.__file__).parent / "sweep.py"
    spec = importlib.util.spec_from_file_location("lshbench_sweep", path)
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    asked = []

    def rows(users):
        asked.append(users.copy())
        return np.repeat(users[:, None].astype(np.float32), 3, axis=1)

    r = sweep.UserRows(rows, np.array([5, 6, 7, 8]))
    assert len(r) == 4 and not asked
    sub = r[np.array([3, 1])]
    assert len(sub) == 2 and not asked
    assert sub[0].tolist() == [8.0, 8.0, 8.0]
    assert r[np.int64(2)].tolist() == [7.0, 7.0, 7.0]
    assert len(asked) == 2
