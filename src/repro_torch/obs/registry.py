"""Labeled metrics registry: counters, gauges, histograms (DESIGN.md
Sec. 12).

One `Registry` holds named metrics; each metric holds one series per
label set (labels are plain keyword arguments).  Two export formats:

  * `snapshot()` — a JSON-able dict (what `--metrics-out` writes and
    `benchmarks/run.py --json` reads columns from);
  * `prometheus_text()` — the Prometheus text exposition format, so a
    scrape endpoint needs nothing beyond serving this string.

Registration is idempotent: asking for an existing name returns the same
metric object (re-registering under a different kind is an error), so
library code can `registry.counter("x").inc()` without coordinating
who creates what.  Everything is plain host-side Python — publishing is
never traced.
"""

from __future__ import annotations

import bisect

import numpy as np

# default histogram buckets: microsecond-latency oriented, widening
# geometrically; anything above the last edge lands in +Inf
DEFAULT_BUCKETS = (
    50.0, 100.0, 250.0, 500.0, 1_000.0, 2_500.0, 5_000.0, 10_000.0,
    25_000.0, 50_000.0, 100_000.0, 250_000.0, 1_000_000.0,
)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple, extra: tuple = ()) -> str:
    parts = [f'{k}="{v}"' for k, v in (*key, *extra)]
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict[tuple, object] = {}

    def labelsets(self) -> list[dict]:
        return [dict(k) for k in self._series]


class Counter(_Metric):
    """Monotonic accumulator (`inc`); one value per label set."""

    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: inc({value}) < 0")
        k = _label_key(labels)
        self._series[k] = self._series.get(k, 0) + value

    def value(self, **labels):
        return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Last-write-wins value (`set`); one value per label set."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[_label_key(labels)] = float(value)

    def value(self, **labels):
        return self._series.get(_label_key(labels))


class Histogram(_Metric):
    """Cumulative-bucket histogram (`observe`); Prometheus semantics."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {self.name}: needs >= 1 bucket")

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        st = self._series.get(k)
        if st is None:
            # one slot per finite bucket plus +Inf
            st = self._series[k] = {
                "counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0,
                "count": 0,
            }
        st["counts"][bisect.bisect_left(self.buckets, float(value))] += 1
        st["sum"] += float(value)
        st["count"] += 1

    def observe_many(self, values, **labels) -> None:
        """Bulk `observe`: one vectorized pass over a batch of samples.
        Hot-path API — the serving frontend observes queue time for
        every ring row of every staged batch, and a Python-level
        `observe` per row is measurable against its near-zero-overhead
        budget (bench `serve/obs_overhead`)."""
        vals = np.asarray(values, dtype=float)
        if vals.size == 0:
            return
        k = _label_key(labels)
        st = self._series.get(k)
        if st is None:
            st = self._series[k] = {
                "counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0,
                "count": 0,
            }
        # searchsorted(side='left') == bisect_left: same bucket edges
        idx, cnt = np.unique(
            np.searchsorted(self.buckets, vals, side="left"),
            return_counts=True)
        for i, c in zip(idx, cnt):
            st["counts"][int(i)] += int(c)
        st["sum"] += float(vals.sum())
        st["count"] += int(vals.size)

    def value(self, **labels):
        """Observation count for the label set (0 when never observed)."""
        st = self._series.get(_label_key(labels))
        return 0 if st is None else st["count"]

    def quantile(self, q: float, **labels) -> float:
        """Bucket-resolution quantile: the upper edge of the first bucket
        whose cumulative count covers q (conservative, like Prometheus'
        `histogram_quantile` without interpolation)."""
        st = self._series.get(_label_key(labels))
        if st is None or st["count"] == 0:
            return 0.0
        target = q * st["count"]
        cum = 0
        for i, c in enumerate(st["counts"]):
            cum += c
            if cum >= target:
                return self.buckets[i] if i < len(self.buckets) \
                    else float("inf")
        return float("inf")


class Registry:
    """A namespace of metrics; see the module docstring."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {cls.kind}"
                )
            return m
        m = cls(name, help, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def value(self, name: str, default=None, **labels):
        """Convenience read: the metric's value for a label set, or
        `default` when the metric or series does not exist."""
        m = self._metrics.get(name)
        if m is None:
            return default
        v = m.value(**labels)
        return default if v is None else v

    def reset(self) -> None:
        self._metrics.clear()

    # -- exports --------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able snapshot: {name: {type, help, samples: [...]}}.

        Counter/gauge samples are {labels, value}; histogram samples are
        {labels, count, sum, buckets: {upper_edge: cumulative_count}}.
        """
        out = {}
        for name, m in sorted(self._metrics.items()):
            samples = []
            for key, st in sorted(m._series.items()):
                labels = dict(key)
                if m.kind == "histogram":
                    cum, buckets = 0, {}
                    for i, c in enumerate(st["counts"]):
                        cum += c
                        edge = (f"{m.buckets[i]:g}"
                                if i < len(m.buckets) else "+Inf")
                        buckets[edge] = cum
                    samples.append(dict(labels=labels, count=st["count"],
                                        sum=st["sum"], buckets=buckets))
                else:
                    samples.append(dict(labels=labels, value=st))
            out[name] = dict(type=m.kind, help=m.help, samples=samples)
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one scrape body)."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, st in sorted(m._series.items()):
                if m.kind == "histogram":
                    cum = 0
                    for i, c in enumerate(st["counts"]):
                        cum += c
                        edge = (f"{m.buckets[i]:g}"
                                if i < len(m.buckets) else "+Inf")
                        lines.append(
                            f"{name}_bucket"
                            f"{_label_str(key, (('le', edge),))} {cum}"
                        )
                    lines.append(f"{name}_sum{_label_str(key)} {st['sum']:g}")
                    lines.append(
                        f"{name}_count{_label_str(key)} {st['count']}")
                else:
                    lines.append(f"{name}{_label_str(key)} {st:g}")
        return "\n".join(lines) + ("\n" if lines else "")


# the process-default registry: CLIs and benchmarks publish here unless
# handed an explicit one (tests build their own for isolation)
REGISTRY = Registry()
