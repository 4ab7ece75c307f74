"""Lightweight counter/histogram registry: the port's own copy of the JAX
package's `obs.metrics`, with the same names and behaviour.

A long-lived process reports here what it wants to count without attaching
a profiler. The resilience layer (`repro_torch.resilience`) reports under
`resilience.*`: `ladder_attempts` / `ladder_escalations` /
`ladder_exhausted` (the checked operators' ladders), `degradations` and
`faults_fired` / `oom_injected` (fault injection); the ladders also count
`core.overflow_escalations`. Metrics are plain Python (no locks beyond the
GIL's atomicity for `+=` on ints): incrementing a counter costs one dict
lookup and an add.

Usage::

    from repro_torch.obs import metrics

    metrics.counter("resilience.ladder_attempts").inc()
    metrics.histogram("engine.run_wall_s").observe(dt)
    metrics.snapshot()   # {name: value | summary-dict}, for reporting
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Counter:
    """Monotone event count."""

    name: str
    value: int = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def as_value(self):
        return self.value


# Percentiles need retained observations; cap the buffer so a long-lived
# server's histograms stay O(1) memory. At the cap, every other retained
# sample is dropped and the keep-stride doubles — a deterministic (no RNG)
# systematic sample that stays uniformly spread over the whole stream.
SAMPLE_CAP = 4096


def percentiles(values, pcts=(50, 95, 99)) -> dict:
    """Nearest-rank percentiles over raw values: ``{"p50": ..., ...}``.
    Shared by Histogram.summary() and anything holding its own latency
    list (BENCH writers); benches should stop hand-rolling medians."""
    out = {}
    s = sorted(float(v) for v in values)
    for p in pcts:
        key = f"p{p:g}"
        if not s:
            out[key] = 0.0
            continue
        rank = max(int(-(-len(s) * p // 100)), 1)  # ceil, 1-based
        out[key] = s[min(rank, len(s)) - 1]
    return out


@dataclasses.dataclass
class Histogram:
    """Streaming summary of an observed quantity (count/sum/min/max/last)
    plus a bounded sample buffer for percentile export.

    No buckets: the consumers here (CLI tables, BENCH_*.json rows) want
    moments and a few percentiles, and a full histogram would force a
    bucket-boundary choice on every metric. `mean` is derived; percentiles
    are nearest-rank over the retained samples (exact until SAMPLE_CAP
    observations, a deterministic stride-thinned approximation after)."""

    name: str
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    last: float = 0.0
    samples: list = dataclasses.field(default_factory=list, repr=False)
    stride: int = 1  # keep every stride-th observation (doubles at the cap)

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        self.min = x if x < self.min else self.min
        self.max = x if x > self.max else self.max
        self.last = x
        if (self.count - 1) % self.stride == 0:
            self.samples.append(x)
            if len(self.samples) >= SAMPLE_CAP:
                self.samples = self.samples[::2]
                self.stride *= 2

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        return percentiles(self.samples, (p,))[f"p{p:g}"]

    def summary(self, pcts=(50, 95, 99)) -> dict:
        """Moments + percentiles, JSON-ready — the BENCH_serve.json /
        ServeEngine latency-report shape."""
        out = {"count": self.count, "mean": self.mean,
               "min": self.min if self.count else 0.0,
               "max": self.max if self.count else 0.0}
        out.update(percentiles(self.samples, pcts))
        return out

    def as_value(self):
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": self.min, "max": self.max, "last": self.last}


class MetricsRegistry:
    """Name -> metric map. `counter()`/`histogram()` get-or-create, so call
    sites never coordinate registration; asking for an existing name with
    the other kind raises (one name, one type)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, kind):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind(name)
        elif not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        return {name: m.as_value() for name, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        self._metrics.clear()


REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
