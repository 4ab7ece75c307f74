"""The 90th percentile (nearest rank) of the latency of every query of the
window whose answer returned, in milliseconds. The nearest-rank rule is
the one of the port's `obs.metrics.percentiles`, copied here."""
import math


def nearest_rank(values, pct: float) -> float:
    """The smallest value with at least `pct` percent of `values` at or
    below it."""
    s = sorted(values)
    rank = max(math.ceil(len(s) * pct / 100), 1)
    return s[min(rank, len(s)) - 1]


def read(ctx):
    lat = [q.latency_s for q in ctx.queries if q.done is not None]
    return nearest_rank(lat, 90) * 1e3 if lat else None
