"""The program's own spans that opened in the window, for the per-layer
metrics that read them: `repro_torch.obs.trace.recorded()`, which the
program fills while the traced run's profiler is on.

The window runs from the first query's due time to the last answer's
return, on the host clock the spans share (`time.perf_counter`). Nothing
is read where the program records no spans (a program without the
recorder), none opened in the window, or they have no device interval (a
run on the CPU)."""
from __future__ import annotations


def in_window(ctx, name: str) -> list:
    """The recorded spans named `name` whose host start lies in the window."""
    try:
        from repro_torch.obs.trace import recorded
    except ImportError:
        return []
    done = [q.done for q in ctx.queries if q.done is not None]
    if not done:
        return []
    lo = int(min(q.due for q in ctx.queries) * 1e9)
    hi = int(max(done) * 1e9)
    return [s for s in recorded() if s.name == name and lo <= s.t0_ns <= hi]


def device_ms_per_query(ctx, name: str, own: bool = False) -> float | None:
    """Device milliseconds a completed query in the window's `name` spans:
    each span's device interval, or with `own` its self time (the interval
    less its child spans')."""
    spans = in_window(ctx, name)
    if not spans or not ctx.completed or any(s.device_ms is None for s in spans):
        return None
    return sum(s.self_ms if own else s.device_ms for s in spans) / ctx.completed
