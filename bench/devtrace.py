"""Reduction of a profiler trace of the window to what the per-layer
metrics and the breakdown read: the device's operations by name, the
seconds in which any ran, and the idle gaps named by what the host was
doing.

The window is the host's `bench.window` span. Device operations are the
profiler's CUDA-side events (kernels, copies, fills), user annotations
left out; busy time is the length of their union inside the window.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# idle gaps named, longest first; the rest only count towards idle time
NAMED_GAPS = 400


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: dict  # device operation name -> [count, seconds]
    gaps: dict  # host activity -> seconds of the named idle gaps

    def seconds(self, match) -> tuple[int, float]:
        """(count, seconds) of the device operations whose name `match`
        accepts."""
        n, s = 0, 0.0
        for name, (c, t) in self.ops.items():
            if match(name):
                n, s = n + c, s + t
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, t) for n, (_, t) in self.ops.items()), key=lambda x: -x[1])
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])
        return {"device_ops": [[short(n), t] for n, t in ops[:top]],
                "idle_gaps": [[n, t] for n, t in gaps[:top]]}


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.removeprefix("void ")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:width]


def reduce_profile(prof, window: str = "bench.window") -> DeviceTrace | None:
    """A DeviceTrace of the profiled window, or None where the profiler saw
    no window or no device operation (a run on the CPU)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host, dev = [], []
    w0 = w1 = None
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.name() == window:
                w0, w1 = e.start_ns(), e.end_ns()
            else:
                host.append((e.start_ns(), e.end_ns(), e.name(), e.is_user_annotation()))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation() \
                and e.duration_ns() > 0:
            dev.append((e.start_ns(), e.end_ns(), e.name()))
    if w0 is None or not dev:
        return None
    ops: dict = {}
    spans = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        c = ops.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (t - s) / 1e9
        spans.append((s, t))
    if not spans:
        return None
    spans.sort()
    busy = 0
    gaps = []
    cur_s, cur_t = w0, w0
    for s, t in spans:
        if s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s = s
        cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    if w1 > cur_t:
        gaps.append((cur_t, w1))
    return DeviceTrace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, ops=ops,
                       gaps=name_gaps(gaps, host))


def name_gaps(gaps: list, host: list) -> dict:
    """Seconds of the longest idle gaps by what the host was doing at each
    gap's start: the innermost `bench.*` annotation around it and the
    innermost host operation inside that."""
    if not gaps:
        return {}
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:NAMED_GAPS]
    starts = np.array([h[0] for h in host], dtype=np.int64)
    ends = np.array([h[1] for h in host], dtype=np.int64)
    names = [h[2] for h in host]
    marks = np.array([h[3] and h[2].startswith("bench.") for h in host], dtype=bool)
    out: dict = {}
    for g0, g1 in gaps:
        t = g0 + 1
        inside = (starts <= t) & (ends > t)
        label = []
        for sel in (inside & marks, inside & ~marks):
            idx = np.flatnonzero(sel)
            if idx.size:
                label.append(names[idx[np.argmax(starts[idx])]])
        key = " > ".join(label) or "host idle"
        out[key] = out.get(key, 0.0) + (g1 - g0) / 1e9
    return out
