"""Per-node query tracing: what the device actually did (DESIGN.md §12).
The port's counterpart of the JAX package's `obs.trace`.

`trace_execute(plan)` runs a physical plan node by node, bottom-up, with a
device sync around every operator: each node's children are executed
first, and the node then runs on its children's materialized results
(`executor.Materialized`), timed alone with `timed_call` (CUDA events on
the stream of the tensors' card, the host clock for CPU tensors;
median-of-k). Eager PyTorch folds nothing, so a child's result can be
handed over as it is: there is no whole-plan program that could fold a
subtree away, and nothing has to be kept opaque to a compiler. The result
is a `QueryTrace` tree of `Span`s carrying, per node:

    wall_s        device-synced median wall time of the node alone
    predicted_s   the optimizer's cost-model prediction for the node
    rows_in/out   valid-row counts through the operator
    bytes_in/out  device bytes entering/leaving (capacity x itemsize)
    strategy      the chosen algorithm/pattern or group-by strategy

exportable as JSON (`as_dict`/`to_json`) and as Chrome trace-event format
(`chrome_trace`/`to_chrome_trace` — loadable in Perfetto / about:tracing).

Tracing is strictly opt-in: `executor.run(plan)` without `trace=True`
runs no node alone, allocates no `Span` and enters no dispatch mode. A
traced run pays a device sync per node that the untraced run does not;
`overhead_bound_s` quantifies the slack the trace itself claims
(per-node dispatch/sync floor + a relative term), and the traced run times
the untraced plan too (`e2e_wall_s`), so every trace carries its own
measured-vs-attributed comparison.

The span recorder (`span`, `begin`/`end`, `recorded`) times the program's
own phases where they run, on whatever path runs them: the query server's
phases of each request and each plan node's call in `executor.execute`,
untraced runs included; `annotate` adds what code below a span saw to it
(the probe's rows in no partition). It is on only while a torch profiler
runs or inside `recording()`; off, a span costs one flag check.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import json
import time

import torch

from . import metrics

from ..core.table import tensors_of


def _device_of(args, device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    t = next(tensors_of(args), None)
    return t.device if t is not None else torch.device("cpu")


def timed_call(fn, *args, iters: int = 1, warmup: int = 1, device=None):
    """(result, median wall seconds) of `fn(*args)`. The shared timing
    primitive of the tracer and the planner's consumers.

    On a card (`device`, or the device of the first tensor in `args`) each
    call is bracketed by CUDA events recorded on the card's current stream,
    and the end event is synchronized on: the time is the device's, from
    the start event to the last of the call's work. For CPU tensors the host
    clock times each call."""
    dev = _device_of(args, device)
    out = None
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        for _ in range(max(warmup, 0)):
            out = fn(*args)
        torch.cuda.synchronize(dev)
        ts = []
        for _ in range(max(iters, 1)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = fn(*args)
            end.record(stream)
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(max(warmup, 0)):
            out = fn(*args)
        ts = []
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            out = fn(*args)
            ts.append(time.perf_counter() - t0)
    ts.sort()
    return out, max(ts[len(ts) // 2], 0.0)


def median_wall(fn, *args, iters: int = 3, warmup: int = 1, device=None) -> float:
    """Median wall seconds of `fn(*args)` (see `timed_call`)."""
    return timed_call(fn, *args, iters=iters, warmup=warmup, device=device)[1]


def sync_floor(iters: int = 5, device="cpu") -> float:
    """Median host wall of one trivial op plus a synchronize on `device`:
    the per-node floor a traced run pays that the untraced plan does not."""
    dev = torch.device(device)
    x = torch.zeros(8, dtype=torch.int32, device=dev)
    ts = []
    for i in range(max(iters, 1) + 1):
        t0 = time.perf_counter()
        y = x + 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if i:  # the first round warms the op up
            ts.append(time.perf_counter() - t0)
    del y
    ts.sort()
    return ts[len(ts) // 2]


# ---------------------------------------------------------------------------
# the span recorder: the program's phases, timed in place
# ---------------------------------------------------------------------------
# Spans kept, newest last. A 30 s window of the benchmark records at most
# about 4,000 (Q18 served to four clients: 360 queries x 11; the star query
# 108 x 17). A span past the cap pushes out the oldest and counts
# `obs.spans_dropped`.
RING_CAP = 16384

_ring: collections.deque = collections.deque(maxlen=RING_CAP)
_forced = 0  # open `recording()` blocks
_profiler_enabled = torch._C._autograd._profiler_enabled
# the innermost open context-manager span: its children's parent, whose
# request id they carry
_CURRENT = contextvars.ContextVar("repro_torch_span", default=None)
_INHERIT = object()


class SpanRecord:
    """One recorded interval of the program.

    Host start and end are `time.perf_counter_ns()` (the clock of the
    server's `submitted_at`). On a card, a start and an end CUDA event on
    the current stream bound a device span's interval, read only when
    asked for (`device_ms`). Each event costs the host tens of microseconds
    there, so only spans whose device time is read take them (the padding,
    each plan node's own call but a scan's); the rest are host spans
    (`device=False`). `qid` is the request the span served (None outside a
    request); `parent` the span it opened under. `attrs` holds small
    values; a plan node's `rows_out` is its 0-d count tensor, turned into a
    number only when read.

    Used as a context manager (`span`), it opens on entry; `begin` opens
    it at once."""

    __slots__ = ("name", "parent", "qid", "attrs", "t0_ns", "t1_ns", "children",
                 "_device", "_ev0", "_ev1", "_rf", "_token")

    # allocation counter pinning the off path: with the recorder off no
    # SpanRecord is ever made (tests/test_torch_spans.py)
    allocated = 0

    def __init__(self, name: str, parent, qid, attrs: dict, device: bool = True):
        SpanRecord.allocated += 1
        self.name, self.parent, self.qid, self.attrs = name, parent, qid, attrs
        self.children: list = []
        self._device = device
        self._ev0 = self._ev1 = self._rf = None
        self.t0_ns = self.t1_ns = None

    def _open(self) -> None:
        if self.parent is _INHERIT:
            self.parent = _CURRENT.get()
        parent = self.parent
        if self.qid is _INHERIT:
            self.qid = None if parent is None else parent.qid
        first = parent is not None and not parent.children
        if parent is not None:
            parent.children.append(self)
        if self._device and torch.cuda.is_initialized():
            if first and parent._ev0 is not None:
                # a device span launches nothing before its first child
                # opens (a plan node runs its inputs first): same start
                self._ev0 = parent._ev0
            else:
                self._ev0 = torch.cuda.Event(enable_timing=True)
                self._ev0.record()
        self.t0_ns = time.perf_counter_ns()

    def _close(self, attrs: dict) -> None:
        if self._ev0 is not None:
            self._ev1 = torch.cuda.Event(enable_timing=True)
            self._ev1.record()
        self.t1_ns = time.perf_counter_ns()
        self.attrs.update(attrs)
        if len(_ring) == RING_CAP:
            metrics.counter("obs.spans_dropped").inc()
        _ring.append(self)

    def __enter__(self) -> "SpanRecord":
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._open()
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, et, ev, tb):
        _CURRENT.reset(self._token)
        self._close({} if et is None else {"error": et.__name__})
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
        return False

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        """Milliseconds between the span's two events on the device; None
        off a card and for host-only spans. Waits for the end event if the
        device has not reached it yet."""
        if self._ev1 is None:
            return None
        self._ev1.synchronize()
        return self._ev0.elapsed_time(self._ev1)

    @property
    def ms(self) -> float:
        """The device interval, the host interval where there is none."""
        d = self.device_ms
        return self.host_ms if d is None else d

    @property
    def self_ms(self) -> float:
        """`ms` less its closed child spans': the span's own work. On the
        device a host child counts nothing."""
        kids = [c for c in self.children if c.t1_ns is not None]
        d = self.device_ms
        if d is None:
            return self.host_ms - sum(c.host_ms for c in kids)
        return d - sum(c.device_ms or 0.0 for c in kids)

    @property
    def rows_out(self) -> int | None:
        v = self.attrs.get("rows_out")
        return None if v is None else int(v)


def on() -> bool:
    """Whether spans are recorded: a torch profiler runs, or a
    `recording()` block is open."""
    return bool(_forced) or _profiler_enabled()


@contextlib.contextmanager
def recording():
    """Records spans within the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def recorded() -> list:
    """The closed spans the ring holds, in the order they closed."""
    return list(_ring)


def reset() -> None:
    _ring.clear()


def to_unix_ns(perf_ns: int) -> int:
    """A `perf_counter_ns()` reading on the Unix-epoch clock of the
    profiler's trace events."""
    return perf_ns + time.time_ns() - time.perf_counter_ns()


class _Off:
    """The span of an off recorder: does nothing, yields None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, *, parent=_INHERIT, qid=_INHERIT, device: bool = True, **attrs):
    """A context manager recording the block as a span named `name`, with
    `attrs`; it yields the SpanRecord (None when the recorder is off). The
    parent defaults to the innermost open span and the request id to its
    parent's; spans opened inside the block are this one's children.
    `device=False` makes a host span, with no events. A device span's
    children are device spans or host spans that launch nothing, and it
    launches nothing before its first child opens, which shares its start
    event. Under a profiler the block is also a
    `torch.profiler.record_function` of the same name, so the profiler's
    trace shows it beside the kernels it launched."""
    if not (_forced or _profiler_enabled()):
        return _OFF
    return SpanRecord(name, parent, qid, attrs, device)


def begin(name: str, *, parent=None, qid=None, **attrs) -> SpanRecord | None:
    """Opens a host span that a later call closes with `end` (a request's
    time in the queue); None when the recorder is off. It is no parent of
    the spans opened after it unless they name it, and enters no
    `record_function`: it lives in the ring only."""
    if not (_forced or _profiler_enabled()):
        return None
    rec = SpanRecord(name, parent, qid, attrs, device=False)
    rec._open()
    return rec


def end(rec: SpanRecord | None, **attrs) -> None:
    """Closes a span `begin` opened; nothing for None or a closed span."""
    if rec is not None and rec.t1_ns is None:
        rec._close(attrs)


def annotate(**attrs) -> None:
    """Sets `attrs` on the innermost open context-manager span (a value
    may be a 0-d tensor, read late as a node's `rows_out` is); nothing when
    the recorder is off or no such span is open."""
    if not (_forced or _profiler_enabled()):
        return
    rec = _CURRENT.get()
    if rec is not None:
        rec.attrs.update(attrs)


def node_span(node):
    """`span` of a plan node's own call, `exec.<op>`, with its strategy and
    capacity; a scan launches nothing. The caller sets `rows_out` on the
    yielded record."""
    if not (_forced or _profiler_enabled()):
        return _OFF
    op = op_of(node)
    return SpanRecord(f"exec.{op}", _INHERIT, _INHERIT,
                      {"strategy": strategy_of(node), "capacity": int(node.capacity)},
                      op != "scan")


@dataclasses.dataclass
class Span:
    """One physical plan node's measured execution."""

    op: str  # operator kind: scan/filter/project/join/groupby/...
    name: str  # the node's describe() line (choice + estimates)
    strategy: str  # algorithm/pattern or group-by strategy, "" if n/a
    path: tuple  # child-index path from the root (root = ())
    predicted_s: float  # optimizer cost-model prediction (node alone)
    wall_s: float  # device-synced median wall of the node alone
    rows_in: int
    rows_out: int
    bytes_in: int
    bytes_out: int
    t0_s: float  # offset of the timed window from the trace start
    children: list = dataclasses.field(default_factory=list)

    # allocation counter pinning the zero-overhead contract: an untraced
    # run must never construct a Span (tests/test_torch_obs.py)
    allocated = 0

    def __post_init__(self):
        Span.allocated += 1

    @property
    def residual(self):
        """measured/modeled ratio; None where the model prices the node
        at zero (scan/project carry no predicted cost to divide by)."""
        if self.predicted_s > 0.0:
            return self.wall_s / self.predicted_s
        return None

    def as_dict(self) -> dict:
        return {
            "op": self.op, "name": self.name, "strategy": self.strategy,
            "path": list(self.path), "predicted_s": self.predicted_s,
            "measured_s": self.wall_s, "residual": self.residual,
            "rows_in": self.rows_in, "rows_out": self.rows_out,
            "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
        }


@dataclasses.dataclass
class QueryTrace:
    """Measured execution tree of one physical plan."""

    root: Span
    backend: str  # backend fingerprint (obs.calibration)
    total_wall_s: float  # whole traced traversal
    e2e_wall_s: float  # untraced whole-plan median wall
    sync_floor_s: float  # per-dispatch sync floor at trace time
    iters: int = 1
    warmup: int = 1
    # EscalationReports recorded while this trace ran (resilience's report
    # ring, windowed by sequence number) — explain(actuals=trace) renders
    # these as its escalation footer
    escalations: tuple = ()

    def spans(self) -> list:
        out = []

        def walk(s):
            out.append(s)
            for c in s.children:
                walk(c)

        walk(self.root)
        return out

    def by_path(self) -> dict:
        return {s.path: s for s in self.spans()}

    @property
    def sum_wall_s(self) -> float:
        return sum(s.wall_s for s in self.spans())

    @property
    def overhead_bound_s(self) -> float:
        """The slack the trace claims for its own attribution: per-node
        dispatch/sync floor, plus a relative term for what per-node
        execution changes (each node's inputs arrive materialized and its
        outputs are synchronized on). Within this bound, the per-node walls
        must account for the untraced end-to-end time — the acceptance
        check of DESIGN.md §12."""
        n = len(self.spans())
        return n * self.sync_floor_s + 0.75 * max(self.sum_wall_s, self.e2e_wall_s)

    def as_dict(self) -> dict:
        return {
            "backend": self.backend,
            "total_wall_s": self.total_wall_s,
            "e2e_wall_s": self.e2e_wall_s,
            "sum_wall_s": self.sum_wall_s,
            "sync_floor_s": self.sync_floor_s,
            "overhead_bound_s": self.overhead_bound_s,
            "iters": self.iters, "warmup": self.warmup,
            "nodes": [s.as_dict() for s in self.spans()],
            "escalations": [r.as_dict() for r in self.escalations],
        }

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2, sort_keys=True)

    def chrome_trace(self) -> list:
        """Chrome trace-event list (Perfetto / about:tracing loadable):
        one complete ('X') event per span on a single track, timestamps
        in microseconds from the trace start."""
        events = []
        for s in self.spans():
            events.append({
                "name": f"{s.op}[{s.strategy}]" if s.strategy else s.op,
                "cat": "plan-node", "ph": "X",
                "ts": s.t0_s * 1e6, "dur": max(s.wall_s, 1e-9) * 1e6,
                "pid": 0, "tid": 0,
                "args": s.as_dict(),
            })
        return events

    def to_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_trace(),
                       "displayTimeUnit": "ms"}, f, indent=2)

    def table(self) -> str:
        """Human-readable predicted-vs-measured table, one row per node."""
        head = (f"{'node':<28} {'strategy':<16} {'rows_out':>9} "
                f"{'predicted':>11} {'measured':>11} {'residual':>9}")
        lines = [head, "-" * len(head)]
        for s in self.spans():
            label = ("  " * len(s.path)) + s.op
            res = f"{s.residual:.2f}x" if s.residual is not None else "-"
            flag = " <-- >2x" if s.residual is not None and (
                s.residual >= 2.0 or s.residual <= 0.5) else ""
            lines.append(
                f"{label:<28} {s.strategy:<16} {s.rows_out:>9} "
                f"{s.predicted_s*1e6:>9.0f}us {s.wall_s*1e6:>9.0f}us "
                f"{res:>9}{flag}")
        lines.append(
            f"{'sum(nodes)':<28} {'':<16} {'':>9} "
            f"{'':>11} {self.sum_wall_s*1e6:>9.0f}us "
            f"(e2e {self.e2e_wall_s*1e6:.0f}us, "
            f"bound {self.overhead_bound_s*1e6:.0f}us)")
        return "\n".join(lines)


def _table_bytes(t) -> int:
    return int(t.nbytes())


_OP_NAMES = {
    "PScan": "scan", "PFilter": "filter", "PProject": "project",
    "PJoin": "join", "PGroupBy": "groupby", "PGroupJoin": "groupjoin",
    "POrderByLimit": "orderby",
}


def op_of(node) -> str:
    return _OP_NAMES.get(type(node).__name__, type(node).__name__.lower())


def strategy_of(node) -> str:
    from ..engine import physical as P

    if isinstance(node, P.PJoin):
        return f"{node.algorithm}/{node.pattern}"
    if isinstance(node, P.PGroupBy):
        return node.strategy
    if isinstance(node, P.PGroupJoin):
        return f"phj+{node.agg_strategy}"
    return ""


def _with_children(node, mats):
    """Shallow copy of a physical node with its children replaced by
    `executor.Materialized` wrappers, so `execute` consumes precomputed
    child results instead of recursing."""
    kids = node.children()
    if not kids:
        return node
    if len(kids) == 1:
        return dataclasses.replace(node, child=mats[0])
    return dataclasses.replace(node, build=mats[0], probe=mats[1])


def trace_execute(plan, tables=None, *, iters: int = 1, warmup: int = 1,
                  measure_e2e: bool = True, validate_capacity: bool = True):
    """Execute `plan` with per-node timing. Returns
    ``(table, valid_count, QueryTrace)`` — the table/count pair is the
    untraced `run()` result (same operator code on the same inputs; only
    the execution granularity differs).

    Children run first and each node runs on their materialized results.
    With ``validate_capacity=True`` (the default) the trace finishes with
    one untimed pass under `executor.checked_mode()`: every
    capacity-sensitive node re-runs through its resilience ladder, so a
    plan whose capacities were misestimated records `EscalationReport`s —
    surfaced on `QueryTrace.escalations` and rendered by
    `explain(actuals=trace)` (DESIGN.md §13)."""
    from ..engine import executor
    from ..engine import physical as P
    from ..resilience import escalation
    from .calibration import backend_fingerprint

    tables = dict(tables if tables is not None else plan.catalog.tables)
    device = next(iter(tables.values())).device
    t_begin = time.perf_counter()
    floor = sync_floor(device=device)
    esc_since = escalation.current_seq()

    def visit(node, path):
        child_out = []
        child_spans = []
        for i, kid in enumerate(node.children()):
            r, s = visit(kid, path + (i,))
            child_out.append(r)
            child_spans.append(s)
        if isinstance(node, P.PScan):
            def fn(tb):
                return executor.execute(node, tb)

            args = (tables,)
            rows_in = int(tables[node.table].num_rows)
            bytes_in = _table_bytes(tables[node.table])
        else:
            def fn(child_vals):
                mats = [executor.Materialized(v) for v in child_vals]
                return executor.execute(_with_children(node, mats), {})

            args = (child_out,)
            rows_in = sum(int(c) for _, c in child_out)
            bytes_in = sum(_table_bytes(t) + 4 for t, _ in child_out)
        t0 = time.perf_counter() - t_begin
        (out_t, out_c), wall = timed_call(fn, *args, iters=iters, warmup=warmup,
                                          device=device)
        span = Span(
            op=op_of(node), name=node.describe(),
            strategy=strategy_of(node), path=path,
            predicted_s=float(node.cost), wall_s=wall,
            rows_in=rows_in, rows_out=int(out_c),
            bytes_in=bytes_in, bytes_out=_table_bytes(out_t) + 4,
            t0_s=t0, children=child_spans,
        )
        return (out_t, out_c), span

    (out_t, out_c), root = visit(plan.root, ())
    if validate_capacity:
        # untimed: ladder checks are host-side histograms plus (only on
        # escalation) a larger-shape re-run; results are discarded — the
        # pass exists for its EscalationReports
        with executor.checked_mode():
            executor.execute(plan.root, tables)
    e2e = 0.0
    if measure_e2e:
        _, e2e = timed_call(lambda: executor.run(plan, tables),
                            iters=max(iters, 1), warmup=max(warmup, 1), device=device)
    trace = QueryTrace(
        root=root, backend=backend_fingerprint(device),
        total_wall_s=time.perf_counter() - t_begin, e2e_wall_s=e2e,
        sync_floor_s=floor, iters=iters, warmup=warmup,
        escalations=tuple(escalation.recent_reports(esc_since)),
    )
    return out_t, torch.as_tensor(out_c, dtype=torch.int32, device=out_t.device), trace
