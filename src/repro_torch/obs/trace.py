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
calls nothing here, allocates no `Span` and enters no dispatch mode. A
traced run pays a device sync per node that the untraced run does not;
`overhead_bound_s` quantifies the slack the trace itself claims
(per-node dispatch/sync floor + a relative term), and the traced run times
the untraced plan too (`e2e_wall_s`), so every trace carries its own
measured-vs-attributed comparison.
"""
from __future__ import annotations

import dataclasses
import json
import time

import torch

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
