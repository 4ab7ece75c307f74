"""The span recorder of `repro_torch.obs.trace` (`span`, `begin`/`end`,
`recorded`) and the spans the query server and the executor record with
it, on the CPU: nothing is made while it is off; while on, each request's
spans form one tree under its `qserve.request`, carry its `qid`, and under
a torch profiler each context-manager span has a `record_function` twin at
the same moment on the profiler's clock."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import KEY_SENTINEL, table_from_numpy
from repro_torch.engine import Catalog, executor, optimize, scan
from repro_torch.obs import metrics, trace
from repro_torch.resilience import faults
from repro_torch.serve import query as Q

# a join, a group-by fused into it and a top-k: the engine's Q18 shape
PLAN = (scan("S").join(scan("R"), key="k").group_by("k", sv="sum")
        .order_by("sv_sum", limit=5, descending=True))
GROUPS = scan("S").join(scan("R"), key="k").group_by("g", sv="sum")
JOIN = scan("S").join(scan("R"), key="k")
CROSSING = {"qserve.request", "qserve.queued"}  # begin/end spans: no twin


def _tables(n_r=300, n_s=1200, seed=0, tail=0):
    """R (keys a permutation) and S (foreign keys); the last `tail` of S's
    keys are KEY_SENTINEL."""
    rng = np.random.default_rng(seed)
    sk = rng.integers(0, n_r, n_s).astype(np.int32)
    sk[n_s - tail:] = KEY_SENTINEL
    cols = {"R": {"k": rng.permutation(n_r).astype(np.int32),
                  "rv": rng.integers(0, 50, n_r).astype(np.int64)},
            "S": {"k": sk,
                  "g": rng.integers(0, 8, n_s).astype(np.int32),
                  "sv": rng.integers(0, 50, n_s).astype(np.int64)}}
    return {n: table_from_numpy(t, "cpu") for n, t in cols.items()}


def _serve(n=3, **kw):
    tables = _tables()
    server = Q.QueryServer(device="cpu", **kw)
    reqs = [Q.QueryRequest(qid=100 + i, plan=PLAN, tables=dict(tables)) for i in range(n)]
    for r in reqs:
        server.submit(r)
    while server.step():
        pass
    assert all(r.done and not r.error for r in reqs)
    return reqs


def _chain(s):
    """The names of `s`'s ancestors, innermost first."""
    out = []
    while s.parent is not None:
        s = s.parent
        out.append(s.name)
    return out


@pytest.fixture(autouse=True)
def _empty_ring():
    trace.reset()
    yield
    trace.reset()


def test_off_records_nothing_enters_no_record_function_and_makes_no_event(monkeypatch):
    """With no profiler and no `recording()`, a served query and an
    executor run make no span, no `record_function` and no CUDA event."""
    entered, events = [], []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **kw: entered.append(a))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **kw: events.append(a))
    before = trace.SpanRecord.allocated
    assert not trace.on()
    reqs = _serve()
    plan = optimize(PLAN, Catalog(_tables()), measure_profile=False)
    executor.run(plan)
    executor.run_morsels(optimize(GROUPS, Catalog(_tables()), measure_profile=False),
                         factor=2)
    assert trace.SpanRecord.allocated == before and not entered and not events
    assert trace.recorded() == []
    assert all(r.request_span is None and r.queued_span is None for r in reqs)
    assert trace.begin("qserve.request", qid=1) is None
    with trace.span("x") as rec:
        assert rec is None


def test_served_request_is_one_tree_carrying_its_qid():
    with trace.recording():
        reqs = _serve()
    spans = trace.recorded()
    by_qid = {r.qid: [s for s in spans if s.qid == r.qid] for r in reqs}
    assert sum(map(len, by_qid.values())) + sum(
        s.name == "qserve.tick" for s in spans) == len(spans)
    for req in reqs:
        mine = by_qid[req.qid]
        roots = [s for s in mine if s.parent is None]
        assert [s.name for s in roots] == ["qserve.request"]
        root = roots[0]
        assert root is req.request_span and root.attrs["path"] == "fast"
        assert root.attrs["signature"] == req.signature and root.attrs["error"] == ""
        # every span of the request lies under its root, which holds them in time
        assert all(s is root or _chain(s)[-1] == "qserve.request" for s in mine)
        assert all(root.t0_ns <= s.t0_ns <= s.t1_ns <= root.t1_ns for s in mine)
        names = {s.name for s in mine}
        assert {"qserve.queued", "qserve.plan", "qserve.admit", "qserve.run",
                "qserve.pad", "exec.run", "exec.groupjoin", "exec.orderby",
                "exec.scan"} <= names
        (queued,) = [s for s in mine if s.name == "qserve.queued"]
        (run,) = [s for s in mine if s.name == "qserve.run"]
        assert queued.parent is root and run.parent is root and queued.t1_ns <= run.t0_ns
        assert all(s.parent is queued for s in mine if s.name in ("qserve.plan",
                                                                  "qserve.admit"))
        (pad,) = [s for s in mine if s.name == "qserve.pad"]
        assert pad.parent is run
        # the run's engine spans nest under it; the first request's plan
        # sizing runs the plan once more, under its `qserve.plan`
        for s in mine:
            if s.name.startswith("exec."):
                assert "qserve.run" in _chain(s) or "qserve.plan" in _chain(s)
        (ex,) = [s for s in mine if s.name == "exec.run"]
        assert ex.parent is run and ex.attrs["degraded"] is False
        (top,) = ex.children
        assert top.name == "exec.orderby" and top.rows_out == int(req.result[1])
        assert top.attrs["capacity"] == 5
    plans = [s for s in spans if s.name == "qserve.plan"]
    assert [s.attrs["hit"] for s in plans] == [False, True, True]
    assert sum(s.name == "qserve.tick" for s in spans) >= 1


def test_self_time_is_duration_less_children():
    with trace.recording():
        _serve(n=2)
    spans = trace.recorded()
    assert spans and all(s.device_ms is None for s in spans)  # the CPU has no events
    for s in spans:
        kids = sum(c.host_ms for c in s.children)
        assert s.self_ms == pytest.approx(s.host_ms - kids, abs=1e-9)
        assert s.self_ms >= 0, s.name  # children nest inside their parent
    gj = [s for s in spans if s.name == "exec.groupjoin"]
    assert gj and all(len(s.children) == 2 for s in gj)
    assert all({c.name for c in s.children} == {"exec.scan"} for s in gj)


class FakeEvent:
    """A CUDA event on the host clock, for a CPU run."""

    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        FakeEvent.made.append(self)

    def record(self):
        self.t = time.perf_counter_ns()

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


DEVICE_SPANS = {"qserve.pad", "exec.groupjoin", "exec.orderby"}


def test_device_intervals_only_where_read_and_self_time_on_the_device(monkeypatch):
    """On a card (faked here) the padding and the plan nodes' calls but the
    scans' take events; the other spans are host spans, which count
    nothing of a device span's self time. A node's first input shares the
    node's start event: the node launches nothing before it."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.made.clear()
    with trace.recording():
        _serve(n=2)
    spans = trace.recorded()
    device = [s for s in spans if s.device_ms is not None]
    assert {s.name for s in device} == DEVICE_SPANS
    shared = [s for s in device if s.parent is not None and s.parent.children[0] is s
              and s.parent.device_ms is not None]
    assert shared and all(s._ev0 is s.parent._ev0 for s in shared)
    assert {s.name for s in shared} == {"exec.groupjoin"}
    assert len(FakeEvent.made) == 2 * len(device) - len(shared)
    for s in spans:
        if s.device_ms is None:
            assert s.self_ms == pytest.approx(s.host_ms - sum(c.host_ms for c in s.children))
        else:
            assert s.self_ms == pytest.approx(
                s.device_ms - sum(c.device_ms for c in s.children if c.device_ms is not None))
    gj = [s for s in spans if s.name == "exec.groupjoin"]
    assert all(s.self_ms == pytest.approx(s.device_ms) for s in gj)  # its scans are host


def test_rows_out_equal_the_counts_the_run_returned():
    plan = optimize(PLAN, Catalog(_tables()), measure_profile=False)
    with trace.recording():
        _, count = executor.run(plan)
        _, gcount = executor.execute(plan.root.child, plan.catalog.tables)
    runs = [s for s in trace.recorded() if s.name == "exec.run"]
    assert len(runs) == 1 and runs[0].qid is None and runs[0].parent is None
    (top,) = runs[0].children
    assert top.rows_out == int(count)
    assert [s.rows_out for s in trace.recorded() if s.name == "exec.groupjoin"] == [
        int(gcount)] * 2
    scans = [s for s in trace.recorded() if s.name == "exec.scan"]
    assert sorted(s.rows_out for s in scans) == [300, 300, 1200, 1200]


def test_morsels_and_degraded_run_are_spans():
    plan = optimize(GROUPS, Catalog(_tables()), measure_profile=False)
    with trace.recording():
        executor.run_morsels(plan, factor=2)
    morsels = [s for s in trace.recorded() if s.name == "exec.morsel"]
    assert [s.attrs["index"] for s in morsels] == [0, 1]
    assert all([c.name for c in s.children] == ["exec.run"] for s in morsels)
    trace.reset()
    with trace.recording(), faults.inject("raise:executor.run@0"):
        executor.run(plan)
    (ex,) = [s for s in trace.recorded() if s.name == "exec.run"]
    assert ex.attrs["degraded"] is True


def test_trace_execute_records_the_same_node_spans():
    plan = optimize(PLAN, Catalog(_tables()), measure_profile=False)
    with trace.recording():
        executor.run(plan, trace=True)
    names = {s.name for s in trace.recorded()}
    assert {"exec.scan", "exec.groupjoin", "exec.orderby", "exec.run"} <= names


def test_every_span_has_a_profiler_twin_at_the_same_moment():
    """Under torch.profiler each context-manager span is also a
    record_function event of its name; the twin starts within 1 ms of the
    span on the profiler's (Unix-epoch) clock. Begin/end spans have none."""
    tables = _tables()
    server = Q.QueryServer(device="cpu")
    warm = Q.QueryRequest(qid=1, plan=PLAN, tables=dict(tables))
    server.submit(warm)
    server.step()  # plans the signature: the profiled tick only runs
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert trace.on()
        with torch.profiler.record_function("warm"):
            pass
        for i in range(2):
            server.submit(Q.QueryRequest(qid=2 + i, plan=PLAN, tables=dict(tables)))
        server.step()
        offset = trace.to_unix_ns(0)
    assert not trace.on()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e.start_ns())
    spans = trace.recorded()
    assert {s.name for s in spans} >= {"qserve.tick", "qserve.run", "qserve.pad",
                                       "exec.run", "exec.groupjoin"} | CROSSING
    for s in spans:
        if s.name in CROSSING:
            assert s.name not in events
            continue
        starts = events.get(s.name, [])
        assert starts, s.name
        assert min(abs(t - (s.t0_ns + offset)) for t in starts) < 1_000_000, s.name
    assert len(events["exec.run"]) == 2


@pytest.mark.parametrize("tail", [0, 37])
@pytest.mark.parametrize("query,node", [(JOIN, "exec.join"), (PLAN, "exec.groupjoin")])
def test_probe_rows_outside_every_partition_are_on_the_node_span(query, node, tail):
    """A PHJ join and a group-join on the plain arm leave on their node's
    span `rows_outside`, the probe rows past the last partition's end (the
    sentinel partition's, which the probe kernel's whole grid answers): the
    probe side's KEY_SENTINEL keys, 0 where it has none."""
    plan = optimize(query, Catalog(_tables(tail=tail)), measure_profile=False)
    with trace.recording():
        executor.run(plan)
    (rec,) = [s for s in trace.recorded() if s.name == node]
    assert rec.attrs["strategy"].startswith("phj")
    assert int(rec.attrs["rows_outside"]) == tail


def test_served_padding_is_the_probe_rows_outside():
    """A served query's probe side is padded to its bucket, and the
    executor masks the padding to KEY_SENTINEL: each run's group-join span
    counts those rows outside every partition. The first request's plan
    sizing runs the padded tables unmasked, their continuation keys live."""
    with trace.recording():
        _serve(n=2)
    gj = {}
    for s in trace.recorded():
        if s.name == "exec.groupjoin":
            where = "qserve.run" if "qserve.run" in _chain(s) else "qserve.plan"
            gj.setdefault(where, []).append(int(s.attrs["rows_outside"]))
    assert gj == {"qserve.plan": [0], "qserve.run": [Q.bucket_rows(1200) - 1200] * 2}


def test_annotate_sets_the_innermost_span_and_off_makes_nothing():
    before = trace.SpanRecord.allocated
    assert not trace.on()
    trace.annotate(rows_outside=5)
    with trace.span("outer") as rec:
        assert rec is None
        trace.annotate(rows_outside=5)
    assert trace.SpanRecord.allocated == before and trace.recorded() == []
    with trace.recording():
        trace.annotate(a=1)  # no span open: nothing to set
        with trace.span("outer", a=1):
            with trace.span("inner"):
                trace.annotate(a=2, b=3)
            trace.annotate(a=4)
    inner, outer = trace.recorded()
    assert inner.attrs == {"a": 2, "b": 3} and outer.attrs == {"a": 4}
    assert trace.SpanRecord.allocated == before + 2


def test_ring_is_bounded_and_counts_what_it_drops():
    dropped = metrics.counter("obs.spans_dropped").value
    with trace.recording():
        for i in range(trace.RING_CAP + 3):
            trace.end(trace.begin("x", i=i))
    spans = trace.recorded()
    assert len(spans) == trace.RING_CAP and spans[0].attrs["i"] == 3
    assert metrics.counter("obs.spans_dropped").value == dropped + 3


def test_server_keeps_no_histograms_and_the_audit_counts_nothing():
    """The server's and the auditor's unread instruments are gone: a served
    run observes no histogram, and an audit leaves the registry as it was."""
    _serve(n=2)
    snap = metrics.snapshot()
    assert snap["qserve.completed"] >= 2
    assert not [n for n, v in snap.items() if isinstance(v, dict)
                and n.startswith(("qserve.", "engine."))]
    plan = optimize(PLAN, Catalog(_tables()), measure_profile=False)
    executor.audit(plan)
    assert metrics.snapshot() == snap
