"""The per-layer metrics that read the program's own spans
(bench/progspans.py), on hand-built spans: the window's filter, the
division by completed queries, and nothing read without device intervals
or without the recorder."""
import dataclasses

import pytest

from bench import harness, registry
from bench.loop import Query

METRICS = ("serve.pad_ms", "op.groupjoin_window_ms", "op.join_window_ms")


@dataclasses.dataclass
class FakeSpan:
    name: str
    t0_ns: int
    device_ms: float | None
    self_ms: float | None = None


def ctx_of(n_done=4, n_missing=0):
    """Queries due from 10.0 s on, the last answer back at 20.0 s."""
    qs = [Query(due=10.0 + i, answer={}, done=20.0 - i) for i in range(n_done)]
    qs += [Query(due=11.0) for _ in range(n_missing)]
    return harness.Context(setup_s=1.0, window_s=10.0, queries=qs, right=[True] * len(qs),
                           peak_bytes=0)


def spans(device=True):
    d = (lambda ms: ms) if device else (lambda ms: None)
    s = 10**9
    return [
        FakeSpan("qserve.pad", 9 * s, d(100.0)),  # before the first due: out
        FakeSpan("qserve.pad", 10 * s, d(2.0)),  # at the window's start: in
        FakeSpan("qserve.pad", 15 * s, d(6.0)),
        FakeSpan("qserve.pad", 20 * s + 1, d(100.0)),  # after the last answer: out
        FakeSpan("exec.groupjoin", 12 * s, d(50.0), 40.0),
        FakeSpan("exec.groupjoin", 13 * s, d(60.0), 44.0),
        FakeSpan("exec.join", 14 * s, d(30.0), 30.0),
        FakeSpan("exec.join", 21 * s, d(30.0), 30.0),
    ]


@pytest.fixture
def recorded(monkeypatch):
    from repro_torch.obs import trace

    def plant(spans_):
        monkeypatch.setattr(trace, "recorded", lambda: list(spans_))
    return plant


def read(name, ctx):
    return registry.load_metric(name).read(ctx)


def test_window_filter_and_per_query_division(recorded):
    recorded(spans())
    ctx = ctx_of(n_done=4, n_missing=2)  # 4 answers back: the divisor
    assert read("serve.pad_ms", ctx) == pytest.approx((2.0 + 6.0) / 4)
    # self time, not the interval: the inputs' spans are taken out
    assert read("op.groupjoin_window_ms", ctx) == pytest.approx((40.0 + 44.0) / 4)
    assert read("op.join_window_ms", ctx) == pytest.approx(30.0 / 4)


def test_nothing_read_without_device_intervals(recorded):
    recorded(spans(device=False))
    for name in METRICS:
        assert read(name, ctx_of()) is None


@pytest.mark.parametrize("name", METRICS)
def test_nothing_read_without_spans_answers_or_recorder(name, recorded, monkeypatch):
    recorded([])
    assert read(name, ctx_of()) is None
    recorded(spans())
    assert read(name, ctx_of(n_done=0, n_missing=3)) is None
    # a program without the recorder (an older port): nothing, no error
    from repro_torch.obs import trace

    monkeypatch.delattr(trace, "recorded")
    assert read(name, ctx_of()) is None
