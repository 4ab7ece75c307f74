"""Whole runs at a tiny size on the CPU: the result line, the metrics'
arithmetic, the import check, and `correct` coming out false under the
control and under each fault a cell can have."""
import subprocess
import sys
import time
import types

import pytest

from bench import control, harness, registry
from bench.loop import Query

from .conftest import HELD, ROOT, run_tiny, tiny_parts

SPEC = registry.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]] + list(HELD)
SERVED = ([w["name"] for w in SPEC["workloads"] if w["traffic"].startswith("served")]
          + [c for c, t in HELD.items() if t.startswith("served")])


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    parts = tiny_parts(cell)
    res = run_tiny(parts)["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in SPEC["end_to_end"]}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or m["unit"] == "GiB"
    limits = parts["query"].LIMITS
    assert {"answers_missing", "answers_wrong", "rows_wrong_max",
            "groups_wrong"} <= set(res["checks"]) == set(limits)
    assert all(c["limit"] == limits[k] and 0 <= c["value"] <= c["limit"]
               for k, c in res["checks"].items())


def test_traced_result_line():
    out = run_tiny(tiny_parts("star4-sf10.served4"), trace=True)
    res = out["result"]
    assert res["correct"]
    names = {m["name"] for m in SPEC["per_layer"] if "star4-sf10.served4" in m["workloads"]}
    # the CPU runs no kernel and has no device trace: only the spans', the
    # counter's and the host clock's metrics read anything; the others are
    # named as silent, which fails a run on the card (bench/run.py)
    read = {"plan.capacity_ratio", "op.groupjoin_ms", "op.join_ms",
            "dispatch.launches_per_query", "query.mfu"}
    assert set(res["metrics"]) == names & read
    assert set(out["silent"]) == names - read


def ctx_of(latencies, right, window_s=2.0, missing=0):
    qs = [Query(due=0.0, answer={}, done=lat) for lat in latencies]
    qs += [Query(due=0.0) for _ in range(missing)]
    return harness.Context(setup_s=1.5, window_s=window_s, queries=qs,
                           right=list(right) + [False] * missing, peak_bytes=3 << 30)


def test_rate_and_tail_over_all_requests():
    read = lambda name, ctx: registry.load_metric(name).read(ctx)  # noqa: E731
    lat = [0.01 * i for i in range(1, 21)]  # 20 answers, 10 ms to 200 ms
    ctx = ctx_of(lat, [True] * 19 + [False])
    assert read("queries_per_s", ctx) == 19 / 2.0  # right answers only
    assert read("latency_p90_ms", ctx) == pytest.approx(180.0)  # the 18th of 20
    assert read("latency_p90_ms", ctx_of(lat[:10], [True] * 10)) == pytest.approx(90.0)
    assert read("peak_device_gib", ctx) == 3.0
    assert read("setup_s", ctx) == 1.5
    assert read("query.mfu", ctx) is None  # no bytes counted outside a traced run


def test_forbidden_modules_compared_by_top_level_name(monkeypatch):
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtools", types.ModuleType("x"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.engine", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert harness.forbidden_loaded() == ["jax", "repro.engine"]
    with pytest.raises(SystemExit):
        run_tiny(tiny_parts("q18-sf10.embedded"), seconds=0.2)


@pytest.mark.parametrize("planted", ["jax", "repro.data"])
def test_a_module_loaded_by_a_metric_reader_is_found(planted, monkeypatch):
    """A reader runs after the window and after the reference; what it
    loads is still looked for before the result is returned."""
    load = registry.load_metric

    def loading(name, root=registry.ROOT):
        mod = load(name, root)
        if name != "setup_s":
            return mod
        reader = types.ModuleType(name)

        def read(ctx):
            monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
            return mod.read(ctx)

        reader.read = read
        return reader

    monkeypatch.setattr(registry, "load_metric", loading)
    with pytest.raises(SystemExit, match=planted):
        run_tiny(tiny_parts("q18-sf10.embedded"), seconds=0.2)


def test_run_exits_without_a_card():
    proc = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
                           "q18-sf10.embedded", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=120, cwd=ROOT,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "GPU" in proc.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = run_tiny(tiny_parts(cell), make_entry=control.control_entry())["result"]
    assert not res["correct"]
    assert res["checks"]["answers_wrong"]["value"] == res["attempted"]
    assert res["checks"]["groups_wrong"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["q18-sf10.served4", "skew-groupby.served4"])
def test_control_is_not_correct_on_the_card(card, cell):
    parts = tiny_parts(cell, shrink=64)
    good = run_tiny(parts, device=card, seconds=2.0)["result"]
    bad = run_tiny(parts, device=card, seconds=2.0, make_entry=control.control_entry())
    assert good["correct"] and not bad["result"]["correct"]


def alter_answer(monkeypatch):
    """An answer altered where it is produced: the top-k's order column."""
    from repro_torch.engine import executor

    orig = executor._order_by

    def altered(node, tables, counts=None):
        out, count = orig(node, tables, counts)
        col = out[node.key].clone()
        col[0] += 1
        return out.with_columns(**{node.key: col}), count

    monkeypatch.setattr(executor, "_order_by", altered)


def drop_half(monkeypatch):
    """Half of the batch left out: every scan's second half of rows."""
    from repro_torch.engine import executor
    from repro_torch.engine import physical as P

    orig = executor.execute

    def halved(node, tables, counts=None):
        out, count = orig(node, tables, counts)
        if isinstance(node, P.PScan):
            count = count // 2
        return out, count

    monkeypatch.setattr(executor, "execute", halved)


def state_unchanged(monkeypatch):
    """A step that returns its state unchanged: the server's tick does
    nothing, so no answer ever comes."""
    from repro_torch.serve import QueryServer

    monkeypatch.setattr(QueryServer, "step", lambda self: bool(self.queue))


FAULTS = ([(c, alter_answer) for c in CELLS] + [(c, drop_half) for c in CELLS]
          + [(c, state_unchanged) for c in SERVED])
# the number each fault has to fail
FAILS = {alter_answer: "answers_wrong", drop_half: "groups_wrong",
         state_unchanged: "answers_missing"}


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    parts = tiny_parts(cell)
    if fault is state_unchanged:
        # the warm-up would wait for ever: the fault starts with the window
        from bench import loop

        orig = loop.run_window

        def faulty(*a, **kw):
            fault(monkeypatch)
            return orig(*a, **kw)

        monkeypatch.setattr(loop, "run_window", faulty)
    else:
        fault(monkeypatch)
    t0 = time.perf_counter()
    res = run_tiny(parts, seconds=0.3, late_s=0.5)["result"]
    assert not res["correct"]
    assert res["checks"][FAILS[fault]]["value"] > 0
    assert time.perf_counter() - t0 < 60
