"""Parity of the port's trace layer (`repro_torch.obs.trace`, `run(trace=True)`,
`explain(actuals=)`, `residuals_of`, `python -m repro_torch.obs`) with the
JAX package's, on the CPU.

The same numpy tables (4-byte columns: the JAX package runs with x64 off)
go into each package's Catalog; both optimize the same query with one
explicit `PrimitiveProfile` and an empty residual store, and the traced
runs must give the same span tree: ops, strategies, paths, rows and bytes
in and out, and the same predicted costs (the same floats). Measured times
differ by nature. The JAX package plans its partitions on its 'xla' arm,
as in tests/test_torch_engine.py.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.engine as JE  # noqa: E402
import repro.kernels.ops as jops  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.engine as TE  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.obs.residuals import ResidualStore as JResiduals  # noqa: E402
from repro_torch.core.planner import PrimitiveProfile  # noqa: E402
from repro_torch.engine import physical as TP  # noqa: E402
from repro_torch.obs import (CalibrationStore, Span, backend_fingerprint,  # noqa: E402
                             residuals_of, timed_call, trace)
from repro_torch.obs.residuals import ResidualStore as TResiduals  # noqa: E402

PROFILE = dict(seq_bw=2.1e11, sort_pass_bw=3.3e10, partition_pass_bw=5.7e10,
               unclustered_penalty=7.5, clustered_penalty=1.4)


@pytest.fixture(autouse=True)
def jax_partition_plan_on_its_xla_arm(monkeypatch):
    monkeypatch.setattr(jops, "partition_plan_impl", lambda: "xla")


def _tables(n_r=64, n_s=512, seed=0):
    rng = np.random.default_rng(seed)
    return {"R": {"k": rng.permutation(n_r).astype(np.int32),
                  "rv": rng.integers(0, 50, n_r).astype(np.int32)},
            "S": {"k": rng.integers(0, n_r, n_s).astype(np.int32),
                  "g": rng.integers(0, 8, n_s).astype(np.int32),
                  "sv": rng.integers(0, 50, n_s).astype(np.int32)}}


QUERIES = {
    "star": lambda E: E.scan("S").join(E.scan("R"), key="k").group_by("g", rv="sum", sv="sum"),
    "unfused": lambda E: E.scan("S").join(E.scan("R"), key="k").group_by("g", rv="sum"),
    "filtered_topk": lambda E: (E.scan("S").filter("sv", ">", 20).join(E.scan("R"), key="k")
                                .group_by("g", sv="sum")
                                .order_by("sv_sum", limit=4, descending=True)),
}
FORCE = {"unfused": ("phj", "gftr")}


def plans(name, seed=0):
    tables = _tables(seed=seed)
    jc = JE.Catalog({n: J.Table({c: jnp.asarray(v) for c, v in t.items()})
                     for n, t in tables.items()})
    tc = TE.Catalog({n: T.table_from_numpy(t, "cpu") for n, t in tables.items()})
    kw = {"force_join": FORCE[name]} if name in FORCE else {}
    q = QUERIES[name]
    jplan = JE.optimize(q(JE), jc, profile=J.PrimitiveProfile(**PROFILE),
                        residuals=JResiduals(), **kw)
    tplan = TE.optimize(q(TE), tc, profile=PrimitiveProfile(**PROFILE),
                        residuals=TResiduals(), **kw)
    return jplan, tplan


def valid_rows(table, count):
    n = int(count)
    return {c: np.asarray(table[c])[:n] if not isinstance(table[c], torch.Tensor)
            else table[c][:n].numpy() for c in table.column_names}


# ---------------------------------------------------------------------------
# the span tree against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_span_tree_matches_jax(name):
    jplan, tplan = plans(name)
    jt, jc, jtr = jplan.run(trace=True)
    tt, tc, ttr = tplan.run(trace=True)
    assert int(jc) == int(tc)
    jrows, trows = valid_rows(jt, jc), valid_rows(tt, tc)
    assert sorted(jrows) == sorted(trows)
    for c in jrows:
        np.testing.assert_array_equal(jrows[c], trows[c], err_msg=c)
    js, ts = jtr.spans(), ttr.spans()
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        for f in ("op", "strategy", "path", "rows_in", "rows_out", "bytes_in", "bytes_out",
                  "predicted_s", "name"):
            assert getattr(a, f) == getattr(b, f), (f, a.path)
    assert [r.as_dict() for r in jtr.escalations] == [r.as_dict() for r in ttr.escalations]


def test_traced_run_matches_untraced():
    _, plan = plans("star")
    t_ref, c_ref = plan.run()
    t_tr, c_tr, tr = plan.run(trace=True)
    assert int(c_tr) == int(c_ref)
    assert c_tr.dtype == c_ref.dtype == torch.int32
    for col in t_ref.column_names:
        assert torch.equal(t_ref[col][:int(c_ref)], t_tr[col][:int(c_ref)])
    assert tr.root.op in ("groupby", "groupjoin")
    assert all(s.wall_s > 0 for s in tr.spans())
    assert tr.root.rows_out == int(c_ref)


def test_trace_overhead_bound_accounts_for_e2e():
    _, plan = plans("star")
    _, _, tr = plan.run(trace=True, trace_iters=3, trace_warmup=1)
    assert tr.e2e_wall_s > 0
    assert abs(tr.sum_wall_s - tr.e2e_wall_s) <= tr.overhead_bound_s


def test_untraced_run_allocates_no_span_and_enters_no_mode(monkeypatch):
    """trace=False takes the untraced code path: no Span allocated and no
    dispatch mode entered, however often the plan runs."""
    from torch.utils import _python_dispatch

    _, plan = plans("star")
    entered = []
    real = _python_dispatch.TorchDispatchMode.__enter__
    monkeypatch.setattr(_python_dispatch.TorchDispatchMode, "__enter__",
                        lambda self: (entered.append(self), real(self))[1])
    before = Span.allocated
    plan.run()
    plan.run()
    assert Span.allocated == before and not entered
    _, _, tr = plan.run(trace=True)
    assert Span.allocated - before == len(tr.spans())


def test_trace_rejects_counts_and_checked():
    _, plan = plans("star")
    with pytest.raises(ValueError, match="counts"):
        plan.run(trace=True, counts={"S": 10})
    with pytest.raises(ValueError, match="checked"):
        plan.run(trace=True, checked=True)


def test_trace_exports_match_jax_keys(tmp_path):
    jplan, tplan = plans("star")
    _, _, jtr = jplan.run(trace=True)
    _, _, ttr = tplan.run(trace=True)
    jd, td = jtr.as_dict(), ttr.as_dict()
    assert set(jd) == set(td)
    assert td["backend"] == backend_fingerprint("cpu")
    assert [set(n) for n in jd["nodes"]] == [set(n) for n in td["nodes"]]
    je, te = jtr.chrome_trace(), ttr.chrome_trace()
    assert [set(e) for e in je] == [set(e) for e in te]
    assert [e["name"] for e in je] == [e["name"] for e in te]
    assert all(e["ph"] == "X" and e["dur"] > 0 and e["ts"] >= 0 for e in te)
    ttr.to_json(str(tmp_path / "TRACE.json"))
    assert json.loads((tmp_path / "TRACE.json").read_text())["nodes"]
    ttr.to_chrome_trace(str(tmp_path / "TRACE.perfetto.json"))
    assert json.loads((tmp_path / "TRACE.perfetto.json").read_text())["traceEvents"]
    tbl = ttr.table()
    assert "predicted" in tbl and "measured" in tbl and "residual" in tbl
    assert len(tbl.splitlines()) == len(jtr.table().splitlines())


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_explain_with_actuals_annotates_every_node(name):
    """One annotated line per node, at the JAX package's place and in its
    format: the lines of explain(actuals=) equal the JAX package's once the
    measured numbers are masked."""
    import re

    jplan, tplan = plans(name)
    _, _, jtr = jplan.run(trace=True)
    _, _, ttr = tplan.run(trace=True)
    out = tplan.explain(actuals=ttr)
    annotated = [ln for ln in out.splitlines() if "predicted[" in ln]
    assert len(annotated) == len(ttr.spans())
    assert "residual[-]" in out  # scans carry no price

    def mask(text):
        text = re.sub(r"measured\[\d+us\]", "measured[*]", text)
        return re.sub(r"residual\[[\d.]+x\]( \*\* >2x DIVERGENCE \*\*)?", "residual[*]", text)

    assert mask(out) == mask(jplan.explain(actuals=jtr))


def test_residuals_of_skips_unpriced_nodes():
    jplan, tplan = plans("filtered_topk")
    _, _, jtr = jplan.run(trace=True)
    _, _, ttr = tplan.run(trace=True)
    res = residuals_of(ttr)
    assert res and all(r.predicted_s > 0 and r.ratio > 0 for r in res)
    assert not any(r.op == "scan" for r in res)
    from repro.obs import residuals_of as jresiduals_of

    assert [(r.key, r.predicted_s) for r in res] == [
        (r.key, r.predicted_s) for r in jresiduals_of(jtr)]


def test_timed_call_host_clock_on_cpu_and_median():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    out, wall = timed_call(fn, torch.zeros(4), iters=3, warmup=2)
    assert torch.equal(out, torch.ones(4)) and wall >= 0 and len(calls) == 5
    assert trace._device_of((T.table_from_numpy({"a": np.zeros(3, np.int32)}, "cpu"),)).type \
        == "cpu"
    assert trace.sync_floor(iters=3) >= 0
    assert trace.median_wall(fn, torch.zeros(2), iters=1) >= 0


def test_reference_timed_call_is_what_the_port_replaces():
    """The JAX package's primitive blocks on jax outputs; the port's takes
    the device from the arguments. Both return (result, median seconds)."""
    out, wall = jtrace.timed_call(lambda x: x + 1, jnp.zeros(3), iters=2)
    assert np.asarray(out).tolist() == [1.0, 1.0, 1.0] and wall >= 0


def test_obs_cli_smoke(tmp_path, monkeypatch):
    """`python -m repro_torch.obs --smoke --device cpu` end to end: traced
    workload, TRACE files written with full schemas, the calibration store
    gains residuals under the CPU's fingerprint."""
    from repro_torch.obs.__main__ import main

    cal = tmp_path / "CALIBRATION.json"
    monkeypatch.setenv("REPRO_CALIBRATION_PATH", str(cal))
    store = CalibrationStore()
    store.put_profile(backend_fingerprint("cpu"), 1 << 16, PrimitiveProfile(**PROFILE))
    store.save()
    monkeypatch.setattr(TP, "_PROFILE_CACHE", {})
    monkeypatch.chdir(tmp_path)
    assert main(["--smoke", "--device", "cpu", "--iters", "1", "--warmup", "1"]) == 0
    tr = json.loads((tmp_path / "TRACE.json").read_text())
    assert set(tr["queries"]) == {"star", "highcard_groupby"}
    for q in tr["queries"].values():
        assert all("residual" in n and n["measured_s"] > 0 for n in q["nodes"])
    assert json.loads((tmp_path / "TRACE.perfetto.json").read_text())["traceEvents"]
    ent = json.loads(cal.read_text())[backend_fingerprint("cpu")]
    assert ent["profiles"] and ent["residuals"]
    assert any(k.startswith(("groupby/", "groupjoin/", "join/")) for k in ent["residuals"])


def test_obs_cli_needs_a_card_unless_told_cpu(monkeypatch, tmp_path, capsys):
    from repro_torch.obs.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert main(["--smoke"]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "TRACE.json").exists()
