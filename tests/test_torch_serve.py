"""The port's query server (`repro_torch.serve`) against the JAX package's,
on the CPU.

  * `bucket_rows`, `pad_table` (integer wraparound included) and
    `plan_signature` equal the JAX package's: the same submission has the
    same 16-hex signature in both packages.
  * The assertions of every test of tests/test_serve_query.py, and of its
    chaos smoke, held on the port. (The JAX package's own server tests fail
    on JAX 0.9: its `plan_peak_bytes` reaches `jax.core.Literal`.)
  * Both servers side by side on the same requests: with `plan_peak_bytes`
    replaced in each package, inside the test, by one function of the
    test's own (the tables' bytes times three) and one explicit
    `PrimitiveProfile`, every request takes the same path, error and morsel
    factor and gives the same canonical rows, and the `qserve.*` counters
    move the same.

Then the CLIs: `python -m repro_torch.serve --chaos` and
`python -m repro_torch.resilience --smoke` with `--device cpu`, and their
refusal to run without a card otherwise.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.engine as JE  # noqa: E402
import repro.kernels.ops as jops  # noqa: E402
from repro.engine import executor as jex  # noqa: E402
from repro.engine import physical as JP  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.serve import query as JQ  # noqa: E402
from repro_torch.core import Table, table_from_numpy  # noqa: E402
from repro_torch.core.planner import PrimitiveProfile  # noqa: E402
from repro_torch.data import relgen  # noqa: E402
from repro_torch.engine import Catalog, executor, optimize, plan_peak_bytes, scan  # noqa: E402
from repro_torch.engine import physical as TP  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.serve import query as Q  # noqa: E402

PROFILE = dict(seq_bw=2.1e11, sort_pass_bw=3.3e10, partition_pass_bw=5.7e10,
               unclustered_penalty=7.5, clustered_penalty=1.4)


@pytest.fixture(autouse=True)
def scratch_calibration(tmp_path, monkeypatch):
    """Both packages read an empty calibration store of the test's own, and
    the JAX package plans its partitions on its 'xla' arm (as in
    tests/test_torch_engine.py)."""
    monkeypatch.setenv("REPRO_CALIBRATION_PATH", str(tmp_path / "CALIBRATION.json"))
    monkeypatch.setattr(jops, "partition_plan_impl", lambda: "xla")


def canon(table, count):
    n = int(count)
    cols = sorted(table.column_names)
    mats = [table[c][:n].numpy() if isinstance(table[c], torch.Tensor)
            else np.asarray(table[c])[:n] for c in cols]
    return tuple(cols), sorted(zip(*[m.tolist() for m in mats]))


def tables_of(cols: dict) -> dict:
    return {n: table_from_numpy(t, "cpu") for n, t in cols.items()}


def make_join_tables(n_r, n_s, seed=0):
    R, S = relgen.generate(relgen.JoinWorkload("t", n_r, n_s, 1, 1, seed=seed))
    return tables_of({"R": R, "S": S})


def one_shot(plan, tables):
    return canon(*optimize(plan, Catalog(tables), measure_profile=False).run())


JOIN_PLAN = scan("S").join(scan("R"), key="k")


def drive(server, reqs, per_tick=4, max_ticks=500):
    i = 0
    while (i < len(reqs) or server.queue or server.deferred) and server.tick < max_ticks:
        for _ in range(per_tick):
            if i < len(reqs):
                server.submit(reqs[i])
                i += 1
        server.step()


# ---------------------------------------------------------------------------
# bucketing / padding / signatures against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1500, 2048, 2049, 1 << 20])
def test_bucket_rows_equals_jax(n):
    assert Q.bucket_rows(n) == JQ.bucket_rows(n)


PAD_CASES = {
    "ints": {"k": np.array([5, 3, 9], np.int32), "x": np.array([1.5, 2.5, 3.5], np.float32)},
    "int64": {"k": np.array([7, -2, 40], np.int64)},
    "wraparound": {"k": np.array([2**31 - 3, 0, 17], np.int32)},
    "one_row": {"k": np.array([4], np.int32), "x": np.array([0.25], np.float32)},
}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
@pytest.mark.parametrize("capacity", [3, 8, 64])
def test_pad_table_equals_jax(case, capacity):
    cols = PAD_CASES[case]
    if case == "int64":  # the JAX package runs with x64 off: compare the int64 padding alone
        got = Q.pad_table(table_from_numpy(cols, "cpu"), capacity)["k"].numpy()
        k = cols["k"]
        want = np.concatenate([k, k.max() + 1 + np.arange(capacity - k.size)])
        np.testing.assert_array_equal(got, want)
        return
    t = table_from_numpy(cols, "cpu")
    if capacity < t.num_rows:
        with pytest.raises(ValueError):
            Q.pad_table(t, capacity)
        return
    got = Q.pad_table(t, capacity)
    want = JQ.pad_table(J.Table({c: jnp.asarray(v) for c, v in cols.items()}), capacity)
    for c in cols:
        assert got[c].numpy().dtype == np.asarray(want[c]).dtype
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]), err_msg=c)
    if case == "wraparound" and capacity > 3:
        assert got["k"].numpy()[3:].min() == -2**31  # wrapped as the JAX package's does


def _sig_plans(E):
    return [E.scan("S").join(E.scan("R"), key="k"),
            E.scan("S").filter("s1", "<", 10).join(E.scan("R"), key="k"),
            E.scan("S").group_by("k", s1="sum"),
            E.scan("S").filter("s1", "<", 1 << 30).order_by("s1", limit=32)]


@pytest.mark.parametrize("sizes", [(400, 1500), (450, 1200), (400, 2500), (70, 64)])
def test_plan_signature_equals_jax(sizes):
    R, S = relgen.generate(relgen.JoinWorkload("t", *sizes, 1, 1, seed=3))
    tt = tables_of({"R": R, "S": S})
    jt = {n: J.Table({c: jnp.asarray(v) for c, v in t.items()})
          for n, t in {"R": R, "S": S}.items()}
    for tp, jp in zip(_sig_plans(JE), _sig_plans(JE)):
        assert Q.plan_signature(tp, tt) == JQ.plan_signature(jp, jt)
    # the port's own logical plans build the same signature
    import repro_torch.engine as TE

    for tp, jp in zip(_sig_plans(TE), _sig_plans(JE)):
        sig, buckets = Q.plan_signature(tp, tt)
        assert (sig, buckets) == JQ.plan_signature(jp, jt) and len(sig) == 16


# ---------------------------------------------------------------------------
# tests/test_serve_query.py's assertions, on the port
# ---------------------------------------------------------------------------
def test_bucket_rows_power_of_two_floor():
    assert Q.bucket_rows(0) == Q.MIN_BUCKET
    assert Q.bucket_rows(1) == Q.MIN_BUCKET
    assert Q.bucket_rows(64) == 64
    assert Q.bucket_rows(65) == 128
    assert Q.bucket_rows(1500) == 2048
    assert Q.bucket_rows(2048) == 2048


def test_pad_table_preserves_uniqueness_and_wraps_floats():
    t = table_from_numpy({"k": np.array([5, 3, 9], np.int32),
                          "x": np.array([1.5, 2.5, 3.5], np.float32)}, "cpu")
    p = Q.pad_table(t, 8)
    assert p.num_rows == 8
    k = p["k"].numpy()
    assert k[:3].tolist() == [5, 3, 9]
    assert len(set(k.tolist())) == 8
    assert k[3:].min() > 9
    assert p["x"].numpy()[:3].tolist() == [1.5, 2.5, 3.5]
    assert Q.pad_table(t, 3) is t
    with pytest.raises(ValueError):
        Q.pad_table(t, 2)


def test_plan_signature_buckets_collapse_sizes():
    t1 = make_join_tables(400, 1500, seed=1)
    t2 = make_join_tables(450, 1200, seed=2)  # same buckets (512, 2048)
    t3 = make_join_tables(400, 2500, seed=3)  # S in the next bucket
    s1, b1 = Q.plan_signature(JOIN_PLAN, t1)
    s2, _ = Q.plan_signature(JOIN_PLAN, t2)
    s3, _ = Q.plan_signature(JOIN_PLAN, t3)
    assert s1 == s2
    assert s1 != s3
    assert b1 == {"R": 512, "S": 2048}
    f1 = scan("S").filter("s1", "<", 10).join(scan("R"), key="k")
    f2 = scan("S").filter("s1", "<", 11).join(scan("R"), key="k")
    assert Q.plan_signature(f1, t1)[0] != Q.plan_signature(f2, t1)[0]


def test_executor_counts_reuse_one_plan():
    """One optimized plan serves every dataset padded to its buckets, with
    the true valid counts, equal to per-dataset one-shot runs (the JAX
    package's bucketed executable; here there is nothing to compile)."""
    datasets = [make_join_tables(400, 1500, seed=4), make_join_tables(450, 1200, seed=5)]
    sig, buckets = Q.plan_signature(JOIN_PLAN, datasets[0])
    padded0 = {n: Q.pad_table(t, buckets[n]) for n, t in datasets[0].items()}
    plan = optimize(JOIN_PLAN, Catalog(padded0), measure_profile=False)
    for tb in datasets:
        padded = {n: Q.pad_table(t, buckets[n]) for n, t in tb.items()}
        counts = {n: t.num_rows for n, t in tb.items()}
        assert canon(*plan.run(padded, counts=counts)) == one_shot(JOIN_PLAN, tb)
    assert not hasattr(plan, "compiled_bucketed")


def test_server_shares_one_plan_across_sizes():
    sizes = [(400, 1500), (450, 1200), (300, 1700)]
    reqs = [Q.QueryRequest(qid=i, plan=JOIN_PLAN, tables=make_join_tables(nr, ns, seed=10 + i))
            for i, (nr, ns) in enumerate(sizes)]
    before = metrics.counter("qserve.plans_compiled").value
    hits = metrics.counter("qserve.plan_cache_hits").value
    server = Q.QueryServer(device="cpu")
    drive(server, reqs)
    assert metrics.counter("qserve.plans_compiled").value == before + 1
    assert metrics.counter("qserve.plan_cache_hits").value == hits + 2
    for req in reqs:
        assert req.done and not req.error and req.path == "fast"
        assert canon(*req.result) == one_shot(JOIN_PLAN, req.tables)
        assert req.signature == reqs[0].signature
        assert req.exec_wall_s > 0 and req.done_tick >= req.submit_tick
        assert req.total_wall_s >= req.exec_wall_s and req.queue_wall_s >= req.plan_wall_s


def test_server_admission_price_and_shedding():
    tb = make_join_tables(400, 1500, seed=20)
    priced = Q.QueryServer(max_price_s=0.0, device="cpu")
    req = Q.QueryRequest(qid=0, plan=JOIN_PLAN, tables=tb)
    priced.submit(req)
    priced.run()
    assert req.error == "rejected" and req.result is None

    shedder = Q.QueryServer(max_queue=2, device="cpu")
    reqs = [Q.QueryRequest(qid=i, plan=JOIN_PLAN, tables=tb) for i in range(5)]
    for r in reqs:
        shedder.submit(r)  # all before any tick: 2 queued, 3 shed
    assert [r.error for r in reqs] == ["", "", "shed", "shed", "shed"]
    shedder.run()
    assert all(not r.error for r in reqs[:2])


def test_server_deadline_expires_on_admission_tick():
    tb = make_join_tables(400, 1500, seed=21)
    server = Q.QueryServer(slots_per_tick=1, device="cpu")
    first = Q.QueryRequest(qid=0, plan=JOIN_PLAN, tables=tb)
    racer = Q.QueryRequest(qid=1, plan=JOIN_PLAN, tables=tb, deadline_ticks=2)
    server.submit(first)
    server.submit(racer)
    server.run()
    assert first.done and not first.error
    assert racer.error == "deadline" and racer.result is None
    assert racer.done_tick == 2 and racer.admit_tick == -1


def test_server_tick_budget_paces_admission():
    tb = make_join_tables(400, 1500, seed=22)
    server = Q.QueryServer(slots_per_tick=4, device="cpu")
    probe = Q.QueryRequest(qid=0, plan=JOIN_PLAN, tables=tb)
    server.submit(probe)
    server.run()
    assert probe.done and probe.price_s > 0
    budget = Q.QueryServer(slots_per_tick=4, tick_budget_s=probe.price_s * 1.5, device="cpu")
    reqs = [Q.QueryRequest(qid=i, plan=JOIN_PLAN, tables=tb) for i in range(3)]
    for r in reqs:
        budget.submit(r)
    budget.run()
    assert [r.admit_tick for r in reqs] == [1, 2, 3]
    assert all(not r.error for r in reqs)


def test_breaker_state_machine():
    br = Q.CircuitBreaker("sig", threshold=2, cooldown=3, max_cooldown=12)
    assert br.route(1) == "fast"
    br.record_fast_failure(1)
    assert br.state == Q.CLOSED
    br.record_fast_failure(2)
    assert br.state == Q.OPEN
    assert br.route(3) == "safe"
    assert br.route(5) == "fast" and br.state == Q.HALF_OPEN
    br.record_fast_failure(5)
    assert br.state == Q.OPEN and br.cooldown == 6
    assert br.route(7) == "safe"
    assert br.route(11) == "fast" and br.state == Q.HALF_OPEN
    br.record_fast_success(11)
    assert br.state == Q.CLOSED and br.cooldown == 3
    assert br.route(12) == "fast"


def _groupby_tables(i, domain, seed0):
    return tables_of({"S": relgen.generate(
        relgen.JoinWorkload("t", domain, 1500, 1, 1, seed=seed0 + i))[1]})


def test_server_breaker_quarantines_and_recovers():
    plan = scan("S").group_by("k", s1="sum")
    server = Q.QueryServer(breaker_cooldown=2, device="cpu")
    reqs = [Q.QueryRequest(qid=i, plan=plan, tables=_groupby_tables(i, 400, 40),
                           fault_spec="raise:qserve.execute" if i < 2 else "")
            for i in range(8)]
    drive(server, reqs, per_tick=1)
    assert [r.qid for r in reqs if r.error] == [0, 1]
    paths = [r.path for r in reqs if not r.error]
    assert "safe" in paths
    assert paths[-1] == "fast"
    assert server.breakers[reqs[0].signature].state == Q.CLOSED
    for r in reqs[2:]:
        assert canon(*r.result) == one_shot(plan, r.tables)


def test_server_saturation_escalates_to_correct_result():
    plan = scan("S").group_by("k", s1="sum")
    before = metrics.counter("qserve.saturations").value
    server = Q.QueryServer(breaker_cooldown=2, device="cpu")
    reqs = [Q.QueryRequest(qid=i, plan=plan, tables=_groupby_tables(i, 5000, 50),
                           fault_spec="estimates:/32") for i in range(4)]
    drive(server, reqs, per_tick=1)
    assert metrics.counter("qserve.saturations").value > before
    assert server.cache[reqs[0].signature].safe_level > 0
    for r in reqs:
        assert r.done and not r.error, (r.qid, r.detail)
        assert canon(*r.result) == one_shot(plan, r.tables)


def test_server_mem_rejects_unsplittable_with_typed_error():
    tables = tables_of({"S": relgen.generate(relgen.JoinWorkload("t", 5000, 1500, 1, 1,
                                                                   seed=9))[1]})
    plan = scan("S").filter("s1", "<", 1 << 30).order_by("s1", limit=32)
    before = metrics.counter("qserve.mem_rejections").value
    server = Q.QueryServer(measure_profile=False, mem_budget_bytes=4096, device="cpu")
    req = Q.QueryRequest(qid=0, plan=plan, tables=tables)
    server.submit(req)
    server.run()
    assert req.error == "rejected"
    assert "MemoryBudgetExceeded" in req.detail
    assert metrics.counter("qserve.mem_rejections").value == before + 1
    assert server.budget.reserved == 0


def test_server_chunked_run_bit_identical_under_tight_budget():
    rng = np.random.default_rng(11)

    def mk():
        return {"B": Table({f"c{c}": torch.from_numpy(
            rng.integers(0, 100, 30_000).astype(np.int32)) for c in range(16)})}

    plan = scan("B").filter("c0", "<", 60)
    t0 = mk()
    padded = {n: Q.pad_table(t, Q.bucket_rows(t.num_rows)) for n, t in t0.items()}
    phys = optimize(plan, Catalog(padded), measure_profile=False)
    whole = plan_peak_bytes(phys, padded, counts={n: t.num_rows for n, t in t0.items()})
    before = metrics.counter("qserve.chunked_runs").value
    server = Q.QueryServer(measure_profile=False, mem_budget_bytes=int(whole * 0.6),
                           device="cpu")
    reqs = [Q.QueryRequest(qid=i, plan=plan, tables=t0 if i == 0 else mk()) for i in range(2)]
    drive(server, reqs, per_tick=1)
    for r in reqs:
        assert r.done and not r.error, (r.qid, r.detail)
        assert r.morsels >= 2
        assert canon(*r.result) == one_shot(plan, r.tables)
    entry = server.cache[reqs[0].signature]
    assert entry.morsel_factor >= 2
    assert entry.peak_bytes <= server.budget.total
    assert metrics.counter("qserve.chunked_runs").value == before + 2
    assert server.budget.reserved == 0
    assert server.budget.peak_reserved <= server.budget.total


def test_server_same_tick_contention_defers_not_sheds():
    tables = make_join_tables(400, 1500, seed=21)
    server0 = Q.QueryServer(measure_profile=False, device="cpu")
    probe = Q.QueryRequest(qid=99, plan=JOIN_PLAN, tables=tables)
    server0.submit(probe)
    server0.run()
    peak = server0.cache[probe.signature].peak_bytes
    assert peak > 0

    before = metrics.counter("qserve.mem_deferrals").value
    server = Q.QueryServer(measure_profile=False, slots_per_tick=2,
                           mem_budget_bytes=int(peak * 1.5), device="cpu")
    reqs = [Q.QueryRequest(qid=i, plan=JOIN_PLAN, tables=tables) for i in range(2)]
    drive(server, reqs, per_tick=2)
    for r in reqs:
        assert r.done and not r.error, (r.qid, r.detail)
        assert canon(*r.result) == one_shot(JOIN_PLAN, tables)
    assert metrics.counter("qserve.mem_deferrals").value > before
    assert reqs[1].ticks_deferred > 0
    assert reqs[0].ticks_deferred == 0
    assert server.budget.reserved == 0
    assert server.budget.peak_reserved <= server.budget.total


def test_server_deferred_request_does_not_starve_queue():
    tables = make_join_tables(350, 1300, seed=31)
    before_shed = metrics.counter("qserve.shed").value
    server = Q.QueryServer(measure_profile=False, max_queue=2, slots_per_tick=2, device="cpu")
    stuck = Q.QueryRequest(qid=0, plan=JOIN_PLAN, tables=tables,
                           fault_spec="oom:qserve.admit", deadline_ticks=8)
    server.submit(stuck)
    server.step()
    assert stuck in server.deferred and not server.queue
    later = [Q.QueryRequest(qid=1 + i, plan=JOIN_PLAN, tables=tables) for i in range(4)]
    for pair in (later[:2], later[2:]):
        for r in pair:
            server.submit(r)
        while server.queue:
            server.step()
    server.run()
    assert metrics.counter("qserve.shed").value == before_shed
    for r in later:
        assert r.done and not r.error, (r.qid, r.detail)
    assert stuck.error == "deadline"
    assert stuck.ticks_deferred > 0
    assert server.budget.reserved == 0


def test_chaos_smoke_single_family():
    from repro_torch.serve import chaos

    rep = chaos.run_chaos(queries_per_family=24, smoke=True, families=("estimates",),
                          device="cpu")
    assert rep["ok"], rep["failures"]
    assert rep["baseline"]["p99_s"] > 0
    assert rep["baseline"]["throughput_qps"] > 0
    fam = rep["families"]["estimates"]
    assert fam["wrong_results"] == 0 and fam["contaminated"] == 0
    assert fam["counters"]["qserve.saturations"] > 0


def test_chaos_refuses_the_pallas_family():
    from repro_torch.serve import chaos

    with pytest.raises(ValueError, match="pallas.*fire nowhere"):
        chaos.run_chaos(queries_per_family=4, families=("pallas",), device="cpu")
    assert chaos.FAMILIES == ("overflow", "raise", "estimates")


# ---------------------------------------------------------------------------
# both servers side by side
# ---------------------------------------------------------------------------
def _nbytes(t) -> int:
    if isinstance(t, Table):
        return t.nbytes()
    return int(sum(t[c].nbytes for c in t.column_names))


def fake_peak(plan, tables=None, counts=None):
    """The test's own bytes ticket: three times the input tables' bytes."""
    tables = tables if tables is not None else plan.catalog.tables
    return 3 * sum(_nbytes(t) for t in tables.values())


@pytest.fixture
def twin(monkeypatch):
    """Both packages on one explicit profile and the test's own peak."""
    monkeypatch.setattr(jex, "plan_peak_bytes", fake_peak)
    monkeypatch.setattr(executor, "plan_peak_bytes", fake_peak)
    monkeypatch.setattr(JP, "PrimitiveProfile", lambda: J.PrimitiveProfile(**PROFILE))
    monkeypatch.setattr(TP, "PrimitiveProfile", lambda: PrimitiveProfile(**PROFILE))


def _scenario(name):
    """(requests as (plan builder, numpy tables, fault spec, deadline),
    server kwargs, submissions per tick)."""
    def join_t(nr, ns, seed):
        R, S = relgen.generate(relgen.JoinWorkload("t", nr, ns, 1, 1, seed=seed))
        return {"R": R, "S": S}

    def gb_t(domain, seed):
        return {"S": relgen.generate(relgen.JoinWorkload("t", domain, 1500, 1, 1, seed=seed))[1]}

    join = lambda E: E.scan("S").join(E.scan("R"), key="k")  # noqa: E731
    gby = lambda E: E.scan("S").group_by("k", s1="sum")  # noqa: E731
    if name == "sizes":
        return ([(join, join_t(nr, ns, 10 + i), "", None)
                 for i, (nr, ns) in enumerate([(400, 1500), (450, 1200), (300, 1700)])],
                {}, 4)
    if name == "breaker":
        return ([(gby, gb_t(400, 40 + i), "raise:qserve.execute" if i < 2 else "", None)
                 for i in range(8)], {"breaker_cooldown": 2}, 1)
    if name == "estimates":
        return ([(gby, gb_t(5000, 50 + i), "estimates:/32", None) for i in range(4)],
                {"breaker_cooldown": 2}, 1)
    if name == "pressure":
        t = join_t(400, 1500, 22)
        return ([(join, t, "", 1 if j < 2 else None) for j in range(7)],
                {"max_queue": 4, "slots_per_tick": 2}, 7)
    if name == "defer":
        t = join_t(400, 1500, 21)
        return ([(join, t, "", None) for _ in range(2)],
                {"slots_per_tick": 2, "mem_budget_bytes": int(fake_peak(None, {
                    n: table_from_numpy(v, "cpu") for n, v in t.items()}) * 1.5)}, 2)
    if name == "morsels":
        rng = np.random.default_rng(11)
        t = {"B": {f"c{c}": rng.integers(0, 100, 30_000).astype(np.int32) for c in range(8)}}
        whole = 3 * 8 * 4 * Q.bucket_rows(30_000)
        return ([(lambda E: E.scan("B").filter("c0", "<", 60), t, "", None)],
                {"mem_budget_bytes": int(whole * 0.6)}, 1)
    raise KeyError(name)


def _qserve_delta(registry_counter, names, before):
    return {n: registry_counter(n).value - before[n] for n in names}


@pytest.mark.parametrize("name", ["sizes", "breaker", "estimates", "pressure", "defer",
                                  "morsels"])
def test_servers_agree_request_by_request(twin, name):
    import repro_torch.engine as TE

    reqs, kw, per_tick = _scenario(name)
    names = ["qserve." + n for n in (
        "submitted", "plans_compiled", "plan_cache_hits", "shed", "rejected",
        "deadline_evictions", "fast_runs", "fast_failures", "safe_runs", "safe_escalations",
        "saturations", "failed", "completed", "breaker_opens", "breaker_closes",
        "breaker_probes", "mem_deferrals", "mem_rejections", "chunked_runs")]
    out = {}
    for pkg, E, QQ, reg, mk in (
            ("jax", JE, JQ, jmetrics.counter,
             lambda t: J.Table({c: jnp.asarray(v) for c, v in t.items()})),
            ("torch", TE, Q, metrics.counter, lambda t: table_from_numpy(t, "cpu"))):
        before = {n: reg(n).value for n in names}
        server = QQ.QueryServer(**kw)
        rs = [QQ.QueryRequest(qid=i, plan=build(E), tables={n: mk(t) for n, t in tabs.items()},
                              fault_spec=spec, deadline_ticks=dl)
              for i, (build, tabs, spec, dl) in enumerate(reqs)]
        drive(server, rs, per_tick=per_tick)
        out[pkg] = ([(r.qid, r.done, r.error, r.path, r.morsels, r.signature, r.admit_tick,
                      r.ticks_deferred, r.escalations,
                      canon(*r.result) if r.result is not None else None) for r in rs],
                    _qserve_delta(reg, names, before), server.tick)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]
    # each scenario drives what it is named for
    rows, delta, _ = out["torch"]
    want = {"sizes": ("plan_cache_hits", 2), "breaker": ("breaker_closes", 1),
            "estimates": ("saturations", 1), "pressure": ("shed", 3),
            "defer": ("mem_deferrals", 1), "morsels": ("chunked_runs", 1)}[name]
    assert delta["qserve." + want[0]] >= want[1], delta
    assert all(r[1] for r in rows)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
def test_serve_cli_chaos_smoke_on_cpu(tmp_path, monkeypatch):
    from repro_torch.serve import chaos
    from repro_torch.serve.__main__ import main

    real = chaos.run_chaos
    monkeypatch.setattr(chaos, "run_chaos",
                        lambda **kw: real(queries_per_family=24, families=("estimates",), **kw))
    out = tmp_path / "BENCH.json"
    assert main(["--chaos", "--smoke", "--device", "cpu", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and rep["config"]["device"] == "cpu"


@pytest.mark.parametrize("module", ["serve", "resilience"])
def test_clis_need_a_card_unless_told_cpu(module, monkeypatch, capsys):
    import importlib

    main = importlib.import_module(f"repro_torch.{module}.__main__").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--chaos" if module == "serve" else "--smoke"]) == 1
    assert "--device cpu" in capsys.readouterr().err


def test_resilience_cli_smoke_on_cpu(capsys):
    from repro_torch.resilience.__main__ import NO_KERNELS_SECTION, main

    assert main(["--smoke", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["kernels"] == NO_KERNELS_SECTION
    assert {c["case"] for c in rep["cases"]} == {
        "ladder.phj", "ladder.groupjoin", "ladder.groupby_partition", "engine.degrade_once",
        "engine.oom_morsel_rung"}
    assert all(c["ok"] for c in rep["cases"])
