"""Parity of the port's query engine with the JAX package, on the CPU.

For each plan of tests/test_engine.py (and the group-join fusion of
tests/test_groupjoin.py), the same numpy tables, made from a seed, go into
each package's Catalog; both optimize the same query with one explicit
`PrimitiveProfile` and an empty residual store, and then:

  * `explain()` is equal line for line;
  * the valid rows of the port's `run()` equal the JAX package's `run()`
    (integers exactly, float32 sums at the earlier slices' tolerance for
    sums taken in another order, see SUM_RTOL);
  * `run(checked=True)` gives those rows again and the same escalation
    reports as the JAX package's `run(jit=False)`.

The checked runs are compared for the plans tests/test_engine.py names;
the other plans (pins of the same file on capacities and choices) are
compared on `explain()` and `run()`. Columns are 4-byte: the JAX package
runs with x64 off. The JAX package plans its partitions on its 'xla' arm
(a stable sort, the counterpart of the port's CPU arm; its own tests pin it
bit-identical to the Pallas arm, which would run interpreted here). Then the
morsel
driver, the memory budget, the calibration store, and the two failure
paths: a kernel error reaches the caller undegraded, an injected executor
fault degrades once as it does in the JAX package.
"""
import dataclasses
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.engine as JE  # noqa: E402
import repro.kernels.ops as jops  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.engine as TE  # noqa: E402
from repro.engine import membudget as jmb  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs.residuals import ResidualStore as JResiduals  # noqa: E402
from repro.resilience import escalation as jesc  # noqa: E402
from repro.resilience import faults as jfaults  # noqa: E402
from repro_torch.core.planner import PrimitiveProfile  # noqa: E402
from repro_torch.data import relgen as trel  # noqa: E402
from repro_torch.engine import executor as tex  # noqa: E402
from repro_torch.engine import membudget as tmb  # noqa: E402
from repro_torch.engine import physical as TP  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import radix_partition as krp  # noqa: E402
from repro_torch.obs import calibration as tcal  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs.residuals import ResidualStore as TResiduals  # noqa: E402
from repro_torch.resilience import escalation as tesc  # noqa: E402
from repro_torch.resilience import faults as tfaults  # noqa: E402

# one explicit profile for both packages (neither package's defaults)
PROFILE = dict(seq_bw=2.1e11, sort_pass_bw=3.3e10, partition_pass_bw=5.7e10,
               unclustered_penalty=7.5, clustered_penalty=1.4)
# float32 sums taken in another order: the earlier slices' rtol, and an atol
# of 2 x row block x max x eps(float32) for the partition strategy's sums,
# which are differences of block prefix sums (row blocks up to 1024)
SUM_RTOL, SUM_ATOL_PER_MAX = 1e-5, 2 * 1024 * 2.0 ** -23


@pytest.fixture(autouse=True)
def jax_partition_plan_on_its_xla_arm(monkeypatch):
    monkeypatch.setattr(jops, "partition_plan_impl", lambda: "xla")


# ---------------------------------------------------------------------------
# the plans: (numpy tables, query builder over an engine module, optimize kw)
# ---------------------------------------------------------------------------
def _join_tables(n_r, n_s, r_payloads=2, s_payloads=1, seed=0, **kw):
    R, S = trel.generate(trel.JoinWorkload("t", n_r, n_s, r_payloads, s_payloads, seed=seed,
                                           **kw))
    return {"R": R, "S": S}


def _star(n_fact, n_dim, n_joins, seed=0, **kw):
    fact, dims, _, _ = trel.generate_star(n_fact, n_dim, n_joins, seed=seed, **kw)
    return {"fact": fact, **{f"dim{i}": d for i, d in enumerate(dims)}}


def _arange(n, mult=1):
    return (np.arange(n) * mult).astype(np.int32)


def case_single_join(mr):
    return (_join_tables(2000, 4000, match_ratio=mr),
            lambda E: E.scan("R").join(E.scan("S"), key="k"), {})


def case_filter_then_join():
    t = _join_tables(2000, 4000, 1, 1)
    thresh = int(np.median(t["S"]["s1"]))
    return t, lambda E: E.scan("S").filter("s1", "<", thresh).join(E.scan("R"), key="k"), {}


def case_project_order_by():
    rng = np.random.default_rng(5)
    t = {"t": {"k": _arange(1000), "v": rng.permutation(1000).astype(np.int32),
               "w": np.zeros(1000, np.int32)}}
    return t, lambda E: E.scan("t").project("k", "v").order_by("v", limit=10,
                                                               descending=True), {}


def case_order_by_int_min():
    t = {"t": {"k": _arange(4), "v": np.array([5, -2147483648, 17, 3], np.int32)}}
    return t, lambda E: E.scan("t").order_by("v", limit=2, descending=True), {}


def case_auto_mn():
    rng = np.random.default_rng(13)
    keys = np.concatenate([_arange(900), _arange(100)])
    rng.shuffle(keys)
    t = {"R": {"k": keys, "r": _arange(1000)},
         "S": {"k": rng.integers(0, 900, 3000).astype(np.int32), "s": _arange(3000)}}
    return t, lambda E: E.scan("R").join(E.scan("S"), key="k"), {"safety": 2.0}


def case_mn_correlated_multiplicity():
    rng = np.random.default_rng(17)
    bkeys = np.concatenate([_arange(100), np.zeros(400, np.int32)])
    rng.shuffle(bkeys)
    t = {"A": {"k": bkeys, "a": _arange(500)},
         "B": {"k": np.zeros(200, np.int32), "b": _arange(200)}}
    return t, lambda E: E.scan("A").join(E.scan("B"), key="k"), {}


def case_two_joins_groupby_topk():
    t = _star(8000, 2000, 2, seed=3, payloads_per_dim=1)
    return t, lambda E: (E.scan("fact")
                         .join(E.scan("dim0"), left_key="fk0", right_key="k0")
                         .join(E.scan("dim1"), left_key="fk1", right_key="k1")
                         .group_by("fk0", p1_0="sum", p0_0="count")
                         .order_by("p1_0_sum", limit=16, descending=True)), {}


def _fusion_tables(n_r, n_s, n_groups, seed):
    rng = np.random.default_rng(seed)
    R = {"k": rng.permutation(n_r).astype(np.int32),
         "rv": rng.integers(0, 100, n_r).astype(np.int32),
         "r2": rng.integers(0, 100, n_r).astype(np.int32)}
    S = {"k": rng.integers(0, n_r, n_s).astype(np.int32),
         "g": rng.integers(0, n_groups, n_s).astype(np.int32),
         "sv": rng.integers(0, 100, n_s).astype(np.int32),
         "sf": rng.random(n_s).astype(np.float32)}
    return {"R": R, "S": S}


def case_group_join_fusion(n_groups, mult, aggs):
    t = _fusion_tables(2000, 20000, n_groups, 1)
    t["S"]["g"] = (t["S"]["g"].astype(np.int64) * mult % (1 << 30)).astype(np.int32)
    return t, lambda E: E.scan("S").join(E.scan("R"), key="k").group_by("g", **aggs), {}


def case_group_join_on_build_key_alias():
    rng = np.random.default_rng(2)
    t = {"R": {"kr": rng.permutation(1000).astype(np.int32),
               "rv": rng.integers(0, 100, 1000).astype(np.int32)},
         "S": {"k": rng.integers(0, 1000, 15000).astype(np.int32),
               "sv": rng.integers(0, 100, 15000).astype(np.int32),
               "x0": rng.integers(0, 100, 15000).astype(np.int32)}}
    return t, lambda E: (E.scan("S").join(E.scan("R"), left_key="k", right_key="kr")
                         .group_by("kr", sv="sum", rv="count")), {}


def case_group_join_low_match_ratio():
    rng = np.random.default_rng(4)
    t = {"R": {"k": rng.permutation(2000).astype(np.int32),
               "rv": rng.integers(0, 100, 2000).astype(np.int32)},
         "S": {"k": rng.integers(0, 80_000, 20000).astype(np.int32),
               "g": rng.integers(0, 50, 20000).astype(np.int32)}}
    return t, lambda E: E.scan("S").join(E.scan("R"), key="k").group_by("g", rv="sum"), {}


def case_forced(force):
    return (_join_tables(2000, 4000, 2, 2),
            lambda E: E.scan("R").join(E.scan("S"), key="k").group_by("k", s1="sum", r2="max"),
            {"force_join": force})


def case_correlated_filter_and_join():
    rng = np.random.default_rng(29)
    t = {"R": {"k": _arange(1000), "r": _arange(1000, 2)},
         "S": {"k": rng.integers(0, 10_000, 20_000).astype(np.int32), "s": _arange(20_000)}}
    return t, lambda E: E.scan("S").filter("k", "<", 1000).join(E.scan("R"), key="k"), {}


def case_stacked_correlated_filters():
    t = {"t": {"k": _arange(10_000), "v": _arange(10_000)}}
    return t, lambda E: E.scan("t").filter("k", "<", 5000).filter("v", "<", 5000), {}


def case_chained_mn_joins():
    t = {"A": {"k": np.array([0] * 5 + [1, 2, 3, 4, 5], np.int32), "a": _arange(10)},
         "B": {"k": np.array([0] * 4 + [1, 2, 3, 4, 5, 6], np.int32), "b": _arange(10)},
         "C": {"k": np.array([0] * 3 + [1, 2], np.int32), "c": _arange(5)}}
    return t, lambda E: (E.scan("A").join(E.scan("B"), key="k", mode="mn")
                         .filter("a", ">=", 0)
                         .join(E.scan("C"), key="k", mode="mn")), {}


def case_float_group_keys():
    rng = np.random.default_rng(23)
    t = {"t": {"k": (rng.integers(0, 500, 20_000).astype(np.float32) / 50.0),
               "v": np.ones(20_000, np.float32)}}
    return t, lambda E: E.scan("t").group_by("k", v="sum"), {}


def case_key_domain(kind):
    rng = np.random.default_rng(2)
    hi = 256 if kind == "dense" else 1 << 30
    t = {"t": {"k": rng.integers(0, hi, 20_000).astype(np.int32),
               "v": np.ones(20_000, np.float32)}}
    return t, lambda E: E.scan("t").group_by("k", v="sum"), {}


def case_partition_multiplicity_guard():
    rng = np.random.default_rng(11)
    keys = np.concatenate([np.arange(18_000, dtype=np.int64) * 97 % (1 << 30),
                           np.full(2_000, 5, np.int64)]).astype(np.int32)
    rng.shuffle(keys)
    return ({"t": {"k": keys, "v": np.ones(keys.size, np.float32)}},
            lambda E: E.scan("t").group_by("k", v="sum"), {})


def case_partition_block_scaling():
    rng = np.random.default_rng(5)
    base = rng.permutation(3000).astype(np.int64) * 1315423911 % (1 << 30)
    keys = np.repeat(base, 6).astype(np.int32)
    rng.shuffle(keys)
    return ({"t": {"k": keys, "v": np.ones(keys.size, np.float32)}},
            lambda E: E.scan("t").group_by("k", v="sum", k="count"), {})


def case_filter_after_groupby_under_skew():
    keys = np.concatenate([np.zeros(9000, np.int32), np.arange(1, 1000, dtype=np.int32)])
    return ({"t": {"k": keys, "v": np.ones(keys.size, np.float32)}},
            lambda E: E.scan("t").group_by("k", v="sum").filter("k", ">=", 1), {})


def case_alias_origin_uniqueness():
    rng = np.random.default_rng(31)
    t = {"fact": {"fk": rng.integers(0, 100, 1000).astype(np.int32), "f": _arange(1000)},
         "dim": {"kd": _arange(100), "d": _arange(100, 3)},
         "T": {"kt": np.repeat(_arange(100), 2), "t": _arange(200)}}
    return t, lambda E: (E.scan("fact").join(E.scan("dim"), left_key="fk", right_key="kd")
                         .filter("f", ">=", 0)
                         .join(E.scan("T"), left_key="kd", right_key="kt")), {"safety": 2.0}


def case_greedy_join_order():
    t = _star(20_000, 2000, 2, seed=1)
    t["dim0"] = {k: v[:200] for k, v in t["dim0"].items()}
    return t, lambda E: (E.scan("fact")
                         .join(E.scan("dim1"), left_key="fk1", right_key="k1")
                         .join(E.scan("dim0"), left_key="fk0", right_key="k0")), {}


# the plans tests/test_engine.py names, compared plain and checked
CASES = {
    "single_join_mr0.5": lambda: case_single_join(0.5),
    "filter_then_join": case_filter_then_join,
    "project_order_by_limit": case_project_order_by,
    "auto_mn": case_auto_mn,
    "two_joins_groupby_topk": case_two_joins_groupby_topk,
    "group_join_fusion": lambda: case_group_join_fusion(
        20000, 7919, dict(rv="sum", sv="mean", r2="max", sf="sum")),
    "group_join_fusion_dense": lambda: case_group_join_fusion(50, 1, dict(rv="sum")),
    "forced_smj_gfur": lambda: case_forced(("smj", "gfur")),
    "correlated_filter_and_join": case_correlated_filter_and_join,
    "stacked_correlated_filters": case_stacked_correlated_filters,
    "chained_mn_joins": case_chained_mn_joins,
    "float_group_keys": case_float_group_keys,
    "key_domain_dense": lambda: case_key_domain("dense"),
    "key_domain_sparse": lambda: case_key_domain("sparse"),
}
# more pins of the same files, compared plain
MORE_CASES = {
    "single_join_mr1": lambda: case_single_join(1.0),
    "forced_phj_gfur": lambda: case_forced(("phj", "gfur")),
    "order_by_int_min": case_order_by_int_min,
    "mn_correlated_multiplicity": case_mn_correlated_multiplicity,
    "group_join_build_key_alias": case_group_join_on_build_key_alias,
    "group_join_low_match_ratio": case_group_join_low_match_ratio,
    "forced_smj_gftr": lambda: case_forced(("smj", "gftr")),
    "partition_multiplicity_guard": case_partition_multiplicity_guard,
    "partition_block_scaling": case_partition_block_scaling,
    "filter_after_groupby_skew": case_filter_after_groupby_under_skew,
    "alias_origin_uniqueness": case_alias_origin_uniqueness,
    "greedy_join_order": case_greedy_join_order,
}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def catalogs(tables):
    jc = JE.Catalog({n: J.Table({c: jnp.asarray(v) for c, v in t.items()})
                     for n, t in tables.items()})
    tc = TE.Catalog({n: T.table_from_numpy(t, device="cpu") for n, t in tables.items()})
    return jc, tc


def plans(case):
    tables, query, kw = {**CASES, **MORE_CASES}[case]()
    jc, tc = catalogs(tables)
    jplan = JE.optimize(query(JE), jc, profile=J.PrimitiveProfile(**PROFILE),
                        residuals=JResiduals(), **kw)
    tplan = TE.optimize(query(TE), tc, profile=PrimitiveProfile(**PROFILE),
                        residuals=TResiduals(), **kw)
    return jplan, tplan


def _np(col):
    return col.numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


def valid_rows(table, count):
    """{column: valid values}, and the row order that sorts them by every
    column but the float aggregates (which are compared at a tolerance)."""
    n = int(count)
    cols = {c: _np(table[c])[:n] for c in sorted(table.column_names)}
    exact = [c for c, v in cols.items()
             if not (v.dtype.kind == "f" and c.endswith(("_sum", "_mean")))]
    order = np.lexsort([cols[c] for c in reversed(exact)]) if exact else np.arange(n)
    return {c: v[order] for c, v in cols.items()}


def assert_same_rows(jres, tres, what=""):
    (jt, jn), (tt, tn) = jres, tres
    assert int(jn) == int(tn), what
    a, b = valid_rows(jt, jn), valid_rows(tt, tn)
    assert a.keys() == b.keys(), what
    for c in a:
        assert a[c].dtype == b[c].dtype, (what, c, a[c].dtype, b[c].dtype)
        if a[c].dtype.kind == "f" and c.endswith(("_sum", "_mean")):
            atol = SUM_ATOL_PER_MAX * float(np.abs(a[c]).max(initial=0))
            np.testing.assert_allclose(b[c], a[c], rtol=SUM_RTOL, atol=atol,
                                       err_msg=f"{what} {c}")
        else:
            np.testing.assert_array_equal(b[c], a[c], err_msg=f"{what} {c}")


def reports_of(esc, fn):
    since = esc.current_seq()
    out = fn()
    return out, [r.as_dict() for r in esc.recent_reports(since)]


# ---------------------------------------------------------------------------
# the plans, both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES) + sorted(MORE_CASES))
def test_plan_matches_jax(case):
    jplan, tplan = plans(case)
    text = tplan.explain()
    assert text.splitlines() == jplan.explain().splitlines()
    assert tplan.total_cost == pytest.approx(jplan.total_cost, rel=1e-12)
    jres, tres = jplan.run(), tplan.run()
    assert isinstance(tres[1], torch.Tensor) and tres[1].dtype == torch.int32
    assert_same_rows(jres, tres, "run")
    if case not in CASES:
        return
    jchk, jrep = reports_of(jesc, lambda: jplan.run(jit=False))
    tchk, trep = reports_of(tesc, lambda: tplan.run(checked=True))
    assert trep == jrep
    assert_same_rows(jchk, tchk, "checked")
    assert_same_rows(tres, tchk, "checked against plain")


def test_plans_choose_what_the_reference_tests_pin():
    """The choices tests/test_engine.py and tests/test_groupjoin.py pin hold
    in the port under the parity profile."""
    root = plans("auto_mn")[1].root
    assert root.mode == "mn"
    root = plans("key_domain_dense")[1].root
    assert root.strategy == "scatter"
    assert plans("key_domain_sparse")[1].root.strategy == "partition"
    assert plans("float_group_keys")[1].root.strategy != "scatter"
    root = plans("partition_multiplicity_guard")[1].root
    assert root.strategy == "sort" and "multiplicity" in root.rationale
    root = plans("partition_block_scaling")[1].root
    assert root.strategy == "partition" and dict(root.agg_kw)["row_block"] == 128 * 8
    assert isinstance(plans("group_join_fusion")[1].root, TP.PGroupJoin)
    assert plans("group_join_fusion_dense")[1].root.agg_strategy == "scatter"
    assert isinstance(plans("group_join_build_key_alias")[1].root, TP.PGroupJoin)
    assert "fusion rejected" in plans("group_join_low_match_ratio")[1].explain()
    root = plans("forced_smj_gfur")[1].root
    assert isinstance(root, TP.PGroupBy) and root.child.algorithm == "smj"
    root = plans("greedy_join_order")[1].root
    assert root.build.table == "dim1" and root.probe.build.table == "dim0"


def test_run_accepts_same_shape_tables_and_counts():
    """One plan over fresh same-shape tables, and `counts` marking only a
    prefix of a table valid."""
    _, tplan = plans("single_join_mr1")
    R2, S2 = trel.generate(trel.JoinWorkload("t", 2000, 4000, 2, 1, seed=9))
    t2 = {"R": T.table_from_numpy(R2, device="cpu"), "S": T.table_from_numpy(S2, device="cpu")}
    assert int(tplan.run(t2)[1]) == 4000
    assert int(tplan.run(t2, counts={"S": 1000})[1]) == 1000


def test_unported_layers_raise():
    _, tplan = plans("single_join_mr1")
    for call in (lambda: tplan.explain(verify=True), lambda: tplan.explain(actuals=object()),
                 lambda: tplan.run(trace=True), lambda: tex.audit(tplan),
                 lambda: TE.plan_peak_bytes(tplan)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
            call()


@pytest.mark.parametrize("kind", ["tensor", "numpy", "mixed"])
def test_table_from_dict_matches_jax(kind):
    """The same columns as the JAX package's table_from_dict, dtypes kept;
    tensors stay where they are without a device, and numpy columns go to
    the card unless the caller asks for another device."""
    rng = np.random.default_rng(7)
    cols = {"k": rng.integers(0, 99, 50).astype(np.int32),
            "v": rng.normal(size=50).astype(np.float32),
            "w": rng.integers(-5, 5, 50).astype(np.int32)}
    as_tensor = {"tensor": set(cols), "numpy": set(), "mixed": {"k", "w"}}[kind]
    given = {c: torch.from_numpy(v) if c in as_tensor else v for c, v in cols.items()}
    want = J.table_from_dict({c: jnp.asarray(v) for c, v in cols.items()})
    got = T.table_from_dict(given, device="cpu")
    assert got.column_names == want.column_names
    for c in cols:
        assert got[c].device.type == "cpu" and got[c].numpy().dtype == want[c].dtype
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]), err_msg=c)
    if kind == "tensor":
        kept = T.table_from_dict(given)
        assert all(kept[c] is given[c] for c in cols)
    elif torch.cuda.is_available():
        assert T.table_from_dict(given)["v"].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            T.table_from_dict(given)


# ---------------------------------------------------------------------------
# morsels and the memory budget (tests/test_membudget.py's cases that need
# no plan_peak_bytes)
# ---------------------------------------------------------------------------
def _membudget_tables(n_r=400, n_s=1600, seed=3):
    return _join_tables(n_r, n_s, 2, 2, seed=seed)


def test_morsel_axis_and_rows_match_jax():
    jc, tc = catalogs(_membudget_tables())
    for q in (lambda E: E.scan("S").join(E.scan("R"), key="k"),
              lambda E: E.scan("S").group_by("k", s1="sum"),
              lambda E: E.scan("S").order_by("s1", limit=8),
              lambda E: E.scan("S").join(E.scan("R"), key="k").group_by("k", s1="sum")):
        jp = JE.optimize(q(JE), jc, measure_profile=False)
        tp = TE.optimize(q(TE), tc, measure_profile=False)
        assert TP.morsel_axis(tp.root) == JE.morsel_axis(jp.root)
    for rows, f in ((2048, 2), (2048, 32), (2048, 4096), (100, 2), (1, 3)):
        assert TP.morsel_rows(rows, f) == JE.physical.morsel_rows(rows, f)


def test_run_morsels_join_equals_whole_run():
    jc, tc = catalogs(_membudget_tables())
    tplan = TE.optimize(TE.scan("S").join(TE.scan("R"), key="k"), tc, measure_profile=False)
    whole = tplan.run()
    before = tmetrics.counter("engine.morsel_runs").value
    for f in (2, 4, 8):
        assert_same_rows(whole, TE.run_morsels(tplan, factor=f), f"factor {f}")
    assert tmetrics.counter("engine.morsel_runs").value > before
    with pytest.raises(ValueError):
        TE.run_morsels(TE.optimize(TE.scan("S").order_by("s1", limit=8), tc,
                                   measure_profile=False), factor=2)


GB_STRATEGIES = ("sort", "partition", "partition_hash", "scatter", "sort_pallas")


@pytest.mark.parametrize("shape", ["uniform", "one_group", "boundary"])
@pytest.mark.parametrize("n", [65, 150])
def test_run_morsels_group_by_equals_whole_run_every_strategy(shape, n):
    """A morsel-split group-by (partial aggregates re-reduced, mean by sum and
    count) equals the whole run for every strategy (tests/test_membudget.py's
    property at its sizes and key shapes)."""
    rng = np.random.default_rng(n)
    keys = {"one_group": np.full(n, 3, np.int32),
            "boundary": rng.choice(np.array([0, 1, 62, 63], np.int32), n),
            "uniform": rng.integers(0, 64, n).astype(np.int32)}[shape]
    t = {"S": {"k": keys, "v": rng.integers(0, 1000, n).astype(np.int32),
               "w": rng.integers(0, 1000, n).astype(np.int32)}}
    _, tc = catalogs(t)
    tbase = TE.optimize(TE.scan("S").group_by("k", v="sum", w="mean"), tc, measure_profile=False)
    for strategy in GB_STRATEGIES:
        tplan = dataclasses.replace(tbase, root=dataclasses.replace(tbase.root,
                                                                    strategy=strategy),
                                    morsel_plans={})
        whole = tplan.run()
        for factor in (2, 4):
            assert_same_rows(whole, TE.run_morsels(tplan, factor=factor), (strategy, factor))


def test_run_morsels_group_join_equals_whole_run():
    _, tc = catalogs(_fusion_tables(500, 4000, 40, 7))
    q = TE.scan("S").join(TE.scan("R"), key="k").group_by("g", rv="sum", sv="mean", r2="max")
    tplan = TE.optimize(q, tc, profile=PrimitiveProfile(**PROFILE), residuals=TResiduals())
    assert isinstance(tplan.root, TP.PGroupJoin)
    whole = tplan.run()
    for factor in (2, 4):
        assert_same_rows(whole, TE.run_morsels(tplan, factor=factor), factor)


def test_budget_env_validation_matches_jax(monkeypatch):
    for value in ("123456", " 77 ", "lots", "-5", "0", ""):
        monkeypatch.setenv(tmb.ENV_VAR, value)
        try:
            want = jmb.detect_budget_bytes()
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tmb.detect_budget_bytes()
            assert str(got.value) == str(e)
        else:
            assert tmb.detect_budget_bytes() == want
    monkeypatch.delenv(tmb.ENV_VAR)
    assert tmb.detect_budget_bytes("cpu") == tmb.FALLBACK_BUDGET_BYTES
    b = tmb.MemoryBudget(100)
    assert b.try_reserve("a", 60) and not b.try_reserve("b", 50)
    assert b.try_reserve("a", 70) and b.reserved == 70
    assert b.release("a") == 70 and b.release("a") == 0 and b.peak_reserved == 70
    with pytest.raises(ValueError):
        tmb.MemoryBudget(0)


def test_is_memory_error_matches_jax():
    errors = [MemoryError("boom"), tmb.MemoryBudgetExceeded(10, 5),
              RuntimeError("RESOURCE_EXHAUSTED: alloc failed"),
              RuntimeError("Failed to allocate 1GB"), ValueError("bad shape"),
              RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
              tfaults.OOMInjected("executor.run", "forced")]
    for e in errors:
        assert tmb.is_memory_error(e) == jmb.is_memory_error(e), e
    assert tmb.is_memory_error(torch.cuda.OutOfMemoryError("card full"))
    assert not tmb.is_memory_error(_build.KernelError("nvcc failed"))


def test_oom_fault_degrades_onto_the_morsel_rung_as_in_jax():
    tables = _membudget_tables()
    jc, tc = catalogs(tables)
    jplan = JE.optimize(JE.scan("S").join(JE.scan("R"), key="k").group_by("k", s1="sum"), jc,
                        measure_profile=False)
    tplan = TE.optimize(TE.scan("S").join(TE.scan("R"), key="k").group_by("k", s1="sum"), tc,
                        measure_profile=False)
    oracle = tplan.run()
    os.environ[tfaults.ENV_VAR] = "oom:executor.run@0"
    try:
        jres, tres = jplan.run(), tplan.run()
    finally:
        del os.environ[tfaults.ENV_VAR]
    assert_same_rows(oracle, tres)
    assert_same_rows(jres, tres)
    assert tplan.degraded_plan.morsel_factor == jplan.degraded_plan.morsel_factor == 2


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def test_calibrated_profile_round_trips_through_the_store(tmp_path, monkeypatch):
    path = tmp_path / "CALIBRATION.json"
    monkeypatch.setenv("REPRO_CALIBRATION_PATH", str(path))
    fp = tcal.backend_fingerprint("cpu")
    assert "torch" in fp and "jax" not in fp
    n = 1 << 10
    TP._PROFILE_CACHE.pop((fp, n), None)
    prof = TE.calibrated_profile(n, device="cpu")
    store = tcal.CalibrationStore()
    assert dataclasses.astuple(store.get_profile(fp, n)) == dataclasses.astuple(prof)
    # another process: the stored constants, not a new measurement
    TP._PROFILE_CACHE.pop((fp, n))
    assert dataclasses.astuple(TE.calibrated_profile(n, device="cpu")) == \
        dataclasses.astuple(prof)
    # an entry under another fingerprint is never read
    assert store.get_profile("linux-cpu-cpu-jax0.9.0", n) is None
    monkeypatch.setenv("REPRO_CALIBRATION_PATH", str(tmp_path))
    with pytest.raises(ValueError, match="is a directory"):
        tcal.calibration_path()


def test_calibrated_profile_raises_instead_of_falling_back(monkeypatch):
    """A failed measurement reaches the caller: no built-in constants stand
    in for the device's."""
    def broken(*a, **k):
        raise RuntimeError("timer failed")

    monkeypatch.setattr(PrimitiveProfile, "measure", broken)
    monkeypatch.setattr(TP, "_PROFILE_CACHE", {})
    monkeypatch.setattr(tcal.CalibrationStore, "get_profile", lambda *a: None)
    with pytest.raises(RuntimeError, match="timer failed"):
        TE.calibrated_profile(1 << 10, device="cpu")
    _, tc = catalogs(_membudget_tables())
    with pytest.raises(RuntimeError, match="timer failed"):
        TE.optimize(TE.scan("S").join(TE.scan("R"), key="k"), tc, measure_profile=True)


# ---------------------------------------------------------------------------
# failures: a kernel fault surfaces, an executor fault degrades once
# ---------------------------------------------------------------------------
def test_kernel_error_reaches_the_caller_without_degrading(monkeypatch):
    """A kernel that fails inside plan.run(): the join's partition plan
    takes the kernel arm and its per-tile histogram wrapper raises, as a
    failed build does, as a rejection of its inputs does, and as an error
    from the card does. Each reaches the caller as a KernelError naming the
    kernel; re-planning through SMJ would hide the broken kernel behind a
    right answer. The same plan without the fault runs undegraded."""
    _, tplan = plans("single_join_mr1")
    oracle = tplan.run()

    def broken(error):
        def wrapper(digits, num_bins, **kw):
            raise error
        return wrapper

    monkeypatch.setattr(ops, "resolve_impl", lambda impl, *t: "cuda")
    before = tmetrics.counter("resilience.plan_degradations").value
    for error in (_build.KernelError("nvcc failed for block_histograms.cu"),
                  ValueError("num_bins must be in [1, 257], got 300"),
                  RuntimeError("device lost")):
        monkeypatch.setattr(krp, "block_histograms", broken(error))
        with pytest.raises(_build.KernelError, match=re.escape(str(error))) as err:
            tplan.run()
        assert "partition_plan" in str(err.value) or "block_histograms" in str(err.value)
        assert tmetrics.counter("resilience.plan_degradations").value == before
        assert tplan.degraded_plan is None
    monkeypatch.undo()
    assert_same_rows(oracle, tplan.run())
    assert tmetrics.counter("resilience.plan_degradations").value == before
    assert tplan.degraded_plan is None


def test_executor_fault_degrades_once_as_in_jax():
    jplan, tplan = plans("forced_phj_gfur")
    counters = ("resilience.plan_degradations", "resilience.faults_fired")
    before = ({c: jmetrics.counter(c).value for c in counters},
              {c: tmetrics.counter(c).value for c in counters})
    os.environ[jfaults.ENV_VAR] = "raise:executor.run@0"
    try:
        jres, tres = jplan.run(), tplan.run()
    finally:
        del os.environ[jfaults.ENV_VAR]
    assert_same_rows(jres, tres)
    for reg, b in ((jmetrics, before[0]), (tmetrics, before[1])):
        assert {c: reg.counter(c).value - b[c] for c in counters} == dict.fromkeys(counters, 1)
    assert tplan.degraded_plan.degraded.startswith("DEGRADED[FaultInjected")
    assert tplan.degraded_plan.explain().splitlines() == \
        jplan.degraded_plan.explain().splitlines()
    assert tplan.degraded_plan.root.child.algorithm == "smj"
