"""The port's run auditor and contracts (`repro_torch.analysis`), the
counterparts of tests/test_analysis.py's budget, liveness and contract
tests, on the CPU: op budgets, the live-bytes watermark (a large
intermediate seen, dead values dropped, views and in-place ops not counted
twice, inputs live from the start), the 64-bit widening rule, and the
negative space — small deliberately-violating runs must each trip their
`ContractViolation` subclass, and `explain(verify=True)` must catch an
injected priced-vs-run divergence end to end. Then the kernel-call marks:
a plan's budget is the same on the card's arms (rehearsed here: every
kernel wrapper takes its plain version for CPU tensors) as on the CPU's,
and without the marks it is not. The JAX package's own versions of these
tests fail on JAX 0.9 (`jax.core.Literal` is gone); the assertions are
held here on the port."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import (DtypePromotionViolation, FloatScatterViolation,  # noqa: E402
                                  MaterializationViolation, OperatorContract, PrimitiveBudget,
                                  SortBudgetViolation, audit, budget_of, count_sorts)
from repro_torch.analysis import dispatch_audit as A  # noqa: E402
from repro_torch.core import table_from_numpy  # noqa: E402
from repro_torch.core.planner import PrimitiveProfile  # noqa: E402
from repro_torch.engine import Catalog, executor, optimize, scan  # noqa: E402
from repro_torch.kernels import common, ops  # noqa: E402

PROFILE = dict(seq_bw=2.1e11, sort_pass_bw=3.3e10, partition_pass_bw=5.7e10,
               unclustered_penalty=7.5, clustered_penalty=1.4)


# ---------------------------------------------------------------------------
# budget counting
# ---------------------------------------------------------------------------
def test_budget_counts_primitives():
    def fn(x):
        srt = torch.sort(x).values
        idx = torch.argsort(x)  # a sort as well
        gath = srt[idx]
        scat = torch.zeros_like(x)
        scat[idx] = gath
        sadd = torch.zeros_like(x).index_put_((idx,), gath, accumulate=True)
        return scat + sadd

    b = budget_of(fn, torch.arange(16.0))
    assert b.sorts == 2
    assert b.gathers == 1
    assert b.scatters == 1
    assert b.scatter_adds == 1
    assert b.float_scatter_adds == 1  # float operand -> flagged as float


def test_budget_counts_each_op_that_ran():
    """An eager run has no static program: a sort in a loop counts once per
    iteration that ran (the JAX package counts a scan body once)."""
    def fn(x):
        for _ in range(3):
            x = torch.sort(x).values
        return x

    assert count_sorts(fn, torch.arange(8.0)) == 3


def test_budget_add_sub_compose():
    a = PrimitiveBudget(sorts=2, gathers=3)
    b = PrimitiveBudget(sorts=1, gathers=1, scatters=5)
    assert (a + b).sorts == 3 and (a + b).scatters == 5
    assert (a - b).sorts == 1 and (a - b).gathers == 2
    assert PrimitiveBudget(kernel_calls=2).describe() == "kernel_calls=2"


def test_kernel_call_counted_and_its_plain_version_not():
    """ops.histogram's plain version is a bincount (a scatter-add); inside
    the mark it counts as one kernel call and nothing else."""
    digits = torch.arange(1024, dtype=torch.int32) % 16
    b = budget_of(functools.partial(ops.histogram, num_bins=16), digits)
    assert b == PrimitiveBudget(kernel_calls=1)
    assert budget_of(lambda d: torch.bincount(d), digits).scatter_adds == 1


# ---------------------------------------------------------------------------
# liveness watermark
# ---------------------------------------------------------------------------
def test_liveness_peak_sees_large_intermediate():
    def fn(x):
        big = x.repeat(4096)  # 8 * 4096 * 4 B = 128 KiB intermediate
        return big.sum()

    rep = audit(fn, torch.arange(8, dtype=torch.float32))
    assert rep.peak_live_bytes >= 8 * 4096 * 4
    assert rep.out_bytes == 4  # scalar out
    assert rep.arg_bytes == 32


def test_liveness_peak_drops_dead_values():
    def fn(x):
        for _ in range(8):
            x = x * 2  # the previous x dies with each step
        return x.sum()

    rep = audit(fn, torch.arange(1024, dtype=torch.float32))
    # never more than ~3 arrays of x's size live at once
    assert rep.peak_live_bytes <= 3 * 1024 * 4 + 64


def test_views_and_in_place_ops_add_no_bytes():
    def fn(x):
        y = x.clone()  # one new storage
        y.add_(1)  # in place
        v = y[10:20].view(2, 5)  # views of it
        return v

    rep = audit(fn, torch.zeros(1024, dtype=torch.float32))
    assert rep.arg_bytes == 4096
    assert rep.peak_live_bytes == 2 * 4096
    assert rep.out_bytes == 4096  # the view holds its whole storage


def test_inputs_live_from_the_start():
    t = table_from_numpy({"a": np.zeros(100, np.int32), "b": np.zeros(100, np.int64)}, "cpu")
    rep = audit(lambda tb: tb["a"][:10], t)
    assert rep.arg_bytes == 1200 and rep.peak_live_at == "<args>"


# ---------------------------------------------------------------------------
# negative space: each violation class fires on its minimal trigger
# ---------------------------------------------------------------------------
def test_sneaky_sort_trips_sort_budget():
    def sneaky(x):
        return x[torch.argsort(x)]  # a hidden sort

    rep = audit(sneaky, torch.arange(32, dtype=torch.int32))
    contract = analysis.join_contract("phj")  # priced: zero sorts
    with pytest.raises(SortBudgetViolation):
        analysis.enforce(contract, rep)


def test_f64_promotion_trips_dtype_contract():
    def promotes(x):
        return x.to(torch.float64) * 2.0  # silent widening

    rep = audit(promotes, torch.arange(8, dtype=torch.float32))
    assert rep.promotions
    with pytest.raises(DtypePromotionViolation):
        analysis.enforce(OperatorContract(name="int32-pipeline"), rep)
    # deliberate 64-bit inputs stay legal (the port's int64 payloads)
    assert not audit(lambda x: x * 2, torch.arange(8, dtype=torch.int64)).promotions
    # a default-int64 arange is a silent widening; a factory given its dtype
    # (an int64 accumulator for int64 payloads) is a choice
    x32 = torch.arange(8, dtype=torch.int32)
    assert audit(lambda x: torch.arange(8) + x, x32).promotions
    assert audit(lambda x: torch.full((8,), 7) + x, x32).promotions
    assert not audit(lambda x: torch.zeros(8, dtype=torch.int64) + x, x32).promotions
    assert not audit(lambda v: torch.where(v > 1, v, 0), torch.arange(8)).promotions


def test_index_outputs_and_marked_widenings_are_not_promotions():
    """The port's difference from the JAX package's rule: torch's index
    outputs (a sort's indices, nonzero, bincount) are int64 with no 32-bit
    form, and the hash's uint32 arithmetic is done in int64 by design
    (dispatch_audit.DELIBERATE_WIDENINGS); neither is flagged."""
    from repro_torch.core.hash_join import hash32

    x = torch.arange(64, dtype=torch.int32)
    assert not audit(lambda x: torch.sort(x).indices, x).promotions
    assert not audit(lambda x: torch.nonzero(x > 3), x).promotions
    assert not audit(lambda x: torch.bincount(x), x).promotions
    assert not audit(hash32, x).promotions
    assert audit(lambda x: x.to(torch.int64) & 0xFFFFFFFF, x).promotions


def test_float_scatter_add_trips_the_float_scatter_contract():
    def accumulates(v):
        return torch.zeros(8, dtype=torch.float32).index_add_(0, v.to(torch.int32) % 8, v)

    rep = audit(accumulates, torch.arange(32, dtype=torch.float32))
    assert rep.budget.float_scatter_adds == 1
    with pytest.raises(FloatScatterViolation):
        analysis.enforce(analysis.join_contract("phj"), rep)


def test_materialization_bound_trips_on_fat_residency():
    def materializes(x):
        fat = x.repeat(8192)  # 32 MiB live off a 4 KiB input
        return fat.sum()

    rep = audit(materializes, torch.arange(1024, dtype=torch.float32))
    contract = OperatorContract(name="fused", live_multiplier=4.0, live_slack_bytes=1 << 20)
    with pytest.raises(MaterializationViolation):
        analysis.enforce(contract, rep)


def test_port_contract_numbers():
    """The port's own numbers where its operators differ by design (ROADMAP
    Queue 3): m:n PHJ sorts once, partition_hash twice, scatter once (its
    float sums are run sums), order-by twice; no float scatter-add."""
    assert analysis.join_contract("phj", "gftr", "mn").max_sorts == 1
    assert analysis.join_contract("phj").max_sorts == 0
    assert analysis.join_contract("smj").max_sorts == 2
    assert analysis.groupby_contract("partition_hash", 1).max_sorts == 2
    assert analysis.groupby_contract("scatter", 1).max_sorts == 1
    assert analysis.groupby_contract("sort_pallas", 3).max_sorts == 1
    assert analysis.orderby_contract().max_sorts == 2
    assert analysis.groupjoin_contract("sort", 2).max_float_scatter_adds == 0


# ---------------------------------------------------------------------------
# the engine: audit, plan_peak_bytes, explain(verify=True)
# ---------------------------------------------------------------------------
def _plan(force=("phj", "gftr"), seed=0):
    rng = np.random.default_rng(seed)
    n_r, n_s = 256, 2048
    R = {"k": rng.permutation(n_r).astype(np.int32),
         "rv": rng.integers(0, 100, n_r).astype(np.int32)}
    S = {"k": rng.integers(0, n_r, n_s).astype(np.int32),
         "g": rng.integers(0, 32, n_s).astype(np.int32),
         "sv": rng.integers(0, 100, n_s).astype(np.int32)}
    cat = Catalog({"R": table_from_numpy(R, "cpu"), "S": table_from_numpy(S, "cpu")})
    q = scan("S").join(scan("R"), key="k").group_by("g", rv="sum", sv="mean")
    return optimize(q, cat, profile=PrimitiveProfile(**PROFILE), force_join=force)


def test_explain_verify_renders_priced_vs_run():
    plan = _plan()
    text = plan.explain(verify=True)
    assert "priced[" in text and "compiled[" in text
    assert "peak-live=" in text and "audited-peak=" in text
    assert "DIVERGED" not in text
    assert text.count("priced[") == 4  # one per node
    # plain explain stays cheap and unannotated
    assert "priced[" not in plan.explain()


def test_explain_verify_raises_on_injected_violation(monkeypatch):
    """Plan the partitions through an unmarked stable sort under a plan the
    model priced as sort-free: the run now sorts where the contract forbids
    it, and verify must catch the divergence."""
    from repro_torch.core import primitives as prim

    plan = _plan()

    def sorting_plan(digits, num_partitions, *, carry=(), impl=None):
        perm = torch.sort(digits, stable=True).indices.to(torch.int32)
        sizes = torch.bincount(digits, minlength=num_partitions).to(torch.int32)
        offsets = torch.cumsum(sizes, 0, dtype=torch.int32) - sizes
        return perm, tuple(c[perm] for c in carry), offsets, sizes

    monkeypatch.setattr(prim.kops, "partition_plan", sorting_plan)
    with pytest.raises(SortBudgetViolation, match="join"):
        plan.explain(verify=True)


def test_executor_audit_attributes_node_budgets():
    plan = _plan()
    plan_audit = executor.audit(plan)
    assert not plan_audit.violations
    kinds = {type(e.node).__name__: e for e in plan_audit.entries}
    assert "PJoin" in kinds and "PGroupBy" in kinds
    # the join's own budget is sort-free and calls the kernels (partition
    # plans, probe, gathers); the group-by's own budget excludes the join's
    assert kinds["PJoin"].own_budget.sorts == 0
    assert kinds["PJoin"].own_budget.kernel_calls >= 3
    assert kinds["PGroupBy"].own_budget.gathers <= kinds["PGroupBy"].report.budget.gathers
    assert kinds["PScan"].own_budget == PrimitiveBudget()
    d = plan_audit.as_dict()
    assert d["nodes"] and d["budget"]["sorts"] == 0


def test_plan_peak_bytes_is_the_audits_watermark():
    plan = _plan(force=None)
    tables = dict(plan.catalog.tables)
    peak = executor.plan_peak_bytes(plan)
    root = executor.audit(plan).root_report
    assert peak == root.peak_live_bytes > sum(t.nbytes() for t in tables.values())
    # a valid prefix (the serving layer's counts): the run masks the keys
    # past it, one more key column live
    counts = {"R": 256, "S": 512}
    assert peak < executor.plan_peak_bytes(plan, tables, counts=counts) < 2 * peak


def test_plan_peak_bytes_answers_oom_with_more_than_the_card(monkeypatch):
    plan = _plan()

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(A, "audit", oom)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (0, 1000))
    assert executor.plan_peak_bytes(plan) == 1001


@pytest.mark.parametrize("force", [("phj", "gftr"), ("smj", "gftr"), None])
def test_plan_budget_is_the_same_on_the_card_arms(monkeypatch, force):
    """Every kernel wrapper takes its plain version for CPU tensors, so the
    card's code path (impl 'cuda' wherever the device would choose it) runs
    here. With the kernel-call marks, the plan's budget equals the CPU
    arms' budget; without them, the two arms' ops differ (the CPU's
    partition plan is one stable sort, the card's is rank passes, whose
    plain versions run here)."""
    plan = _plan(force=force)
    cpu = executor.audit(plan).root_report.budget
    monkeypatch.setattr(ops, "resolve_impl",
                        lambda impl, *t: "cuda" if impl is None else impl)
    card = executor.audit(plan).root_report.budget
    assert card == cpu
    if force != ("phj", "gftr"):
        return
    monkeypatch.setattr(common, "KERNEL_CALL_OBSERVERS", _Deaf())
    unmarked_card = executor.audit(plan).root_report.budget
    monkeypatch.undo()
    monkeypatch.setattr(common, "KERNEL_CALL_OBSERVERS", _Deaf())
    unmarked_cpu = executor.audit(plan).root_report.budget
    assert unmarked_cpu != unmarked_card
    assert unmarked_card.kernel_calls == unmarked_cpu.kernel_calls == 0


class _Deaf(list):
    """An observer list the auditor registers in but the marks never see."""

    def __bool__(self):
        return False

    def __iter__(self):
        return iter(())


def test_analysis_cli_sweep_is_clean_on_the_cpu(tmp_path, monkeypatch):
    import json

    from repro_torch.analysis.__main__ import main

    monkeypatch.chdir(tmp_path)
    assert main(["--device", "cpu", "--out", "A.json"]) == 0
    rep = json.loads((tmp_path / "A.json").read_text())
    assert rep["summary"]["violations"] == 0
    assert rep["operators"]["join/phj/gftr/pk_fk"]["budget"]["sorts"] == 0
    assert rep["operators"]["primitives/partition_plan"]["budget"] == dict(
        PrimitiveBudget(kernel_calls=1).as_dict())
    assert set(rep["engine"]) == {"engine/join_groupby", "engine/forced_unfused",
                                  "engine/filtered_topk", "engine/q18_int64"}


def test_analysis_cli_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    from repro_torch.analysis.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert main([]) == 1
    assert not (tmp_path / "ANALYSIS.json").exists()
