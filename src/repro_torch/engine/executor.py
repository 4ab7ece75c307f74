"""Physical-plan interpreter over the port's `core` operators: the port's
counterpart of the JAX package's `engine.executor`.

All plan structure (operator order, algorithms, capacities) is host-side
and fixed by the optimizer; the tables flow through the node functions
eagerly, one operator after another, on the device that holds them. There
is nothing to compile: the JAX package traces the whole plan into one XLA
program (`run(jit=True)`), while here `run` calls the same node functions
directly, and `run(checked=True)` is the JAX package's `run(jit=False)`.

Every operator follows the repo's static-shape contract (DESIGN.md §2):
it consumes and produces `(Table-with-capacity, valid_count)` pairs. Rows
at index >= count are padding; before each key-consuming operator the key
column is re-masked to KEY_SENTINEL so padding can never match or form a
group (a scan's whole table is valid, so its keys need no mask). Filters
compact survivors to the front, which preserves the clustering GFTR relies
on (`primitives.compact` is stable).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Mapping

import torch

from ..core import group_aggregate, join, phj_groupjoin
from ..core import primitives as prim
from ..core.groupby import groupby_partition_checked
from ..core.groupjoin import groupjoin_checked
from ..core.hash_join import phj_join_checked
from ..core.table import KEY_SENTINEL, Table, concat_tables
from ..kernels._build import KernelError
from ..obs import metrics
from ..obs import trace as obs_trace
from ..resilience import escalation, faults
from . import membudget
from . import physical as P
from .logical import FILTER_OP_FNS

# Programming errors must surface, not trigger a degraded re-plan: a retried
# plan would either hit the same bug or silently mask it (DESIGN.md §13).
# A failing kernel is one too (kernels.ops raises every failure of a kernel
# arm as KernelError), and so is an error the card reports for any
# operation (torch.AcceleratorError: an earlier launch may have left it):
# the degraded plan would answer through other operators and hide it.
_NON_DEGRADABLE = (TypeError, KeyError, AttributeError, IndexError, KernelError,
                   torch.AcceleratorError)

# Checked mode: capacity-sensitive operators run through their resilience
# ladders (phj_join_checked / groupby_partition_checked / groupjoin_checked)
# instead of the plain drivers, so a plan whose capacities were misestimated
# escalates and records EscalationReports rather than silently truncating.
# `run(checked=True)` sets it; the plain run's protection is the
# degrade-once retry.
_CHECKED = contextvars.ContextVar("repro_torch_executor_checked", default=False)


@contextlib.contextmanager
def checked_mode():
    token = _CHECKED.set(True)
    try:
        yield
    finally:
        _CHECKED.reset(token)


class Materialized:
    """Pseudo plan node wrapping an already-computed ``(Table, count)``
    pair. The per-node tracer (obs.trace) substitutes these for a node's
    children so `execute` runs exactly one operator on its children's
    results. Untraced execution never constructs one."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def children(self):
        return ()


def _count_tensor(count, device) -> torch.Tensor:
    return torch.as_tensor(count, dtype=torch.int32, device=device)


def _valid_mask(table: Table, count) -> torch.Tensor:
    return torch.arange(table.num_rows, dtype=torch.int32, device=table.device) < count


def _mask_key(table: Table, count, key: str) -> Table:
    """Force padding rows' key to KEY_SENTINEL so joins/group-bys drop them.
    A count known on the host to cover the table (a whole scan) leaves the
    table as it is: it has no padding."""
    if isinstance(count, int) and count >= table.num_rows:
        return table
    k = table[key]
    masked = torch.where(_valid_mask(table, count), k,
                         torch.tensor(KEY_SENTINEL, dtype=k.dtype, device=k.device))
    return table.with_columns(**{key: masked})


def execute(node: P.PhysNode, tables: Mapping[str, Table], counts=None):
    """Interpret the plan bottom-up. Returns (Table, valid_count); the count
    is a host int where the plan fixes it (a scan), else a 0-d int32 tensor
    on the tables' device.

    `counts` (optional ``{table_name: valid_count}``) marks only the first
    rows of a table valid (the morsel driver's chunks); without it, a
    scan's whole table is valid.

    Each node's call is an `exec.<op>` span of the recorder (obs.trace)
    while it is on; a node's span holds its children's."""
    if isinstance(node, Materialized):
        return node.value
    with obs_trace.node_span(node) as rec:
        out = _execute_node(node, tables, counts)
        if rec is not None:
            rec.attrs["rows_out"] = out[1]
    return out


def _execute_node(node: P.PhysNode, tables: Mapping[str, Table], counts=None):
    if isinstance(node, P.PScan):
        t = tables[node.table]
        if counts is not None and node.table in counts:
            return t, int(counts[node.table])
        return t, t.num_rows
    if isinstance(node, P.PFilter):
        return _filter(node, tables, counts)
    if isinstance(node, P.PProject):
        t, count = execute(node.child, tables, counts)
        return t.select(node.columns), count
    if isinstance(node, P.PJoin):
        return _join(node, tables, counts)
    if isinstance(node, P.PGroupBy):
        return _group_by(node, tables, counts)
    if isinstance(node, P.PGroupJoin):
        return _group_join(node, tables, counts)
    if isinstance(node, P.POrderByLimit):
        return _order_by(node, tables, counts)
    raise TypeError(f"unknown physical node {type(node).__name__}")


def _filter(node: P.PFilter, tables, counts=None):
    t, count = execute(node.child, tables, counts)
    mask = FILTER_OP_FNS[node.op](t[node.column], node.value) & _valid_mask(t, count)
    names = t.column_names
    outs, new_count = prim.compact(mask, [t[n] for n in names], node.capacity)
    return Table(dict(zip(names, outs))), new_count


def _join(node: P.PJoin, tables, counts=None):
    bt, b_count = execute(node.build, tables, counts)
    pt, p_count = execute(node.probe, tables, counts)
    bt = _mask_key(bt, b_count, node.build_key)
    pt = _mask_key(pt, p_count, node.probe_key)
    # core.join wants one shared key name: align build's key to the probe's
    if node.build_key != node.probe_key:
        bt = bt.rename({node.build_key: node.probe_key})
    if node.algorithm == "phj" and _CHECKED.get():
        out, count = phj_join_checked(
            bt, pt, key=node.probe_key, pattern=node.pattern,
            out_size=node.capacity, mode=node.mode,
        )
    else:
        out, count = join(
            bt, pt, key=node.probe_key, algorithm=node.algorithm,
            pattern=node.pattern, out_size=node.capacity, mode=node.mode,
        )
    if node.build_key != node.probe_key:
        # restore the equal-valued alias column (schema contract)
        out = out.with_columns(**{node.build_key: out[node.probe_key]})
    return out, count


def _group_by(node: P.PGroupBy, tables, counts=None):
    t, count = execute(node.child, tables, counts)
    t = _mask_key(t, count, node.key)
    sel = t.select((node.key,) + tuple(c for c, _ in node.aggs))
    if node.strategy == "partition" and _CHECKED.get():
        return groupby_partition_checked(
            sel, key=node.key, aggs=dict(node.aggs),
            num_groups=node.capacity, **dict(node.agg_kw),
        )
    return group_aggregate(
        sel, key=node.key, aggs=dict(node.aggs), num_groups=node.capacity,
        strategy=node.strategy, **dict(node.agg_kw),
    )


def _group_join(node: P.PGroupJoin, tables, counts=None):
    """Fused join + grouped aggregation: the probe's matches feed the
    accumulator directly (core.groupjoin), so only the key, group-key, and
    aggregate-input columns are ever touched — the join output never
    exists. The accumulator is the node's `agg_strategy`, as in the JAX
    package's engine (`fused=False`: the probe kernel on the card, never
    the probe_agg kernel, which sums in float32 and has no min or max)."""
    bt, b_count = execute(node.build, tables, counts)
    pt, p_count = execute(node.probe, tables, counts)
    bt = _mask_key(bt, b_count, node.build_key)
    pt = _mask_key(pt, p_count, node.probe_key)
    key = node.probe_key
    if node.build_key != key:
        bt = bt.rename({node.build_key: key})
    agg_cols = [c for c, _ in node.aggs]
    b_need = dict.fromkeys([key] + [c for c in agg_cols if c in bt])
    p_need = dict.fromkeys([key, node.probe_group_key]
                           + [c for c in agg_cols if c in pt])
    kw = dict(key=key, group_key=node.probe_group_key, aggs=dict(node.aggs),
              num_groups=node.capacity, agg_strategy=node.agg_strategy,
              agg_kw=dict(node.agg_kw) or None, fused=False)
    driver = groupjoin_checked if _CHECKED.get() else phj_groupjoin
    out, count = driver(bt.select(tuple(b_need)), pt.select(tuple(p_need)), **kw)
    if node.group_key != node.probe_group_key:
        # logical schema names the group column after the GroupBy key (the
        # equal-valued build-key alias); restore it
        out = out.rename({node.probe_group_key: node.group_key})
    return out, count


def _order_by(node: P.POrderByLimit, tables, counts=None):
    t, count = execute(node.child, tables, counts)
    k = t[node.key]
    if node.descending:
        # bitwise complement reverses integer order without the INT_MIN
        # overflow of arithmetic negation; floats negate safely
        k = -k if k.dtype.is_floating_point else ~k
    # validity is the primary sort key, so padding rows land strictly after
    # every valid row no matter what values they carry: a stable sort by the
    # key, then a stable sort of that order by validity (the JAX package's
    # one sort of (invalid, key, iota))
    perm = torch.sort(k, stable=True).indices
    invalid = ~_valid_mask(t, count)
    perm = perm[torch.sort(invalid[perm].to(torch.int8), stable=True).indices]
    # slice the permutation before gathering: top-k needs a capacity-length
    # gather, not a full-table copy of every column
    out = t.take(perm[:node.capacity])
    return out, _count_tensor(count, t.device).clamp(max=node.capacity)


# ---------------------------------------------------------------------------
# contract audit: the run's side of priced-vs-run (DESIGN.md §11)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class NodeAudit:
    """One physical node judged against its priced contract. `own_budget`
    is the node's incremental primitive budget: its subtree's run minus its
    children's subtree runs, so a join is never charged for the sort its
    order-by child pays."""
    node: P.PhysNode
    contract: object  # analysis.OperatorContract
    report: object  # analysis.AuditReport of the node's SUBTREE
    own_budget: object  # analysis.PrimitiveBudget of the node alone
    violations: list


@dataclasses.dataclass
class PlanAudit:
    entries: list  # NodeAudit, preorder from the root
    root_report: object  # whole-plan AuditReport

    @property
    def violations(self) -> list:
        return [v for e in self.entries for v in e.violations]

    def by_node(self) -> dict:
        return {id(e.node): e for e in self.entries}

    def as_dict(self) -> dict:
        return {
            "peak_live_bytes": self.root_report.peak_live_bytes,
            "budget": self.root_report.budget.as_dict(),
            "nodes": [{
                "node": type(e.node).__name__,
                "contract": e.contract.describe(),
                "compiled": e.own_budget.as_dict(),
                "violations": [f"{type(v).__name__}: {v}"
                               for v in e.violations],
            } for e in self.entries],
        }


def _scan_names(node: P.PhysNode) -> set:
    if isinstance(node, P.PScan):
        return {node.table}
    names: set = set()
    for child in node.children():
        names |= _scan_names(child)
    return names


def audit(plan: "P.PhysicalPlan",
          tables: Mapping[str, Table] | None = None) -> PlanAudit:
    """Run every plan subtree once under the auditor
    (`analysis.dispatch_audit`), attribute each node's incremental
    primitive budget, and judge it against the node's declared contract
    (`analysis.contracts.contract_for_node`). A subtree runs on only the
    tables it scans, so the liveness watermark of a fused group-join
    reflects *its* inputs — the checkable form of 'the join output never
    materialized'."""
    from ..analysis import contracts as C
    from ..analysis import dispatch_audit as A

    tables = dict(tables if tables is not None else plan.catalog.tables)
    reports: dict = {}
    entries: list[NodeAudit] = []

    def visit(node: P.PhysNode):
        sub = {n: tables[n] for n in sorted(_scan_names(node))}
        rep = A.audit(lambda tb: execute(node, tb), sub)
        reports[id(node)] = rep
        contract = C.contract_for_node(node)
        entry = NodeAudit(node=node, contract=contract, report=rep,
                          own_budget=None, violations=[])
        entries.append(entry)  # preorder: parent precedes children
        own = rep.budget
        for child in node.children():
            visit(child)
            own = own - reports[id(child)].budget
        entry.own_budget = own
        entry.violations = C.check(contract, rep, own)

    visit(plan.root)
    return PlanAudit(entries=entries, root_report=reports[id(plan.root)])


def plan_peak_bytes(plan: "P.PhysicalPlan", tables: Mapping[str, Table] | None = None,
                    counts=None) -> int:
    """The plan's peak live bytes (the figure the memory governor admits
    against): the auditor's watermark over one run of the plan on the
    tables' device, inputs included — on a card the bytes the run really
    allocated at its worst, each op's workspace included. With `counts`,
    the run the serving layer makes (a valid prefix of each table). A run
    that exhausts the card's memory needs more than the card has: the
    answer is then the card's total memory plus one byte, which no budget
    on that card admits whole."""
    from ..analysis import dispatch_audit as A

    tables = dict(tables if tables is not None else plan.catalog.tables)
    try:
        return int(A.audit(lambda tb: execute(plan.root, tb, counts), tables)
                   .peak_live_bytes)
    except torch.cuda.OutOfMemoryError:
        device = next(iter(tables.values())).device
        return int(torch.cuda.mem_get_info(device)[1]) + 1


def run(plan: "P.PhysicalPlan", tables: Mapping[str, Table] | None = None,
        *, checked: bool = False, trace: bool = False, trace_iters: int = 1,
        trace_warmup: int = 1, counts=None):
    """Execute a PhysicalPlan. `tables` defaults to the catalog's; pass new
    same-shape tables to reuse one plan across datasets. Returns (Table,
    valid_count), the count a 0-d int32 tensor.

    `checked=True` runs the capacity-sensitive nodes through their
    resilience ladders, which record EscalationReports (the JAX package's
    `run(jit=False)`). `counts` ({table_name: valid_count}) marks only the
    first rows of those tables valid.

    With ``trace=True`` the plan runs node by node under the span tracer
    (obs.trace) and returns ``(table, count, QueryTrace)`` — per-node
    device-synced wall times, rows/bytes, and predicted-vs-measured
    residuals. Tracing is strictly opt-in: the untraced path below never
    calls the tracer and allocates no `Span`.

    Graceful degradation (DESIGN.md §13): if the plan raises — an
    `EscalationExhausted` ladder, a fault-injected `raise:executor.run` —
    the executor re-plans ONCE via `physical.degrade_plan` (doubled
    capacities, sort/smj strategies) and reruns. Programming errors and
    kernel failures (`_NON_DEGRADABLE`) and failures of an
    already-degraded plan re-raise untouched.

    The untraced run is an `exec.run` span of the recorder (obs.trace),
    its attribute `degraded` whether a degraded plan answered."""
    if trace:
        if counts is not None or checked:
            raise ValueError("trace=True does not support counts= or checked= (the "
                             "span tracer materializes per-node inputs and makes its "
                             "own checked pass)")
        from ..obs.trace import trace_execute

        return trace_execute(plan, tables, iters=trace_iters, warmup=trace_warmup)
    with obs_trace.span("exec.run", device=False, degraded=bool(plan.degraded)) as rec:
        return _run(plan, tables, checked, counts, rec)


def _run(plan, tables, checked, counts, rec):
    tables = dict(tables if tables is not None else plan.catalog.tables)

    def attempt(p: "P.PhysicalPlan"):
        faults.check_site("executor.run")
        faults.check_oom("executor.run")
        if p.morsel_factor > 1:
            # memory rung (DESIGN.md §15): out-of-core morsel driver
            return run_morsels(p, tables, counts=counts, checked=checked)
        with checked_mode() if checked else contextlib.nullcontext():
            out, count = execute(p.root, tables, counts)
        return out, _count_tensor(count, out.device)

    try:
        return attempt(plan)
    except _NON_DEGRADABLE:
        raise
    except Exception as e:  # noqa: BLE001 — everything else degrades once
        if plan.degraded:
            raise
        reason = f"{type(e).__name__}: {e}"[:120]
        if plan.degraded_plan is None:
            # allocation failures route onto the MEMORY rung when the plan
            # is splittable — a smaller working set, never the default
            # rung's doubled capacities (DESIGN.md §15)
            if (membudget.is_memory_error(e)
                    and P.morsel_axis(plan.root) is not None):
                plan.degraded_plan = P.degrade_plan(plan, reason, memory=True)
            else:
                plan.degraded_plan = P.degrade_plan(plan, reason)
        metrics.counter("resilience.plan_degradations").inc()
        escalation.record_degradation("executor", reason)
        if rec is not None:
            rec.attrs["degraded"] = True
        return attempt(plan.degraded_plan)


# ---------------------------------------------------------------------------
# morsel-driven out-of-core execution (DESIGN.md §15)
# ---------------------------------------------------------------------------
def run_morsels(plan: "P.PhysicalPlan",
                tables: Mapping[str, Table] | None = None, *,
                counts=None, factor: int | None = None, checked: bool = False):
    """Execute `plan` out-of-core: split the morsel axis (the probe spine's
    base scan, `physical.morsel_axis`) into `factor` equal chunks, run the
    capacity-scaled per-morsel clone (`physical.morsel_plan`) over each
    chunk — chunk validity rides in as a count, so every morsel runs the
    same plan — and recombine host-side: concat for row-shaped roots, a
    partial-aggregate merge for group roots (sum/count/min/max re-reduce;
    mean = merged sum / merged count, the exact `_finalize` expression).
    Returns (Table, valid_count) shaped exactly like whole-plan `run`."""
    factor = int(factor if factor is not None else plan.morsel_factor)
    if factor < 2:
        raise ValueError(f"morsel factor must be >= 2, got {factor}")
    axis = P.morsel_axis(plan.root)
    if axis is None:
        raise ValueError("plan has no morsel axis (not splittable)")
    tables = dict(tables if tables is not None else plan.catalog.tables)
    axis_table = tables[axis]
    rows = axis_table.num_rows
    total = int(counts[axis]) if counts is not None and axis in counts else rows
    mp = P.morsel_plan(plan, factor, rows=rows)
    m = P.morsel_rows(rows, factor)
    padded = axis_table.pad_to(m * factor)
    base_counts = dict(counts) if counts is not None else {}
    parts = []
    for i in range(factor):
        cnt = min(max(total - i * m, 0), m)
        if cnt == 0 and i > 0:
            continue  # past the valid tail; morsel 0 always runs so an
            # empty input still yields a well-formed empty result
        chunk = Table({n: v[i * m:(i + 1) * m]
                       for n, v in padded.columns.items()})
        mtables = dict(tables)
        mtables[axis] = chunk
        mcounts = dict(base_counts)
        mcounts[axis] = cnt
        metrics.counter("engine.morsel_runs").inc()
        with obs_trace.span("exec.morsel", device=False, index=i, rows=cnt):
            parts.append(run(mp, mtables, checked=checked, counts=mcounts))
    return _recombine(plan.root, parts)


def _recombine(root: P.PhysNode, parts: list):
    """Merge per-morsel results into the whole-plan (Table, count)."""
    sliced = [(t.head(int(c)), int(c)) for t, c in parts]
    if isinstance(root, (P.PGroupBy, P.PGroupJoin)):
        return _merge_partials(root, sliced)
    # row-shaped root (join/filter/project/scan spine): morsels partition
    # the probe, so valid rows concatenate — total is the whole-plan count
    # and fits the root capacity whenever the whole plan would have
    total = sum(c for _, c in sliced)
    if total > root.capacity:
        raise ValueError(
            f"morsel recombine overflow: {total} rows exceed the root "
            f"capacity {root.capacity}")
    cat = concat_tables([t for t, _ in sliced])
    return cat.pad_to(root.capacity), _count_tensor(total, cat.device)


def _merge_partials(root, sliced):
    """Re-reduce per-morsel partial aggregates (the `partial_agg_plan`
    rewrite) into final aggregates, bit-identical to the whole-plan
    result: integer sums/counts/min/max are associative, and mean divides
    the merged sum by the merged count with the exact `_finalize`
    expression (`acc / max(count,1).to(acc.dtype)`)."""
    key = root.key if isinstance(root, P.PGroupBy) else root.group_key
    partial, count_col = P.partial_agg_plan(root)
    combine = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}
    cat = concat_tables([t for t, _ in sliced])
    merged, count = group_aggregate(
        cat, key=key,
        aggs={f"{c}_{pop}": combine[pop] for c, pop in partial},
        num_groups=root.capacity, strategy="sort",
    )

    def final(c, op):
        if op == "mean":
            s = merged[f"{c}_sum_sum"]
            n = merged[f"{count_col}_count_sum"]
            return s / n.clamp(min=1).to(s.dtype)
        pop = dict(partial)[c]
        return merged[f"{c}_{pop}_{combine[pop]}"]

    out = {key: merged[key]}
    out.update({f"{c}_{op}": final(c, op) for c, op in root.aggs})
    return Table(out).select(root.columns), count
