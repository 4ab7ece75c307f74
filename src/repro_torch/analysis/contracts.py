"""Operator contracts: what each physical operator promises a run will (not)
do, in the same primitive vocabulary the cost model prices. The port's
counterpart of the JAX package's `analysis.contracts`.

A contract is the *priced* side of priced-vs-run (DESIGN.md §11): the
planner charged PHJ zero sort passes, so a PHJ run that sorts is a plan the
model mis-priced — the chooser's Figure-18 decisions stop being
trustworthy the moment that drifts. `check()` compares an `AuditReport`
(the run's side, from `dispatch_audit`) against a contract and returns
typed violations; `enforce()` raises the first one.

The materialization contract is expressed through the liveness watermark:
a fused group-join's peak live bytes must stay a small multiple of its
input+output bytes, *independent of the join-output capacity* — the
checkable form of "the joined row never exists".

Where the port's operators differ from the JAX package's by design, their
contracts carry the port's own numbers (each pinned in ROADMAP Queue 3):
PHJ's m:n match index is one stable sort (`hash_join.match_index`), the
partition_hash group-by sorts each 256-row tile and then the combine, and
a group-by's or group-join's float sums are run sums, never float
scatter-adds (`ops.RunSums`). The kernel lint (VMEM budgets, grid
aliasing) has no counterpart yet, and neither have its two violations.
"""
from __future__ import annotations

import dataclasses

from .dispatch_audit import AuditReport, PrimitiveBudget


class ContractViolation(Exception):
    """A run diverged from the contract the cost model priced."""


class SortBudgetViolation(ContractViolation):
    """More sorts than the priced plan allows (e.g. a 'sort-free' partition
    pipeline that ran through a sort)."""


class MaterializationViolation(ContractViolation):
    """Peak live bytes exceed the contract bound — something the fusion
    promised never to materialize got materialized."""


class DtypePromotionViolation(ContractViolation):
    """An op silently widened to a 64-bit dtype none of its inputs had."""


class FloatScatterViolation(ContractViolation):
    """Float scatter-add outside the approved accumulators (order-dependent
    under the card's atomics)."""


@dataclasses.dataclass(frozen=True)
class OperatorContract:
    """Budget bounds one operator promises. `None` means unconstrained."""
    name: str
    max_sorts: int | None = None
    max_float_scatter_adds: int | None = None
    forbid_64bit_promotion: bool = True
    # peak_live_bytes <= live_multiplier * (arg_bytes + out_bytes) + slack
    live_multiplier: float | None = None
    live_slack_bytes: int = 1 << 20

    def describe(self) -> str:
        parts = []
        if self.max_sorts is not None:
            parts.append(f"sorts<={self.max_sorts}")
        if self.max_float_scatter_adds is not None:
            parts.append(f"f32-scatter-adds<={self.max_float_scatter_adds}")
        if self.live_multiplier is not None:
            parts.append(f"peak-live<={self.live_multiplier:g}x(in+out)")
        if self.forbid_64bit_promotion:
            parts.append("no-64bit-promotion")
        return " ".join(parts) if parts else "unconstrained"


def check(contract: OperatorContract, report: AuditReport,
          budget: PrimitiveBudget | None = None) -> list[ContractViolation]:
    """Judge a run against its contract. `budget` overrides the report's
    (the executor passes per-node incremental budgets so a parent isn't
    charged for its children's primitives)."""
    budget = report.budget if budget is None else budget
    out: list[ContractViolation] = []
    if contract.max_sorts is not None and budget.sorts > contract.max_sorts:
        out.append(SortBudgetViolation(
            f"{contract.name}: the run sorted {budget.sorts} time(s); the priced "
            f"contract allows {contract.max_sorts}"))
    if (contract.max_float_scatter_adds is not None
            and budget.float_scatter_adds > contract.max_float_scatter_adds):
        out.append(FloatScatterViolation(
            f"{contract.name}: {budget.float_scatter_adds} float "
            f"scatter-add(s) vs allowed {contract.max_float_scatter_adds} "
            f"(approved accumulators only)"))
    if contract.forbid_64bit_promotion and report.promotions:
        out.append(DtypePromotionViolation(
            f"{contract.name}: silent 64-bit promotion at "
            f"{'; '.join(report.promotions[:3])}"))
    if contract.live_multiplier is not None:
        bound = (contract.live_multiplier * (report.arg_bytes + report.out_bytes)
                 + contract.live_slack_bytes)
        if report.peak_live_bytes > bound:
            out.append(MaterializationViolation(
                f"{contract.name}: peak live bytes "
                f"{report.peak_live_bytes} (at {report.peak_live_at}) "
                f"exceed {bound:.0f} = {contract.live_multiplier:g}x"
                f"(in={report.arg_bytes} + out={report.out_bytes}) + "
                f"{contract.live_slack_bytes} slack — a promised-away "
                f"materialization happened"))
    return out


def enforce(contract: OperatorContract, report: AuditReport,
            budget: PrimitiveBudget | None = None) -> None:
    violations = check(contract, report, budget)
    if violations:
        raise violations[0]


# ---------------------------------------------------------------------------
# per-operator contract registry (the priced budgets)
# ---------------------------------------------------------------------------
# Sort budget per group-by strategy. 'sort' pays exactly one sort;
# 'partition' one block-local sort after the sort-free radix planner;
# 'partition_hash' one sort of its 256-row tiles and one of the combine;
# 'scatter' one sort by key, which every float sum shares (the JAX package
# scatters them; here they are run sums); 'sort_pallas' one plan sort (its
# segmented sums need no combine sort: the kernel writes its partials in
# key order).
GROUPBY_SORTS = {"sort": 1, "partition": 1, "partition_hash": 2, "scatter": 1,
                 "sort_pallas": 1}


def groupby_contract(strategy: str, n_aggs: int) -> OperatorContract:
    # float sums are run sums (ops.RunSums): never a float scatter-add
    return OperatorContract(name=f"groupby[{strategy}]",
                            max_sorts=GROUPBY_SORTS.get(strategy, 2),
                            max_float_scatter_adds=0)


# PHJ pk_fk is sort-free; its m:n match index is one stable sort of the
# rows that can match (hash_join.match_index); SMJ sorts both sides.
JOIN_SORTS = {("phj", "pk_fk"): 0, ("phj", "mn"): 1, ("nphj", "pk_fk"): 0,
              ("smj", "pk_fk"): 2, ("smj", "mn"): 2}


def join_contract(algorithm: str, pattern: str = "gftr",
                  mode: str = "pk_fk") -> OperatorContract:
    # joins move payloads with gathers/plain scatters; a float scatter-add
    # in a join is always a drifted accumulator
    return OperatorContract(name=f"join[{algorithm}/{pattern}]",
                            max_sorts=JOIN_SORTS.get((algorithm, mode), 0),
                            max_float_scatter_adds=0)


GROUPJOIN_LIVE_MULTIPLIER = 512.0
GROUPJOIN_LIVE_SLACK = 8 << 20


def groupjoin_contract(agg_strategy: str, n_aggs: int,
                       live_multiplier: float | None = GROUPJOIN_LIVE_MULTIPLIER,
                       ) -> OperatorContract:
    """Fused probe+accumulate: PHJ partitioning is sort-free, so the only
    sorts are the accumulator's own; and the join output must never
    materialize — peak live bytes stay bounded by the inputs, independent
    of the join cardinality (512x + 8 MiB slack, the JAX package's bound:
    any plan that materializes a join output at fanout beyond ~512x its
    input blows through it, while the fused path stays constant)."""
    base = groupby_contract(agg_strategy, n_aggs)
    return OperatorContract(name=f"groupjoin[phj+{agg_strategy}]",
                            max_sorts=base.max_sorts,
                            max_float_scatter_adds=base.max_float_scatter_adds,
                            live_multiplier=live_multiplier,
                            live_slack_bytes=GROUPJOIN_LIVE_SLACK)


def orderby_contract() -> OperatorContract:
    # two stable sorts: by the key, then that order by validity (the JAX
    # package's one sort of (invalid, key, iota))
    return OperatorContract(name="order_by_limit", max_sorts=2,
                            max_float_scatter_adds=0)


def passthrough_contract(name: str) -> OperatorContract:
    """Scan/filter/project: no sorts, no float accumulation."""
    return OperatorContract(name=name, max_sorts=0, max_float_scatter_adds=0)


def partition_plan_contract() -> OperatorContract:
    """The radix partition planner: one kernel call whatever its arm, and
    nothing sorted around it."""
    return OperatorContract(name="partition_plan", max_sorts=0,
                            max_float_scatter_adds=0)


def contract_for_node(node) -> OperatorContract:
    """Map an engine physical node to its priced contract."""
    from ..engine import physical as P
    if isinstance(node, P.PJoin):
        return join_contract(node.algorithm, node.pattern, node.mode)
    if isinstance(node, P.PGroupBy):
        return groupby_contract(node.strategy, len(node.aggs))
    if isinstance(node, P.PGroupJoin):
        return groupjoin_contract(node.agg_strategy, len(node.aggs))
    if isinstance(node, P.POrderByLimit):
        return orderby_contract()
    if isinstance(node, P.PScan):
        return passthrough_contract("scan")
    if isinstance(node, P.PFilter):
        return passthrough_contract("filter")
    if isinstance(node, P.PProject):
        return passthrough_contract("project")
    return OperatorContract(name=type(node).__name__)
