"""repro_torch.analysis — the run auditor and the operator contracts: the
port's counterpart of the JAX package's `analysis`.

`dispatch_audit` watches one eager run (a `TorchDispatchMode`) and counts
its plan-shaping ops, its kernel calls and its peak of live bytes;
`contracts` holds each operator's priced budget and the typed
`ContractViolation` hierarchy; `kernel_lint` checks the launches of the
Hopper kernels that `kernels.common.register` declares (fit, the
determinism rule, scatter discipline).
`python -m repro_torch.analysis` sweeps the operators, the kernels and the
engine's plans and writes ANALYSIS.json; it exits non-zero on any
violation."""
from .contracts import (ContractViolation, DtypePromotionViolation, FloatScatterViolation,
                        GridAliasViolation, MaterializationViolation, OperatorContract,
                        SortBudgetViolation, VmemBudgetViolation, check, contract_for_node,
                        enforce, groupby_contract, groupjoin_contract, join_contract,
                        orderby_contract, partition_plan_contract, passthrough_contract)
from .dispatch_audit import AuditReport, PrimitiveBudget, audit, audit_fn, budget_of, count_sorts
from .kernel_lint import KernelLintReport, lint_launch, lint_production_kernels, lint_source

__all__ = [
    "AuditReport", "PrimitiveBudget", "audit", "audit_fn", "budget_of", "count_sorts",
    "ContractViolation", "SortBudgetViolation", "MaterializationViolation",
    "DtypePromotionViolation", "FloatScatterViolation",
    "VmemBudgetViolation", "GridAliasViolation",
    "OperatorContract", "check", "enforce", "contract_for_node",
    "join_contract", "groupby_contract", "groupjoin_contract",
    "orderby_contract", "passthrough_contract", "partition_plan_contract",
    "KernelLintReport", "lint_launch", "lint_source", "lint_production_kernels",
]
