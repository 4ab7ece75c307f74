"""repro_torch.analysis — the run auditor and the operator contracts: the
port's counterpart of the JAX package's `analysis`.

`dispatch_audit` watches one eager run (a `TorchDispatchMode`) and counts
its plan-shaping ops, its kernel calls and its peak of live bytes;
`contracts` holds each operator's priced budget and the typed
`ContractViolation` hierarchy. `python -m repro_torch.analysis` sweeps the
operators and the engine's plans and writes ANALYSIS.json; it exits
non-zero on any violation. The launch-configuration lint (the JAX
package's `kernel_lint`) is not ported yet."""
from .contracts import (ContractViolation, DtypePromotionViolation, FloatScatterViolation,
                        MaterializationViolation, OperatorContract, SortBudgetViolation, check,
                        contract_for_node, enforce, groupby_contract, groupjoin_contract,
                        join_contract, orderby_contract, partition_plan_contract,
                        passthrough_contract)
from .dispatch_audit import AuditReport, PrimitiveBudget, audit, audit_fn, budget_of, count_sorts

__all__ = [
    "AuditReport", "PrimitiveBudget", "audit", "audit_fn", "budget_of", "count_sorts",
    "ContractViolation", "SortBudgetViolation", "MaterializationViolation",
    "DtypePromotionViolation", "FloatScatterViolation",
    "OperatorContract", "check", "enforce", "contract_for_node",
    "join_contract", "groupby_contract", "groupjoin_contract",
    "orderby_contract", "passthrough_contract", "partition_plan_contract",
]
