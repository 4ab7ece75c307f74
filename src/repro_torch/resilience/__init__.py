"""repro_torch.resilience — the escalation runtime and fault injection of
the port, copies of the JAX package's `resilience.escalation` and
`resilience.faults`:

  * `escalation` — the bounded-attempt `Ladder` behind every `*_checked`
    driver; structured `EscalationReport`s, typed `EscalationExhausted`,
    `resilience.*` metrics;
  * `faults` — deterministic fault injection (`REPRO_FAULTS` / `inject()`):
    forced overflows, corrupted estimates, named host-side failures. The
    port has no degradation arm, so `pallas:` specs parse and fire nowhere.
"""
from .escalation import (Attempt, EscalationExhausted, EscalationReport,
                         EscalationStep, Ladder, current_seq,
                         recent_degradations, recent_reports,
                         record_degradation, record_report)
from .faults import ENV_VAR, FaultInjected, FaultPlan, FaultSpec, inject, parse

__all__ = [
    "Attempt", "EscalationExhausted", "EscalationReport", "EscalationStep",
    "Ladder", "current_seq", "recent_degradations", "recent_reports",
    "record_degradation", "record_report",
    "ENV_VAR", "FaultInjected", "FaultPlan", "FaultSpec", "inject", "parse",
]
