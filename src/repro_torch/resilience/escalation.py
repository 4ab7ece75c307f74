"""Declarative bounded-attempt escalation engine: the port's own copy of
the JAX package's `resilience.escalation`.

The operators run with static capacities (build blocks, partition fan-out,
accumulator sizes) chosen from estimates. When an estimate is wrong, the
checked drivers re-run with bigger knobs. A `Ladder` makes that policy
declarative and bounded:

  * the operator states its knobs (a plain dict) and an ordered list of
    `EscalationStep`s — each a growth rule `grow(knobs, diag) -> new
    knobs or None` with a per-step application cap;
  * a `check(knobs) -> (ok, detail, diag)` callback performs the cheap
    host-side overflow check (histogram max, distinct count, ...);
  * `Ladder.resolve` alternates check and grow: on overflow it asks the
    FIRST step that still has budget and can grow; a step that returns
    None (cannot help) yields to the next rung — bits give way to
    capacity, capacity to a strategy fallback;
  * every run returns an `EscalationReport` (attempt log, final knobs,
    wasted checks) and counts in the port's `obs.metrics`; exhaustion
    raises a typed `EscalationExhausted` carrying the report — never a
    silent wrong answer.

Fault hook: `faults.overflow_forced(operator, attempt)` can force any check
to report overflow, driving the ladder deterministically through its rungs.
All of this is host-side Python.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

from . import faults

# module-level ring of recent reports, so a caller can see what the last
# runs escalated without threading a report through every return path. Monotone seq so consumers can window.
_RING_CAP = 64
_reports: list = []
_degradations: list = []
_seq = itertools.count()


@dataclasses.dataclass
class EscalationStep:
    """One rung: a named growth rule. `grow(knobs, diag)` returns the new
    knob dict, or None when this rung cannot help (exhausted semantics
    distinct from budget: a bits rung at its cap returns None so the
    ladder moves on to capacity/strategy rungs)."""

    name: str
    grow: Callable[[dict, object], dict | None]
    max_times: int = 4


@dataclasses.dataclass
class Attempt:
    """One check under one knob assignment."""

    index: int
    knobs: dict
    ok: bool
    forced: bool = False  # overflow forced by fault injection
    step: str = ""  # rung applied to ESCAPE this attempt ("" on success)
    detail: str = ""


@dataclasses.dataclass
class EscalationReport:
    """Structured outcome of a ladder run; feeds metrics and
    EscalationExhausted."""

    operator: str
    attempts: list = dataclasses.field(default_factory=list)
    final_knobs: dict = dataclasses.field(default_factory=dict)
    converged: bool = False
    steps_applied: dict = dataclasses.field(default_factory=dict)
    # wasted device work: each failed check re-ran a cheap device reduction
    # (histogram / distinct count); the count is the honest proxy since the
    # checks are O(n) scans the final run repeats.
    wasted_checks: int = 0
    seq: int = -1

    @property
    def escalated(self) -> bool:
        return len(self.attempts) > 1

    def as_dict(self) -> dict:
        return {
            "operator": self.operator,
            "converged": self.converged,
            "attempts": [
                {"index": a.index, "ok": a.ok, "forced": a.forced,
                 "step": a.step, "detail": a.detail,
                 "knobs": dict(a.knobs)}
                for a in self.attempts
            ],
            "final_knobs": dict(self.final_knobs),
            "steps_applied": dict(self.steps_applied),
            "wasted_checks": self.wasted_checks,
        }

    def summary(self) -> str:
        if not self.escalated:
            return f"{self.operator}: clean (1 attempt)"
        path = " -> ".join(a.step for a in self.attempts if a.step)
        state = "converged" if self.converged else "EXHAUSTED"
        return (f"{self.operator}: {state} after {len(self.attempts)} "
                f"attempts via [{path}]")


class EscalationExhausted(RuntimeError):
    """Every rung's budget is spent and the check still reports overflow.
    Carries the full report — the caller decides what to do; the ladder never silently proceeds."""

    def __init__(self, report: EscalationReport):
        self.report = report
        super().__init__(report.summary())


@dataclasses.dataclass
class Ladder:
    """An operator's declared escalation policy."""

    operator: str
    steps: list  # [EscalationStep]
    max_attempts: int = 8

    def resolve(self, knobs: dict,
                check: Callable[[dict], tuple]) -> EscalationReport:
        """Alternate check/grow until the check passes. `check(knobs)`
        returns (ok, detail, diag); diag is passed to the growth rules
        (e.g. the observed max partition size or required group count).
        Returns the report on convergence; raises EscalationExhausted
        otherwise. Host-side only."""
        from ..obs import metrics  # deferred: core paths import us

        report = EscalationReport(operator=self.operator, final_knobs=knobs)
        used = {s.name: 0 for s in self.steps}
        knobs = dict(knobs)
        for attempt in range(self.max_attempts):
            metrics.counter("resilience.ladder_attempts").inc()
            ok, detail, diag = check(knobs)
            forced = False
            if ok and faults.overflow_forced(self.operator, attempt):
                ok, forced = False, True
                detail = (detail + "; " if detail else "") + "forced by fault"
            rec = Attempt(index=attempt, knobs=dict(knobs), ok=ok,
                          forced=forced, detail=detail)
            report.attempts.append(rec)
            if ok:
                report.converged = True
                report.final_knobs = dict(knobs)
                report.steps_applied = {k: v for k, v in used.items() if v}
                if report.escalated:
                    metrics.counter("resilience.ladder_escalations").inc()
                    metrics.counter("core.overflow_escalations").inc()
                record_report(report)
                return report
            report.wasted_checks += 1
            grown = None
            for step in self.steps:
                if used[step.name] >= step.max_times:
                    continue
                grown = step.grow(knobs, diag)
                if grown is not None:
                    used[step.name] += 1
                    rec.step = step.name
                    knobs = dict(grown)
                    break
            if grown is None:
                break  # no rung can help: exhausted
        report.final_knobs = dict(knobs)
        report.steps_applied = {k: v for k, v in used.items() if v}
        metrics.counter("resilience.ladder_exhausted").inc()
        record_report(report)
        raise EscalationExhausted(report)


# ---------------------------------------------------------------------------
# report / degradation rings
# ---------------------------------------------------------------------------
def record_report(report: EscalationReport) -> int:
    report.seq = next(_seq)
    _reports.append(report)
    del _reports[:-_RING_CAP]
    return report.seq


def recent_reports(since: int = -1) -> list:
    """Reports with seq > since, oldest first."""
    return [r for r in _reports if r.seq > since]


def current_seq() -> int:
    """High-water mark; pass to recent_reports(since=...) to window."""
    return max((r.seq for r in _reports), default=-1)


def record_degradation(component: str, reason: str) -> None:
    """Note a degradation event (a plan re-planned, a serve slot evicted)
    for reporting."""
    from ..obs import metrics  # deferred

    _degradations.append({"component": component, "reason": reason,
                          "seq": next(_seq)})
    del _degradations[:-_RING_CAP]
    metrics.counter("resilience.degradations").inc()


def recent_degradations(since: int = -1) -> list:
    return [d for d in _degradations if d["seq"] > since]
