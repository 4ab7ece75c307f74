"""Measured-vs-modeled residuals and the regret signal: the port's own
copy of the JAX package's `obs.residuals` (DESIGN.md §12).

A *residual* is the ratio measured/modeled for one plan node — 1.0 means
the cost model priced the operator exactly. `residuals_of` extracts
them from a `QueryTrace` (obs.trace); `ResidualStore` keeps a
per-(operator, strategy) EWMA so repeated runs sharpen the picture instead
of the last run overwriting it; `regret_check` replays a cost
comparison with each candidate's predicted time multiplied by its stored
residual and reports when the model's winner *loses* the corrected
comparison by more than `REGRET_FACTOR` — the flag the optimizer attaches
to plans whose predicted winner lost last run (ROADMAP).

Residuals are per-backend: the store lives inside CALIBRATION.json under
the backend fingerprint (obs.calibration), never pooled across devices.
"""
from __future__ import annotations

import dataclasses

EWMA_ALPHA = 0.3  # weight of the newest observation
REGRET_FACTOR = 2.0  # "lost by >2x" threshold (ROADMAP)


@dataclasses.dataclass
class NodeResidual:
    """One node's measured-vs-modeled outcome."""

    op: str  # operator kind (join/groupby/groupjoin/...)
    strategy: str  # chosen algorithm/pattern or strategy
    predicted_s: float
    measured_s: float

    @property
    def key(self) -> str:
        return f"{self.op}/{self.strategy}" if self.strategy else self.op

    @property
    def ratio(self) -> float:
        return self.measured_s / self.predicted_s

    def as_dict(self) -> dict:
        return {"op": self.op, "strategy": self.strategy,
                "predicted_s": self.predicted_s,
                "measured_s": self.measured_s, "ratio": self.ratio}


def residuals_of(trace) -> list:
    """NodeResiduals for every span the cost model actually priced
    (scan/project carry zero predicted cost — no ratio to learn from)."""
    return [NodeResidual(op=s.op, strategy=s.strategy,
                         predicted_s=s.predicted_s, measured_s=s.wall_s)
            for s in trace.spans() if s.predicted_s > 0.0]


class ResidualStore:
    """Per-(operator, strategy) EWMA of measured/modeled ratios.

    `data` maps "op/strategy" -> {"ewma", "count", "last"} and is the
    JSON-serializable half; `correction()` is the consumer-facing read:
    the multiplicative factor that maps a modeled time onto this backend's
    measured reality (1.0 when nothing was ever observed)."""

    def __init__(self, data: dict | None = None):
        self.data: dict = dict(data or {})

    @classmethod
    def from_dict(cls, data: dict) -> "ResidualStore":
        return cls({k: dict(v) for k, v in data.items()
                    if isinstance(v, dict) and "ewma" in v})

    def as_dict(self) -> dict:
        return {k: dict(v) for k, v in sorted(self.data.items())}

    def update(self, residuals, alpha: float = EWMA_ALPHA) -> None:
        for r in residuals:
            ratio = float(r.ratio)
            ent = self.data.get(r.key)
            if ent is None:
                self.data[r.key] = {"ewma": ratio, "count": 1,
                                    "last": ratio}
            else:
                ent["ewma"] = (1 - alpha) * float(ent["ewma"]) + alpha * ratio
                ent["count"] = int(ent.get("count", 0)) + 1
                ent["last"] = ratio

    def correction(self, op: str, strategy: str = "",
                   default: float = 1.0) -> float:
        key = f"{op}/{strategy}" if strategy else op
        ent = self.data.get(key)
        return float(ent["ewma"]) if ent else default

    def observed(self, op: str, strategy: str = "") -> bool:
        key = f"{op}/{strategy}" if strategy else op
        return key in self.data


def regret_check(store: ResidualStore, op: str, choices: dict,
                 chosen: str, factor: float = REGRET_FACTOR) -> str:
    """Replay a strategy choice with residual-corrected costs.

    `choices` maps strategy -> predicted seconds (the model's comparison);
    each is multiplied by the store's EWMA for (op, strategy). Returns a
    regret message when the chosen strategy's corrected time exceeds the
    best corrected alternative by >= `factor` — i.e. last run's residuals
    say the predicted winner actually loses by that much — and "" when the
    choice survives correction (or nothing relevant was ever observed).
    Advisory only: the flag annotates the plan, it never flips the choice
    (the residuals may come from different shapes than this query's)."""
    if chosen not in choices or not store.observed(op, chosen):
        return ""
    corrected = {s: t * store.correction(op, s) for s, t in choices.items()}
    alts = {s: c for s, c in corrected.items() if s != chosen}
    if not alts:
        return ""
    best = min(alts, key=alts.get)
    if corrected[chosen] >= factor * alts[best] > 0.0:
        return (f"REGRET: predicted winner '{chosen}' loses by "
                f"{corrected[chosen] / alts[best]:.1f}x after residual "
                f"correction (measured/modeled EWMA "
                f"{store.correction(op, chosen):.2f}x vs '{best}' "
                f"{store.correction(op, best):.2f}x)")
    return ""
