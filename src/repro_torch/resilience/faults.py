"""Deterministic fault injection for the escalation ladders: the port's own
copy of the JAX package's `resilience.faults`, with the same grammar, so one
`REPRO_FAULTS` string means the same thing in both packages.

Fault families:

  * ``overflow:<ladder>@<when>`` — force an escalation ladder's overflow
    check to report "overflowed" at chosen attempt indices, driving the
    ladder up its rungs whatever the data (`escalation.Ladder` consults
    `overflow_forced` after the real check);
  * ``raise:<site>[@<when>]`` — make a named host-side site raise
    `FaultInjected` (`check_site`);
  * ``oom:<site>[@<when>]`` — make a named host-side allocation site raise
    `OOMInjected` (a `MemoryError`; `check_oom`);
  * ``estimates:<x|/><factor>`` — multiply (x) or divide (/) the
    statistics layer's estimates by a factor (`estimate_factor`);
    ``seed:<int>`` jitters that factor deterministically per site;
  * ``pallas:<site|*>[@<when>]`` — parsed, and kept so that a spec written
    for the JAX package is valid here, but it fires nowhere in the port:
    the port has no degradation arm (a kernel that fails raises), so no
    site checks for it.

Grammar (validated at read time, per call, never frozen at import)::

    REPRO_FAULTS := spec[,spec...]
    spec         := overflow:<ladder>@<when>
                  | pallas:<site|*>[@<when>]
                  | raise:<site>[@<when>]
                  | oom:<site>[@<when>]
                  | estimates:<x|/><factor>
                  | seed:<int>
    when         := all | <int>[+<int>...]      (attempt/occurrence indices)

Examples::

    REPRO_FAULTS=overflow:phj@0                # phj ladder overflows at attempt 0
    REPRO_FAULTS=overflow:phj@0+1+2            # ... at its first three attempts
    REPRO_FAULTS=estimates:/16,seed:7          # estimates ~16x too low

Programmatic use (the innermost context wins over the env var)::

    with faults.inject("overflow:groupjoin@0"):
        ...

Every injection site is host-side Python; when no faults are active each
hook returns at once (one module-level check and an env lookup) and adds no
device work. Occurrence counting is deterministic: each (fault-kind, site)
pair keeps a per-activation counter, reset whenever the active spec changes
(context enter/exit or a new env string), so ``@0`` always means "the first
call under this activation". Fired faults count in the port's
`obs.metrics` (`resilience.faults_fired`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

ENV_VAR = "REPRO_FAULTS"

_GRAMMAR = (
    "spec[,spec...] with spec := overflow:<ladder>@<when> | "
    "pallas:<site|*>[@<when>] | raise:<site>[@<when>] | "
    "oom:<site>[@<when>] | "
    "estimates:<x|/><factor> | seed:<int>; when := all | <int>[+<int>...]"
)


class FaultInjected(RuntimeError):
    """Raised by an armed injection site. Carries the site name so the
    degradation layers can report WHAT failed, not just that something
    did."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        super().__init__(f"injected fault at {site!r}"
                         + (f": {detail}" if detail else ""))


class OOMInjected(FaultInjected, MemoryError):
    """Injected allocation failure. Subclasses MemoryError, so a caller that
    tells memory failures apart handles it as a real one."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed spec. `when` is None for 'all' (every occurrence),
    else a frozenset of occurrence indices."""

    kind: str  # overflow | pallas | raise | oom | estimates | seed
    target: str  # ladder/site name, "*" wildcard, or "" for estimates/seed
    when: frozenset | None = None
    factor: float = 1.0  # estimates only (already inverted for '/')
    seed: int = 0  # seed only

    def fires_at(self, occurrence: int) -> bool:
        return self.when is None or occurrence in self.when


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The full parsed REPRO_FAULTS / inject() value."""

    raw: str
    specs: tuple = ()

    def matching(self, kind: str, target: str):
        for s in self.specs:
            if s.kind == kind and (s.target == target or s.target == "*"):
                yield s

    @property
    def seed(self) -> int:
        for s in self.specs:
            if s.kind == "seed":
                return s.seed
        return 0


_EMPTY = FaultPlan(raw="")


def _bad(spec: str, why: str) -> ValueError:
    return ValueError(
        f"{ENV_VAR} spec {spec!r} is not a recognized value ({why}); "
        f"allowed grammar: {_GRAMMAR}")


def _parse_when(spec: str, text: str) -> frozenset | None:
    if text == "all":
        return None
    try:
        idx = frozenset(int(p) for p in text.split("+"))
    except ValueError:
        raise _bad(spec, f"bad occurrence list {text!r}") from None
    if any(i < 0 for i in idx):
        raise _bad(spec, "occurrence indices must be >= 0")
    return idx


def parse(value: str) -> FaultPlan:
    """Parse a REPRO_FAULTS string, raising ValueError (naming the
    grammar) on anything unrecognized. An empty/whitespace value is the
    empty plan."""
    value = value.strip()
    if not value:
        return _EMPTY
    specs = []
    for spec in value.split(","):
        spec = spec.strip()
        if not spec:
            continue
        kind, sep, rest = spec.partition(":")
        if not sep:
            raise _bad(spec, "missing ':'")
        if kind == "overflow":
            target, sep, when = rest.partition("@")
            if not sep or not target:
                raise _bad(spec, "overflow needs <ladder>@<when>")
            specs.append(FaultSpec("overflow", target,
                                   _parse_when(spec, when)))
        elif kind in ("pallas", "raise", "oom"):
            target, sep, when = rest.partition("@")
            if not target:
                raise _bad(spec, f"{kind} needs a site name"
                                 + ("" if kind == "oom" else " or '*'"))
            if kind in ("raise", "oom") and target == "*":
                raise _bad(spec, f"{kind}:* would break host-side control "
                                 "flow everywhere; name a site")
            specs.append(FaultSpec(
                kind, target, _parse_when(spec, when) if sep else None))
        elif kind == "estimates":
            if not rest or rest[0] not in "x/":
                raise _bad(spec, "estimates needs x<factor> or /<factor>")
            try:
                f = float(rest[1:])
            except ValueError:
                raise _bad(spec, f"bad factor {rest[1:]!r}") from None
            if f <= 0:
                raise _bad(spec, "factor must be > 0")
            specs.append(FaultSpec(
                "estimates", "", factor=(f if rest[0] == "x" else 1.0 / f)))
        elif kind == "seed":
            try:
                specs.append(FaultSpec("seed", "", seed=int(rest)))
            except ValueError:
                raise _bad(spec, f"bad seed {rest!r}") from None
        else:
            raise _bad(spec, f"unknown fault kind {kind!r}")
    return FaultPlan(raw=value, specs=tuple(specs))


# ---------------------------------------------------------------------------
# activation: innermost inject() context wins over the env var
# ---------------------------------------------------------------------------
_stack: list[FaultPlan] = []

# occurrence counters for the CURRENT activation; keyed by (kind, site).
# _counts_key tracks which raw spec the counters belong to so a changed
# env string (or context enter/exit) restarts counting at 0.
_counts: dict = {}
_counts_key: str | None = None


def _active() -> FaultPlan:
    """The governing plan: innermost inject() context, else REPRO_FAULTS
    (parsed and validated on every call — never frozen at import)."""
    global _counts_key
    if _stack:
        plan = _stack[-1]
    else:
        env = os.environ.get(ENV_VAR, "")
        plan = parse(env) if env.strip() else _EMPTY
    if plan.raw != _counts_key:
        _counts.clear()
        _counts_key = plan.raw
    return plan


def active() -> bool:
    """True when any fault spec is in force (cheap enough for hot paths:
    no parsing unless the env var is set or a context is entered)."""
    if _stack:
        return bool(_stack[-1].specs)
    return bool(os.environ.get(ENV_VAR, "").strip())


@contextlib.contextmanager
def inject(spec: str):
    """Activate a fault spec for the dynamic extent of the with-block.
    Occurrence counters start at zero on entry and are discarded on exit,
    so `@0` semantics are reproducible per activation."""
    plan = parse(spec)
    _stack.append(plan)
    _counts.clear()
    global _counts_key
    _counts_key = plan.raw
    try:
        yield plan
    finally:
        _stack.pop()
        _counts.clear()
        _counts_key = None


def _occurrence(kind: str, site: str) -> int:
    key = (kind, site)
    n = _counts.get(key, 0)
    _counts[key] = n + 1
    return n


def _record(name: str) -> None:
    from ..obs import metrics  # deferred: keep faults import-light

    metrics.counter(name).inc()


# ---------------------------------------------------------------------------
# injection sites (each a no-op returning immediately when inactive)
# ---------------------------------------------------------------------------
def overflow_forced(ladder: str, attempt: int) -> bool:
    """Should ladder `ladder`'s check at `attempt` be forced to report
    overflow? Consulted by escalation.Ladder AFTER the real check, so a
    forced overflow always exercises a real escalation."""
    if not active():
        return False
    for s in _active().matching("overflow", ladder):
        if s.fires_at(attempt):
            _record("resilience.faults_fired")
            return True
    return False


def check_site(site: str) -> None:
    """Raise FaultInjected if a `raise:` spec targets this host-side
    site (e.g. 'executor.run')."""
    if not active():
        return
    for s in _active().matching("raise", site):
        if s.fires_at(_occurrence("raise", site)):
            _record("resilience.faults_fired")
            raise FaultInjected(site)
    return


def check_oom(site: str) -> None:
    """Raise OOMInjected (a MemoryError) if an `oom:` spec targets this
    host-side allocation site (e.g. 'executor.run', 'qserve.admit')."""
    if not active():
        return
    for s in _active().matching("oom", site):
        if s.fires_at(_occurrence("oom", site)):
            _record("resilience.faults_fired")
            _record("resilience.oom_injected")
            raise OOMInjected(site, "allocation failure forced")
    return


def estimate_factor(site: str = "") -> float:
    """Multiplier the statistics layer applies to its estimates. 1.0 when
    no estimates fault is active. With a `seed:` spec the factor is
    deterministically jittered per site (within [factor/2, factor*2] in
    log space), so one spec yields many distinct-but-reproducible wrong
    estimates."""
    if not active():
        return 1.0
    plan = _active()
    factor = 1.0
    for s in plan.specs:
        if s.kind == "estimates":
            factor *= s.factor
    if factor != 1.0 and plan.seed:
        h = hash((plan.seed, site)) & 0xFFFF
        factor *= 2.0 ** ((h / 0xFFFF) * 2.0 - 1.0)
        _record("resilience.faults_fired")
    elif factor != 1.0:
        _record("resilience.faults_fired")
    return factor
