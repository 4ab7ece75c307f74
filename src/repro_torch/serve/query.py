"""Concurrent relational query-serving runtime (DESIGN.md §14): the port's
counterpart of the JAX package's `serve.query`.

The engine under traffic: many logical plans in flight at once, driven by
a deterministic tick loop — bounded queue with load shedding, per-query
deadlines, a fixed number of execution slots per tick — plus the three
mechanisms that make a *relational* server more than a loop around
`optimize().run()`:

  * **capacity bucketing** — input relations are padded up to
    power-of-two capacity buckets (`bucket_rows` / `pad_table`) and their
    TRUE valid counts ride into the executor (`executor.run(...,
    counts=...)`), so differently-sized datasets with the same plan shape
    and schema share ONE optimized plan. The plan cache is keyed by
    `plan_signature` = hash(logical plan, per-table capacity bucket +
    dtype schema). Nothing is compiled: the fast path is
    `executor.run(plan, padded, counts=counts)` on the cached plan, and the
    counters keep the JAX package's names (`qserve.plans_compiled`,
    `qserve.plan_cache_hits`), counting plans optimized and reused.
  * **cost-priced admission** — the optimizer's `predict_*` total cost is
    the admission ticket: each tick admits FIFO work until a per-tick
    predicted-seconds budget is spent, and a query priced above
    `max_price_s` is rejected outright. Planning happens once per
    signature, at first admission, and the price is cached with the plan.
  * **per-signature circuit breakers** — a signature whose fast
    executions keep failing is quarantined: while its breaker is OPEN, its
    queries run the SAFE path — `run(checked=True)` (escalation ladders
    live) over a `physical.degrade_plan` escalation chain — while every
    other signature stays on the fast path. Half-open probes re-try the
    fast path after a cooldown and close the breaker on success. One
    hostile query shape degrades alone.

Failure detection on the fast path is two-pronged: exceptions (ladder
exhaustion, injected `raise:*`) and *saturation* — a data-dependent root
whose valid count fills its static capacity is treated as suspect
truncation (the silent-failure mode of adversarially wrong estimates,
e.g. `estimates:/32`), because every capacity-clamped operator reports
`count = min(found, capacity)`. Saturated fast runs are re-run on the safe
path, which escalates `degrade_plan` levels (capacity x2 per level) until
the result fits, then remembers the converged level on the cache entry. A
failing kernel (`KernelError`) is never degraded around: it surfaces.

Memory governor (DESIGN.md §15): admission also buys a *bytes ticket* —
each signature's peak live bytes, measured by one run of the plan on its
device (`executor.plan_peak_bytes`, computed once, cached on the entry),
must fit ``budget - reserved`` (`engine.membudget.MemoryBudget`).
Over-budget-but-splittable signatures run out-of-core through the morsel
driver (`executor.run_morsels`) at the smallest fitting power-of-two
factor; a request whose ticket doesn't fit *right now* is DEFERRED
(off-queue, so it never starves fresh submissions of max_queue slots);
a signature that can never fit is rejected with the typed
`MemoryBudgetExceeded`. Tickets release when the run leaves the server,
on every path.

Chaos hooks: each request's `fault_spec` (the `resilience.faults`
grammar) is activated around ITS planning/execution only, and the
host-side sites `qserve.plan` / `qserve.execute` can be targeted by
`raise:` specs (`oom:qserve.admit` / `oom:executor.run` inject
allocation failures). See serve/chaos.py for the soak harness.

Spans (obs.trace's recorder, on under a profiler or `trace.recording()`),
each carrying the request's `qid`: `qserve.request` from submission to
its finish, whatever the outcome; under it `qserve.queued` from submission
to the start of its run (planning and admission in it: `qserve.plan`, a
lookup or an optimization and sizing, and `qserve.admit`, each bytes
reservation tried) and `qserve.run`, the run and its fallbacks, which
holds `qserve.pad` and the executor's `exec.*` spans. `qserve.tick` is
each `step`. The padding and the plan nodes' spans have device intervals;
the rest are host spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import Mapping

import torch

from ..core.table import Table
from ..engine import executor
from ..engine import membudget as MB
from ..engine import physical as P
from ..engine import stats as S
from ..obs import metrics
from ..obs import trace
from ..resilience import escalation, faults

MIN_BUCKET = 64  # smallest capacity bucket


class CapacitySaturated(RuntimeError):
    """A root operator's valid count reached its static capacity: the
    result is *suspected* truncated (capacity clamping makes real
    truncation indistinguishable from an exact fit), so the run is
    treated as failed and retried with more headroom."""


def bucket_rows(n: int) -> int:
    """Power-of-two capacity bucket for an ``n``-row relation (>= MIN_BUCKET).
    Padding to the bucket means at most 2x wasted rows, in exchange for a
    plan cache that differently-sized relations can share."""
    return max(MIN_BUCKET, 1 << max(int(n - 1).bit_length(), 0))


def pad_table(t: Table, capacity: int) -> Table:
    """Pad every column of `t` to `capacity` rows.

    Integer columns are padded with a synthetic continuation
    (max+1, max+2, ...) in the column's dtype, wrapping around past its
    largest value as the JAX package's does: this preserves exact column
    uniqueness — the optimizer's PK-FK proof runs on the padded table — and
    never inflates any existing key's multiplicity, so padded statistics
    stay faithful to the real data's join geometry. Float (and bool)
    columns wrap-repeat. The padding is made on the column's device: no
    host copy. Padded rows are dead weight at run time: the executor's
    (Table, valid_count) discipline masks them to KEY_SENTINEL before any
    key-consuming operator, so their values only ever influence the
    planner's statistics.
    """
    n = t.num_rows
    if n == capacity:
        return t
    if n > capacity:
        raise ValueError(f"table has {n} rows > bucket capacity {capacity}")
    pad = capacity - n
    cols = {}
    for name in t.column_names:
        col = t[name]
        if col.dtype.is_floating_point or col.dtype.is_complex or col.dtype == torch.bool:
            cols[name] = (col.repeat(-(-capacity // n))[:capacity] if n
                          else col.new_zeros(capacity))
        else:
            fill = col.max() + 1 + torch.arange(pad, dtype=col.dtype, device=col.device)
            cols[name] = torch.cat([col, fill])
    return Table(cols)


def plan_signature(plan, tables: Mapping[str, Table]):
    """Normalize-and-hash a submission into its cache identity.

    The signature covers the logical plan tree (frozen dataclass repr —
    operator order, keys, aggregates, filter constants) and each input
    relation's (capacity bucket, column dtypes, named as numpy names them,
    so the same submission has the same signature in the JAX package). Two
    submissions whose plans match and whose relations share schemas and
    buckets collapse to one signature — one optimizer call, one cached
    plan, one circuit breaker. Returns ``(signature, {table: bucket})``."""
    buckets = {name: bucket_rows(t.num_rows) for name, t in tables.items()}
    schema = tuple(
        (name, buckets[name],
         tuple((c, _dtype_name(tables[name][c].dtype))
               for c in tables[name].column_names))
        for name in sorted(tables))
    digest = hashlib.sha256(repr((plan, schema)).encode()).hexdigest()
    return digest[:16], buckets


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (torch.int32 -> 'int32')."""
    return str(dtype).removeprefix("torch.")


def _saturated(root, count) -> bool:
    """True when a data-dependent root filled its static capacity — the
    truncation-suspicion signal. Order-by-limit roots saturate by design
    (top-k fills its limit); scans/projects are full-width by contract."""
    if not isinstance(root, (P.PFilter, P.PJoin, P.PGroupBy, P.PGroupJoin)):
        return False
    return int(count) >= root.capacity


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclasses.dataclass
class CircuitBreaker:
    """Per-plan-signature failure isolation (DESIGN.md §14).

    State machine::

        CLOSED ──(threshold consecutive fast failures)──> OPEN
        OPEN ──(cooldown ticks elapsed)──> HALF_OPEN: one fast probe
        HALF_OPEN ──probe success──> CLOSED   (cooldown resets)
        HALF_OPEN ──probe failure──> OPEN     (cooldown doubles, capped)

    While OPEN, `route()` sends every request of the signature to the
    safe path (degraded plans + checked_mode). Safe-path successes
    do NOT close the breaker — they prove the quarantine works, not that
    the fast path recovered; only a half-open probe can close it. A
    safe-path failure pushes the next probe out (the signature is failing
    even degraded; probing the fast path sooner is pointless)."""

    signature: str
    threshold: int = 2
    cooldown: int = 8
    max_cooldown: int = 64
    state: str = CLOSED
    failures: int = 0  # consecutive fast-path failures
    opened_at: int = -1
    _cooldown0: int = dataclasses.field(default=0, repr=False)

    def __post_init__(self):
        self._cooldown0 = self.cooldown

    def route(self, tick: int) -> str:
        """'fast' or 'safe' for a request arriving at `tick`."""
        if self.state == OPEN and tick - self.opened_at >= self.cooldown:
            self.state = HALF_OPEN
            metrics.counter("qserve.breaker_probes").inc()
            return "fast"  # the half-open probe
        return "fast" if self.state == CLOSED else "safe"

    def record_fast_success(self, tick: int) -> None:
        if self.state == HALF_OPEN:
            metrics.counter("qserve.breaker_closes").inc()
            self.cooldown = self._cooldown0
        self.state, self.failures = CLOSED, 0

    def record_fast_failure(self, tick: int) -> None:
        self.failures += 1
        if self.state == HALF_OPEN:
            self.cooldown = min(self.cooldown * 2, self.max_cooldown)
            self._open(tick)
        elif self.state == CLOSED and self.failures >= self.threshold:
            self._open(tick)

    def record_safe_failure(self, tick: int) -> None:
        if self.state == OPEN:
            self.opened_at = tick  # still toxic: push the probe out

    def _open(self, tick: int) -> None:
        self.state, self.opened_at = OPEN, tick
        metrics.counter("qserve.breaker_opens").inc()
        escalation.record_degradation(
            "qserve", f"breaker OPEN sig={self.signature[:8]} "
                      f"cooldown={self.cooldown}")


# ---------------------------------------------------------------------------
# requests and cache entries
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class QueryRequest:
    """One query in flight. `fault_spec` (the REPRO_FAULTS grammar; "" =
    none) is activated via `faults.inject()` around THIS request's
    planning and execution stages only — the chaos harness's per-request
    hostile-conditions hook."""

    qid: int
    plan: object  # logical.Plan
    tables: dict  # {name: Table} — the request's actual (unpadded) inputs
    # absolute server tick by which the request must START running
    # (None = no deadline); overdue queued requests are evicted with
    # error="deadline"
    deadline_ticks: int | None = None
    fault_spec: str = ""
    # -- outcome -----------------------------------------------------------
    result: tuple | None = None  # (Table, valid_count) on success
    done: bool = False
    # why the request finished without a result: "" | "shed" | "rejected"
    # | "deadline" | "failed"
    error: str = ""
    detail: str = ""
    # which execution path delivered the result: "fast" | "safe" |
    # "fast+safe" (fast attempt failed, same-tick safe fallback delivered)
    path: str = ""
    signature: str = ""
    price_s: float = 0.0  # the optimizer's predicted cost = admission ticket
    # -- latency breakdown -------------------------------------------------
    submit_tick: int = -1
    admit_tick: int = -1
    done_tick: int = -1
    ticks_queued: int = 0
    # ticks spent memory-deferred: the bytes ticket didn't fit
    # `budget - reserved`, so the request waited WITHOUT occupying a
    # max_queue slot (DESIGN.md §15)
    ticks_deferred: int = 0
    plan_wall_s: float = 0.0
    # host seconds of the run, fallbacks included, with no device sync:
    # the host's enqueueing, not the device's work (that is in the device
    # intervals of the run's `qserve.pad` and `exec.*` spans)
    exec_wall_s: float = 0.0
    # host seconds from submission to the start of the run (planning
    # included), and to the end of the run
    queue_wall_s: float = 0.0
    total_wall_s: float = 0.0
    submitted_at: float = 0.0  # time.perf_counter() at submission
    escalations: int = 0  # safe-path degrade-level escalations
    morsels: int = 1  # morsel factor the result was produced at (1 = whole)
    # the open `qserve.request` and `qserve.queued` spans (None while the
    # recorder is off)
    request_span: object = dataclasses.field(default=None, init=False, repr=False)
    queued_span: object = dataclasses.field(default=None, init=False, repr=False)


@dataclasses.dataclass
class PlanEntry:
    """One signature's cached artifacts: the optimized plan all
    same-signature requests share, its predicted price, and the
    lazily-built `degrade_plan` escalation chain the safe path climbs.
    `safe_level` remembers where the safe path last converged, so a
    quarantined signature pays its escalation walk once."""

    signature: str
    buckets: dict
    plan: P.PhysicalPlan
    price_s: float
    hits: int = 0
    safe_level: int = 0
    degraded_chain: list = dataclasses.field(default_factory=list, repr=False)
    # -- memory governor (DESIGN.md §15) -------------------------------------
    # the bytes ticket admission buys: the peak live bytes of one run of
    # the form this signature actually runs (whole plan, or the smallest
    # fitting morsel clone when the whole plan exceeds the budget)
    peak_bytes: int = 0
    # 1 = whole-plan execution fits; >= 2 = run through the morsel driver
    # at this factor; 0 = NEVER fits (no morsel axis, or no factor small
    # enough) — admission rejects with MemoryBudgetExceeded
    morsel_factor: int = 1

    def degraded(self, level: int) -> P.PhysicalPlan:
        """The plan with `degrade_plan` applied `level` times (level 0 =
        the original plan run under checked_mode; each level doubles every
        data-bearing capacity and forces exact strategies)."""
        if level == 0:
            return self.plan
        while len(self.degraded_chain) < level:
            base = (self.degraded_chain[-1] if self.degraded_chain
                    else self.plan)
            self.degraded_chain.append(P.degrade_plan(
                base, f"qserve safe level {len(self.degraded_chain) + 1}"))
        return self.degraded_chain[level - 1]


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
class QueryServer:
    """Deterministic tick-loop relational query server.

    Usage::

        server = QueryServer(tick_budget_s=0.05)
        for q in queries:
            server.submit(QueryRequest(qid=..., plan=..., tables=...))
        server.run()                # drains the queue
        server.completed            # every request, with outcomes

    Per tick (`step()`): sweep queued deadlines -> admit FIFO work
    (bounded by `slots_per_tick` and the predicted-cost tick budget;
    overpriced queries rejected) -> execute admitted requests through
    their signatures' breaker-chosen path.

    The bytes budget is `mem_budget_bytes`, else the memory of `device`
    (default: the card when there is one; `engine.membudget`)."""

    def __init__(self, *, max_queue: int | None = 256,
                 slots_per_tick: int = 4,
                 tick_budget_s: float = float("inf"),
                 max_price_s: float = float("inf"),
                 mem_budget_bytes: int | None = None,
                 safety: float = 1.5, measure_profile: bool = False,
                 breaker_threshold: int = 2, breaker_cooldown: int = 8,
                 breaker_max_cooldown: int = 64, max_safe_level: int = 6,
                 device=None):
        self.max_queue = max_queue
        self.slots_per_tick = slots_per_tick
        self.tick_budget_s = tick_budget_s
        self.max_price_s = max_price_s
        # bytes ticket (DESIGN.md §15): each admitted request reserves its
        # signature's peak-live bytes until its run finishes; default
        # budget is the device's memory / REPRO_MEM_BUDGET_BYTES
        self.budget = MB.MemoryBudget(mem_budget_bytes, device=device)
        self.safety = safety
        self.measure_profile = measure_profile
        self.breaker_kw = dict(threshold=breaker_threshold,
                               cooldown=breaker_cooldown,
                               max_cooldown=breaker_max_cooldown)
        self.max_safe_level = max_safe_level
        self.cache: dict[str, PlanEntry] = {}
        self.breakers: dict[str, CircuitBreaker] = {}
        self.queue: list[QueryRequest] = []
        # memory-deferred requests: planned and priced, waiting for budget
        # headroom. NOT part of `queue` — a stuck large query must not
        # occupy a max_queue slot and starve fresh submissions
        self.deferred: list[QueryRequest] = []
        self.completed: list[QueryRequest] = []
        self.tick = 0

    # -- admission -----------------------------------------------------------
    def submit(self, req: QueryRequest) -> None:
        req.submit_tick = self.tick
        req.submitted_at = time.perf_counter()
        req.request_span = trace.begin("qserve.request", qid=req.qid)
        req.queued_span = trace.begin("qserve.queued", parent=req.request_span,
                                      qid=req.qid)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.error, req.done, req.done_tick = "shed", True, self.tick
            metrics.counter("qserve.shed").inc()
            escalation.record_degradation(
                "qserve", f"shed qid={req.qid}: queue full ({self.max_queue})")
            self._end_spans(req)
            self.completed.append(req)
            return
        metrics.counter("qserve.submitted").inc()
        self.queue.append(req)

    def _fault_ctx(self, req: QueryRequest):
        return (faults.inject(req.fault_spec) if req.fault_spec
                else contextlib.nullcontext())

    def _finish(self, req: QueryRequest, error: str, detail: str = "", *,
                end_spans: bool = True) -> None:
        req.error, req.done, req.done_tick = error, True, self.tick
        req.detail = detail[:200]
        if end_spans:
            self._end_spans(req)
        self.completed.append(req)

    @staticmethod
    def _end_spans(req: QueryRequest) -> None:
        trace.end(req.queued_span, ticks_deferred=req.ticks_deferred)
        trace.end(req.request_span, signature=req.signature, path=req.path,
                  morsels=req.morsels, error=req.error)

    def _sweep_deadlines(self) -> None:
        overdue = [r for r in self.queue + self.deferred
                   if r.deadline_ticks is not None
                   and self.tick >= r.deadline_ticks]
        if not overdue:
            return
        self.queue = [r for r in self.queue if r not in overdue]
        self.deferred = [r for r in self.deferred if r not in overdue]
        for req in overdue:
            metrics.counter("qserve.deadline_evictions").inc()
            self._finish(req, "deadline")

    def _ensure_entry(self, req: QueryRequest) -> PlanEntry:
        with trace.span("qserve.plan", parent=req.queued_span, qid=req.qid,
                        device=False) as rec:
            entry = self._lookup_or_plan(req)
            if rec is not None:
                rec.attrs["hit"] = entry.hits > 0  # a fresh entry has none
        return entry

    def _lookup_or_plan(self, req: QueryRequest) -> PlanEntry:
        t0 = time.perf_counter()
        sig, buckets = plan_signature(req.plan, req.tables)
        req.signature = sig
        if sig not in self.breakers:
            self.breakers[sig] = CircuitBreaker(sig, **self.breaker_kw)
        entry = self.cache.get(sig)
        if entry is None:
            faults.check_site("qserve.plan")
            # plan against the PADDED relations: the optimizer's capacity
            # and strategy choices must hold for every dataset in the
            # bucket, and padded statistics are faithful (see pad_table)
            padded = {n: pad_table(t, buckets[n])
                      for n, t in req.tables.items()}
            phys = P.optimize(req.plan, S.Catalog(padded),
                              safety=self.safety,
                              measure_profile=self.measure_profile)
            entry = PlanEntry(signature=sig, buckets=buckets, plan=phys,
                                  price_s=float(phys.total_cost))
            self._size_entry(entry, padded)
            self.cache[sig] = entry
            # the JAX package's counter names: here they count optimized
            # plans cached per signature and their reuses
            metrics.counter("qserve.plans_compiled").inc()
        else:
            entry.hits += 1
            metrics.counter("qserve.plan_cache_hits").inc()
        req.price_s = entry.price_s
        req.plan_wall_s = time.perf_counter() - t0
        return entry

    def _size_entry(self, entry: PlanEntry, padded: Mapping) -> None:
        """Size a fresh entry's bytes ticket (DESIGN.md §15): the peak live
        bytes of one run of the bucketed form the signature runs
        (`executor.plan_peak_bytes`). When
        the whole plan exceeds the TOTAL budget, probe power-of-two morsel
        factors (smallest first) for the first clone whose peak fits and
        cache it — the ticket is then the MORSEL peak, and every run of
        the signature goes through the morsel driver. No fitting factor
        (or no morsel axis) leaves ``morsel_factor = 0``: the signature
        can never fit, and admission rejects it with the typed error."""
        counts = {n: t.num_rows for n, t in padded.items()}
        entry.peak_bytes = executor.plan_peak_bytes(
            entry.plan, padded, counts=counts)
        if entry.peak_bytes <= self.budget.total:
            return
        axis = P.morsel_axis(entry.plan.root)
        if axis is None:
            entry.morsel_factor = 0
            return
        rows = entry.buckets[axis]
        factor = 2
        while True:
            try:
                mp = P.morsel_plan(entry.plan, factor, rows=rows)
            except ValueError:  # no recombinable partial rewrite
                break
            m = P.morsel_rows(rows, factor)
            mtables = dict(padded)
            mtables[axis] = padded[axis].head(m)
            mcounts = dict(counts)
            mcounts[axis] = m
            peak = executor.plan_peak_bytes(mp, mtables, counts=mcounts)
            if peak <= self.budget.total:
                entry.peak_bytes = peak
                entry.morsel_factor = factor
                return
            if m <= MIN_BUCKET:
                break  # morsels can't shrink further
            factor *= 2
        entry.morsel_factor = 0  # never fits

    def _try_reserve(self, entry: PlanEntry, req: QueryRequest) -> bool:
        """Buy the request's bytes ticket: reserve the entry's peak against
        `budget - reserved`. The `oom:qserve.admit` fault site models an
        allocation race lost at admission — an injected hit counts as a
        failed reservation (the request defers), never as an error."""
        with trace.span("qserve.admit", parent=req.queued_span, qid=req.qid,
                        device=False, bytes=entry.peak_bytes) as rec:
            try:
                with self._fault_ctx(req):
                    faults.check_oom("qserve.admit")
            except faults.OOMInjected:
                ok = False
            else:
                ok = self.budget.try_reserve(f"q{req.qid}", entry.peak_bytes)
            if rec is not None:
                rec.attrs["reserved"] = ok
        return ok

    def _admit(self) -> list[QueryRequest]:
        batch: list[QueryRequest] = []
        spent = 0.0
        # memory-deferred requests retry FIRST (FIFO seniority: they were
        # submitted before anything still in the queue), sharing the tick's
        # slot and seconds budgets with fresh admissions
        still_deferred: list[QueryRequest] = []
        for i, req in enumerate(self.deferred):
            entry = self.cache[req.signature]
            if len(batch) >= self.slots_per_tick or (
                    batch and spent + req.price_s > self.tick_budget_s):
                still_deferred.extend(self.deferred[i:])
                break
            if not self._try_reserve(entry, req):
                still_deferred.append(req)
                continue
            spent += req.price_s
            req.admit_tick = self.tick
            batch.append(req)
        self.deferred = still_deferred
        while self.queue and len(batch) < self.slots_per_tick:
            req = self.queue[0]
            try:
                with self._fault_ctx(req):
                    self._ensure_entry(req)
            except Exception as e:  # noqa: BLE001 — planning failed alone
                self.queue.pop(0)
                metrics.counter("qserve.failed").inc()
                escalation.record_degradation(
                    "qserve", f"plan failed qid={req.qid}: "
                              f"{type(e).__name__}: {e}"[:160])
                self._finish(req, "failed", f"plan: {type(e).__name__}: {e}")
                continue
            if req.price_s > self.max_price_s:
                # admission control: the cost model prices the query out
                self.queue.pop(0)
                metrics.counter("qserve.rejected").inc()
                escalation.record_degradation(
                    "qserve", f"rejected qid={req.qid}: price "
                              f"{req.price_s:.6f}s > {self.max_price_s}s")
                self._finish(req, "rejected",
                             f"price {req.price_s:.6f}s > cap")
                continue
            entry = self.cache[req.signature]
            if entry.morsel_factor == 0:
                # can NEVER fit the device budget, at any morsel factor:
                # typed rejection, not a crash or an eternal deferral
                self.queue.pop(0)
                exc = MB.MemoryBudgetExceeded(
                    entry.peak_bytes, self.budget.total,
                    "unsplittable at any morsel factor")
                metrics.counter("qserve.mem_rejections").inc()
                escalation.record_degradation(
                    "qserve", f"mem-rejected qid={req.qid}: {exc}"[:160])
                self._finish(req, "rejected", f"{type(exc).__name__}: {exc}")
                continue
            if batch and spent + req.price_s > self.tick_budget_s:
                break  # FIFO head waits for a tick with budget headroom
            if not self._try_reserve(entry, req):
                # splittable and budget-sized, just not NOW: defer without
                # holding a max_queue slot; retried next tick. Queue time
                # freezes here — deferred ticks accrue separately
                self.queue.pop(0)
                req.ticks_queued = self.tick - req.submit_tick
                metrics.counter("qserve.mem_deferrals").inc()
                self.deferred.append(req)
                continue
            self.queue.pop(0)
            spent += req.price_s
            req.admit_tick = self.tick
            req.ticks_queued = self.tick - req.submit_tick
            batch.append(req)
        return batch

    # -- execution -----------------------------------------------------------
    def _pad_inputs(self, entry: PlanEntry, req: QueryRequest):
        with trace.span("qserve.pad"):
            padded = {n: pad_table(t, entry.buckets[n])
                      for n, t in req.tables.items()}
        counts = {n: t.num_rows for n, t in req.tables.items()}
        return padded, counts

    def _run_fast(self, entry: PlanEntry, req: QueryRequest):
        faults.check_site("qserve.execute")
        padded, counts = self._pad_inputs(entry, req)
        if entry.morsel_factor > 1:
            # budget-sized signature: out-of-core morsel path, one chunk
            # at a time through the cached morsel clone
            out, count = executor.run_morsels(
                entry.plan, padded, counts=counts,
                factor=entry.morsel_factor)
            metrics.counter("qserve.chunked_runs").inc()
            req.morsels = entry.morsel_factor
        else:
            out, count = executor.run(entry.plan, padded, counts=counts)
        metrics.counter("qserve.fast_runs").inc()
        if _saturated(entry.plan.root, count):
            metrics.counter("qserve.saturations").inc()
            raise CapacitySaturated(
                f"root count {int(count)} filled capacity "
                f"{entry.plan.root.capacity}")
        return out, count

    def _run_safe(self, entry: PlanEntry, req: QueryRequest):
        """Quarantine execution: checked_mode (ladders live) over the
        degrade_plan escalation chain, climbing levels until the result
        fits its capacities. Converged level is cached on the entry."""
        faults.check_site("qserve.execute")
        padded, counts = self._pad_inputs(entry, req)
        last_exc: Exception | None = None
        for level in range(entry.safe_level, self.max_safe_level + 1):
            plan = entry.degraded(level)
            try:
                out, count = executor.run(plan, padded, counts=counts,
                                          checked=True)
            except executor._NON_DEGRADABLE:
                raise
            except Exception as e:  # noqa: BLE001 — escalate a level
                last_exc = e
                metrics.counter("qserve.safe_escalations").inc()
                req.escalations += 1
                continue
            if _saturated(plan.root, count):
                metrics.counter("qserve.safe_escalations").inc()
                req.escalations += 1
                continue
            entry.safe_level = level
            metrics.counter("qserve.safe_runs").inc()
            return out, count
        raise CapacitySaturated(
            f"safe path exhausted at level {self.max_safe_level}"
        ) from last_exc

    def _run_chunked_safe(self, entry: PlanEntry, req: QueryRequest):
        """Memory fallback: a run that hit an allocation failure retries
        out-of-core, climbing power-of-two morsel factors until one fits
        the device. The converged factor is cached on the entry so later
        runs of the signature go straight to the morsel path."""
        axis = P.morsel_axis(entry.plan.root)
        if axis is None:
            raise MB.MemoryBudgetExceeded(
                entry.peak_bytes, self.budget.total, "no morsel axis")
        padded, counts = self._pad_inputs(entry, req)
        rows = entry.buckets[axis]
        factor = max(entry.morsel_factor, 1) * 2
        last_exc: Exception | None = None
        while factor <= max(rows // MIN_BUCKET, 2):
            try:
                out, count = executor.run_morsels(
                    entry.plan, padded, counts=counts, factor=factor)
            except executor._NON_DEGRADABLE:
                raise
            except Exception as e:  # noqa: BLE001 — shrink and retry
                if not MB.is_memory_error(e):
                    raise
                last_exc = e
                factor *= 2
                continue
            entry.morsel_factor = factor
            metrics.counter("qserve.chunked_runs").inc()
            req.morsels = factor
            return out, count
        raise MB.MemoryBudgetExceeded(
            entry.peak_bytes, self.budget.total,
            f"morsel factors exhausted at {factor // 2}") from last_exc

    def _fallback(self, entry: PlanEntry, req: QueryRequest,
                  fast_exc: Exception):
        """The same-tick fallback after a fast failure: allocation
        failures of a splittable plan go out-of-core (`_run_chunked_safe`
        — a SMALLER working set); everything else climbs the
        capacity-doubling safe chain."""
        if (MB.is_memory_error(fast_exc)
                and P.morsel_axis(entry.plan.root) is not None):
            return self._run_chunked_safe(entry, req)
        return self._run_safe(entry, req)

    def _run_one(self, req: QueryRequest) -> None:
        trace.end(req.queued_span, ticks_deferred=req.ticks_deferred)
        with trace.span("qserve.run", parent=req.request_span, qid=req.qid,
                        device=False):
            self._run_request(req)
        self._end_spans(req)  # the request's span holds its run's

    def _run_request(self, req: QueryRequest) -> None:
        entry = self.cache[req.signature]
        breaker = self.breakers[req.signature]
        t0 = time.perf_counter()
        req.queue_wall_s = t0 - req.submitted_at
        try:
            with self._fault_ctx(req):
                route = breaker.route(self.tick)
                try:
                    if route == "fast":
                        out = self._run_fast(entry, req)
                    else:
                        out = self._run_safe(entry, req)
                except executor._NON_DEGRADABLE:
                    raise  # programming errors surface; never quarantine
                except Exception as e:  # noqa: BLE001 — contain to request
                    if route == "fast":
                        breaker.record_fast_failure(self.tick)
                        metrics.counter("qserve.fast_failures").inc()
                        try:
                            out = self._fallback(entry, req, e)
                            route = "fast+safe"
                        except executor._NON_DEGRADABLE:
                            raise
                        except Exception as e2:  # noqa: BLE001
                            breaker.record_safe_failure(self.tick)
                            metrics.counter("qserve.failed").inc()
                            req.exec_wall_s = time.perf_counter() - t0
                            self._finish(req, "failed",
                                         f"{type(e2).__name__}: {e2}",
                                         end_spans=False)
                            return
                    else:
                        breaker.record_safe_failure(self.tick)
                        metrics.counter("qserve.failed").inc()
                        req.exec_wall_s = time.perf_counter() - t0
                        self._finish(req, "failed",
                                     f"{type(e).__name__}: {e}", end_spans=False)
                        return
                else:
                    if route == "fast":
                        breaker.record_fast_success(self.tick)
        finally:
            # the bytes ticket is held from admission to HERE — every exit
            # path (success, failure, even a surfacing programming error)
            # releases it, so reservations can never leak
            self.budget.release(f"q{req.qid}")
        req.exec_wall_s = time.perf_counter() - t0
        req.total_wall_s = req.queue_wall_s + req.exec_wall_s
        req.result = out
        req.path = route
        req.done, req.done_tick = True, self.tick
        metrics.counter("qserve.completed").inc()
        self.completed.append(req)

    # -- the loop ------------------------------------------------------------
    def step(self) -> bool:
        """One server tick. Returns True if any work happened or remains."""
        self.tick += 1
        with trace.span("qserve.tick", parent=None, qid=None, device=False,
                        tick=self.tick):
            self._sweep_deadlines()
            batch = self._admit()
            for req in self.deferred:
                req.ticks_deferred += 1
            for req in batch:
                self._run_one(req)
        return bool(batch) or bool(self.queue) or bool(self.deferred)

    def run(self, max_ticks: int = 100_000) -> int:
        """Step until the queue and deferred list drain (or `max_ticks`).
        Returns ticks."""
        ticks = 0
        while (self.queue or self.deferred) and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks
