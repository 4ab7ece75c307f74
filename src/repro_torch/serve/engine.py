"""Batched LM serving engine: continuous batching over fixed-capacity slots.

The port's copy of the JAX package's `serve/engine.py`. The engine owns a
(max_batch,) slot array; requests are admitted into free slots, every
decode_step advances all live slots one token at their OWN position (vector
`pos` — per-slot ring-buffer offsets), finished slots are freed and
immediately refillable. Admission resets the freed slot's cache rows to
their pristine values so no state leaks between requests. The KV cache is
allocated once at capacity on the parameters' device, and the step's tokens
and positions go to that device every tick. The step is eager
`model.decode_step`; greedy decoding takes the first maximal logit, as
`np.argmax` does.

Resilience (DESIGN.md §13): admission sheds when the queue is full
(`max_queue`), per-request deadlines evict overdue work, and a failing
decode step is retried with backoff; if it keeps failing, the
most-recently-admitted slot is evicted (requeued while it has retry
budget, failed alone once it doesn't) so one poisoned query cannot take
down the batch. The cache is only ever reassigned on a successful step
(decode_step never writes the cache it is given), so a failed step leaves
every surviving slot's state untouched. A broken kernel is not a poisoned
query: a `KernelError` (and `torch.AcceleratorError`, a card left unusable
by an earlier launch) reaches the caller at once, never retried and never
answered by evicting a request.

Memory governance (DESIGN.md §15): an optional byte budget
(`mem_budget_bytes`) gates slot admission — a request declaring
`mem_bytes` buys a reservation ticket before it takes a slot. A queue
head whose ticket does not fit is DEFERRED, not admitted and not shed:
it holds its queue position, ages in `ticks_deferred` (never in
`ticks_queued` or `ticks_running`), and retries every tick until enough
in-flight work releases its tickets. Every slot-exit path — completion,
deadline eviction, poisoned eviction, requeue — releases the ticket.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..engine import membudget as MB
from ..kernels._build import KernelError
from ..models import model as M
from ..models.params import leaves, map_leaves
from ..obs import metrics
from ..resilience import escalation, faults

# failures of the step that are faults of the port or of the card, not of a
# request: re-raised, never retried or evicted around
NON_RETRYABLE = (KernelError, torch.AcceleratorError)


def _reset_slot(cache, pristine, axes, slot: int):
    """Copy slot `slot`'s rows from the pristine cache into `cache`, in
    place (per-leaf batch axis located via the cache's logical-axes tree).
    Returns `cache`."""
    for c, p, ax in zip(leaves(cache, torch.is_tensor), leaves(pristine, torch.is_tensor),
                        leaves(axes, lambda x: isinstance(x, M.AxesLeaf))):
        if "batch" in ax.axes:
            b_axis = ax.axes.index("batch")
            c.select(b_axis, slot).copy_(p.select(b_axis, slot))
    return cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # absolute engine tick by which the request must finish (None = no
    # deadline); overdue requests are evicted from slot or queue with
    # error="deadline"
    deadline_ticks: int | None = None
    # why the request finished without completing: "", "shed", "deadline",
    # "poisoned"
    error: str = ""
    # re-admissions allowed after this request's slot is evicted for a
    # persistent step failure before it is failed alone
    retries_left: int = 1
    # bytes this request's slot state needs while live; admission reserves
    # them against the engine's budget (0 = exempt from the governor)
    mem_bytes: int = 0
    # -- latency breakdown (engine ticks; accumulated across requeues and
    # observed into the serve.ticks_* histograms when the request ends) --
    submit_tick: int = -1
    done_tick: int = -1
    ticks_queued: int = 0   # ticks spent waiting in the queue
    ticks_running: int = 0  # ticks spent live in a slot
    ticks_retrying: int = 0  # failed step attempts charged while live
    ticks_deferred: int = 0  # ticks blocked at the queue head on memory
    _enqueued_at: int = dataclasses.field(default=0, repr=False)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 max_len: int = 256, eos_id: int = 2, batch_stub=None,
                 dtype=torch.float32, step_fn: Callable | None = None,
                 max_queue: int | None = None, step_retries: int = 2,
                 retry_backoff_s: float = 0.005,
                 mem_budget_bytes: int | None = None):
        self.cfg, self.params = cfg, params
        self.max_batch, self.max_len, self.eos_id = max_batch, max_len, eos_id
        self.max_queue = max_queue
        self.budget = MB.MemoryBudget(mem_budget_bytes)
        self.step_retries = step_retries
        self.retry_backoff_s = retry_backoff_s
        self.device = params["embed"]["table"].device
        self.cache = M.init_cache(cfg, params, max_batch, max_len, batch_stub or {}, dtype)
        self._pristine = map_leaves(torch.clone, self.cache, is_leaf=torch.is_tensor)
        self._cache_axes = M.cache_axes(cfg, max_batch, max_len, dtype)
        self.slot_req: list[Request | None] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)  # per-slot position
        self.tokens = np.zeros(max_batch, np.int32)
        self.queue: list[Request] = []
        self.tick = 0  # absolute engine tick (deadline clock)
        # admission order, newest = the eviction candidate on a poisoned step
        self._admit_seq = itertools.count()
        self._slot_seq = [-1] * max_batch
        self._hold_admission = False  # one-tick pause after an eviction
        self._step = step_fn or (lambda p, c, t, pos: M.decode_step(cfg, p, c, t, pos))

    # -- latency accounting --------------------------------------------------
    def _finish(self, req: Request):
        """Stamp the end of a request's life and publish its tick
        breakdown (queued vs running vs retrying) to the serve.ticks_*
        histograms — `latency_summary()` reports their percentiles."""
        req.done_tick = self.tick
        metrics.histogram("serve.ticks_queued").observe(req.ticks_queued)
        metrics.histogram("serve.ticks_running").observe(req.ticks_running)
        metrics.histogram("serve.ticks_retrying").observe(req.ticks_retrying)
        metrics.histogram("serve.ticks_deferred").observe(req.ticks_deferred)

    @staticmethod
    def latency_summary(pcts=(50, 95, 99)) -> dict:
        """Per-stage tick percentiles over every finished request."""
        return {name: metrics.histogram(f"serve.{name}").summary(pcts)
                for name in ("ticks_queued", "ticks_running",
                             "ticks_retrying", "ticks_deferred")}

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request):
        req.submit_tick = self.tick
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            # load shedding: fail fast at admission instead of letting the
            # backlog grow past what the engine can drain
            req.error, req.done = "shed", True
            self._finish(req)
            metrics.counter("resilience.serve_shed").inc()
            escalation.record_degradation(
                "serve", f"shed rid={req.rid}: queue full ({self.max_queue})")
            return
        req._enqueued_at = self.tick
        self.queue.append(req)

    def _admit(self):
        # after an eviction, let the surviving batch run one tick before
        # refilling: readmitting into a still-failing batch would burn the
        # requeued request's retry budget on someone else's poison (an
        # empty batch can't be poisoned, so admission always resumes there)
        if self._hold_admission:
            self._hold_admission = False
            if any(r is not None for r in self.slot_req):
                return
        for i in range(self.max_batch):
            if self.slot_req[i] is None and self.queue:
                head = self.queue[0]
                if head.mem_bytes and not self.budget.try_reserve(
                        f"r{head.rid}", head.mem_bytes):
                    # memory-deferred: the head keeps its queue position
                    # and ages as DEFERRED — not queued, and certainly not
                    # running. No one jumps past it (FIFO under pressure,
                    # so a big request cannot starve behind small ones).
                    head.ticks_queued += self.tick - head._enqueued_at
                    head._enqueued_at = self.tick
                    head.ticks_deferred += 1
                    metrics.counter("serve.mem_deferrals").inc()
                    break
                req = self.queue.pop(0)
                req.ticks_queued += self.tick - req._enqueued_at
                self.slot_req[i] = req
                self._slot_seq[i] = next(self._admit_seq)
                # fresh slot: position 0, pristine cache rows (no leakage
                # from the previous occupant)
                self.slot_pos[i] = 0
                self.cache = _reset_slot(self.cache, self._pristine, self._cache_axes, i)
                # prefill-by-decode: feed prompt tokens one per engine step
                req._prompt_cursor = 1
                self.tokens[i] = req.prompt[0]

    # -- resilience sweeps ----------------------------------------------------
    def _overdue(self, req: Request | None) -> bool:
        return (req is not None and req.deadline_ticks is not None
                and self.tick >= req.deadline_ticks)

    def _sweep_deadlines(self):
        for i, req in enumerate(self.slot_req):
            if self._overdue(req):
                req.error, req.done = "deadline", True
                self._finish(req)
                self.slot_req[i] = None
                self.budget.release(f"r{req.rid}")
                metrics.counter("resilience.serve_deadline_evictions").inc()
        overdue = [r for r in self.queue if self._overdue(r)]
        if overdue:
            self.queue = [r for r in self.queue if not self._overdue(r)]
            for req in overdue:
                req.error, req.done = "deadline", True
                req.ticks_queued += self.tick - req._enqueued_at
                self._finish(req)
                metrics.counter("resilience.serve_deadline_evictions").inc()

    def _evict_poisoned(self, err: Exception):
        """A step failed past its retry budget: evict the most recently
        admitted slot — the request whose arrival changed the batch — and
        requeue it if it has retry budget left, else fail it alone."""
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
        i = max(live, key=lambda j: self._slot_seq[j])
        req = self.slot_req[i]
        self.slot_req[i] = None
        self.budget.release(f"r{req.rid}")
        self._hold_admission = True
        metrics.counter("resilience.serve_evictions").inc()
        escalation.record_degradation(
            "serve", f"evicted rid={req.rid}: {type(err).__name__}: {err}")
        if req.retries_left > 0:
            req.retries_left -= 1
            req.out.clear()  # partial output from the failed run is void
            req._enqueued_at = self.tick
            self.queue.append(req)
        else:
            req.error, req.done = "poisoned", True
            self._finish(req)

    # -- one engine tick ------------------------------------------------------
    def step(self):
        self.tick += 1
        self._sweep_deadlines()
        self._admit()
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not live:
            return False
        # bounded retry with backoff; `self.cache` is reassigned only from a
        # successful call, so a failed step leaves all slot state untouched
        for retry in range(self.step_retries + 1):
            try:
                faults.check_site("serve.step")
                logits, cache = self._step(
                    self.params, self.cache,
                    torch.as_tensor(self.tokens, device=self.device),
                    torch.as_tensor(self.slot_pos, device=self.device),
                )
                break
            except NON_RETRYABLE:
                raise
            except Exception as e:  # noqa: BLE001 — isolate, don't crash
                for i in live:  # the whole batch burns the failed attempt
                    self.slot_req[i].ticks_retrying += 1
                if retry < self.step_retries:
                    metrics.counter("resilience.serve_retries").inc()
                    time.sleep(self.retry_backoff_s * (1 << retry))
                    continue
                self._evict_poisoned(e)
                return True  # the surviving slots run again next tick
        self.cache = cache
        # torch.argmax returns the first maximal index, as np.argmax does
        nxt_all = torch.argmax(logits, dim=-1).tolist()
        for i in live:
            self.slot_pos[i] += 1
            req = self.slot_req[i]
            req.ticks_running += 1
            if req._prompt_cursor < len(req.prompt):  # still prefilling
                self.tokens[i] = req.prompt[req._prompt_cursor]
                req._prompt_cursor += 1
                continue
            nxt = int(nxt_all[i])
            req.out.append(nxt)
            self.tokens[i] = nxt
            if nxt == self.eos_id or len(req.out) >= req.max_tokens \
               or int(self.slot_pos[i]) >= self.max_len - 1:
                req.done = True
                self._finish(req)
                self.slot_req[i] = None  # free slot for continuous batching
                self.budget.release(f"r{req.rid}")
        return True

    def run(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(self.slot_req)) and ticks < max_ticks:
            if not self.step():
                break
            ticks += 1
        return ticks
