"""The one general traffic generator: offers a cell's queries to the
program for a window, as its traffic file says, and records every answer
with its latency.

A traffic file names the entry the window drives and the loop:

  "entry": "server"     QueryServer.submit / step (`server` holds keyword
                        arguments for QueryServer beside `device`)
  "entry": "executor"   executor.run on a plan optimized once in set-up
  "loop": "closed"      `clients` callers; each sends its next query when
                        its answer returns
  "loop": "open"        `rate_per_s` queries a second, in bursts of `burst`
                        due at once, whatever is still in flight
  "warmup_per_client"   queries per client (per burst slot when open)
                        answered before the window

An answer returns when the host holds it: its count synchronized and its
rows copied off the device. A query's latency runs from when it was due
(its submission in a closed loop, its scheduled time in an open one) to
that moment.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import traceback

import torch

# how long past the window's close an answer is waited for
LATE_S = 60.0


def fetch(result) -> dict:
    """Bring an answer to the host: (Table, count) -> {column: numpy}."""
    table, count = result
    n = int(count)
    return {c: table[c][:n].cpu().numpy() for c in table.column_names}


@dataclasses.dataclass
class Query:
    due: float  # host clock when the query was due
    answer: dict | None = None
    done: float | None = None  # host clock when its answer returned
    error: str = ""

    @property
    def latency_s(self) -> float | None:
        return None if self.done is None else self.done - self.due


class ServerEntry:
    """Queries through QueryServer.submit and step."""

    def __init__(self, server, logical, tables):
        from repro_torch.serve import QueryRequest

        self._request = QueryRequest
        self.server, self.logical, self.tables = server, logical, tables
        self.inflight: dict[int, Query] = {}
        self.seen = 0
        self.qid = 0

    def submit(self, q: Query) -> None:
        req = self._request(qid=self.qid, plan=self.logical, tables=dict(self.tables))
        self.inflight[self.qid] = q
        self.qid += 1
        self.server.submit(req)

    def poll(self) -> list[Query]:
        """One server tick; the queries it finished, answers fetched."""
        with torch.profiler.record_function("bench.step"):
            self.server.step()
        out = []
        done = self.server.completed
        for req in done[self.seen:]:
            q = self.inflight.pop(req.qid)
            if req.error:
                q.error = f"{req.error}: {req.detail}"
            else:
                with torch.profiler.record_function("bench.fetch"):
                    q.answer = fetch(req.result)
                req.result = None
            q.done = time.perf_counter()
            out.append(q)
        self.seen = len(done)
        return out

    def plan(self):
        """The cached physical plan, its padded tables and their counts: what
        the window ran."""
        from repro_torch.serve.query import pad_table

        entry = next(iter(self.server.cache.values()))
        padded = {n: pad_table(t, entry.buckets[n]) for n, t in self.tables.items()}
        return entry.plan, padded, {n: t.num_rows for n, t in self.tables.items()}

    def groups(self, late_s: float):
        return one_more_query_groups(self, late_s)


class ExecutorEntry:
    """Queries through executor.run on one plan, one at a time."""

    def __init__(self, plan, tables):
        self.physical, self.tables = plan, tables
        self.queue: list[Query] = []

    def submit(self, q: Query) -> None:
        self.queue.append(q)

    def poll(self) -> list[Query]:
        from repro_torch.engine import executor

        q = self.queue.pop(0)
        try:
            with torch.profiler.record_function("bench.run"):
                result = executor.run(self.physical, self.tables)
            with torch.profiler.record_function("bench.fetch"):
                q.answer = fetch(result)
        except Exception as e:  # noqa: BLE001 - a failed query is recorded, not fatal
            traceback.print_exc(file=sys.stderr)
            q.error = f"{type(e).__name__}: {e}"
        q.done = time.perf_counter()
        return [q]

    def plan(self):
        return self.physical, self.tables, None

    def groups(self, late_s: float):
        return one_more_query_groups(self, late_s)


def group_node(root):
    """The plan's group node: the order-by's input, or the root itself."""
    from repro_torch.engine import physical as P

    return root.child if isinstance(root, P.POrderByLimit) else root


@contextlib.contextmanager
def keep_output(node):
    """Within the block, every output of `node` the executor produces is
    appended to the yielded list, its valid rows on the host."""
    from repro_torch.engine import executor

    orig = executor.execute
    kept: list[dict] = []

    def execute(n, tables, counts=None):
        out = orig(n, tables, counts)
        if n is node:
            kept.append(fetch(out))
        return out

    executor.execute = execute
    try:
        yield kept
    finally:
        executor.execute = orig


def one_more_query_groups(entry, late_s: float) -> dict | None:
    """One more query through the window's entry, after the window: the
    full output of its plan's group node, valid rows on the host; None
    where the query failed or its answer did not come within `late_s`."""
    plan = entry.plan()[0]
    q = Query(due=time.perf_counter())
    with keep_output(group_node(plan.root)) as kept:
        entry.submit(q)
        end = q.due + late_s
        while q.done is None and time.perf_counter() < end:
            entry.poll()
    return kept[-1] if kept and q.answer is not None else None


def warm_up(entry, traffic: dict) -> None:
    """Answer `warmup_per_client` rounds of queries before the window."""
    slots = traffic.get("clients", traffic.get("burst", 1))
    for i in range(traffic.get("warmup_per_client", 0)):
        t0 = time.perf_counter()
        pending = slots
        for _ in range(slots):
            entry.submit(Query(due=time.perf_counter()))
        while pending:
            for q in entry.poll():
                pending -= 1
                if q.error:
                    raise RuntimeError(f"a warm-up query failed: {q.error}")
        print(f"warm-up round {i}: {slots} queries in {time.perf_counter() - t0:.3f} s",
              file=sys.stderr, flush=True)


def run_window(entry, traffic: dict, seconds: float,
               late_s: float = LATE_S) -> tuple[list[Query], float]:
    """Offer queries for `seconds`, then wait up to `late_s` for what is in
    flight. Returns every query due in the window and the window's length:
    from its start to the last answer (to the wait's end, where an answer
    never came)."""
    loop = traffic["loop"]
    queries: list[Query] = []
    t0 = time.perf_counter()
    end = t0 + seconds
    outstanding = 0

    def send(due):
        nonlocal outstanding
        q = Query(due=due)
        queries.append(q)
        outstanding += 1
        entry.submit(q)

    if loop == "closed":
        for _ in range(int(traffic["clients"])):
            send(time.perf_counter())
    elif loop == "open":
        burst = int(traffic.get("burst", 1))
        every = burst / float(traffic["rate_per_s"])
        next_due = t0
    else:
        raise ValueError(f"unknown loop {loop!r}")
    last = t0
    with torch.profiler.record_function("bench.window"):
        while True:
            now = time.perf_counter()
            if loop == "open":
                while next_due < end and next_due <= now:
                    for _ in range(burst):
                        send(next_due)
                    next_due += every
                if not outstanding:
                    if next_due >= end:
                        break
                    time.sleep(max(next_due - time.perf_counter(), 0.0))
                    continue
            elif not outstanding:
                break
            if now > end + late_s:
                break
            for q in entry.poll():
                outstanding -= 1
                last = q.done
                if loop == "closed" and q.done < end:
                    send(time.perf_counter())
    return queries, (time.perf_counter() if outstanding else last) - t0
