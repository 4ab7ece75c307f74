"""One run of one cell: set-up, the window, the answer check, the metrics.

`run_cell` does all of it on a device it is given; `bench/run.py` looks for
the card and calls it. A run with `trace` set profiles the window, counts
the partition and gather kernels' bytes around their launches, takes the
plan's per-node spans after the window, and reports the per-layer metrics;
otherwise it reports the end-to-end ones. The forbidden modules are looked
for once everything of the run has been loaded: the reference, the check
and every metric reader.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch

from . import check, datagen, devtrace, loop, registry, roofline, spans

# top-level modules that may not be loaded in the process that reports
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    setup_s: float
    window_s: float
    queries: list  # loop.Query of the window, in order of submission
    right: list  # whether each query's answer was right
    peak_bytes: int
    launches: dict | None = None  # kernel -> launches in the window (traced run)
    launch_bytes: dict | None = None  # kernel -> [bytes of each launch] (traced run)
    device: devtrace.DeviceTrace | None = None  # the window's device trace (traced run)
    spans: list | None = None  # per-node spans after the window (traced run)
    compulsory_bytes: int = 0  # bytes one query must move (roofline)

    @property
    def answered(self) -> int:
        """Right answers in the window."""
        return sum(self.right)

    @property
    def completed(self) -> int:
        """Queries of the window whose answer returned."""
        return sum(1 for q in self.queries if q.answer is not None)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def refuse_forbidden() -> None:
    """Ends the process, naming them, where forbidden modules are loaded."""
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"modules of the JAX package or JAX are loaded: {bad}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _entry(parts: dict, tables: dict, device):
    """The entry the traffic drives, ready for the window."""
    from repro_torch.core.table import Table
    from repro_torch.engine import Catalog, optimize, scan

    logical = parts["query"].plan(scan)
    program_tables = {name: Table(dict(cols)) for name, cols in tables.items()}
    traffic = parts["traffic"]
    if traffic["entry"] == "server":
        from repro_torch.serve import QueryServer

        server = QueryServer(device=device, **traffic.get("server", {}))
        return loop.ServerEntry(server, logical, program_tables)
    if traffic["entry"] == "executor":
        plan = optimize(logical, Catalog(program_tables), measure_profile=False)
        return loop.ExecutorEntry(plan, program_tables)
    raise ValueError(f"unknown entry {traffic['entry']!r}")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(parts: dict, seed: int, seconds: float, trace: bool, device, *,
             t_start: float, late_s: float = loop.LATE_S, root=registry.ROOT,
             make_entry=_entry) -> dict:
    """One run. Returns {"result": the result line's dict, "checks": the
    numbers compared with their limits, "silent": the names of the cell's
    metrics that read nothing}. `make_entry(parts, tables, device)` makes
    what the window drives."""
    from repro_torch.kernels import ops

    query, config, traffic = parts["query"], parts["config"], parts["traffic"]
    cuda = torch.device(device).type == "cuda"
    kind = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: registry.load_metric(m["name"], root) for m in parts[kind]}
    captures: dict = {}
    for reader in readers.values():
        for kernel, what in getattr(reader, "CAPTURE", {}).items():
            if captures.setdefault(kernel, what) != what:
                raise ValueError(f"two metrics capture {kernel!r} differently")
    log(f"set-up: {time.perf_counter() - t_start:.3f} s to the first table")
    tables = datagen.make_tables(config, seed, device)
    _sync(device)
    log(f"set-up: {time.perf_counter() - t_start:.3f} s to the tables drawn "
        f"({datagen.table_bytes(tables) / 1e9:.3f} GB)")
    entry = make_entry(parts, tables, device)
    loop.warm_up(entry, traffic)
    plan = entry.plan()[0]
    print(f"plan ({config['name']}, seed {seed}):\n"
          f"{plan.explain() if plan is not None else 'none'}", flush=True)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up: {setup_s:.3f} s to the window, warm-up done")

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    prof = launch_bytes = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        with roofline.capture_launch_bytes(captures) as launch_bytes, prof:
            queries, window_s = loop.run_window(entry, traffic, seconds, late_s)
    else:
        queries, window_s = loop.run_window(entry, traffic, seconds, late_s)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = Context(setup_s=setup_s, window_s=window_s, queries=queries, right=[],
                  peak_bytes=peak)
    answers = [q.answer for q in queries]
    if trace:
        ctx.launches = ops.launch_counts()
        ctx.launch_bytes = launch_bytes
        t0 = time.perf_counter()
        ctx.device = devtrace.reduce_profile(prof)
        log(f"trace reduced in {time.perf_counter() - t0:.3f} s")
        del prof
        ctx.spans = spans.node_spans(*entry.plan())
        answer_bytes = next((sum(v.nbytes for v in a.values()) for a in answers if a), 0)
        ctx.compulsory_bytes = roofline.compulsory_bytes(tables, query.READS, answer_bytes)
    # one more query through the same entry: its group node's full output
    t0 = time.perf_counter()
    groups = entry.groups(late_s)
    log(f"group output of one more query: {time.perf_counter() - t0:.3f} s")

    # the program's state goes before the reference runs; the reference
    # draws the same tables again from the seed
    del entry, plan, tables
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = query.reference(datagen.make_tables(config, seed, device))
    numbers, ctx.right = query.judge(answers, groups, ref)
    del ref, groups
    log(f"reference and check: {time.perf_counter() - t0:.3f} s")

    failed = sum(1 for q in queries if q.error)
    for q in queries:
        if q.error:
            log(f"failed query: {q.error}")
    metrics, silent = {}, []
    for name, reader in readers.items():
        value = reader.read(ctx)
        if value is None:
            log(f"metric {name} read nothing")
            silent.append(name)
            continue
        metrics[name] = {"value": value, "unit": _unit(parts[kind], name)}
    # an end-to-end metric that reads nothing (no answer came) fails the run
    correct = (check.within_limits(numbers, query.LIMITS) and failed == 0
               and (trace or not silent))
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace and ctx.device is not None:
        dev["busy_s"] = ctx.device.busy_s
        dev["window_s"] = ctx.device.window_s
    result = {"correct": correct, "attempted": len(queries), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and ctx.device is not None:
        result["breakdown"] = ctx.device.breakdown()
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in query.LIMITS.items()}
    result["checks"] = checks
    refuse_forbidden()
    return {"result": result, "checks": checks, "silent": silent}


def _unit(entries: list, name: str) -> str:
    return next(m["unit"] for m in entries if m["name"] == name)
