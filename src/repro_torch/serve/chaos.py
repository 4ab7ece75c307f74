"""Chaos/soak harness for the query-serving runtime (DESIGN.md §14): the
port's counterpart of the JAX package's `serve.chaos`.

`python -m repro_torch.serve --chaos` drives hundreds of mixed queries —
PK-FK joins, grouped aggregations, fused group-joins, and filter+top-k over
`data/relgen.py` workloads — through a `QueryServer` on one device, once
without faults and once per fault family:

  baseline    no faults. Every request must complete on the fast path;
              its canonicalized result becomes the query's oracle (spot
              cross-checked against independent one-shot engine runs),
              and its warm latencies become the p50/p95/p99 + throughput
              baseline of the scoreboard.
  overflow    `overflow:phj@0` on every join-shaped query (the first two
              also fail their fast attempt via `raise:qserve.execute@0`,
              tripping the breaker): quarantined joins must climb the phj
              escalation ladder on the safe path and still match their
              oracles; the half-open probe must close the breaker.
  raise       `raise:qserve.execute` (every occurrence) on the first four
              group-by-shaped queries: they must fail ALONE (fast and
              safe), open the breaker, and the clean remainder must
              recover through the half-open probe back to the fast path.
  estimates   `estimates:/32` on every group-by-shaped query: the first
              one plans the signature with 32x-too-small cardinalities,
              poisoning the cached plan. Saturation detection must catch
              the silent truncation, the safe path must escalate
              `degrade_plan` levels until results fit, and every result
              must still match its oracle.

The JAX package's fourth family, `pallas:*` (every Pallas arm down, XLA
fallbacks), has no counterpart: the port's kernels have no fallback arm,
and `pallas:` specs fire nowhere (NO_PALLAS_FAMILY).

After each fault pass the harness asserts the blast radius: failures
confined to the faulted signature, every untargeted request fast-path and
oracle-identical (zero contamination), untargeted warm p99 within 2x of
the fault-free baseline (judged on the card only: on a CPU that other
processes share, a request's wall time measures its neighbours, so there
the p99s are recorded and not held to the bound), and the `qserve.*` / `resilience.*` counter
deltas consistent with the injected faults (a fault family that fires
nothing is a broken family). A final pressure pass pins the admission
machinery: exact shed counts at a full queue, exact deadline evictions,
and cost-based rejection under a tiny `max_price_s`.

A memory pass then pins the byte-budget governor: big splittable queries
(a wide-filter shape whose peak scales with the morsel axis) served under
a budget below their whole-plan peak must complete via the morsel-driven
out-of-core path bit-identical to their fault-free oracles, an injected
`oom:executor.run@0` must recover through the chunked fallback, reserved
bytes must never exceed the budget, standard queries must stay untouched
on the fast path, and a never-fitting unsplittable query must be rejected
with a typed error — not a crash.

All chaos payloads are integers, so canonicalized results (sorted valid
rows over sorted columns) are bit-identical across every execution
strategy a breaker or ladder can pick.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.table import table_from_numpy
from ..data import relgen
from ..engine import executor
from ..engine import stats as S
from ..engine.logical import scan
from ..engine.physical import optimize
from ..obs import metrics
from .query import QueryRequest, QueryServer, pad_table, plan_signature

SHAPES = ("join", "groupby", "groupjoin", "topk")
FAMILIES = ("overflow", "raise", "estimates")
FAMILY_TARGETS = {"overflow": "join", "raise": "groupby", "estimates": "groupby"}
FAMILY_SPECS = {
    # (spec for the first `breaker_threshold` targeted queries,
    #  spec for the rest). `raise:qserve.execute@0` fails only the fast
    # attempt, so the combined spec exercises the ladder via the safe
    # fallback AND trips the breaker.
    "overflow": ("raise:qserve.execute@0,overflow:phj@0", "overflow:phj@0"),
    "raise": ("raise:qserve.execute", ""),
    "estimates": ("estimates:/32", "estimates:/32"),
}
# Why the JAX package's fourth family has no counterpart here.
NO_PALLAS_FAMILY = (
    "the 'pallas' family cannot fire in the port: `pallas:` fault specs parse but "
    "fire nowhere, because a kernel that fails is never answered by a plain arm "
    "(it surfaces as a KernelError); families are " + "/".join(FAMILIES))
RAISE_FAULTED = 4  # hard-faulted queries in the raise family

# plan constants (fixed per shape — a shape is ONE signature; only the
# dataset sizes vary, inside one capacity bucket)
PLANS = {
    "join": scan("S").join(scan("R"), key="k"),
    "groupby": scan("S").group_by("k", s1="sum"),
    "groupjoin": scan("fact").join(scan("dim0"), left_key="fk0",
                                   right_key="k0").group_by("fk0",
                                                            payload="sum"),
    "topk": scan("S").filter("s1", "<", 1 << 30).order_by("s1", limit=32),
}


def canon(table, count):
    """Valid rows, order- and shape-insensitive (integer payloads)."""
    n = int(count)
    cols = sorted(table.column_names)
    mats = [table[c][:n].cpu().numpy() for c in cols]
    return tuple(cols), sorted(zip(*[m.tolist() for m in mats]))


@dataclasses.dataclass
class ChaosQuery:
    qid: int
    shape: str
    plan: object
    tables: dict
    oracle: object = None  # canonicalized fault-free result


def _make_tables(shape: str, rng: np.random.Generator, device) -> dict:
    """One dataset for `shape` on `device`, sized inside the shape's
    capacity bucket (so every query of a shape lands on ONE plan signature,
    and valid counts never equal a bucket — saturation stays a truncation
    signal). The same numpy data as the JAX package's for the same seed."""
    seed = int(rng.integers(0, 2**31 - 1))
    if shape == "join":
        n_r, n_s = int(rng.integers(300, 480)), int(rng.integers(1100, 1900))
        R, Stab = relgen.generate(relgen.JoinWorkload(
            "cj", n_r, n_s, 1, 1, seed=seed))
        tables = {"R": R, "S": Stab}
    elif shape in ("groupby", "topk"):
        # sparse group keys (domain 5000 >> distinct): the shape whose
        # capacities hinge on the distinct-count estimate
        n_s = int(rng.integers(1100, 1900))
        _, Stab = relgen.generate(relgen.JoinWorkload(
            "cg", 5000, n_s, 1, 1, seed=seed))
        tables = {"S": Stab}
    else:
        n_fact, n_dim = int(rng.integers(600, 1000)), int(rng.integers(70, 120))
        fact, dims, _, _ = relgen.generate_star(n_fact, n_dim, 1, seed=seed)
        tables = {"fact": fact, "dim0": dims[0]}
    return {n: table_from_numpy(t, device) for n, t in tables.items()}


def build_mix(n_queries: int, seed: int = 0, device="cuda") -> list:
    rng = np.random.default_rng(seed)
    return [ChaosQuery(qid=i, shape=SHAPES[i % len(SHAPES)],
                       plan=PLANS[SHAPES[i % len(SHAPES)]],
                       tables=_make_tables(SHAPES[i % len(SHAPES)], rng, device))
            for i in range(n_queries)]


def _counter_window():
    names = [n for n, m in metrics.REGISTRY._metrics.items()
             if isinstance(m, metrics.Counter)]
    return {n: metrics.counter(n).value for n in names}


def _counter_delta(before: dict) -> dict:
    after = _counter_window()
    keys = set(before) | set(after)
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in sorted(keys)
            if after.get(k, 0) != before.get(k, 0)}


def _drive(queries, fault_for=None, submit_per_tick: int = 4,
           server_kw: dict | None = None, device="cuda"):
    """One soak pass: fresh server, `submit_per_tick` arrivals per tick,
    step until drained. Returns (server, requests, counter_deltas,
    wall_s)."""
    before = _counter_window()
    kw = dict(measure_profile=True, breaker_cooldown=5, device=device)
    kw.update(server_kw or {})
    server = QueryServer(**kw)
    reqs = []
    t0 = time.perf_counter()
    i = 0
    while i < len(queries) or server.queue or server.deferred:
        for _ in range(submit_per_tick):
            if i < len(queries):
                q = queries[i]
                spec = fault_for(q) if fault_for else ""
                req = QueryRequest(qid=q.qid, plan=q.plan, tables=q.tables,
                                   fault_spec=spec)
                server.submit(req)
                reqs.append(req)
                i += 1
        server.step()
    return server, reqs, _counter_delta(before), time.perf_counter() - t0


def _warm_walls(reqs) -> dict:
    """Per-shape-signature exec wall times EXCLUDING each signature's
    first completed run (which pays the first use of its operators)."""
    seen: set = set()
    walls: dict[str, list] = {}
    for req in reqs:
        if not req.done or req.error or req.result is None:
            continue
        if req.signature not in seen:
            seen.add(req.signature)
            continue
        walls.setdefault(req.signature, []).append(req.exec_wall_s)
    return walls


def run_chaos(queries_per_family: int = 200, seed: int = 0,
              smoke: bool = False, families=FAMILIES, device="cuda") -> dict:
    """The soak on `device` (the card unless the caller asks for another).
    Asking for the JAX package's 'pallas' family raises ValueError: it
    cannot fire here (NO_PALLAS_FAMILY). The p99 confinement checks judge
    latency on a CUDA device only (`config.latency_judged`)."""
    families = tuple(families)
    latency_judged = str(device).startswith("cuda")
    if "pallas" in families:
        raise ValueError(NO_PALLAS_FAMILY)
    unknown = [f for f in families if f not in FAMILY_TARGETS]
    if unknown:
        raise ValueError(f"unknown chaos families {unknown}; allowed: {'/'.join(FAMILIES)}")
    if smoke:
        queries_per_family = min(queries_per_family, 48)
    failures: list[str] = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    queries = build_mix(queries_per_family, seed=seed, device=device)
    by_shape = {s: [q for q in queries if q.shape == s] for s in SHAPES}

    # ---- baseline: fault-free oracles + latency/throughput floor --------
    server, reqs, delta, wall = _drive(queries, device=device)
    req_by_qid = {r.qid: r for r in reqs}
    sig_of_shape: dict[str, str] = {}
    for q in queries:
        req = req_by_qid[q.qid]
        check(req.done and not req.error,
              f"baseline.q{q.qid}: {req.error or 'not done'}")
        check(req.path == "fast", f"baseline.q{q.qid}: path={req.path}")
        if req.result is not None:
            q.oracle = canon(*req.result)
        sig_of_shape[q.shape] = req.signature
    check(delta.get("qserve.failed", 0) == 0, "baseline.failed_nonzero")
    check(delta.get("qserve.saturations", 0) == 0,
          "baseline.saturations_nonzero")
    # spot-check oracles against independent one-shot engine runs
    for s in SHAPES:
        q = by_shape[s][0]
        one_shot = optimize(q.plan, S.Catalog(q.tables),
                            measure_profile=True).run()
        check(q.oracle == canon(*one_shot), f"baseline.oracle_mismatch.{s}")

    walls = _warm_walls(reqs)
    all_walls = [w for ws in walls.values() for w in ws]
    base_p = metrics.percentiles(all_walls, (50, 95, 99))
    base_shape_p99 = {s: metrics.percentiles(walls.get(sig_of_shape[s], []),
                                             (99,))["p99"] for s in SHAPES}
    baseline = {
        "queries": len(queries), "wall_s": wall,
        "throughput_qps": len(queries) / wall if wall else 0.0,
        "p50_s": base_p["p50"], "p95_s": base_p["p95"],
        "p99_s": base_p["p99"],
        "per_shape_p99_s": base_shape_p99,
        "plans_compiled": delta.get("qserve.plans_compiled", 0),
        "plan_cache_hits": delta.get("qserve.plan_cache_hits", 0),
        "counters": delta,
    }
    check(baseline["plans_compiled"] == len(SHAPES),
          f"baseline.compiles={baseline['plans_compiled']} != {len(SHAPES)}")
    # whole-plan audited peaks per standard signature (sized under the
    # default — effectively unbounded — budget), for the memory pass
    standard_peaks = {sig: e.peak_bytes for sig, e in server.cache.items()}

    # ---- fault families -------------------------------------------------
    family_reports = {}
    for family in families:
        target = FAMILY_TARGETS[family]
        first_spec, rest_spec = FAMILY_SPECS[family]
        n_first = RAISE_FAULTED if family == "raise" else 2
        seen_targets = {"n": 0}

        def fault_for(q, _target=target, _first=first_spec, _rest=rest_spec,
                      _n_first=n_first, _seen=seen_targets):
            if q.shape != _target:
                return ""
            _seen["n"] += 1
            return _first if _seen["n"] <= _n_first else _rest

        server, reqs, delta, wall = _drive(queries, fault_for=fault_for, device=device)
        req_by_qid = {r.qid: r for r in reqs}
        target_qids = [q.qid for q in by_shape[target]]
        expect_failed = ([q.qid for q in by_shape[target][:RAISE_FAULTED]]
                         if family == "raise" else [])

        wrong = contaminated = 0
        for q in queries:
            req = req_by_qid[q.qid]
            if q.qid in expect_failed:
                check(req.error == "failed",
                      f"{family}.q{q.qid}: expected failed, got "
                      f"{req.error or req.path}")
                continue
            if not (req.done and not req.error and req.result is not None):
                check(False, f"{family}.q{q.qid}: {req.error or 'not done'} "
                             f"{req.detail}")
                continue
            if canon(*req.result) != q.oracle:
                wrong += 1
            if q.shape != target and (req.path != "fast" or req.escalations):
                contaminated += 1
        check(wrong == 0, f"{family}.wrong_results={wrong}")
        check(contaminated == 0, f"{family}.contaminated={contaminated}")
        check(delta.get("qserve.failed", 0) == len(expect_failed),
              f"{family}.failed={delta.get('qserve.failed', 0)} != "
              f"{len(expect_failed)}")
        check(delta.get("qserve.shed", 0) == 0, f"{family}.shed_nonzero")
        check(delta.get("resilience.faults_fired", 0) > 0,
              f"{family}.no_faults_fired")

        # family-specific counter consistency
        if family == "overflow":
            check(delta.get("resilience.ladder_escalations", 0) > 0,
                  "overflow.no_ladder_escalations")
            check(delta.get("qserve.breaker_opens", 0) >= 1,
                  "overflow.breaker_never_opened")
            check(delta.get("qserve.breaker_closes", 0) >= 1,
                  "overflow.breaker_never_closed")
        elif family == "raise":
            check(delta.get("qserve.breaker_opens", 0) >= 1,
                  "raise.breaker_never_opened")
            check(delta.get("qserve.breaker_closes", 0) >= 1,
                  "raise.breaker_never_closed")
            br = server.breakers.get(sig_of_shape[target])
            check(br is not None and br.state == "closed",
                  "raise.breaker_not_recovered")
        elif family == "estimates":
            check(delta.get("qserve.saturations", 0) > 0,
                  "estimates.no_saturations")
            check(delta.get("qserve.safe_escalations", 0) > 0,
                  "estimates.no_safe_escalations")
            check(delta.get("qserve.breaker_opens", 0) >= 1,
                  "estimates.breaker_never_opened")

        # blast radius: untargeted signatures' warm p99 within 2x baseline
        walls = _warm_walls(reqs)
        confinement = {}
        for s in SHAPES:
            if s == target:
                continue
            p99 = metrics.percentiles(walls.get(sig_of_shape[s], []),
                                      (99,))["p99"]
            base = base_shape_p99[s]
            confinement[s] = {"p99_s": p99, "baseline_p99_s": base}
            check(not latency_judged or p99 <= max(2 * base, base + 0.010),
                  f"{family}.p99_blowup.{s}: {p99:.4f}s vs base {base:.4f}s")

        family_reports[family] = {
            "queries": len(queries), "target_shape": target,
            "targeted": len(target_qids), "wall_s": wall,
            "expected_failed": len(expect_failed),
            "wrong_results": wrong, "contaminated": contaminated,
            "confinement": confinement, "counters": delta,
        }

    # ---- pressure: shedding / deadlines / admission pricing -------------
    pq = by_shape["join"][0]  # one signature, 14 simultaneous arrivals
    before = _counter_window()
    server = QueryServer(measure_profile=True, max_queue=8,
                         slots_per_tick=2, device=device)
    press_reqs = [QueryRequest(qid=1000 + j, plan=pq.plan, tables=pq.tables,
                               # the first two expire on the very tick they
                               # would be admitted: sweep-before-admit
                               # must evict, not run, them
                               deadline_ticks=1 if j < 2 else None)
                  for j in range(14)]
    for req in press_reqs:
        server.submit(req)
    server.run()
    shed = sum(r.error == "shed" for r in press_reqs)
    dead = sum(r.error == "deadline" for r in press_reqs)
    done = sum(bool(r.result is not None and not r.error)
               for r in press_reqs)
    check(shed == 6, f"pressure.shed={shed} != 6")  # 14 arrivals, queue of 8
    check(dead == 2, f"pressure.deadline={dead} != 2")
    check(done == 6, f"pressure.completed={done} != 6")
    priced = QueryServer(measure_profile=True, max_price_s=1e-12, device=device)
    rej = [QueryRequest(qid=2000 + j, plan=pq.plan, tables=pq.tables)
           for j in range(2)]
    for req in rej:
        priced.submit(req)
    priced.run()
    check(all(r.error == "rejected" for r in rej), "pressure.not_rejected")
    pressure = {"shed": shed, "deadline": dead, "completed": done,
                "rejected": sum(r.error == "rejected" for r in rej),
                "counters": _counter_delta(before)}

    # ---- memory: byte budget, morsel out-of-core fallback, oom faults ---
    # The big splittable shape is a wide multi-column filter: its audited
    # peak scales linearly with the morsel axis. (Join-shaped plans carry
    # a probe-size-independent hash-build structure, so at chaos scale
    # they cannot shrink their peak much by chunking the probe side.)
    before = _counter_window()
    rngm = np.random.default_rng(seed + 7)
    big_plan = scan("B").filter("c0", "<", 60)
    big_qs = []
    # sized so budget = 0.6 * whole-peak clears every standard shape's
    # whole-plan peak (~17 MiB, dominated by the fixed PHJ build side)
    for j in range(3):
        cols = {f"c{c}": rngm.integers(0, 100, 250_000).astype(np.int32)
                for c in range(48)}
        big_qs.append(ChaosQuery(qid=3000 + j, shape="bigfilter", plan=big_plan,
                                 tables={"B": table_from_numpy(cols, device)}))
    # size the big shape with the same machinery admission uses
    _, bucketsB = plan_signature(big_plan, big_qs[0].tables)
    paddedB = {n: pad_table(t, bucketsB[n])
               for n, t in big_qs[0].tables.items()}
    physB = optimize(big_plan, S.Catalog(paddedB), measure_profile=True)
    big_whole = executor.plan_peak_bytes(
        physB, paddedB,
        counts={n: t.num_rows for n, t in big_qs[0].tables.items()})
    budget = int(big_whole * 0.6)  # big must chunk; standard must fit
    max_standard = max(standard_peaks.values())
    check(budget > int(1.05 * max_standard),
          f"memory.budget_too_small: budget={budget} vs "
          f"standard peak {max_standard}")
    for q in big_qs:
        q.oracle = canon(*optimize(q.plan, S.Catalog(q.tables),
                                   measure_profile=True).run())
    # one join query in its OWN capacity bucket (S outside the standard
    # 2048 bucket) gets an injected oom on its fast attempt: it must
    # recover through the chunked fallback without perturbing the cached
    # morsel factor of the standard join signature
    seedo = int(np.random.default_rng(seed + 13).integers(0, 2**31 - 1))
    R2, S2 = relgen.generate(relgen.JoinWorkload("cm", 350, 2500, 1, 1,
                                                 seed=seedo))
    oomq = ChaosQuery(qid=3100, shape="join", plan=PLANS["join"],
                      tables={"R": table_from_numpy(R2, device),
                              "S": table_from_numpy(S2, device)})
    oomq.oracle = canon(*optimize(oomq.plan, S.Catalog(oomq.tables),
                                  measure_profile=True).run())

    mem_queries = list(queries)
    for pos, bq in zip((5, 17, 29), big_qs):
        mem_queries.insert(min(pos, len(mem_queries)), bq)
    mem_queries.append(oomq)

    def mem_fault(q):
        return "oom:executor.run@0" if q.qid == oomq.qid else ""

    server, reqs, _, wall = _drive(
        mem_queries, fault_for=mem_fault,
        server_kw=dict(mem_budget_bytes=budget), device=device)
    req_by_qid = {r.qid: r for r in reqs}
    wrong = contaminated = 0
    for q in mem_queries:
        req = req_by_qid[q.qid]
        if not (req.done and not req.error and req.result is not None):
            check(False, f"memory.q{q.qid}: {req.error or 'not done'} "
                         f"{req.detail}")
            continue
        if canon(*req.result) != q.oracle:
            wrong += 1
        if q.qid < 3000 and (req.path != "fast" or req.morsels != 1
                             or req.escalations):
            contaminated += 1
    check(wrong == 0, f"memory.wrong_results={wrong}")
    check(contaminated == 0, f"memory.contaminated={contaminated}")
    for bq in big_qs:
        check(req_by_qid[bq.qid].morsels >= 2,
              f"memory.q{bq.qid}.not_chunked "
              f"(morsels={req_by_qid[bq.qid].morsels})")
    # the injected oom is caught INSIDE executor.run, which degrades the
    # plan onto its morsel rung before the server ever sees a failure:
    # the request stays fast-path, the engine counters record the rescue
    check(req_by_qid[oomq.qid].path == "fast",
          f"memory.oom_query_path={req_by_qid[oomq.qid].path}")
    check(server.budget.peak_reserved <= server.budget.total,
          f"memory.reserved_over_budget: {server.budget.peak_reserved} > "
          f"{server.budget.total}")
    check(server.budget.reserved == 0, "memory.reservations_leaked")

    # blast radius: standard signatures' warm p99 within 2x baseline
    walls = _warm_walls(reqs)
    mem_confinement = {}
    for s in SHAPES:
        p99 = metrics.percentiles(walls.get(sig_of_shape[s], []),
                                  (99,))["p99"]
        base = base_shape_p99[s]
        mem_confinement[s] = {"p99_s": p99, "baseline_p99_s": base}
        check(not latency_judged or p99 <= max(2 * base, base + 0.010),
              f"memory.p99_blowup.{s}: {p99:.4f}s vs base {base:.4f}s")

    # a never-fitting unsplittable shape (top-k root has no morsel axis)
    # must be REJECTED with the typed error, not crash the server
    tq = by_shape["topk"][0]
    rej_server = QueryServer(measure_profile=True, mem_budget_bytes=4096, device=device)
    rej_req = QueryRequest(qid=3200, plan=tq.plan, tables=tq.tables)
    rej_server.submit(rej_req)
    rej_server.run()
    check(rej_req.error == "rejected",
          f"memory.unsplittable_not_rejected: {rej_req.error}")
    check("MemoryBudgetExceeded" in (rej_req.detail or ""),
          f"memory.reject_detail: {rej_req.detail}")

    mem_delta = _counter_delta(before)
    check(mem_delta.get("qserve.chunked_runs", 0) >= 3,
          f"memory.chunked_runs={mem_delta.get('qserve.chunked_runs', 0)}")
    check(mem_delta.get("qserve.mem_rejections", 0) >= 1,
          "memory.no_mem_rejections")
    check(mem_delta.get("resilience.oom_injected", 0) >= 1,
          "memory.oom_never_fired")
    check(mem_delta.get("resilience.plan_degradations", 0) >= 1,
          "memory.oom_not_rescued_by_morsel_rung")
    memory_report = {
        "budget_bytes": budget, "big_whole_peak_bytes": big_whole,
        "max_standard_peak_bytes": max_standard,
        "big_morsels": [req_by_qid[bq.qid].morsels for bq in big_qs],
        "chunked_runs": mem_delta.get("qserve.chunked_runs", 0),
        "mem_deferrals": mem_delta.get("qserve.mem_deferrals", 0),
        "mem_rejections": mem_delta.get("qserve.mem_rejections", 0),
        "oom_injected": mem_delta.get("resilience.oom_injected", 0),
        "reserved_le_budget": bool(server.budget.peak_reserved
                                   <= server.budget.total),
        "peak_reserved_bytes": server.budget.peak_reserved,
        "wrong_results": wrong, "contaminated": contaminated,
        "confinement": mem_confinement, "wall_s": wall,
        "counters": mem_delta,
    }

    return {
        "ok": not failures, "failures": failures,
        "config": {"queries_per_family": queries_per_family, "seed": seed,
                   "smoke": smoke, "shapes": list(SHAPES),
                   "families": list(families), "device": str(device),
                   "latency_judged": latency_judged},
        "baseline": baseline, "families": family_reports,
        "pressure": pressure, "memory": memory_report,
    }
