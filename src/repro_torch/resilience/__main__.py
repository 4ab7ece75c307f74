"""`python -m repro_torch.resilience --smoke` — fault-injection smoke gate:
the port's counterpart of `python -m repro.resilience --smoke`.

Exercises the resilience layers under deterministic faults (DESIGN.md §13)
and exits non-zero if any degraded run diverges from its fault-free oracle:

  ladders  — one forced overflow at attempt 0 per escalation ladder
             (phj, groupjoin, groupby_partition): the ladder must
             escalate, converge, and reproduce the oracle's valid rows;
  engine   — `raise:executor.run@0` forces one executor failure: the
             degrade-once re-plan must reproduce the oracle;
  memory   — `oom:executor.run@0` forces one allocation failure: the
             executor must degrade onto the MORSEL rung (out-of-core
             chunked execution, DESIGN.md §15) and reproduce the oracle.

The JAX package's `kernels` section (`pallas:*` forces every Pallas arm
down and each dispatch falls back to its XLA arm) has no counterpart: a
failure of one of the port's kernels is a `KernelError`, which no arm
catches and the executor never degrades around. The report says so.

Escalated knobs change row order (partition bits) and padded shape
(accumulator capacity), never the multiset of valid rows — so runs are
compared as canonicalized valid rows: sorted tuples over sorted columns.

The smoke also asserts the `resilience.*` counters moved: a smoke that
passes without firing any fault is a broken smoke.

Usage: python -m repro_torch.resilience --smoke [--device cuda|cpu]

The tables live on `--device` (default: the card). Without a card the
command exits 1 unless `--device cpu` is given; it never falls back to the
CPU by itself.
"""
from __future__ import annotations

import json
import sys

import numpy as np

NO_KERNELS_SECTION = (
    "no counterpart: the port's kernels have no fallback arm; a failing kernel is a "
    "KernelError that reaches the caller and is never degraded around")


def _canon(table, count):
    """Valid rows, order- and shape-insensitive: sorted row tuples over
    sorted column names (all smoke payloads are integer-valued)."""
    n = int(count)
    cols = sorted(table.column_names)
    mats = [table[c][:n].cpu().numpy() for c in cols]
    return tuple(cols), sorted(zip(*[m.tolist() for m in mats]))


def _check(name, oracle, got, failures):
    if oracle == got:
        return {"case": name, "ok": True}
    failures.append(name)
    return {"case": name, "ok": False}


def smoke(device: str = "cuda") -> int:
    from ..core import table_from_numpy
    from ..core.groupby import groupby_partition_checked
    from ..core.groupjoin import groupjoin_checked
    from ..core.hash_join import phj_join_checked
    from ..data import relgen
    from ..engine import Catalog, optimize, scan
    from ..obs import metrics
    from . import faults

    rng = np.random.default_rng(7)
    R = table_from_numpy({"k": np.arange(512, dtype=np.int32),
                          "v": rng.integers(0, 100, 512).astype(np.int32)}, device)
    S = table_from_numpy({"k": rng.integers(0, 512, 2048).astype(np.int32),
                          "w": rng.integers(0, 9, 2048).astype(np.int32)}, device)

    failures: list[str] = []
    cases = []

    # -- ladders: forced overflow at attempt 0, one per ladder --------------
    oracle = _canon(*phj_join_checked(R, S, key="k"))
    with faults.inject("overflow:phj@0"):
        out, rep = phj_join_checked(R, S, key="k", with_report=True)
    entry = _check("ladder.phj", oracle, _canon(*out), failures)
    entry.update(escalated=rep.escalated, attempts=len(rep.attempts))
    cases.append(entry)

    gj_kw = dict(key="k", group_key="k", aggs={"w": "sum"}, num_groups=512)
    oracle = _canon(*groupjoin_checked(R, S, **gj_kw))
    with faults.inject("overflow:groupjoin@0"):
        out, rep = groupjoin_checked(R, S, with_report=True, **gj_kw)
    entry = _check("ladder.groupjoin", oracle, _canon(*out), failures)
    entry.update(escalated=rep.escalated, attempts=len(rep.attempts))
    cases.append(entry)

    gb_kw = dict(key="k", aggs={"w": "sum"}, num_groups=512)
    oracle = _canon(*groupby_partition_checked(S, **gb_kw))
    with faults.inject("overflow:groupby_partition@0"):
        out, rep = groupby_partition_checked(S, with_report=True, **gb_kw)
    entry = _check("ladder.groupby_partition", oracle, _canon(*out), failures)
    entry.update(escalated=rep.escalated, attempts=len(rep.attempts))
    cases.append(entry)

    # -- engine: one forced executor failure, degrade-once re-plan ----------
    w = relgen.JoinWorkload("t", 1000, 4000, 2, 1, match_ratio=1.0)
    er, es = relgen.generate(w)
    cat = Catalog({"R": table_from_numpy(er, device), "S": table_from_numpy(es, device)})
    q = scan("R").join(scan("S"), key="k").group_by("k", s1="sum")
    oracle = _canon(*optimize(q, cat, measure_profile=False).run())
    plan = optimize(q, cat, measure_profile=False)
    with faults.inject("raise:executor.run@0"):
        got = _canon(*plan.run())
    entry = _check("engine.degrade_once", oracle, got, failures)
    entry["degraded"] = bool(plan.degraded_plan is not None
                             and plan.degraded_plan.degraded)
    if not entry["degraded"]:
        failures.append("engine.no_degradation")
    cases.append(entry)

    # -- memory: one forced oom, degrade onto the morsel rung ---------------
    plan2 = optimize(q, cat, measure_profile=False)
    with faults.inject("oom:executor.run@0"):
        got = _canon(*plan2.run())
    entry = _check("engine.oom_morsel_rung", oracle, got, failures)
    entry["morsel_factor"] = (plan2.degraded_plan.morsel_factor
                              if plan2.degraded_plan is not None else 0)
    if entry["morsel_factor"] < 2:
        failures.append("engine.oom_no_morsel_degradation")
    cases.append(entry)

    snap = {k: v for k, v in sorted(metrics.snapshot().items())
            if k.startswith("resilience.")}
    for name in ("resilience.ladder_escalations",
                 "resilience.plan_degradations",
                 "resilience.oom_injected",
                 "resilience.faults_fired"):
        if not snap.get(name):
            failures.append(f"counter_zero.{name}")

    result = {"ok": not failures, "failures": failures, "cases": cases,
              "kernels": NO_KERNELS_SECTION, "device": str(device), "metrics": snap}
    print(json.dumps(result, indent=2, sort_keys=True))
    return 0 if not failures else 1


def main(argv: list[str]) -> int:
    if "--smoke" not in argv:
        print(__doc__)
        return 0 if argv in ([], ["--help"]) else 2
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        return 1
    return smoke(device)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
