"""`python -m repro_torch.analysis` — audit one run of every production entry
point against its priced contract and write ANALYSIS.json. Non-zero exit on
any contract violation: the check that the plan that ran is the plan the
cost model priced (DESIGN.md §11). The port's counterpart of
`python -m repro.analysis`, without its kernel lint (not ported yet).

Sections:
  operators — phj/smj/nphj joins (both materialization patterns, and the
              m:n modes), all five group-by strategies, the group-join on
              the engine's arm, and the partition and sort planners;
  engine    — optimizer-chosen physical plans (join + group-by as chosen
              and with fusion forced off, a filtered top-k, Q18 over a J2
              extract with 8-byte payloads), audited node by node via
              executor.audit.

Usage: python -m repro_torch.analysis [--device cuda|cpu] [--out ANALYSIS.json]

The tables live on `--device` (default: the card). Without a card the
command exits 1 unless `--device cpu` is given; it never falls back to the
CPU by itself.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np

from . import contracts as C
from .dispatch_audit import audit


def _operator_entries(device: str):
    """(name, fn, args, contract) for every core operator entry point, at
    small shapes: the op counts of these runs are the counts at any scale
    (pass counts are pinned by the same bit-widths the planner uses)."""
    import torch

    from ..core import group_aggregate, join, phj_groupjoin, table_from_numpy
    from ..core import primitives as prim

    rng = np.random.default_rng(0)
    n_r, n_s, n_groups = 512, 2048, 64
    R = table_from_numpy({"k": rng.permutation(n_r).astype(np.int32),
                          "rv": rng.integers(0, 100, n_r).astype(np.int32)}, device)
    S = table_from_numpy({"k": rng.integers(0, n_r, n_s).astype(np.int32),
                          "g": rng.integers(0, n_groups, n_s).astype(np.int32),
                          "sv": rng.integers(0, 100, n_s).astype(np.int32)}, device)
    G = table_from_numpy({"k": S["g"].cpu().numpy(),
                          "v": rng.normal(size=n_s).astype(np.float32)}, device)
    keys = S["k"]
    digits = torch.from_numpy(rng.integers(0, 16, n_s).astype(np.int32)).to(device)
    aggs = {"v": "sum"}

    entries = []
    for alg in ("phj", "smj", "nphj"):
        for pattern in ("gftr", "gfur"):
            if alg == "nphj" and pattern == "gfur":
                continue  # nphj has a single materialization pattern
            fn = functools.partial(join, key="k", algorithm=alg, pattern=pattern,
                                   out_size=n_s, mode="pk_fk")
            entries.append((f"join/{alg}/{pattern}/pk_fk", fn, (R, S),
                            C.join_contract(alg, pattern)))
    for alg in ("phj", "smj"):
        entries.append((
            f"join/{alg}/gftr/mn",
            functools.partial(join, key="k", algorithm=alg, pattern="gftr",
                              out_size=2 * n_s, mode="mn"),
            (R, S), C.join_contract(alg, "gftr", "mn")))

    for strategy in ("sort", "partition", "partition_hash", "scatter", "sort_pallas"):
        fn = functools.partial(group_aggregate, key="k", aggs=aggs,
                               num_groups=2 * n_groups, strategy=strategy)
        entries.append((f"groupby/{strategy}", fn, (G,),
                        C.groupby_contract(strategy, len(aggs))))

    for strategy in ("sort", "scatter"):
        # the engine's arm: the probe feeds the accumulator (fused=False)
        fn = functools.partial(phj_groupjoin, key="k", group_key="g",
                               aggs={"rv": "sum", "sv": "mean"},
                               num_groups=2 * n_groups, agg_strategy=strategy,
                               fused=False)
        entries.append((f"groupjoin/phj+{strategy}", fn, (R, S),
                        C.groupjoin_contract(strategy, 2)))

    entries.append((
        "primitives/partition_plan",
        functools.partial(prim.plan_partition_permutation, num_partitions=16),
        (digits,), C.partition_plan_contract()))
    entries.append((
        "primitives/sort_plan",
        prim.plan_sort_permutation, (keys,),
        C.OperatorContract(name="sort_plan", max_sorts=1, max_float_scatter_adds=0)))
    return entries


def _engine_plans(device: str):
    """Optimizer-chosen plans across the chooser's branches: a join +
    group-by (as chosen and with fusion forced off), a filtered top-k, and
    TPC-H Q18 over a J2 extract with its 8-byte payloads."""
    from ..core import table_from_numpy
    from ..data.relgen import generate_tpc
    from ..engine import Catalog, optimize, scan

    rng = np.random.default_rng(1)
    n_r, n_s = 512, 4096
    R = {"k": rng.permutation(n_r).astype(np.int32),
         "rv": rng.integers(0, 100, n_r).astype(np.int32)}
    S = {"k": rng.integers(0, n_r, n_s).astype(np.int32),
         "g": rng.integers(0, 64, n_s).astype(np.int32),
         "sv": rng.integers(0, 100, n_s).astype(np.int32)}
    cat = Catalog({"R": table_from_numpy(R, device), "S": table_from_numpy(S, device)})

    plans = []
    q = scan("S").join(scan("R"), key="k").group_by("g", rv="sum", sv="mean")
    plans.append(("engine/join_groupby", optimize(q, cat, measure_profile=False)))
    plans.append(("engine/forced_unfused",
                  optimize(q, cat, measure_profile=False, force_join=("phj", "gftr"))))
    q2 = (scan("S").filter("sv", ">", 50).join(scan("R"), key="k")
          .group_by("g", sv="sum")
          .order_by("sv_sum", limit=8, descending=True))
    plans.append(("engine/filtered_topk", optimize(q2, cat, measure_profile=False)))
    Rn, Sn, _ = generate_tpc("J2", scale=1 / 4096, payload_bytes=8, seed=0)
    q18 = (scan("lineitem").join(scan("orders"), key="k")
           .group_by("k", s1="sum", r1="max", r2="count"))
    j2 = Catalog({"orders": table_from_numpy(Rn, device),
                  "lineitem": table_from_numpy(Sn, device)})
    plans.append(("engine/q18_int64", optimize(q18, j2, measure_profile=False)))
    return plans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="ANALYSIS.json")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        return 1
    device = str(device)

    report = {"device": device, "operators": {}, "engine": {}}
    n_violations = 0

    print("== operators ==")
    for name, fn, fargs, contract in _operator_entries(device):
        rep = audit(fn, *fargs)
        violations = C.check(contract, rep)
        n_violations += len(violations)
        status = "VIOLATION" if violations else "ok"
        print(f"{name}: ran[{rep.budget.describe() or 'none'}] "
              f"priced[{contract.describe()}] "
              f"peak-live={rep.peak_live_bytes/1024:.0f}KiB {status}")
        for v in violations:
            print(f"  {type(v).__name__}: {v}")
        entry = rep.as_dict()
        entry["contract"] = contract.describe()
        entry["violations"] = [f"{type(v).__name__}: {v}" for v in violations]
        report["operators"][name] = entry

    print("== engine ==")
    from ..engine import executor

    for name, plan in _engine_plans(device):
        plan_audit = executor.audit(plan)
        n_violations += len(plan_audit.violations)
        status = "VIOLATION" if plan_audit.violations else "ok"
        root = plan_audit.root_report
        print(f"{name}: ran[{root.budget.describe() or 'none'}] "
              f"peak-live={root.peak_live_bytes/1024:.0f}KiB "
              f"nodes={len(plan_audit.entries)} {status}")
        for v in plan_audit.violations:
            print(f"  {type(v).__name__}: {v}")
        report["engine"][name] = plan_audit.as_dict()

    report["summary"] = {"violations": n_violations}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(f"wrote {args.out}: {n_violations} violation(s)")
    return 1 if n_violations else 0


if __name__ == "__main__":
    sys.exit(main())
