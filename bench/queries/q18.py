"""TPC-H Q18's join and group-by: lineitem joined to orders on the order
key, grouped by it (sum of s1, max of r1, count of r2), the 100 largest
sums first, Q18's LIMIT 100.

`plan` builds the logical plan with the engine's `scan`; `reference`
works the answer out again in plain PyTorch from the generated tables,
one row per group, with the sums accumulated in `acc`; `judge`
compares the program's output with it."""
from __future__ import annotations

import torch

from bench import check, refops

KEY = "k"
ORDER = "s1_sum"
LIMIT = 100
# (table, column) that the query must read
READS = (("lineitem", "k"), ("lineitem", "s1"), ("orders", "k"), ("orders", "r1"))

# the numbers compared and their limits: the configuration states exact
# 64-bit integer sums
LIMITS = check.EXACT_LIMITS


def judge(answers: list, groups, ref: dict):
    return check.judge_exact(answers, groups, ref, KEY, ORDER, LIMIT)


def plan(scan):
    return (scan("lineitem").join(scan("orders"), key="k")
            .group_by("k", s1="sum", r1="max", r2="count")
            .order_by("s1_sum", limit=LIMIT, descending=True))


def reference(tables: dict, acc: torch.dtype = torch.int64) -> dict:
    li, od = tables["lineitem"], tables["orders"]
    hit, row = refops.unique_key_rows(od["k"], li["k"])
    k = li["k"][hit]
    gk, inv, cnt = refops.groups(k)
    g = gk.numel()
    return {
        "k": gk,
        "s1_sum": refops.group_sum(inv, g, li["s1"][hit], acc).to(torch.int64),
        "r1_max": refops.group_max(inv, g, od["r1"][row[hit]]),
        "r2_count": cnt.to(torch.int64),
    }
