"""The paper's join-sequence star query (§5.2.7, Fig. 16): the fact table
joined to its four dimensions on fk0-fk3, grouped by fk0 with the sum of
dimension 1's payload, the 8 largest sums first.

`plan` builds the logical plan with the engine's `scan`; `reference`
works the answer out again in plain PyTorch from the generated tables,
one row per group, with the sums accumulated in `acc`; `judge`
compares the program's output with it."""
from __future__ import annotations

import torch

from bench import check, refops

JOINS = 4
KEY = "fk0"
ORDER = "p1_0_sum"
LIMIT = 8
READS = (tuple(("fact", f"fk{i}") for i in range(JOINS))
         + tuple((f"dim{i}", f"k{i}") for i in range(JOINS)) + (("dim1", "p1_0"),))

# the numbers compared and their limits: the configuration states exact
# 64-bit integer sums
LIMITS = check.EXACT_LIMITS


def judge(answers: list, groups, ref: dict):
    return check.judge_exact(answers, groups, ref, KEY, ORDER, LIMIT)


def plan(scan):
    q = scan("fact")
    for i in range(JOINS):
        q = q.join(scan(f"dim{i}"), left_key=f"fk{i}", right_key=f"k{i}")
    return q.group_by("fk0", p1_0="sum").order_by("p1_0_sum", limit=LIMIT, descending=True)


def reference(tables: dict, acc: torch.dtype = torch.int64) -> dict:
    fact = tables["fact"]
    keep = torch.ones_like(fact["fk0"], dtype=torch.bool)
    rows = []
    for i in range(JOINS):
        hit, row = refops.unique_key_rows(tables[f"dim{i}"][f"k{i}"], fact[f"fk{i}"])
        keep &= hit
        rows.append(row)
    gk, inv, _ = refops.groups(fact["fk0"][keep])
    p1 = tables["dim1"]["p1_0"][rows[1][keep]]
    return {"fk0": gk, "p1_0_sum": refops.group_sum(inv, gk.numel(), p1, acc).to(torch.int64)}
