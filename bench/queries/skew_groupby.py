"""A group-by over Zipf-skewed keys: the facts table grouped by `k`, the
sum of its float32 `v` and the count of each group, the 100 largest sums
first.

`plan` builds the logical plan with the engine's `scan`; `reference`
works the answer out again in plain PyTorch from the generated tables,
one row per group, keys ascending, the sums accumulated in `acc` and
returned in float64, the counts in int64; `judge` compares the program's
output with it."""
from __future__ import annotations

import torch

from bench import check, refops

KEY = "k"
ORDER = "v_sum"
LIMIT = 100
READS = (("facts", "k"), ("facts", "v"))
# the control's accumulator: one precision below the float32 sums that the
# configuration states
NARROW = torch.bfloat16

# The largest relative gap of a group's float32 sum from the float64
# reference, the limit that a configuration of this query states. The
# program sums each key's run by a segmented scan that doubles its stride
# each step (`ops.RunSums`): for values >= 0 its error is at most ceil(log2 L) * 2^-24
# of the sum of a run of L rows, 1.5e-6 for key 0's ~23M rows (L < 2^25),
# 1.55e-6 where 256-row tiles are summed first and their partials then
# (8 + 18 steps). On an H100 at 60M rows of keys (zipf(1.5) - 1) mod 4096
# and values in [0, 1), on 3 seeds, float32 sums read 2.9e-5 to 5.9e-5 added
# one row after another, 3.6e-5 to 9.2e-5 by `index_add_`, and 1.5e-7 at most
# by `torch.sum` (a tree) over the 64 largest groups; a bfloat16
# accumulation reads 0.99998. A dropped row changes an exact count.
SUM_REL_ERR_MAX = 1e-5
LIMITS = {**check.EXACT_LIMITS, "sum_rel_err_max": SUM_REL_ERR_MAX}


def judge(answers: list, groups, ref: dict):
    numbers, right = check.judge_close(answers, groups, ref, KEY, ORDER, LIMIT,
                                       {ORDER: SUM_REL_ERR_MAX})
    numbers["sum_rel_err_max"] = numbers.pop("rel_err_max")
    return numbers, right


def plan(scan):
    return (scan("facts").group_by("k", v="sum", k="count")
            .order_by("v_sum", limit=LIMIT, descending=True))


def reference(tables: dict, acc: torch.dtype = torch.float64) -> dict:
    facts = tables["facts"]
    gk, inv, cnt = refops.groups(facts["k"])
    return {
        "k": gk,
        "v_sum": refops.group_sum(inv, gk.numel(), facts["v"], acc).to(torch.float64),
        "k_count": cnt.to(torch.int64),
    }
