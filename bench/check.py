"""Comparisons of a query's output with the plain reference's groups.

A query file (`bench/queries/<query>.py`) states its own numbers and their
limits (`LIMITS`) and its `judge(answers, groups, ref)`; the exact ones
below serve the queries whose configurations state 64-bit integer sums,
the close ones those whose configurations state float sums within a
relative limit of the reference's.

An answer is the query's top rows, largest first by the order column. Ties
at the cut may be broken either way, so an answer row is right when its
key is one of the reference's groups, every column equals that group's
row, no key repeats, and its order value is the reference's i-th largest.
`groups` is the full output of the plan's group node in one more query
through the window's entry after it closed: every group is compared.
"""
from __future__ import annotations

import numpy as np
import torch

# the exact comparison's numbers, each with its limit
EXACT_LIMITS = {"answers_missing": 0, "answers_wrong": 0, "rows_wrong_max": 0,
                "groups_wrong": 0}


def _match(rows: dict, ref: dict, key: str, dev) -> torch.Tensor:
    """Whether each of `rows` (numpy columns) is a group of `ref` (one row
    per group, keys ascending) with every column equal, and is not a
    repeat of an earlier row's key."""
    m = len(rows[key])
    a = {c: torch.from_numpy(np.asarray(rows[c])).to(dev) for c in ref}
    gk = ref[key]
    pos = torch.searchsorted(gk, a[key].to(gk.dtype)).clamp(max=max(gk.numel() - 1, 0))
    ok = (gk[pos] == a[key]) if gk.numel() else torch.zeros(m, dtype=torch.bool, device=dev)
    for c in ref:
        if c != key:
            ok &= ref[c][pos] == a[c].to(ref[c].dtype)
    _, first = np.unique(np.asarray(rows[key]), return_index=True)
    dup = torch.ones(m, dtype=torch.bool, device=dev)
    dup[torch.from_numpy(first).to(dev)] = False
    return ok & ~dup


def rows_wrong(answer: dict, ref: dict, key: str, order: str, limit: int) -> int:
    """Rows of one answer that disagree with the reference, counting rows
    missing or in excess. `ref` holds one row per group, keys ascending, on
    any device; `answer` holds numpy columns."""
    dev = ref[key].device
    top = torch.sort(ref[order], descending=True).values[:limit]
    want = top.numel()
    n = len(answer[key]) if key in answer else 0
    if any(c not in answer for c in ref):
        return max(n, want)
    m = min(n, want)
    ok = _match({c: answer[c][:m] for c in ref}, ref, key, dev)
    ok &= torch.from_numpy(np.asarray(answer[order][:m])).to(dev).to(top.dtype) == top[:m]
    return abs(n - want) + int((~ok).sum())


def groups_wrong(groups: dict | None, ref: dict, key: str) -> int:
    """Groups of the program's full output that are not one of the
    reference's with every column equal (a repeat counts), plus the
    reference's groups that no such row matched. No output: every group."""
    want = ref[key].numel()
    if groups is None or any(c not in groups for c in ref):
        return want + (0 if groups is None or key not in groups else len(groups[key]))
    ok = int(_match(groups, ref, key, ref[key].device).sum())
    return (len(groups[key]) - ok) + (want - ok)


def judge_exact(answers: list, groups: dict | None, ref: dict, key: str, order: str,
                limit: int):
    """(numbers, right): the numbers of EXACT_LIMITS over a window (answers
    that never came, None in `answers`; answers with any wrong row; the most
    wrong rows in one; wrong or missing groups of the full output) and
    whether each answer is right. Identical answers are compared once."""
    seen: dict = {}
    right = []
    missing = worst = 0
    for ans in answers:
        if ans is None:
            missing += 1
            right.append(False)
            continue
        sig = tuple((c, ans[c].dtype.str, ans[c].tobytes()) for c in sorted(ans))
        if sig not in seen:
            seen[sig] = rows_wrong(ans, ref, key, order, limit)
        worst = max(worst, seen[sig])
        right.append(seen[sig] == 0)
    wrong = len(answers) - missing - sum(right)
    return ({"answers_missing": missing, "answers_wrong": wrong, "rows_wrong_max": worst,
             "groups_wrong": groups_wrong(groups, ref, key)}, right)


def _match_close(rows: dict, ref: dict, key: str, rel: dict, dev):
    """(ok, err): whether each of `rows` (numpy columns) is a group of `ref`
    (one row per group, keys ascending) whose columns in `rel` lie within
    that relative limit of the group's and whose other columns are equal,
    and is not a repeat of an earlier row's key; and each row's largest
    relative gap over the columns in `rel` (0 where its key is no group)."""
    m = len(rows[key])
    err = torch.zeros(m, dtype=torch.float64, device=dev)
    gk = ref[key]
    if not gk.numel():
        return torch.zeros(m, dtype=torch.bool, device=dev), err
    a = {c: torch.from_numpy(np.asarray(rows[c])).to(dev) for c in ref}
    pos = torch.searchsorted(gk, a[key].to(gk.dtype)).clamp(max=gk.numel() - 1)
    hit = gk[pos] == a[key]
    ok = hit.clone()
    for c in ref:
        if c == key:
            continue
        want = ref[c][pos]
        if c in rel:
            gap = rel_gap(a[c].to(torch.float64), want.to(torch.float64))
            ok &= gap <= rel[c]
            err = torch.maximum(err, torch.where(hit, gap, 0.0))
        else:
            ok &= want == a[c].to(ref[c].dtype)
    _, first = np.unique(np.asarray(rows[key]), return_index=True)
    dup = torch.ones(m, dtype=torch.bool, device=dev)
    dup[torch.from_numpy(first).to(dev)] = False
    return ok & ~dup, err


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| / |want| in float64; a gap that is not a finite number
    reads as float64's largest."""
    big = torch.finfo(torch.float64).max
    gap = (got - want).abs() / want.abs().clamp_min(torch.finfo(torch.float64).tiny)
    return torch.nan_to_num(gap, nan=big, posinf=big)


def rows_wrong_close(answer: dict, ref: dict, key: str, order: str, limit: int,
                     rel: dict) -> int:
    """`rows_wrong` with the columns of `rel` compared within their relative
    limits: the order column against the reference's i-th largest, so near
    ties at the cut may fall either way."""
    dev = ref[key].device
    top = torch.sort(ref[order], descending=True).values[:limit]
    want = top.numel()
    n = len(answer[key]) if key in answer else 0
    if any(c not in answer for c in ref):
        return max(n, want)
    m = min(n, want)
    ok, _ = _match_close({c: answer[c][:m] for c in ref}, ref, key, rel, dev)
    got = torch.from_numpy(np.asarray(answer[order][:m])).to(dev).to(torch.float64)
    ok &= rel_gap(got, top[:m].to(torch.float64)) <= rel.get(order, 0.0)
    return abs(n - want) + int((~ok).sum())


def groups_close(groups: dict | None, ref: dict, key: str, rel: dict) -> tuple[int, float]:
    """(wrong, gap): `groups_wrong` with the columns of `rel` compared
    within their relative limits, and the largest relative gap of those
    columns over every group of the reference: 1 for a group the output
    lacks, whose value reads as 0."""
    want = ref[key].numel()
    if groups is None or any(c not in groups for c in ref):
        extra = 0 if groups is None or key not in groups else len(groups[key])
        return want + extra, 1.0 if want else 0.0
    dev = ref[key].device
    ok, err = _match_close(groups, ref, key, rel, dev)
    n_ok = int(ok.sum())
    found = torch.from_numpy(np.asarray(groups[key])).to(dev).to(ref[key].dtype)
    lacks = bool((~torch.isin(ref[key], found)).any())
    gap = max(float(err.max()) if err.numel() else 0.0, 1.0 if lacks else 0.0)
    return (len(groups[key]) - n_ok) + (want - n_ok), gap


def judge_close(answers: list, groups: dict | None, ref: dict, key: str, order: str,
                limit: int, rel: dict):
    """(numbers, right): `judge_exact`'s numbers with the columns of `rel`
    compared within their relative limits, and `rel_err_max`, the largest
    relative gap of those columns over the full group output. Identical
    answers are compared once."""
    seen: dict = {}
    right = []
    missing = worst = 0
    for ans in answers:
        if ans is None:
            missing += 1
            right.append(False)
            continue
        sig = tuple((c, ans[c].dtype.str, ans[c].tobytes()) for c in sorted(ans))
        if sig not in seen:
            seen[sig] = rows_wrong_close(ans, ref, key, order, limit, rel)
        worst = max(worst, seen[sig])
        right.append(seen[sig] == 0)
    wrong = len(answers) - missing - sum(right)
    g_wrong, gap = groups_close(groups, ref, key, rel)
    return ({"answers_missing": missing, "answers_wrong": wrong, "rows_wrong_max": worst,
             "groups_wrong": g_wrong, "rel_err_max": gap}, right)


def within_limits(numbers: dict, limits: dict) -> bool:
    """Every number of `limits` present and at or under its limit."""
    return all(k in numbers and numbers[k] <= v for k, v in limits.items())
