"""Plain PyTorch relational steps for the queries' references: a lookup of
unique keys, and grouping. They import nothing of the program under test
and run on whatever device holds the tables."""
from __future__ import annotations

import torch


def unique_key_rows(build_keys: torch.Tensor, probe_keys: torch.Tensor):
    """(hit, row): for each probe key, whether the build keys hold it and
    the build row that does. Raises if the build keys are not unique, since
    an equi-join would then repeat probe rows."""
    order = torch.argsort(build_keys, stable=True)
    sk = build_keys[order]
    if sk.numel() > 1 and not bool((sk[1:] > sk[:-1]).all()):
        raise ValueError("the build side's keys are not unique")
    if sk.numel() == 0:
        return torch.zeros_like(probe_keys, dtype=torch.bool), torch.zeros_like(order[:0])
    pos = torch.searchsorted(sk, probe_keys).clamp(max=sk.numel() - 1)
    return sk[pos] == probe_keys, order[pos]


def groups(keys: torch.Tensor):
    """(group keys ascending, each row's group, rows per group)."""
    gk, inv, cnt = torch.unique(keys, sorted=True, return_inverse=True, return_counts=True)
    return gk, inv, cnt


def group_sum(inv: torch.Tensor, n_groups: int, values: torch.Tensor,
              acc: torch.dtype) -> torch.Tensor:
    """Per-group sums of `values`, accumulated in `acc`."""
    out = torch.zeros(n_groups, dtype=acc, device=values.device)
    return out.index_add_(0, inv, values.to(acc))


def group_max(inv: torch.Tensor, n_groups: int, values: torch.Tensor) -> torch.Tensor:
    out = torch.full((n_groups,), torch.iinfo(values.dtype).min, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, inv, values, "amax")


def top_rows(table: dict, order: str, limit: int) -> dict:
    """The first `limit` rows of `table` by `order`, largest first."""
    idx = torch.argsort(table[order], descending=True, stable=True)[:limit]
    return {c: v[idx] for c, v in table.items()}
