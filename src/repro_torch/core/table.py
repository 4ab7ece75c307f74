"""Columnar Table of equal-length tensors.

Relations are stored column-wise, one tensor per column on one device.
Data-dependent results (join and group-by outputs) keep the reference's
static-capacity contract: (Table-with-capacity, valid_count), where rows at
index >= valid_count are padding and carry sentinel keys, so that outputs
compare row for row with the JAX package.

`table_from_numpy` / `table_to_numpy` carry a relation across: the same
numpy dict feeds this package and the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping

import numpy as np
import torch

from ..kernels.common import KEY_SENTINEL

__all__ = ["KEY_SENTINEL", "Table", "concat_tables", "nonempty", "table_from_dict",
           "table_from_numpy", "table_to_numpy"]


@dataclasses.dataclass
class Table:
    """An ordered collection of named, equal-length columns."""

    columns: dict[str, torch.Tensor]

    def __post_init__(self):
        if not self.columns:
            raise ValueError("Table needs at least one column")
        lengths = {k: v.shape[0] for k, v in self.columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged columns: {lengths}")

    @property
    def num_rows(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def column_names(self) -> tuple[str, ...]:
        return tuple(self.columns)

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __iter__(self) -> Iterator[str]:
        return iter(self.columns)

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.columns.values())

    def with_columns(self, **cols: torch.Tensor) -> "Table":
        return Table({**self.columns, **cols})

    def select(self, names) -> "Table":
        return Table({n: self.columns[n] for n in names})

    def drop(self, names) -> "Table":
        names = set(names)
        return Table({n: v for n, v in self.columns.items() if n not in names})

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(n, n): v for n, v in self.columns.items()})

    def take(self, idx: torch.Tensor) -> "Table":
        """Row gather out[i] = self[clip(idx[i])], as the reference's
        `take(mode="clip")`."""
        safe = idx.clamp(0, max(self.num_rows - 1, 0))
        return Table({n: v[safe] for n, v in self.columns.items()})

    def head(self, n: int) -> "Table":
        return Table({k: v[:n] for k, v in self.columns.items()})

    def pad_to(self, n: int, fill=0) -> "Table":
        cur = self.num_rows
        if cur >= n:
            return self.head(n)
        return Table({k: torch.cat([v, v.new_full((n - cur,) + tuple(v.shape[1:]), fill)])
                      for k, v in self.columns.items()})

    def __repr__(self):
        cols = ", ".join(f"{n}:{v.dtype}{list(v.shape)}" for n, v in self.columns.items())
        return f"Table({cols})"


def table_from_numpy(cols: Mapping[str, np.ndarray], device="cuda") -> Table:
    """A Table on `device` (the card unless the caller asks for another)
    holding copies of the numpy columns, dtypes kept."""
    return Table({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in cols.items()})


def table_from_dict(d: Mapping[str, torch.Tensor | np.ndarray], device=None) -> Table:
    """A Table of the given columns: tensors stay where they are (or move to
    `device` when it is given); numpy arrays go to `device`, the card unless
    the caller asks for another."""
    def col(v):
        if isinstance(v, torch.Tensor):
            return v if device is None else v.to(device)
        return torch.from_numpy(np.ascontiguousarray(v)).to(device or "cuda")

    return Table({k: col(v) for k, v in d.items()})


def table_to_numpy(table: Table) -> dict[str, np.ndarray]:
    """Inverse of `table_from_numpy`."""
    return {k: v.cpu().numpy() for k, v in table.columns.items()}


def concat_tables(tables: list[Table]) -> Table:
    names = tables[0].column_names
    return Table({n: torch.cat([t[n] for t in tables]) for n in names})


def nonempty(table: Table, key: str) -> Table:
    """Substitute one all-sentinel row for a zero-row relation: the sentinel
    key is dropped by every probe, build and aggregate, so results equal the
    true empty input while every intermediate keeps a non-empty shape."""
    if table.num_rows:
        return table
    return Table({n: torch.full((1,), KEY_SENTINEL if n == key else 0, dtype=c.dtype,
                                device=c.device)
                  for n, c in table.columns.items()})
