"""Logical plan IR + fluent builder for the cost-based query engine.

A logical plan is a tree of frozen dataclass nodes describing *what* to
compute, with no algorithm, pattern, or capacity choices — those are the
optimizer's job (engine.physical). Plans are hashable values, so they can
key plan caches and be compared in tests.

Operators (relational core, enough for the paper's workloads — multi-way
PK-FK / m:n joins, filters, grouped aggregation, top-k):

    Scan(table)                    named base relation in a Catalog
    Filter(child, column, op, v)   elementwise predicate
    Project(child, columns)        column pruning
    Join(left, right, lk, rk)      equi-join; optimizer picks build side
    GroupBy(child, key, aggs)      grouped aggregation
    OrderByLimit(child, key, n)    top-k by one column

Build plans with the fluent API::

    q = (scan("fact")
         .join(scan("dim0"), left_key="fk0", right_key="k0")
         .join(scan("dim1"), left_key="fk1", right_key="k1")
         .group_by("fk0", payload="sum")
         .order_by("payload_sum", limit=10, descending=True))
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Mapping

# single home of the predicate table: validation (here), selectivity
# sampling (stats), and execution (executor) all consume the same ops
FILTER_OP_FNS = {
    "==": operator.eq,
    "!=": operator.ne,
    "<": operator.lt,
    "<=": operator.le,
    ">": operator.gt,
    ">=": operator.ge,
}
FILTER_OPS = tuple(FILTER_OP_FNS)
JOIN_MODES = ("auto", "pk_fk", "mn")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Base node; carries the fluent builder methods."""

    def filter(self, column: str, op: str, value) -> "Filter":
        if op not in FILTER_OPS:
            raise ValueError(f"filter op must be one of {FILTER_OPS}, got {op!r}")
        return Filter(self, column, op, value)

    def project(self, *columns: str) -> "Project":
        return Project(self, tuple(columns))

    def join(self, other: "Plan", *, key: str | None = None,
             left_key: str | None = None, right_key: str | None = None,
             mode: str = "auto") -> "Join":
        if key is not None:
            left_key = right_key = key
        if left_key is None or right_key is None:
            raise ValueError("join needs key= or both left_key=/right_key=")
        if mode not in JOIN_MODES:
            raise ValueError(f"join mode must be one of {JOIN_MODES}")
        return Join(self, other, left_key, right_key, mode)

    def group_by(self, key: str, aggs: Mapping[str, str] | None = None,
                 **agg_kw: str) -> "GroupBy":
        merged = dict(aggs or {})
        merged.update(agg_kw)
        if not merged:
            raise ValueError("group_by needs at least one aggregation")
        return GroupBy(self, key, tuple(sorted(merged.items())))

    def order_by(self, key: str, *, limit: int,
                 descending: bool = False) -> "OrderByLimit":
        return OrderByLimit(self, key, int(limit), descending)

    # -- traversal helpers --------------------------------------------------
    def children(self) -> tuple["Plan", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class Scan(Plan):
    table: str


@dataclasses.dataclass(frozen=True)
class Filter(Plan):
    child: Plan
    column: str
    op: str
    value: float

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Project(Plan):
    child: Plan
    columns: tuple[str, ...]

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Join(Plan):
    left: Plan
    right: Plan
    left_key: str
    right_key: str
    mode: str = "auto"

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class GroupBy(Plan):
    child: Plan
    key: str
    aggs: tuple[tuple[str, str], ...]  # ((column, op), ...) sorted

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class OrderByLimit(Plan):
    child: Plan
    key: str
    limit: int
    descending: bool = False

    def children(self):
        return (self.child,)


def scan(table: str) -> Scan:
    """Entry point of the fluent API."""
    return Scan(table)


# ---------------------------------------------------------------------------
# Schema propagation (column names per node) — used by validation + optimizer
# ---------------------------------------------------------------------------
def output_columns(node: Plan, schemas: Mapping[str, tuple[str, ...]]) -> tuple[str, ...]:
    """Column names produced by `node`, given base-table schemas.

    Raises on references to missing columns and on join payload-name
    collisions, so malformed plans fail at build/optimize time rather than
    mid-execution.
    """
    if isinstance(node, Scan):
        if node.table not in schemas:
            raise KeyError(f"unknown table {node.table!r}")
        return tuple(schemas[node.table])
    if isinstance(node, Filter):
        cols = output_columns(node.child, schemas)
        if node.column not in cols:
            raise KeyError(f"filter column {node.column!r} not in {cols}")
        return cols
    if isinstance(node, Project):
        cols = output_columns(node.child, schemas)
        missing = [c for c in node.columns if c not in cols]
        if missing:
            raise KeyError(f"project columns {missing} not in {cols}")
        return node.columns
    if isinstance(node, Join):
        # Equi-join output keeps BOTH key columns (equal values) so chained
        # joins can reference either name regardless of how the optimizer
        # re-orders the tree; when the names coincide they collapse to one.
        lcols = output_columns(node.left, schemas)
        rcols = output_columns(node.right, schemas)
        if node.left_key not in lcols:
            raise KeyError(f"join key {node.left_key!r} not in left {lcols}")
        if node.right_key not in rcols:
            raise KeyError(f"join key {node.right_key!r} not in right {rcols}")
        shared = set(lcols) & set(rcols)
        allowed = {node.left_key} if node.left_key == node.right_key else set()
        clash = shared - allowed
        if clash:
            raise ValueError(f"join column name collision: {sorted(clash)}")
        return lcols + tuple(c for c in rcols if c not in shared)
    if isinstance(node, GroupBy):
        cols = output_columns(node.child, schemas)
        if node.key not in cols:
            raise KeyError(f"group key {node.key!r} not in {cols}")
        for col, op in node.aggs:
            if col not in cols:
                raise KeyError(f"agg column {col!r} not in {cols}")
        return (node.key,) + tuple(f"{c}_{op}" for c, op in node.aggs)
    if isinstance(node, OrderByLimit):
        cols = output_columns(node.child, schemas)
        if node.key not in cols:
            raise KeyError(f"order key {node.key!r} not in {cols}")
        return cols
    raise TypeError(f"unknown plan node {type(node).__name__}")
