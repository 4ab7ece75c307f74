"""Unified join API and join sequences (paper §5.2.7).

`join()` dispatches on (algorithm, pattern):
    algorithm: "smj" | "phj" | "nphj"
    pattern:   "gftr" (optimized materialization, *-OM)
             | "gfur" (unoptimized, *-UM)

`join_sequence()` is the paper's N-way star-join driver: a fact table
F(FK_1..FK_N, payloads) joined against dimension tables D_i(K_i, P_i),
fetching FK_{i+1} through the accumulated fact tuple IDs right before join
i+1, so that no foreign key is materialized before it is needed (§5.2.7).
"""
from __future__ import annotations

import torch

from . import primitives as prim
from .hash_join import phj_join
from .nphj import nphj_join
from .sort_merge import smj_join
from .table import Table

ALGORITHMS = ("smj", "phj", "nphj")
PATTERNS = ("gftr", "gfur")


def join(
    R: Table,
    S: Table,
    *,
    key: str = "k",
    algorithm: str = "phj",
    pattern: str = "gftr",
    out_size: int | None = None,
    mode: str = "pk_fk",
    **kw,
):
    """Inner equi-join of R (build / PK side) and S (probe / FK side).
    Returns (Table, valid_count). Shorthand names from the paper: SMJ-UM =
    (smj, gfur), SMJ-OM = (smj, gftr), PHJ-UM = (phj, gfur), PHJ-OM = (phj,
    gftr); NPHJ has one materialization and pk_fk mode only. mode="mn"
    allows duplicate build keys; its out_size defaults to 2 * S.num_rows."""
    if algorithm == "smj":
        return smj_join(R, S, key=key, pattern=pattern, out_size=out_size, mode=mode, **kw)
    if algorithm == "phj":
        return phj_join(R, S, key=key, pattern=pattern, out_size=out_size, mode=mode, **kw)
    if algorithm == "nphj":
        if mode != "pk_fk":
            raise ValueError("nphj baseline supports pk_fk only")
        return nphj_join(R, S, key=key, out_size=out_size, **kw)
    raise ValueError(f"unknown algorithm {algorithm!r}")


def by_name(name: str):
    """'PHJ-OM' -> kwargs for join()."""
    alg, mat = name.lower().split("-")
    return dict(algorithm=alg, pattern={"om": "gftr", "um": "gfur"}[mat])


def join_sequence(
    fact: Table,
    dims: list[Table],
    *,
    fk_cols: list[str],
    dim_keys: list[str],
    algorithm: str = "phj",
    pattern: str = "gftr",
    out_size: int | None = None,
    restore_order: bool = False,
    keep_ids: bool = False,
):
    """A sequence of N PK-FK joins (paper Fig. 16). Returns (Table,
    valid_count of the last join).

    fact holds fk_cols; dims[i] has key dim_keys[i] plus payload columns.
    Join i materializes dims[i]'s payloads into the running result; FK_i is
    fetched through the fact tuple IDs right before it. restore_order=True
    sorts the result by fact row ID (every algorithm then gives the same
    rows in the same order); keep_ids=True keeps the `_fact_id` column."""
    n = fact.num_rows
    out_size = out_size or n
    # the running state: tuple IDs into the fact table + materialized payloads
    acc = Table({"_fact_id": torch.arange(n, dtype=torch.int32, device=fact.device)})
    count = None
    for dim, fk, dk in zip(dims, fk_cols, dim_keys):
        probe = acc.with_columns(**{dk: prim.gather(fact[fk], acc["_fact_id"], fill=-1)})
        joined, count = join(dim, probe, key=dk, algorithm=algorithm, pattern=pattern,
                             out_size=out_size)
        acc = joined.drop([dk])
    if restore_order:
        ids = acc["_fact_id"]
        acc = acc.take(prim.argsort_stable(torch.where(ids >= 0, ids, n)))
    # the fact table's other columns, by tuple ID
    result = acc.with_columns(**{c: prim.gather(fact[c], acc["_fact_id"], fill=0)
                                 for c in fact.column_names if c not in fk_cols})
    if not keep_ids:
        result = result.drop(["_fact_id"])
    return result, count
