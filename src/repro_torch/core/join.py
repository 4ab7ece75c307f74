"""Unified join API.

`join()` dispatches on (algorithm, pattern):
    algorithm: "phj" (ported) | "smj" | "nphj" (still to port)
    pattern:   "gftr" (optimized materialization, *-OM)
             | "gfur" (unoptimized, *-UM)
"""
from __future__ import annotations

from .hash_join import phj_join
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
    Returns (Table, valid_count). PHJ-OM = (phj, gftr), PHJ-UM = (phj, gfur)."""
    if algorithm == "phj":
        return phj_join(R, S, key=key, pattern=pattern, out_size=out_size, mode=mode, **kw)
    if algorithm in ALGORITHMS:
        raise NotImplementedError(f"join algorithm {algorithm!r} is not ported yet; "
                                  "use algorithm='phj'")
    raise ValueError(f"unknown algorithm {algorithm!r}")


def by_name(name: str):
    """'PHJ-OM' -> kwargs for join()."""
    alg, mat = name.lower().split("-")
    return dict(algorithm=alg, pattern={"om": "gftr", "um": "gfur"}[mat])
