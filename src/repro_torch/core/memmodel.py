"""Analytic peak-memory model for GFUR vs GFTR (paper §4.4, Tables 1-2).

Units: M_c = bytes of one column (n rows x itemsize), M_t = transform
scratch. The model reproduces the paper's phase-by-phase ledger and its
conclusion: GFTR's peak is never higher than GFUR's, so the optimized
pattern does not shrink the solvable problem size.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MemLedger:
    phase: str
    activity: str
    alloc_on_entry: float
    free_on_exit: float
    used_after_exit: float
    peak: float


def gfur_ledger(mt: float = 1.0, mc: float = 1.0) -> list[MemLedger]:
    """Table 1 (in units of M_c, with M_t scratch)."""
    return [
        MemLedger("transform", "init ID_R, transform R'",
                  mt + 3 * mc, mt + mc, 2 * mc, mt + 3 * mc),
        MemLedger("transform", "init ID_S, transform S'",
                  mt + 3 * mc, mt + mc, 4 * mc, mt + 5 * mc),
        MemLedger("find", "write matching IDs", 2 * mc, 4 * mc, 2 * mc, 6 * mc),
        MemLedger("materialize", "materialize payloads", 0.0, 2 * mc, 0.0, 2 * mc),
    ]


def gftr_ledger(mt: float = 1.0, mc: float = 1.0) -> list[MemLedger]:
    """Table 2."""
    return [
        MemLedger("transform", "(R) keys w/ one non-key", mt + 2 * mc, mt, 2 * mc, mt + 2 * mc),
        MemLedger("transform", "(S) keys w/ one non-key", mt + 2 * mc, mt, 4 * mc, mt + 4 * mc),
        MemLedger("find", "write matching IDs", 2 * mc, 2 * mc, 4 * mc, 6 * mc),
        MemLedger("materialize", "two pre-transformed payloads", 0.0, 2 * mc, 2 * mc, 4 * mc),
        MemLedger("materialize", "each remaining payload",
                  mt + 2 * mc, mt + mc, 2 * mc, mt + 4 * mc),
    ]


def peak_memory(pattern: str, mt: float = 1.0, mc: float = 1.0) -> float:
    ledger = gftr_ledger(mt, mc) if pattern == "gftr" else gfur_ledger(mt, mc)
    return max(row.peak for row in ledger)


def peak_memory_bytes(pattern: str, n_rows: int, itemsize: int,
                      mt_bytes: float | None = None) -> float:
    mc = float(n_rows * itemsize)
    mt = mc if mt_bytes is None else mt_bytes  # transform scratch ~ one column
    return peak_memory(pattern, mt=mt, mc=mc)
