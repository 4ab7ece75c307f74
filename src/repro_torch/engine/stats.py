"""Table statistics + cardinality estimation for the query optimizer: the
port's copy of the JAX package's `engine.stats`, on PyTorch tensors.

The paper's decision procedure (Fig. 18) and cost model (§5.4) consume a
`JoinStats` descriptor — sizes, payload widths, match ratio, skew, byte
widths. This module estimates them from the data itself, with device-side
sketches and small host transfers:

  * row counts / min / max          — exact, one reduction each
  * distinct count                  — linear-counting sketch over hashed
                                      keys (B >= 2n buckets, so the
                                      occupancy inversion stays accurate)
  * zipf-skew exponent              — log-log slope of the top run-length
                                      counts of a hashed-stride sample
  * match ratio (join selectivity)  — sampled probe keys membership-tested
                                      against the sorted build key column
  * filter selectivity              — predicate evaluated on a sample

Everything is deterministic (hashed-stride sampling, no RNG state) so
plans are reproducible run to run, and every estimate is the same float as
the JAX package's on the same column: the planner sizes capacities from
them, and one ulp can move a capacity across a multiple of 64.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..core.hash_join import hash32
from ..core.planner import JoinStats
from ..core.table import Table
from ..resilience import faults
from .logical import FILTER_OP_FNS

DEFAULT_SAMPLE = 4096


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Distinct/min/max/zipf for one column. `distinct` is propagated
    UNCHANGED through row-reducing ops: it is then an upper bound (filters
    can only remove key values), and every capacity consumer combines it
    with `min(distinct, surviving_rows)` — shrinking it by selectivity
    would under-size capacities for duplicated keys (a filter that keeps
    10% of rows usually keeps ~all keys when each key has many rows).

    `integer` records the sketched column's dtype kind. It survives
    propagation through joins/projections (they never change a carried
    column's dtype), which lets the group-by chooser route *derived* key
    columns — where no base-table origin is traceable — to the hash-bucketed
    'partition' strategy only when the keys are radix-hashable integers."""

    distinct: float
    min: float
    max: float
    zipf: float  # estimated skew exponent; 0 = uniform
    integer: bool = True  # dtype kind of the sketched column


@dataclasses.dataclass(frozen=True)
class TableStats:
    num_rows: int
    columns: Mapping[str, ColumnStats]

    def __getitem__(self, name: str) -> ColumnStats:
        return self.columns[name]


def np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (or of anything numpy reads as one):
    its itemsize prices plans and its kind routes them."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def is_integer_dtype(dtype) -> bool:
    return bool(np.issubdtype(np_dtype(dtype), np.integer))


def _ratio(hits: int, total: int) -> float:
    """hits / total in float32, as the JAX package's float32 mean and
    int32 division give it."""
    return float(np.float32(hits) / np.float32(total))


# ---------------------------------------------------------------------------
# Sampling + sketches
# ---------------------------------------------------------------------------
def sample_column(col: torch.Tensor, m: int = DEFAULT_SAMPLE, seed: int = 0) -> torch.Tensor:
    """Deterministic hashed-stride sample of up to m values (Fibonacci
    multiplicative stride — covers the array pseudo-randomly with no RNG)."""
    n = col.shape[0]
    if n <= m:
        return col
    idx = (np.arange(m, dtype=np.uint64) * np.uint64(2654435761) + np.uint64(seed)) % n
    return col[torch.from_numpy(idx.astype(np.int64)).to(col.device)]


def _hashable(col: torch.Tensor) -> torch.Tensor:
    """hash32 takes integers; reinterpret floats as same-width ints so every
    distinct float hashes distinctly (the JAX package's bitcast)."""
    if col.dtype.is_floating_point:
        return col.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[col.element_size()])
    return col


def estimate_distinct(col: torch.Tensor) -> float:
    """Linear-counting sketch: hash into B >= max(2n, 64k) buckets, invert
    occupancy. Accurate to a few percent in that regime."""
    n = col.shape[0]
    if n == 0:
        return 0.0
    B = 1 << max(16, int(2 * n - 1).bit_length())
    h = hash32(_hashable(col)) % B
    occupied = torch.zeros(B, dtype=torch.bool, device=col.device)
    occupied.index_put_((h,), torch.ones((), dtype=torch.bool, device=col.device))
    v = int(occupied.sum())
    if v >= B:  # saturated (cannot happen with B >= 2n, but stay safe)
        return float(n)
    est = -B * np.log1p(-v / B)
    # deterministic corruption hook (REPRO_FAULTS=estimates:...): 1.0 when
    # no fault is active, so production estimates are untouched
    est *= faults.estimate_factor("distinct")
    return float(min(max(est, 1.0), n))


def estimate_zipf(col: torch.Tensor, m: int = 2 * DEFAULT_SAMPLE, seed: int = 0) -> float:
    """Skew exponent: least-squares slope of log(frequency) vs log(rank)
    over the top run-length counts of a sorted sample. ~0 for uniform keys,
    ~a for Zipf(a)-distributed keys. Clamped to [0, 4]."""
    s = torch.sort(sample_column(col, m, seed)).values
    counts = torch.unique_consecutive(s, return_counts=True)[1]
    top = torch.sort(counts, descending=True).values[:min(64, s.shape[0])]
    top = top.cpu().numpy().astype(np.float64)
    top = top[top >= 2]  # singleton tail carries no skew signal
    if top.size < 4:
        return 0.0
    ranks = np.arange(1, top.size + 1, dtype=np.float64)
    slope = np.polyfit(np.log(ranks), np.log(top), 1)[0]
    return float(min(max(-slope, 0.0), 4.0))


def _membership_ratio(sorted_build: torch.Tensor, probe_sample: torch.Tensor,
                      mask: torch.Tensor | None = None) -> float:
    """Fraction of (mask-selected) probe sample keys present in the sorted
    build keys — the one membership-test implementation every match-ratio
    path shares."""
    dt = torch.promote_types(sorted_build.dtype, probe_sample.dtype)
    sorted_build, probe_sample = sorted_build.to(dt), probe_sample.to(dt)
    lb = torch.searchsorted(sorted_build, probe_sample)
    lb_c = lb.clamp(max=sorted_build.shape[0] - 1)
    hit = (sorted_build[lb_c] == probe_sample) & (lb < sorted_build.shape[0])
    if mask is None:
        return _ratio(int(hit.sum()), hit.shape[0])
    return _ratio(int((hit & mask).sum()), max(int(mask.sum()), 1))


def estimate_match_ratio(build_keys: torch.Tensor, probe_keys: torch.Tensor,
                         m: int = DEFAULT_SAMPLE, seed: int = 0) -> float:
    """Join selectivity: fraction of (sampled) probe keys with a partner in
    the build key column — one sort of the build keys + a searchsorted."""
    return _membership_ratio(torch.sort(build_keys).values,
                             sample_column(probe_keys, m, seed))


def estimate_selectivity(col: torch.Tensor, op: str, value,
                         m: int = DEFAULT_SAMPLE, seed: int = 0) -> float:
    """Filter selectivity from a sampled predicate evaluation."""
    s = sample_column(col, m, seed)
    mask = FILTER_OP_FNS[op](s, value)
    return _ratio(int(mask.sum()), mask.shape[0])


def collect_column_stats(col: torch.Tensor, *, sample: int = DEFAULT_SAMPLE,
                         seed: int = 0) -> ColumnStats:
    """Sketch one column (shared by TableStats and the Catalog cache)."""
    return ColumnStats(
        distinct=estimate_distinct(col),
        min=float(col.min()),
        max=float(col.max()),
        zipf=estimate_zipf(col, 2 * sample, seed),
        integer=is_integer_dtype(col.dtype),
    )


def collect_table_stats(table: Table, *, sample: int = DEFAULT_SAMPLE,
                        seed: int = 0) -> TableStats:
    """Statistics for every column of a base table (eager; the Catalog's
    per-column path is the lazy production route)."""
    cols = {name: collect_column_stats(table[name], sample=sample, seed=seed)
            for name in table.column_names}
    return TableStats(num_rows=table.num_rows, columns=cols)


# ---------------------------------------------------------------------------
# Catalog: named base tables + lazily cached statistics
# ---------------------------------------------------------------------------
class Catalog:
    """The engine's view of the database: named `Table`s plus per-table
    statistics, collected on first use and cached (re-`register` a table to
    invalidate)."""

    def __init__(self, tables: Mapping[str, Table] | None = None):
        self.tables: dict[str, Table] = dict(tables or {})
        self._stats: dict[str, TableStats] = {}
        self._col_stats: dict[tuple[str, str], ColumnStats] = {}
        self._unique: dict[tuple[str, str], bool] = {}
        self._sel: dict[tuple, float] = {}
        self._mr: dict[tuple, float] = {}
        self._mn_rows: dict[tuple, float] = {}
        self._mult: dict[tuple, float] = {}

    def register(self, name: str, table: Table) -> "Catalog":
        self.tables[name] = table
        self._stats.pop(name, None)
        for cache in (self._col_stats, self._unique, self._sel):
            for k in [k for k in cache if k[0] == name]:
                del cache[k]
        self._mult = {k: v for k, v in self._mult.items() if k[0][0] != name}
        # _mr keys: (build_origin, probe_origin, preds) with origin=(table,col)
        self._mr = {k: v for k, v in self._mr.items()
                    if name not in (k[0][0], k[1][0])}
        # _mn_rows keys: ((origin, preds), (origin, preds))
        self._mn_rows = {k: v for k, v in self._mn_rows.items()
                         if name not in (k[0][0][0], k[1][0][0])}
        return self

    @property
    def device(self) -> torch.device:
        """Where the catalog's tables live (and its plans run): the first
        table's device, or the card when there is one and no table yet."""
        if self.tables:
            return next(iter(self.tables.values())).device
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")

    def schemas(self) -> dict[str, tuple[str, ...]]:
        return {name: t.column_names for name, t in self.tables.items()}

    def stats(self, name: str) -> TableStats:
        if name not in self._stats:
            self._stats[name] = collect_table_stats(self.tables[name])
        return self._stats[name]

    def col_stats(self, name: str, col: str) -> ColumnStats:
        """Per-column statistics, sketched on first use and cached — only
        columns a plan actually consults (join keys, filter columns, group
        keys) ever pay for a sketch; payload columns of wide tables don't."""
        key = (name, col)
        if key not in self._col_stats:
            self._col_stats[key] = collect_column_stats(self.tables[name][col])
        return self._col_stats[key]

    def selectivity(self, name: str, predicates: tuple) -> float:
        """JOINT selectivity of a predicate chain over one base-row sample.
        Evaluating the conjunction on aligned samples (sample_column uses
        the same stride for every column) captures predicate correlation
        that multiplying per-predicate selectivities would miss."""
        key = (name, tuple(predicates))
        if key not in self._sel:
            t = self.tables[name]
            mask = None
            for col, op, value in predicates:
                m = FILTER_OP_FNS[op](sample_column(t[col]), value)
                mask = m if mask is None else (mask & m)
            self._sel[key] = (1.0 if mask is None
                              else _ratio(int(mask.sum()), mask.shape[0]))
        return self._sel[key]

    def max_multiplicity(self, origin: tuple[str, str],
                         preds: tuple = ()) -> float:
        """EXACT maximum per-key row count of a (filtered) base column —
        decides whether an m:n join's build side fits PHJ's padded
        co-partition blocks or must use sort-merge. Device-side: the run
        lengths of the sorted surviving keys, one scalar transfer."""
        key = (origin, tuple(preds))
        if key not in self._mult:
            keys, mask = self._masked_keys(origin, preds)
            runs = torch.unique_consecutive(torch.sort(keys[mask]).values,
                                            return_counts=True)[1]
            self._mult[key] = float(runs.max()) if runs.numel() else 0.0
        return self._mult[key]

    def is_unique(self, name: str, col: str) -> bool:
        """Exact (not sketched) key-uniqueness check, cached; device-side
        (one sort + adjacent-equal reduce, scalar transfer). The optimizer
        uses this to prove a join side is a PK side: a distinct-count sketch
        can be a few percent off, which is the difference between a correct
        pk_fk plan and one that silently drops duplicate matches."""
        key = (name, col)
        if key not in self._unique:
            s = torch.sort(self.tables[name][col]).values
            self._unique[key] = not bool((s[1:] == s[:-1]).any())
        return self._unique[key]

    def match_ratio(self, build_origin: tuple[str, str],
                    probe_origin: tuple[str, str],
                    probe_predicates: tuple = ()) -> float:
        """Memoized join selectivity. `probe_predicates` — a chain of
        (column, op, value) filters over the probe base table — is applied
        to the probe-side row sample before the membership test, so a
        filter correlated with match likelihood (e.g. range-restricting the
        key itself) yields the post-filter match ratio instead of the base
        one. Without this, base-mr x filter-sel double-counts the
        restriction and the join capacity silently truncates."""
        key = (build_origin, probe_origin, tuple(probe_predicates))
        if key not in self._mr:
            probe_t = self.tables[probe_origin[0]]
            bk = torch.sort(self.tables[build_origin[0]][build_origin[1]]).values
            pk = sample_column(probe_t[probe_origin[1]])
            mask = torch.ones(pk.shape, dtype=torch.bool, device=pk.device)
            for col, op, value in probe_predicates:
                mask &= FILTER_OP_FNS[op](sample_column(probe_t[col]), value)
            self._mr[key] = _membership_ratio(bk, pk, mask)
        return self._mr[key]

    def _masked_keys(self, origin: tuple[str, str], predicates: tuple):
        t = self.tables[origin[0]]
        keys = t[origin[1]]
        mask = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
        for col, op, value in predicates:
            mask &= FILTER_OP_FNS[op](t[col], value)
        return keys, mask

    def mn_output_rows(self, a_origin: tuple[str, str],
                       b_origin: tuple[str, str],
                       a_preds: tuple = (), b_preds: tuple = ()) -> float:
        """EXACT m:n join output cardinality between two base columns,
        with each side's pushed-down filter chain applied — sum over keys
        of count_a(k) * count_b(k) over the SURVIVING rows. Device-side:
        sort B's surviving keys and range-count each surviving A key; one
        scalar transfer. Both the independence estimate
        (n_a*n_b/distinct) and uniform retention scaling undershoot by
        orders of magnitude on correlated multiplicity/filters, silently
        truncating the join output through the static capacity. The count
        is summed in int64 (the JAX package sums float32 counts: the same
        float below 2^24 output rows)."""
        # canonicalize each (origin, preds) side together — the count is
        # symmetric, but preds must stay attached to their own side
        key = tuple(sorted(((a_origin, tuple(a_preds)),
                            (b_origin, tuple(b_preds)))))
        if key not in self._mn_rows:
            a, ma = self._masked_keys(a_origin, a_preds)
            b, mb = self._masked_keys(b_origin, b_preds)
            dt = torch.promote_types(a.dtype, b.dtype)
            sb = torch.sort(b[mb].to(dt)).values
            a = a[ma].to(dt)
            per_a = (torch.searchsorted(sb, a, right=True)
                     - torch.searchsorted(sb, a))
            self._mn_rows[key] = float(per_a.sum())
        return self._mn_rows[key]


# ---------------------------------------------------------------------------
# JoinStats synthesis — what the Fig. 18 trees + cost model consume
# ---------------------------------------------------------------------------
def synthesize_join_stats(
    *,
    n_build: int,
    n_probe: int,
    build_payload_cols: int,
    probe_payload_cols: int,
    match_ratio: float,
    zipf: float,
    key_dtype,
    payload_dtypes=(),
) -> JoinStats:
    """Build the planner's workload descriptor from estimated quantities —
    the piece callers previously hand-wrote."""
    key_bytes = np_dtype(key_dtype).itemsize
    payload_bytes = max(
        [np_dtype(d).itemsize for d in payload_dtypes] or [key_bytes]
    )
    return JoinStats(
        n_r=int(n_build),
        n_s=int(n_probe),
        r_payload_cols=int(build_payload_cols),
        s_payload_cols=int(probe_payload_cols),
        match_ratio=float(match_ratio),
        zipf=float(zipf),
        key_bytes=int(key_bytes),
        payload_bytes=int(payload_bytes),
    )
