"""Grouped aggregation: the sort-based algorithms and the partition-based
algorithm (high group cardinality; the paper's third group-by algorithm).

`groupby_sort` sorts the rows by key once (one planned permutation, one
gather per payload column) and reduces each run of equal keys.
`groupby_sort_pallas` keeps that sort and reduces each 256-row tile of it
to per-run partials in the segsum_partials kernel, then combines the
partials (`ops.groupby_sorted_sum`); the name is the reference's, so its
plans carry over.

`groupby_partition` radix-partitions rows on hashed key bits until each
partition fits a `row_block`-row block, then aggregates every partition on
its own: no global sort and no cross-partition combine, because a group
lives in exactly one partition. The partition is planned once and every
column is gathered once, straight into the blocked (P, row_block) layout.

Outputs follow the static-capacity contract: (Table with num_groups rows,
valid_count), padded with KEY_SENTINEL. The partition_hash and scatter
strategies of the reference are still to port.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from . import primitives as prim
from .hash_join import hash32
from .table import KEY_SENTINEL, Table, nonempty

AGG_OPS = ("sum", "count", "min", "max", "mean")
STRATEGIES = ("sort", "partition", "partition_hash", "scatter", "sort_pallas")


def _identity(op, dtype):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _finalize(op, acc, counts):
    if op == "mean":
        return acc / counts.clamp(min=1).to(acc.dtype)
    return acc


def _check_aggs(aggs: dict[str, str], allowed=AGG_OPS) -> None:
    for op in aggs.values():
        if op not in allowed:
            raise ValueError(f"unknown aggregate {op!r}; allowed: {allowed}")


def _min_max_segments(op, vals, valid, rid, num_groups: int):
    """Segment min/max over the runs of a key-sorted or blocked column, with
    the reference's identity (the dtype's extreme, +-inf for floats) in
    empty runs. Pad rows carry the reduction's identity and go to the run
    before them (run 0 before the first), which leaves every run's result
    unchanged; sending them all to one spare segment, as the reference
    does, serialises tens of millions of atomics on one address on the
    card. Min and max do not depend on the order of the updates, so the
    scatter is deterministic."""
    ident = _identity(op, vals.dtype)
    seg = torch.where(rid < num_groups, rid.clamp(min=0), num_groups)
    masked = torch.where(valid, vals, ident)
    out = torch.full((num_groups + 1,), ident, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, seg.to(torch.int64), masked,
                        reduce="amin" if op == "min" else "amax", include_self=True)
    return out[:num_groups]


# ---------------------------------------------------------------------------
# Sort-based (transform first, the GFTR analogue)
# ---------------------------------------------------------------------------
def groupby_sort(table: Table, *, key: str = "k", aggs: dict[str, str], num_groups: int):
    """Sort rows by key, find the runs of equal keys, reduce each run.
    Returns (Table(key + agg columns), valid_count); groups in key order.

    The key sort is planned once and each payload column costs one gather.
    Sums keep the input's dtype: float sums are taken run by run, integer
    sums are differences of a prefix sum and wrap as the input type does
    (`ops.RunSums`, one for every column)."""
    _check_aggs(aggs)
    table = nonempty(table, key)
    sk, perm = prim.plan_sort_permutation(table[key])
    valid, rid, starts, n_found = kops.sorted_runs(sk, num_groups)
    run_sums = kops.RunSums(starts)
    counts = run_sums(valid.to(torch.int32))
    cols = {key: kops.run_keys(sk, starts, n_found)}
    for col, op in aggs.items():
        if op == "count":
            cols[f"{col}_{op}"] = counts
            continue
        tv = prim.apply_permutation(perm, table[col])  # one gather per column
        if op in ("sum", "mean"):
            acc = run_sums(torch.where(valid, tv, torch.zeros((), dtype=tv.dtype,
                                                              device=tv.device)))
        else:
            acc = _min_max_segments(op, tv, valid, rid, num_groups)
        cols[f"{col}_{op}"] = _finalize(op, acc, counts)
    return Table(cols), torch.clamp(n_found, max=num_groups)


def groupby_sort_pallas(table: Table, *, key: str = "k", aggs: dict[str, str],
                        num_groups: int):
    """Sort-based group-by whose per-tile partial sums run in the
    segsum_partials kernel on the card (its plain version on the CPU).
    Sum, mean and count; sums and means are float32.

    The key sort is planned once and each payload column costs one gather
    and one kernel pass. The count pass is key-only and the same for every
    column, so it runs at most once, and only when a mean or count needs
    it."""
    _check_aggs(aggs, ("sum", "mean", "count"))
    table = nonempty(table, key)
    sk, perm = prim.plan_sort_permutation(table[key])
    out = {}
    count = gc = None
    if any(op in ("mean", "count") for op in aggs.values()):
        out[key], gc, count = kops.groupby_sorted_sum(
            sk, torch.ones(sk.shape, dtype=torch.float32, device=sk.device), num_groups)
    for col, op in aggs.items():
        if op == "count":
            out[f"{col}_{op}"] = gc.to(torch.int32)
            continue
        sv = prim.apply_permutation(perm, table[col])  # one gather per column
        gk, gs, cnt = kops.groupby_sorted_sum(sk, sv.to(torch.float32), num_groups)
        if count is None:
            out[key], count = gk, cnt
        out[f"{col}_{op}"] = gs if op == "sum" else gs / gc.clamp(min=1.0)
    return Table(out), count


# ---------------------------------------------------------------------------
# Partition-based
# ---------------------------------------------------------------------------
# default padded-block capacity per partition
PARTITION_ROW_BLOCK = 128


def choose_groupby_partition_bits(n_rows: int, row_block: int = PARTITION_ROW_BLOCK) -> int:
    """Fan-out so that E[partition rows] <= row_block / 2, capped at 16 bits
    (past the cap the block grows instead, see `_partition_layout`)."""
    target = max(1, (2 * n_rows) // row_block)
    return max(1, min(16, (target - 1).bit_length()))


def _partition_layout(n_rows: int, row_block: int,
                      partition_bits: int | None) -> tuple[int, int]:
    """(p_bits, row_block) holding E[rows/partition] <= row_block / 2: when
    the 16-bit fan-out cap is not enough, the block grows to cover the
    expected partition size. Explicit partition_bits keeps the caller's
    layout."""
    if partition_bits is not None:
        return partition_bits, row_block
    p_bits = choose_groupby_partition_bits(n_rows, row_block)
    need = -(-2 * n_rows // (1 << p_bits))
    if need > row_block:
        row_block = 1 << int(need - 1).bit_length()
    return p_bits, row_block


def _partition_digits(keys: torch.Tensor, p_bits: int) -> torch.Tensor:
    """Hash-derived partition digit per row, in [0, P]: valid keys spread
    over [0, P); KEY_SENTINEL rows flood their own partition P.

    Float keys are bitcast (not value-cast) so every distinct float hashes
    distinctly, with -0.0 normalized to +0.0 first, since the two compare
    equal. NaN keys are outside the key contract and go to the padding
    partition, like sentinels."""
    if keys.dtype.is_floating_point:
        sentinel = torch.isnan(keys) | (keys == KEY_SENTINEL)
        normed = torch.where(keys == 0.0, torch.zeros((), dtype=keys.dtype,
                                                      device=keys.device), keys)
        hashable = normed.view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[keys.element_size()])
    else:
        hashable = keys
        sentinel = keys == KEY_SENTINEL
    d = (hash32(hashable) & ((1 << p_bits) - 1)).to(torch.int32)
    return torch.where(sentinel, 1 << p_bits, d)


def groupby_partition(
    table: Table,
    *,
    key: str = "k",
    aggs: dict[str, str],
    num_groups: int,
    row_block: int = PARTITION_ROW_BLOCK,
    partition_bits: int | None = None,
):
    """Partition-based grouped aggregation. Returns (Table, valid_count);
    output rows are ordered by (partition, key).

    Per partition: one stable block-local sort moves the key and every
    aggregate input together; sums and counts are differences of cumulative
    sums at run boundaries, and the dense output is compacted by a binary
    search over the monotone run ids. Min and max need one segment reduction
    each. An aggregate keeps its input's dtype; integer sums wrap as the
    input type does.

    A partition holding more than `row_block` rows has its overhang dropped;
    the fan-out makes that negligible for the high-cardinality,
    low-multiplicity inputs this strategy is for."""
    _check_aggs(aggs)
    table = nonempty(table, key)
    keys = table[key]
    dev = keys.device
    n = keys.shape[0]
    p_bits, row_block = _partition_layout(n, row_block, partition_bits)
    P = 1 << p_bits
    digits = _partition_digits(keys, p_bits)
    # P + 1 partitions: the extra one swallows sentinel padding and is never
    # materialized. The key comes back already partitioned.
    perm, (keys_part,), offsets, sizes = prim.plan_partition_permutation(
        digits, P + 1, carry=(keys,))

    # blocked layout: slot (p, i) holds the i-th row of partition p
    i = torch.arange(row_block, dtype=torch.int32, device=dev)[None, :]
    pos_c = (offsets[:P, None] + i).clamp(0, n - 1)
    in_part = i < sizes[:P, None].clamp(max=row_block)
    src = perm[pos_c]  # (P, row_block) source rows for the payloads
    kblocks = torch.where(in_part, keys_part[pos_c], KEY_SENTINEL)

    # one stable block-local sort; sentinel slots sort to the front of their
    # block and are masked out of every reduction
    ks, order = torch.sort(kblocks, dim=1, stable=True)
    uniq_cols = list(dict.fromkeys(c for c, op in aggs.items() if op != "count"))
    vsorted = {c: torch.gather(table[c][src], 1, order) for c in uniq_cols}
    del order, src
    n_slots = P * row_block
    ksf = ks.reshape(-1)
    valid = ksf != KEY_SENTINEL
    head = torch.cat([torch.ones((P, 1), dtype=torch.bool, device=dev),
                      ks[:, 1:] != ks[:, :-1]], dim=1).reshape(-1)
    rid = torch.cumsum(head & valid, 0, dtype=torch.int32) - 1  # monotone run id
    count = torch.clamp(rid[-1] + 1, max=num_groups)

    # dense compaction by binary search: run r spans [starts[r], starts[r+1])
    r_iota = torch.arange(num_groups + 1, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(rid, r_iota, out_int32=True)
    s_flat, e_flat = starts[:num_groups], starts[1:]
    present = r_iota[:num_groups] < count
    out_keys = torch.where(present, ksf[s_flat.clamp(0, n_slots - 1)], KEY_SENTINEL)

    def run_total(per_slot):
        ecs = torch.cat([per_slot.new_zeros(1), torch.cumsum(per_slot, 0, dtype=per_slot.dtype)])
        return ecs[e_flat] - ecs[s_flat]

    # Sums use block-local cumulative sums: a run never spans blocks, so the
    # prefix a difference cancels is at most one block's magnitude.
    row_s = torch.clamp(s_flat // row_block, max=P - 1)
    col_s = s_flat - (s_flat // row_block) * row_block
    col_e = torch.where(e_flat // row_block == s_flat // row_block,
                        e_flat - (e_flat // row_block) * row_block, row_block)

    def run_block_total(masked2d):
        ecs = torch.cat([masked2d.new_zeros((P, 1)),
                         torch.cumsum(masked2d, 1, dtype=masked2d.dtype)], dim=1).reshape(-1)
        hi = ecs[row_s * (row_block + 1) + col_e]
        lo = ecs[row_s * (row_block + 1) + col_s]
        return torch.where(present, hi - lo, torch.zeros((), dtype=hi.dtype, device=dev))

    valid2d = valid.reshape(P, row_block)
    counts = run_total(valid.to(torch.int32))
    cols = {key: out_keys}
    for col, op in aggs.items():
        if op == "count":
            cols[f"{col}_{op}"] = counts
            continue
        vs = vsorted[col]
        if op in ("sum", "mean"):
            acc = run_block_total(torch.where(valid2d, vs, torch.zeros((), dtype=vs.dtype,
                                                                       device=dev)))
        else:
            acc = _min_max_segments(op, vs.reshape(-1), valid, rid, num_groups)
        cols[f"{col}_{op}"] = _finalize(op, acc, counts)
    return Table(cols), count


def group_aggregate(
    table: Table,
    *,
    key: str = "k",
    aggs: dict[str, str],
    num_groups: int,
    strategy: str = "sort",
    **kw,
):
    """Unified entry point. strategy in STRATEGIES; 'sort' (the default),
    'sort_pallas' and 'partition' are ported, the others raise
    NotImplementedError."""
    fn = {"sort": groupby_sort, "sort_pallas": groupby_sort_pallas,
          "partition": groupby_partition}.get(strategy)
    if fn is not None:
        return fn(table, key=key, aggs=aggs, num_groups=num_groups, **kw)
    if strategy in STRATEGIES:
        raise NotImplementedError(f"group-by strategy {strategy!r} is not ported yet; "
                                  "use strategy='sort' or 'partition'")
    raise ValueError(f"unknown group-by strategy {strategy!r}")
