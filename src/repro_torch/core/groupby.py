"""Grouped aggregation: the sort-based algorithms, the two-phase tile
algorithm, the partition-based algorithm (high group cardinality; the
paper's third group-by algorithm) and the scatter baseline.

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

`groupby_partition_hash` reduces each 256-row tile to one partial per
distinct key (a stable sort inside each tile, then a sum over each run),
then combines the partials with one sorted pass; duplicates and heavy
hitters collapse tile-locally first. `groupby_scatter` indexes the
accumulator by key value, for dense key domains. `choose_groupby_strategy`
picks among them from the input's statistics; `groupby_partition_checked`
runs the partition group-by on the escalation ladder.

Outputs follow the static-capacity contract: (Table with num_groups rows,
valid_count), padded with KEY_SENTINEL.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..resilience import EscalationStep, Ladder
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
# Two-phase tile aggregation (tile partials + sorted combine)
# ---------------------------------------------------------------------------
def groupby_partition_hash(table: Table, *, key: str = "k", aggs: dict[str, str],
                           num_groups: int, block: int = 256):
    """Two-phase aggregation: per tile of `block` rows, one partial per
    distinct key (the role of a thread block's shared-memory hash table),
    then a sorted combine of the partials, which are at most the rows and,
    for skewed or duplicate-heavy inputs, up to `block` times fewer. Returns
    (Table, valid_count); groups in key order.

    The reference's result types: sums, means, minima and maxima are
    float32 (values are cast to float32 first), counts int32. Counts are
    exact integers here (the reference accumulates them in float32, exact
    up to 2^24 rows in a group). Float sums are taken run by run
    (`ops.RunSums`), for the tiles and for the combine."""
    _check_aggs(aggs)
    table = nonempty(table, key)
    keys = table[key]
    dev = keys.device
    n = keys.shape[0]
    n_pad = -n % block
    # phase 1: a stable sort inside each tile; pad and sentinel rows are
    # masked out of every reduction
    kp = torch.cat([keys, keys.new_full((n_pad,), KEY_SENTINEL)]).reshape(-1, block)
    ks, order = torch.sort(kp, dim=1, stable=True)
    n_tiles = ks.shape[0]
    tile0 = torch.arange(n_tiles, dtype=torch.int32, device=dev)[:, None] * block
    src = (order + tile0).reshape(-1)
    src = src.clamp(max=n - 1)
    valid = (ks != KEY_SENTINEL).reshape(-1)
    head = valid & torch.cat([torch.ones((n_tiles, 1), dtype=torch.bool, device=dev),
                              ks[:, 1:] != ks[:, :-1]], dim=1).reshape(-1)
    ksf = ks.reshape(-1)
    # partial p covers the slots [pstart[p], pstart[p + 1]); slots past its
    # key's last row are sentinel slots, masked by `valid`
    pstart = torch.nonzero(head).reshape(-1).to(torch.int32)
    pkeys = ksf[pstart]
    tile_sums = kops.RunSums(torch.cat([pstart, pstart.new_full((1,), ksf.shape[0])]))
    pcounts = tile_sums(valid.to(torch.int32))
    prid = torch.cumsum(head, 0, dtype=torch.int32) - 1
    n_part = pstart.shape[0]
    vals, tiled = {}, {}  # tiled: (column, partial op) -> float32 per partial
    for col, op in aggs.items():
        pop = "sum" if op == "mean" else op
        if op == "count" or (col, pop) in tiled:
            continue
        if col not in vals:
            vals[col] = table[col][src].to(torch.float32)
        v = vals[col]
        tiled[(col, pop)] = (tile_sums(torch.where(valid, v, 0.0)) if pop == "sum"
                             else _min_max_segments(pop, v, valid, prid, n_part))
    del vals, src, valid, prid, head, ks, ksf

    # phase 2: one stable sort of the partials by key, a reduction per run
    if n_part == 0:  # no valid row: one sentinel partial keeps the shapes
        pkeys = keys.new_full((1,), KEY_SENTINEL)
        pcounts = pcounts.new_zeros(1)
        tiled = {k: v.new_zeros(1) for k, v in tiled.items()}
    sk, order = torch.sort(pkeys, stable=True)
    pvalid, rid, starts, n_found = kops.sorted_runs(sk, num_groups)
    run_sums = kops.RunSums(starts)
    counts = run_sums(torch.where(pvalid, pcounts[order], 0))
    cols = {key: kops.run_keys(sk, starts, n_found)}
    for col, op in aggs.items():
        if op == "count":
            cols[f"{col}_{op}"] = counts
            continue
        if op in ("sum", "mean"):
            acc = run_sums(torch.where(pvalid, tiled[(col, "sum")][order], 0.0))
        else:
            acc = _min_max_segments(op, tiled[(col, op)][order], pvalid, rid, num_groups)
        cols[f"{col}_{op}"] = _finalize(op, acc, counts)
    return Table(cols), torch.clamp(n_found, max=num_groups)


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


def groupby_partition_overflowed(keys: torch.Tensor, *, row_block: int = PARTITION_ROW_BLOCK,
                                 partition_bits: int | None = None):
    """Host-side check: would any valid partition exceed the (layout-
    adjusted) block? Returns (overflowed, p_bits, max_partition_rows).
    Sentinel rows are excluded: their partition may overflow."""
    p_bits, row_block = _partition_layout(keys.shape[0], row_block, partition_bits)
    digits = _partition_digits(keys, p_bits)
    sizes = torch.bincount(digits, minlength=(1 << p_bits) + 1)[:1 << p_bits]
    mx = int(sizes.max())
    return mx > row_block, p_bits, mx


def groupby_partition_checked(table: Table, *, key: str = "k", aggs: dict[str, str],
                              num_groups: int, row_block: int = PARTITION_ROW_BLOCK,
                              max_extra_bits: int = 4, max_attempts: int = 8,
                              with_report: bool = False, **kw):
    """groupby_partition on the escalation ladder: first add fan-out bits
    (separating co-hashed groups); if one key's rows still overflow (more
    bits cannot split a key), go back to the base bits and grow the block to
    cover the base layout's largest partition; last, fall back to the sort
    strategy, which is always exact. Each check is a host-side histogram;
    exhaustion raises `EscalationExhausted` instead of dropping rows.

    `with_report=True` also returns the `EscalationReport`."""
    table = nonempty(table, key)
    keys = table[key]
    # the auto layout is resolved once, then pinned through the ladder
    # (explicit partition_bits turns the auto-grow off)
    base_bits, base_block = _partition_layout(keys.shape[0], row_block,
                                              kw.pop("partition_bits", None))
    knobs = {"strategy": "partition", "partition_bits": base_bits, "row_block": base_block}
    base_mx: dict = {}  # the base layout's largest partition, noted by check()

    def check(kn):
        if kn["strategy"] != "partition":
            return True, "sort fallback (always exact)", None
        over, _, mx = groupby_partition_overflowed(keys, row_block=kn["row_block"],
                                                   partition_bits=kn["partition_bits"])
        if kn["partition_bits"] == base_bits:
            base_mx.setdefault("mx", mx)
        return not over, f"partition rows {mx} > block {kn['row_block']}" if over else "", mx

    def grow_bits(kn, diag):
        if kn["strategy"] != "partition" or kn["partition_bits"] >= 20:
            return None
        return {**kn, "partition_bits": kn["partition_bits"] + 1}

    def grow_block(kn, diag):
        if kn["strategy"] != "partition":
            return None
        mx0 = max(base_mx.get("mx", 0), 1)
        rb = 1 << max(int(mx0 - 1).bit_length(), int(base_block - 1).bit_length())
        if rb <= kn["row_block"] and kn["partition_bits"] == base_bits:
            rb = kn["row_block"] * 2  # a forced overflow: grow anyway
        return {**kn, "partition_bits": base_bits, "row_block": rb}

    def to_sort(kn, diag):
        return {**kn, "strategy": "sort"}

    ladder = Ladder("groupby_partition", [
        EscalationStep("partition_bits", grow_bits, max_times=max_extra_bits),
        EscalationStep("row_block", grow_block, max_times=1),
        EscalationStep("strategy:sort", to_sort, max_times=1),
    ], max_attempts=max_attempts)
    report = ladder.resolve(knobs, check)
    kn = report.final_knobs
    if kn["strategy"] == "sort":
        out = groupby_sort(table, key=key, aggs=aggs, num_groups=num_groups)
    else:
        out = groupby_partition(table, key=key, aggs=aggs, num_groups=num_groups,
                                row_block=kn["row_block"], partition_bits=kn["partition_bits"],
                                **kw)
    return (out, report) if with_report else out


# ---------------------------------------------------------------------------
# Scatter baseline (dense key domain)
# ---------------------------------------------------------------------------
def groupby_scatter(table: Table, *, key: str = "k", aggs: dict[str, str], num_groups: int):
    """Direct aggregation for keys in [0, num_groups), indexed by key value.
    Keys outside the domain (KEY_SENTINEL padding among them) are dropped,
    and the output is compacted to the present groups in key order, so every
    strategy shares one (Table, valid_count) contract.

    Counts and integer sums, minima and maxima scatter (exact, and the
    order of the updates does not matter; integer sums wrap as the input
    type does). Float sums do not: the rows are sorted by key once and each
    key's run is summed on its own (`ops.RunSums`), so the sums are the same
    on every run."""
    _check_aggs(aggs)
    table = nonempty(table, key)
    keys = table[key]
    if keys.dtype.is_floating_point:
        raise TypeError(f"scatter group-by needs integer keys, got {keys.dtype}; "
                        "float keys would be silently floored into merged groups")
    dev = keys.device
    in_domain = (keys >= 0) & (keys < num_groups)
    # int32 ids: the float sums' sort of 4-byte keys moves half the bytes
    gid = torch.where(in_domain, keys, num_groups).to(torch.int32)
    counts = torch.bincount(gid, minlength=num_groups + 1)[:num_groups].to(torch.int32)
    run_sums = None
    out = {key: torch.arange(num_groups, dtype=keys.dtype, device=dev)}
    for col, op in aggs.items():
        vals = table[col]
        if op == "count":
            acc = counts
        elif op in ("sum", "mean") and vals.dtype.is_floating_point:
            if run_sums is None:  # one sort by key serves every float sum
                sg, order = torch.sort(gid, stable=True)
                bounds = torch.arange(num_groups + 1, dtype=torch.int32, device=dev)
                run_sums = kops.RunSums(torch.searchsorted(sg, bounds, out_int32=True))
            acc = run_sums(vals[order])
        elif op in ("sum", "mean"):
            acc = torch.zeros(num_groups + 1, dtype=vals.dtype, device=dev).index_add_(
                0, gid, torch.where(in_domain, vals, 0))[:num_groups]
        else:
            acc = _min_max_segments(op, vals, in_domain, gid, num_groups)
        out[f"{col}_{op}"] = _finalize(op, acc, counts)
    names = list(out)
    compacted, n_present = prim.compact(counts > 0, [out[n] for n in names], num_groups)
    out = dict(zip(names, compacted))
    present = torch.arange(num_groups, dtype=torch.int32, device=dev) < n_present
    out[key] = torch.where(present, out[key], KEY_SENTINEL)
    return Table(out), n_present


# ---------------------------------------------------------------------------
# Strategy choice and the entry point
# ---------------------------------------------------------------------------
def choose_groupby_strategy(
    n_rows: int,
    est_groups: float,
    *,
    key_min: float | None = None,
    key_max: float | None = None,
    zipf: float = 0.0,
    dense_domain_limit: int = 1 << 18,
    integer_key: bool = True,
) -> tuple[str, str]:
    """Cardinality-based strategy heuristic, the reference's unchanged.
    Returns (strategy, rationale):
      * dense, small key domains -> 'scatter' (the accumulator stays
        resident, so the unclustered writes are cheap);
      * heavy duplication (rows >> groups) or skew -> 'partition_hash'
        (tile-local pre-aggregation collapses duplicates before the
        expensive pass);
      * high cardinality and integer keys -> 'partition' (radix-partition
        on hashed key bits until each partition fits a block, no global
        sort or combine);
      * high cardinality, non-integer keys -> 'sort'.
    The rationales keep the reference's wording, so both packages give the
    same pair."""
    domain = None
    # scatter indexes the accumulator by key value, so the keys must be
    # non-negative integers in a small domain
    if integer_key and key_min is not None and key_max is not None and key_min >= 0:
        domain = int(key_max) + 1
    if domain is not None and domain <= dense_domain_limit and domain <= max(
            4 * est_groups, 1024):
        return "scatter", f"dense key domain [0, {domain}) fits a resident accumulator"
    if zipf > 1.0:
        return "partition_hash", (f"skewed keys (zipf~{zipf:.2f}): tile pre-aggregation "
                                  "absorbs heavy hitters")
    if est_groups * 8 <= n_rows:
        return "partition_hash", (f"rows/groups ~ {n_rows / max(est_groups, 1.0):.0f}x: tile "
                                  "pre-aggregation shrinks the combine pass")
    if integer_key:
        return "partition", (f"high cardinality (~{est_groups:.0f} groups, low multiplicity): "
                             "radix-partition to VMEM-resident accumulators, no global "
                             "sort/combine")
    return "sort", ("high cardinality, non-integer keys: sequential sort pass beats "
                    "spilling hash tables")


def group_aggregate(
    table: Table,
    *,
    key: str = "k",
    aggs: dict[str, str],
    num_groups: int,
    strategy: str = "sort",
    **kw,
):
    """Unified entry point; strategy in STRATEGIES ('sort', the default,
    'partition', 'partition_hash', 'scatter', 'sort_pallas')."""
    fn = {"sort": groupby_sort, "partition": groupby_partition,
          "partition_hash": groupby_partition_hash, "scatter": groupby_scatter,
          "sort_pallas": groupby_sort_pallas}.get(strategy)
    if fn is None:
        raise ValueError(f"unknown group-by strategy {strategy!r}; allowed: {STRATEGIES}")
    return fn(table, key=key, aggs=aggs, num_groups=num_groups, **kw)
