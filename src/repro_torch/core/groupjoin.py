"""Fused group-join: aggregate during the probe, never materialize the join.

A join followed by a group-by writes the whole join result (one gather per
payload column into a worst-case-sized buffer) and then reads every byte of
it again. `phj_groupjoin` runs the same co-partition plan and probe as
`phj_join`, but folds each matched probe row's aggregate inputs straight
into a group-keyed accumulator:

  * probe_impl='cuda': each probe sub-block is matched against its build
    block and reduced to per-slot partials (group key, float32 sums, int32
    count) inside the probe_agg kernel, with build-side values fetched from
    the staged build block; one sorted combine gives the groups. The joined
    row is never written.
  * probe_impl='torch': the plain probe gives each row's match; unmatched
    rows get KEY_SENTINEL group keys; probe-side inputs cost one planned
    gather each, build-side inputs one gather through the matched virtual
    IDs (GFTR); then `group_aggregate` with `agg_strategy`.

Scope: inner pk_fk joins (build keys unique). The group key must be a
probe-side (S) column; the join key itself is allowed.

Static-shape contract: `num_groups` is the accumulator capacity; the output
is (Table(group_key + f"{col}_{op}" columns), valid_count), padded with
KEY_SENTINEL, like `group_aggregate`. Groups beyond capacity are dropped;
`groupjoin_overflowed` checks both capacities beforehand, and
`groupjoin_checked` escalates partition bits, then the capacity, so the
fused result is always exact.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..kernels.common import resolve_impl
from ..resilience import EscalationStep, Ladder
from . import primitives as prim
from .groupby import AGG_OPS, group_aggregate
from .hash_join import (BUILD_BLOCK, _digits, blocked_partitions, build_blocks,
                        choose_partition_bits, phj_overflowed)
from .table import KEY_SENTINEL, Table, nonempty

# aggregates the fused kernel computes (per-slot sums and counts)
FUSED_OPS = ("sum", "mean", "count")


def _value_blocks(vals_part: torch.Tensor, off: torch.Tensor, sz: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """(P, cap) float32 value blocks aligned with `build_blocks`' key blocks
    (same padding geometry, 0.0 fill)."""
    blocks, _, _ = blocked_partitions(vals_part.to(torch.float32), off, sz, cap, 0.0)
    return blocks


def phj_groupjoin(
    R: Table,
    S: Table,
    *,
    key: str = "k",
    group_key: str,
    aggs: dict[str, str],
    num_groups: int,
    agg_strategy: str = "sort",
    build_block: int = BUILD_BLOCK,
    partition_bits: int | None = None,
    hash_keys: bool = True,
    probe_impl: str | None = None,  # "torch" | "cuda" | None (by device)
    agg_kw: dict | None = None,
):
    """Fused pk_fk join + grouped aggregation. Returns (Table, valid_count).

    `group_key` must be a probe-side (S) column. `aggs` maps a column of
    either relation to an op in sum/count/min/max/mean; output columns are
    named f"{col}_{op}". probe_impl None takes 'cuda' for tensors on the
    card and 'torch' otherwise. The 'cuda' arm computes sum, mean and count
    over integer group keys, with float32 sums and means and int32 counts;
    min and max raise there (use probe_impl='torch'). The 'torch' arm takes
    every op and any `agg_strategy` of `group_aggregate`, whose result types
    it keeps."""
    if group_key not in S.column_names:
        raise ValueError(
            f"group_key {group_key!r} must be a probe-side column "
            f"(have {S.column_names}); build-side group keys would need the "
            "matched row materialized, the movement this operator removes")
    for col, op in aggs.items():
        if op not in AGG_OPS:
            raise ValueError(f"unknown agg op {op!r} for {col!r}")
        if col not in S.column_names and col not in R.column_names:
            raise ValueError(f"agg column {col!r} in neither relation")
    impl = resolve_impl(probe_impl, S[key])
    if impl == "cuda":
        for col, op in aggs.items():
            if op not in FUSED_OPS:
                raise ValueError(
                    f"groupjoin probe_impl='cuda' supports sum/mean/count, got {op!r} for "
                    f"{col!r} (use probe_impl='torch' for min/max)")
        if S[group_key].dtype.is_floating_point:
            raise ValueError("groupjoin probe_impl='cuda' needs integer group keys")

    R = nonempty(R, key)
    S = nonempty(S, key)
    p_bits = (partition_bits if partition_bits is not None
              else choose_partition_bits(R.num_rows, build_block))
    P = 1 << p_bits

    dig_r = _digits(R[key], p_bits, hash_keys)
    dig_s = _digits(S[key], p_bits, hash_keys)
    # P + 1 partitions: sentinel rows flood the extra one (see
    # hash_join._digits) and never reach a build block or probe pass
    perm_r, off_r, sz_r = prim.plan_partition_permutation(dig_r, P + 1)
    perm_s, off_s, sz_s = prim.plan_partition_permutation(dig_s, P + 1)
    off_r, sz_r = off_r[:P], sz_r[:P]
    off_s, sz_s = off_s[:P], sz_s[:P]

    kr = prim.apply_permutation(perm_r, R[key])
    ks = prim.apply_permutation(perm_s, S[key])

    # Probe-side columns reach partitioned order by one planned-permutation
    # gather each, on demand, shared between the group key and an aggregate
    # of the same column.
    probe_part: dict[str, torch.Tensor] = {key: ks}

    def probe_col(col):
        if col not in probe_part:
            probe_part[col] = prim.apply_permutation(perm_s, S[col])
        return probe_part[col]

    gk = probe_col(group_key)
    if impl == "cuda":
        bkeys, _, _ = build_blocks(kr, off_r, sz_r, build_block)
        return _groupjoin_cuda(R, S, aggs, num_groups, bkeys, off_r, sz_r, perm_r, probe_col,
                               ks, gk, off_s, sz_s, group_key)

    # vid_r is -1 where nothing matched (the reference's plain probe gives
    # off_r[part] there): every fetch below is masked by `matched` either way
    vid_r, matched = kops.hash_probe(kr, off_r, sz_r, ks, off_s, sz_s, build_block,
                                     impl="torch")
    gk_masked = torch.where(matched, gk, KEY_SENTINEL)

    # Per-row aggregate inputs in partitioned probe order: the rows the
    # accumulator reads directly; the joined row is never assembled.
    cols = {group_key: gk_masked}
    for col, op in aggs.items():
        if col in cols:
            continue  # aggregating the group key: reuse the masked column
        if op == "count":
            cols[col] = torch.zeros(ks.shape, dtype=torch.int32, device=ks.device)
        elif col in S.column_names:
            cols[col] = probe_col(col)
        else:
            # build-side input, GFTR: transform once, then one clustered
            # probe-length gather through the matched virtual IDs
            tr = prim.apply_permutation(perm_r, R[col])
            cols[col] = prim.gather(tr, torch.where(matched, vid_r, -1), fill=0)
    return group_aggregate(Table(cols), key=group_key, aggs=aggs, num_groups=num_groups,
                           strategy=agg_strategy, **(agg_kw or {}))


def _groupjoin_cuda(R, S, aggs, num_groups, bkeys, off_r, sz_r, perm_r, probe_col, ks, gk,
                    off_s, sz_s, group_key):
    """Probe + accumulate in one kernel pass for every aggregate column
    together (match finding, build-value fetch from the staged block,
    tile-local partials), then one sorted combine."""
    sum_cols = [(col, op) for col, op in aggs.items() if op != "count"]
    col_sides, pv_cols, bv_cols = [], [], []
    for col, _ in sum_cols:
        if col in S.column_names:
            col_sides.append(("probe", len(pv_cols)))
            pv_cols.append(probe_col(col).to(torch.float32))
        else:
            col_sides.append(("build", len(bv_cols)))
            bv_cols.append(_value_blocks(prim.apply_permutation(perm_r, R[col]), off_r, sz_r,
                                         bkeys.shape[1]))
    gkeys, sums, gcounts, count = kops.groupjoin_probe_agg(
        bkeys, torch.stack(bv_cols, dim=1) if bv_cols else None, ks, gk,
        torch.stack(pv_cols) if pv_cols else None, off_s, sz_s, num_groups,
        col_sides=tuple(col_sides))

    out: dict[str, torch.Tensor] = {}
    for (col, op), s in zip(sum_cols, sums):
        out[f"{col}_{op}"] = s
    for col, op in aggs.items():
        if op == "count":
            out[f"{col}_{op}"] = gcounts
        elif op == "mean":
            out[f"{col}_{op}"] = out[f"{col}_{op}"] / gcounts.clamp(min=1).to(torch.float32)
    return Table({group_key: gkeys, **out}), count


# ---------------------------------------------------------------------------
# Capacity checks
# ---------------------------------------------------------------------------
def groupjoin_required_groups(S: Table, *, key: str = "k", group_key: str,
                              agg_strategy: str = "sort") -> int:
    """Exact lower bound on the accumulator capacity the fused aggregation
    needs: the number of distinct probe-side group keys over rows whose join
    key is valid (matching only removes rows), or, for the 'scatter'
    strategy, the dense key domain (max valid group key + 1). One sort and
    one scalar read."""
    if S.num_rows == 0:
        return 0
    gk = S[group_key]
    valid = S[key] != KEY_SENTINEL
    masked = torch.where(valid, gk, KEY_SENTINEL)
    if agg_strategy == "scatter":
        return int(masked.max()) + 1
    sk = torch.sort(masked).values
    present = sk != KEY_SENTINEL
    boundary = torch.cat([present[:1], (sk[1:] != sk[:-1]) & present[1:]])
    return int(boundary.sum())


def groupjoin_overflowed(R: Table, S: Table, *, key: str = "k", group_key: str,
                         num_groups: int, build_block: int = BUILD_BLOCK,
                         partition_bits: int | None = None, hash_keys: bool = True,
                         agg_strategy: str = "sort"):
    """Host-side check of both static capacities the fused path pads to:
    would any build co-partition exceed its block (more partition bits fix
    that), and does the accumulator cover every group (only a larger
    capacity can). Returns (build_overflow, p_bits, group_overflow,
    required_groups)."""
    build_ovf, p_bits = phj_overflowed(R, key=key, build_block=build_block,
                                       partition_bits=partition_bits, hash_keys=hash_keys)
    required = groupjoin_required_groups(S, key=key, group_key=group_key,
                                         agg_strategy=agg_strategy)
    return build_ovf, p_bits, required > num_groups, required


def groupjoin_checked(R: Table, S: Table, *, key: str = "k", group_key: str,
                      aggs: dict[str, str], num_groups: int, max_extra_bits: int = 4,
                      build_block: int = BUILD_BLOCK, max_attempts: int = 8,
                      with_report: bool = False, **kw):
    """phj_groupjoin on the escalation ladder, covering both capacities the
    fused path pads to: first add partition bits while a build co-partition
    overflows its block, then grow the accumulator when `num_groups` would
    drop groups, to the required count (the distinct group keys, or the
    dense key domain for the 'scatter' strategy) rounded up to a multiple
    of 64. Both checks are host-side reductions; the re-run uses strictly
    larger shapes, so the result is exact, or `EscalationExhausted` is
    raised.

    `with_report=True` also returns the `EscalationReport`."""
    hash_keys = kw.get("hash_keys", True)
    agg_strategy = kw.get("agg_strategy", "sort")
    base_bits = kw.pop("partition_bits", None)
    if base_bits is None:
        base_bits = choose_partition_bits(R.num_rows, build_block)
    knobs = {"partition_bits": base_bits, "num_groups": num_groups}

    def check(kn):
        build_ovf, _, group_ovf, required = groupjoin_overflowed(
            R, S, key=key, group_key=group_key, num_groups=kn["num_groups"],
            build_block=build_block, partition_bits=kn["partition_bits"],
            hash_keys=hash_keys, agg_strategy=agg_strategy)
        parts = []
        if build_ovf:
            parts.append(f"build partition > {build_block} rows")
        if group_ovf:
            parts.append(f"{required} groups > capacity {kn['num_groups']}")
        return not parts, "; ".join(parts), {"build_ovf": build_ovf, "required": required}

    def grow_bits(kn, diag):
        # yields to the capacity rung on a pure accumulator overflow (more
        # fan-out cannot make capacity)
        if kn["partition_bits"] >= 20:
            return None
        if diag is not None and not diag["build_ovf"] and diag["required"] > kn["num_groups"]:
            return None
        return {**kn, "partition_bits": kn["partition_bits"] + 1}

    def grow_capacity(kn, diag):
        required = diag["required"] if diag else 0
        if diag is not None and diag["build_ovf"] and required <= kn["num_groups"]:
            return None  # capacity cannot fix a build-block overflow
        if required > kn["num_groups"]:
            target = -(-required // 64) * 64
        else:  # a forced overflow with nothing actually wrong: double
            target = max(64, kn["num_groups"] * 2)
        return {**kn, "num_groups": target}

    ladder = Ladder("groupjoin", [
        EscalationStep("partition_bits", grow_bits, max_times=max_extra_bits),
        EscalationStep("num_groups", grow_capacity, max_times=3),
    ], max_attempts=max_attempts)
    report = ladder.resolve(knobs, check)
    kn = report.final_knobs
    out = phj_groupjoin(R, S, key=key, group_key=group_key, aggs=aggs,
                        num_groups=kn["num_groups"], build_block=build_block,
                        partition_bits=kn["partition_bits"], **kw)
    return (out, report) if with_report else out
