"""Join-algorithm planner: the paper's Fig. 18 decision trees + a
primitive-profile cost model (§5.4: "it is crucial to profile the primitives
beforehand ... weigh clustered GATHERs with additional transformation cost
against unclustered GATHERs").

The decision tree is the paper's summary heuristic; the cost model predicts
per-phase byte traffic from profiled primitive throughputs and is what a
query optimizer would consume. The port's copy of the JAX package's
planner: the trees and formulas are unchanged; `PrimitiveProfile.measure`
times PyTorch programs on the given device.
"""
from __future__ import annotations

import dataclasses

from . import primitives as prim


@dataclasses.dataclass(frozen=True)
class JoinStats:
    """Workload descriptors available to an optimizer."""

    n_r: int
    n_s: int
    r_payload_cols: int
    s_payload_cols: int
    match_ratio: float = 1.0  # fraction of S rows with a partner
    zipf: float = 0.0  # FK skew
    key_bytes: int = 4
    payload_bytes: int = 4

    @property
    def wide(self) -> bool:
        return self.r_payload_cols > 1 or self.s_payload_cols > 1


def choose_algorithm(stats: JoinStats) -> tuple[str, str, str]:
    """Fig. 18a decision tree. Returns (algorithm, pattern, rationale)."""
    # Narrow joins: PHJ-* (transform cost identical; Fig. 9) — PHJ-UM for
    # low match ratios, PHJ-OM otherwise (Fig. 13).
    if not stats.wide:
        if stats.match_ratio < 0.25:
            return "phj", "gfur", "narrow + low match ratio -> PHJ-UM (Fig. 13)"
        return "phj", "gftr", "narrow -> PHJ-* (Fig. 9); OM for robustness to skew (Fig. 14)"
    # Wide joins.
    if stats.match_ratio < 0.25:
        return "phj", "gfur", "wide + low match ratio: materialization cheap -> PHJ-UM (Fig. 13)"
    if stats.zipf > 1.0:
        # PHJ-OM's RADIX-PARTITION is skew-robust; bucket-chaining (not
        # implemented here) degrades; SMJ-UM is the runner-up (Fig. 14).
        return "phj", "gftr", "wide + skewed FKs -> PHJ-OM (Fig. 14)"
    if stats.key_bytes >= 8 or stats.payload_bytes >= 8:
        # SMJ-OM loses its edge with 8-byte data (Fig. 15 / §5.3); PHJ-OM
        # keeps it.
        return "phj", "gftr", "8-byte data: sorting too costly for SMJ-OM -> PHJ-OM (Fig. 15)"
    return "phj", "gftr", "wide + high match ratio -> *-OM; PHJ-OM dominates (Fig. 10)"


def choose_smj_pattern(stats: JoinStats) -> tuple[str, str]:
    """Fig. 18b: SMJ-OM vs SMJ-UM only."""
    if not stats.wide:
        return "gfur", "narrow: SMJ-OM == SMJ-UM (Fig. 9)"
    if stats.match_ratio < 0.25:
        return "gfur", "low match ratio (Fig. 13)"
    if stats.key_bytes >= 8 or stats.payload_bytes >= 8:
        return "gfur", "8-byte sorting cost kills SMJ-OM's edge (Fig. 15)"
    if stats.zipf > 1.0:
        return "gfur", "skew: SMJ-UM competitive via low materialization (Fig. 14)"
    return "gftr", "wide + high match -> SMJ-OM (Fig. 10)"


# ---------------------------------------------------------------------------
# Primitive-profile cost model (bytes moved per phase)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PrimitiveProfile:
    """Measured throughputs (bytes/sec) for the three primitives on the
    target part, plus the random-access penalty of unclustered gathers
    (paper Table 4: ~4.5 lines/load unclustered vs 1.5 clustered => ~3x
    bytes, ~8.5x cycles)."""

    # What `measure()` gave on one NVIDIA H100 80GB HBM3 (power limit
    # 700.00 W) at its default n = 65,536 rows and 4-byte keys
    # (chip_smoke.py prints it); re-profile per card (paper §5.4). At this
    # n the card is launch-bound: the rates are far below its memory rate.
    seq_bw: float = 12383976319.497156
    sort_pass_bw: float = 24763272134.95855
    # A partition pass is NOT a sort pass: it is histogram + prefix + stable
    # rank + move (kernels.ops.partition_plan) — streaming dense work with
    # no compare-exchange network — profiled separately so the planner
    # prices the pipeline that actually runs.
    partition_pass_bw: float = 1466457762.9216678
    unclustered_penalty: float = 2.253968262348582  # slowdown per random-gathered byte
    clustered_penalty: float = 2.253968262348582

    @classmethod
    def measure(cls, n: int = 1 << 16, key_bytes: int = 4, iters: int = 3,
                warmup: int = 1, device="cuda") -> "PrimitiveProfile":
        """Calibrate the profile from timed microbenchmarks on `device`
        (§5.4: "profile the primitives beforehand").

        Times a sequential stream, a SORT-PAIRS, the partition plan at an
        8-bit fan-out (the histogram and rank kernels on the card) and
        clustered/unclustered GATHERs at `n` rows, the median of `iters`
        runs after `warmup` (CUDA events on the card, the host clock
        elsewhere), then backs the five model constants out of the times.
        Penalties are clamped so the model stays physical (unclustered >=
        clustered >= 1) even when a cache blunts the random-access gap at
        small `n`."""
        import time

        import numpy as np
        import torch

        device = torch.device(device)
        on_card = device.type == "cuda"

        def timed(f, *args):
            for _ in range(warmup):
                f(*args)
            ts = []
            for _ in range(iters):
                if on_card:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    f(*args)
                    end.record()
                    end.synchronize()
                    ts.append(start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    f(*args)
                    ts.append(time.perf_counter() - t0)
            ts.sort()
            return max(ts[len(ts) // 2], 1e-9)

        def on(a):
            return torch.from_numpy(a).to(device)

        rng = np.random.default_rng(0)
        kdt = np.int32 if key_bytes <= 4 else np.int64
        keys = on(rng.permutation(n).astype(kdt))
        vals = on(rng.integers(0, 1 << 30, n).astype(np.int32))
        idx_seq = on(np.arange(n, dtype=np.int32))
        idx_rand = on(rng.permutation(n).astype(np.int32))

        # Sequential stream: read + write n*4 bytes each.
        t_seq = timed(lambda v: v + 1, vals)
        seq_bw = 2 * n * 4 / t_seq
        # SORT-PAIRS: charge the LSD pass structure the cost model assumes.
        passes = prim.num_radix_passes(8 * key_bytes)
        t_sort = timed(lambda k, v: prim.sort_pairs(k, v), keys, vals)
        sort_pass_bw = passes * n * (key_bytes + 4) * 2 / t_sort
        # RADIX-PARTITION: the production plan at an 8-bit fan-out, backed
        # out by the same (digit + perm) x rd/wr byte convention
        # partition_cost charges.
        digits = on(rng.integers(0, 256, n).astype(np.int32))
        t_part = timed(lambda d: prim.plan_partition_permutation(d, 256)[0], digits)
        partition_pass_bw = prim.num_radix_passes(8) * n * 8 * 2 / t_part
        # GATHER: effective slowdown per gathered byte vs the sequential rate.
        gather_bytes = n * 4
        t_clu = timed(lambda v, i: torch.index_select(v, 0, i), vals, idx_seq)
        t_unc = timed(lambda v, i: torch.index_select(v, 0, i), vals, idx_rand)
        clustered = max(t_clu * seq_bw / gather_bytes, 1.0)
        unclustered = max(t_unc * seq_bw / gather_bytes, clustered)
        return cls(seq_bw=seq_bw, sort_pass_bw=sort_pass_bw,
                   partition_pass_bw=partition_pass_bw,
                   unclustered_penalty=unclustered, clustered_penalty=clustered)

    def sort_cost(self, n, key_b, val_b):
        passes = prim.num_radix_passes(8 * key_b)  # 8 bits/pass over key width
        return passes * n * (key_b + val_b) * 2 / self.sort_pass_bw

    def partition_cost(self, n, key_b, val_b, total_bits):
        """A partition pass is histogram + rank + move at partition-pass
        bandwidth — pass count scales with the FAN-OUT bits, never the key
        width, and the rate is profiled separately from the sort network
        (the split the kernel-backed planner makes real)."""
        passes = prim.num_radix_passes(total_bits)
        return passes * n * (key_b + val_b) * 2 / self.partition_pass_bw

    def gather_cost(self, n, val_b, clustered):
        pen = self.clustered_penalty if clustered else self.unclustered_penalty
        return n * val_b * pen / self.seq_bw


def predict_join_time(stats: JoinStats, algorithm: str, pattern: str,
                      profile: PrimitiveProfile | None = None,
                      partition_bits: int = 16) -> dict[str, float]:
    """Analytic per-phase time (seconds on the profiled part). Mirrors the
    paper's §4.2 '18 sequential passes replace one random scan' arithmetic."""
    p = profile or PrimitiveProfile()
    kb, vb = stats.key_bytes, stats.payload_bytes
    n_out = int(stats.n_s * stats.match_ratio)
    t = {"transform": 0.0, "find": 0.0, "materialize": 0.0}

    trans = p.sort_cost if algorithm == "smj" else (
        lambda n, k, v: p.partition_cost(n, k, v, partition_bits)
    )
    if algorithm == "nphj":
        t["find"] = (stats.n_r + stats.n_s) * kb * p.unclustered_penalty / p.seq_bw
    else:
        # key+first payload (gftr) or key+ID (gfur) transform for both sides
        t["transform"] = trans(stats.n_r, kb, vb if pattern == "gftr" else 4)
        t["transform"] += trans(stats.n_s, kb, vb if pattern == "gftr" else 4)
        t["find"] = (stats.n_r + stats.n_s) * kb / p.seq_bw  # streaming merge/probe

    clustered = pattern == "gftr" and algorithm != "nphj"
    for ncols, n_side in ((stats.r_payload_cols, stats.n_r), (stats.s_payload_cols, stats.n_s)):
        for i in range(ncols):
            if pattern == "gftr" and i >= 1:
                # lazy transform via the planned permutation: one unclustered
                # gather of the column, not a key+payload re-sort/partition
                # (one-permutation materialization, DESIGN.md §8)
                t["materialize"] += p.gather_cost(n_side, vb, clustered=False)
            t["materialize"] += p.gather_cost(n_out, vb, clustered)
    t["total"] = sum(t.values())
    return t


def predict_groupby_time(n_rows: int, n_aggs: int, strategy: str,
                         profile: PrimitiveProfile | None = None, *,
                         key_bytes: int = 4, val_bytes: int = 4,
                         row_block: int | None = None) -> float:
    """Analytic grouped-aggregation time (seconds) per strategy, matching
    the executable paths in core.groupby:

      sort            one (key, iota) sort — radix passes scale with the
                      KEY WIDTH, at the sort network's profiled rate — +
                      per column: one permutation gather + a streaming
                      segmented reduce
      partition       sort-free rank passes over (digit, key, iota) — pass
                      count scales with log2(partitions), independent of
                      key width, at the separately profiled partition-pass
                      rate (histogram + rank + move,
                      kernels.ops.partition_plan; the carried key moves at
                      pass rate, the RADIX-PARTITION(kin, vin) contract) —
                      + one gather per payload column into the blocked
                      layout + a streaming block-local reduce per column
                      (the VMEM-resident accumulator emits distinct groups,
                      not slots, so its HBM traffic is ~n)
      partition_hash  streaming tile-partial pass + sorted combine over the
                      collapsed partials (~n/4)
      scatter         per column: one unclustered accumulator scatter

    The sort/partition asymmetry is the paper's crossover: at high group
    cardinality partition replaces key-width-many sort passes with
    ceil((p_bits+1)/8) histogram/rank passes that move only (digit, perm)
    bytes — decisive for 8-byte keys and already ahead at 4 bytes once the
    fan-out needs <= 2 passes. The partition and sort terms are split onto
    separate profiled bandwidths so calibration prices the pipeline that
    actually runs.
    """
    p = profile or PrimitiveProfile()
    kb, vb = key_bytes, val_bytes
    if strategy in ("sort", "sort_pallas"):
        t = p.sort_cost(n_rows, kb, 4)  # key + iota, once
        t += n_aggs * p.gather_cost(n_rows, vb, clustered=False)
        t += (1 + n_aggs) * 2 * n_rows * vb / p.seq_bw
        return t
    if strategy == "partition":
        from .groupby import PARTITION_ROW_BLOCK, choose_groupby_partition_bits

        rb = PARTITION_ROW_BLOCK if row_block is None else row_block
        bits = choose_groupby_partition_bits(n_rows, rb) + 1
        t = p.partition_cost(n_rows, 4, kb + 4, bits)  # (digit, key, iota)
        t += n_aggs * p.gather_cost(n_rows, vb, clustered=False)
        t += (1 + n_aggs) * 2 * n_rows * vb / p.seq_bw  # block-local reduce
        return t
    if strategy == "partition_hash":
        return (2 * n_rows * (kb + vb) / p.seq_bw
                + n_aggs * p.sort_cost(max(n_rows // 4, 1), kb, vb))
    if strategy == "scatter":
        return max(n_aggs, 1) * p.gather_cost(n_rows, vb, clustered=False)
    raise ValueError(f"unknown group-by strategy {strategy!r}")


def predict_groupjoin_time(stats: JoinStats, n_aggs: int,
                           agg_strategy: str = "sort",
                           profile: PrimitiveProfile | None = None,
                           partition_bits: int = 16,
                           group_key_carried: bool = False,
                           build_aggs: int = 0,
                           agg_row_block: int | None = None) -> dict[str, float]:
    """Analytic per-phase time of the fused group-join (core.groupjoin):
    probe cost + scatter-accumulate cost, ZERO materialization/gather terms
    — the fusion's whole point is that the joined row is never written to
    or re-read from HBM.

      transform   co-partition both sides, (key, iota) only — identical to
                  the join's narrow transform
      find        streaming co-partition probe
      accumulate  the per-column lazy transforms (same rate the join model
                  charges them): one unclustered n_s permutation gather
                  for the group key (waived via `group_key_carried` when
                  it IS the join key) and for each probe-side aggregate
                  input; build-side inputs (`build_aggs` of the `n_aggs`)
                  instead cost one n_r permutation gather plus one
                  CLUSTERED probe-length gather through the matched
                  virtual IDs (the GFTR pattern); then the group-by cost
                  shape over ALL n_s probe rows (matched rows are masked
                  in place, never compacted)

    The structural asymmetry vs the unfused plan: fused aggregates the
    whole probe side regardless of match ratio, while join-then-group-by
    materializes n_s * match_ratio rows and only groups those. High match
    ratios therefore favor fusion (the materialization round trip
    dominates); very low ones favor the unfused plan (the tiny join output
    is cheaper to group than the full probe side) — the crossover the
    engine's fusion pass prices."""
    p = profile or PrimitiveProfile()
    kb, vb = stats.key_bytes, stats.payload_bytes
    probe_aggs = max(n_aggs - build_aggs, 0)
    t = {"transform": 0.0, "find": 0.0, "accumulate": 0.0}
    t["transform"] = p.partition_cost(stats.n_r, kb, 4, partition_bits)
    t["transform"] += p.partition_cost(stats.n_s, kb, 4, partition_bits)
    t["find"] = (stats.n_r + stats.n_s) * kb / p.seq_bw
    t["accumulate"] = (0.0 if group_key_carried
                       else p.gather_cost(stats.n_s, kb, clustered=False))
    t["accumulate"] += probe_aggs * p.gather_cost(stats.n_s, vb,
                                                  clustered=False)
    t["accumulate"] += build_aggs * (
        p.gather_cost(stats.n_r, vb, clustered=False)
        + p.gather_cost(stats.n_s, vb, clustered=True))
    t["accumulate"] += predict_groupby_time(stats.n_s, n_aggs, agg_strategy,
                                            p, key_bytes=kb, val_bytes=vb,
                                            row_block=agg_row_block)
    t["total"] = sum(t.values())
    return t
