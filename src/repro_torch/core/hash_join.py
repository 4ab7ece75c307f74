"""Partitioned hash join: PHJ-UM (GFUR, §3.2) and PHJ-OM (GFTR, §4.3).

Both sides are stably radix-partitioned on hashed key bits into contiguous
arrays (one plan per side; every column costs one gather). The first
`build_block` rows of each build partition form the paper's shared-memory
hash table, and the probe keys of the co-partition are matched against it
(`kops.hash_probe`, which reads both partitioned key columns directly). The
layout comes from prefix-sum ranks, never from atomics, so partitioning
(key, col_1) and (key, col_2) gives the same layout: the GFTR requirement.

The m:n mode finds the same matches as the reference's block comparison
(every build-block slot of the co-partition against every probe row) in
O(n log n): a key's rows all land in one partition, so a stable sort of the
rows that can match (the first `build_block` of each build partition) by key
keeps each key's matches in block order, and two binary searches per probe
row give its count and its first match (`match_index`, `probe_counts`,
`probe_kth_match`).

`phj_join_checked` runs the join on the escalation ladder: partition bits
first, then the sort-merge join, which is exact for any multiplicity.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..kernels.ref import hash32  # noqa: F401  (re-exported: the hash's plain version)
from ..resilience import EscalationStep, Ladder
from . import primitives as prim
from .phases import phase
from .sort_merge import MODES, smj_join
from .table import KEY_SENTINEL, Table, nonempty

# default build block: the rows of a build partition that can match
BUILD_BLOCK = 256


def choose_partition_bits(n_build: int, build_block: int) -> int:
    """Fan-out so that E[partition size] <= build_block / 4."""
    target = max(1, (4 * n_build) // build_block)
    return max(1, min(20, (target - 1).bit_length()))


def _digits(keys: torch.Tensor, p_bits: int, hash_keys: bool) -> torch.Tensor:
    """Partition digit per row, in [0, 2^p_bits]: valid keys spread over
    [0, P) by the hash; KEY_SENTINEL rows go to their own partition P so they
    can never crowd valid keys out of a shared build block. One launch of
    the partition_digits kernel on the card (`kops.partition_digits`); the
    digits take the partition plan's arm (`REPRO_PARTITION_PLAN_IMPL`),
    whose first step they are."""
    return kops.partition_digits(keys, p_bits, hash_keys, kops.partition_plan_impl())


# ---------------------------------------------------------------------------
# Build-side padded blocks
# ---------------------------------------------------------------------------
def blocked_partitions(arr_part: torch.Tensor, off: torch.Tensor, sz: torch.Tensor,
                       cap: int, fill):
    """Pad each contiguous partition of a partitioned column to `cap` rows:
    (P, cap) blocks where slot (p, i) holds the i-th row of partition p and
    out-of-partition slots carry `fill`. Returns (blocks, idx, valid)."""
    i = torch.arange(cap, dtype=torch.int32, device=arr_part.device)[None, :]
    idx = off[:, None].to(torch.int32) + i
    valid = i < sz[:, None]
    idx_c = idx.clamp(0, arr_part.shape[0] - 1)
    return torch.where(valid, arr_part[idx_c], fill), idx, valid


def build_blocks(keys_part: torch.Tensor, off: torch.Tensor, sz: torch.Tensor, cap: int):
    """(P, cap) key blocks and virtual-ID blocks (positions in the
    partitioned array). Returns (bkeys, bvids, overflow)."""
    bkeys, idx, valid = blocked_partitions(keys_part, off, sz, cap, KEY_SENTINEL)
    bvids = torch.where(valid, idx, -1)
    overflow = sz.max() > cap
    return bkeys, bvids, overflow


# ---------------------------------------------------------------------------
# m:n match finding
# ---------------------------------------------------------------------------
def match_index(keys_part: torch.Tensor, off: torch.Tensor, build_block: int):
    """The build rows that can match, in key order: (sorted_keys,
    positions int32). `keys_part` is the partitioned build key column and
    `off` its partition offsets; only the first `build_block` rows of a
    partition are in its block (the rest carry KEY_SENTINEL here, which no
    probe row matches). Equal keys share a partition, and the sort is
    stable, so each key's rows stay in block order."""
    n = keys_part.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=keys_part.device)
    part = torch.searchsorted(off, pos, right=True, out_int32=True) - 1
    in_block = pos - off[part] < build_block
    sk, order = torch.sort(torch.where(in_block, keys_part, KEY_SENTINEL), stable=True)
    return sk, order.to(torch.int32)


def probe_counts(sorted_keys: torch.Tensor, probe_keys: torch.Tensor):
    """m:n: the number of build matches of each probe row and the index in
    `sorted_keys` of its first one: (counts, first), both int32. KEY_SENTINEL
    probe rows count 0."""
    pk = probe_keys.to(torch.promote_types(probe_keys.dtype, sorted_keys.dtype))
    sk = sorted_keys.to(pk.dtype)
    first = torch.searchsorted(sk, pk, out_int32=True)
    last = torch.searchsorted(sk, pk, right=True, out_int32=True)
    return torch.where(probe_keys != KEY_SENTINEL, last - first, 0), first


def probe_kth_match(positions: torch.Tensor, first: torch.Tensor, rows: torch.Tensor,
                    ranks: torch.Tensor) -> torch.Tensor:
    """m:n expansion: for output row t of probe row rows[t], the position in
    the partitioned build column of its ranks[t]-th match in block order.
    Rows past the valid count get a clipped position."""
    idx = (first[rows] + ranks).clamp(0, max(positions.shape[0] - 1, 0))
    return positions[idx]


# ---------------------------------------------------------------------------
# The join
# ---------------------------------------------------------------------------
def phj_join(
    R: Table,
    S: Table,
    *,
    key: str = "k",
    pattern: str = "gftr",  # "gftr" (PHJ-OM) | "gfur" (PHJ-UM)
    out_size: int | None = None,
    mode: str = "pk_fk",
    build_block: int = BUILD_BLOCK,
    partition_bits: int | None = None,
    hash_keys: bool = True,
    probe_impl: str | None = None,  # "torch" | "cuda" | None (by device)
    gather_impl: str | None = None,  # "torch" | "cuda" | None (by device)
    phases: dict | None = None,
):
    """End-to-end partitioned hash join. Returns (Table, valid_count), with
    valid_count a 0-d int32 tensor.

    Only the first `build_block` rows of a build partition can match; a
    partition that would overflow drops matches, which `phj_overflowed`
    checks beforehand (`phj_join_checked` escalates). In m:n mode, output
    row t is the ranks[t]-th match in block order of probe row rows[t]
    (`prim.expand_offsets`); out_size defaults to 2 * S.num_rows there and
    rows past it are dropped.
    `phases`, when given, receives the wall seconds of each phase (plans,
    probe, compact or expand, gathers), measured with a device
    synchronisation at each phase edge."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; allowed: {'/'.join(MODES)}")
    if pattern not in ("gftr", "gfur"):
        raise ValueError(f"unknown pattern {pattern!r}")
    if out_size is None:
        out_size = S.num_rows if mode == "pk_fk" else 2 * S.num_rows
    out_size = max(out_size, 1)
    R = nonempty(R, key)
    S = nonempty(S, key)
    dev = S.device
    r_pay = [n for n in R.column_names if n != key]
    s_pay = [n for n in S.column_names if n != key]
    p_bits = (partition_bits if partition_bits is not None
              else choose_partition_bits(R.num_rows, build_block))
    P = 1 << p_bits

    with phase(phases, "plans", dev):
        dig_r = _digits(R[key], p_bits, hash_keys)
        dig_s = _digits(S[key], p_bits, hash_keys)
        # P + 1 partitions: the extra one swallows sentinel rows and never
        # gets a build block or a probe pass
        perm_r, off_r, sz_r = prim.plan_partition_permutation(dig_r, P + 1)
        perm_s, off_s, sz_s = prim.plan_partition_permutation(dig_s, P + 1)

    with phase(phases, "probe", dev):
        kr = prim.apply_permutation(perm_r, R[key])
        ks = prim.apply_permutation(perm_s, S[key])
        if mode == "pk_fk":
            # vid_r is -1 where nothing matched (the reference's plain arm
            # gives off_r[part] there); `compact` drops those rows either way
            vid_r, matched = kops.hash_probe(kr, off_r[:P], sz_r[:P], ks, off_s[:P], sz_s[:P],
                                             build_block, probe_impl)
        else:
            sk_r, pos_r = match_index(kr, off_r, build_block)
            counts, first = probe_counts(sk_r, ks)
            del sk_r

    with phase(phases, "compact" if mode == "pk_fk" else "expand", dev):
        if mode == "pk_fk":
            vid_s = torch.arange(ks.shape[0], dtype=torch.int32, device=dev)
            (keys_o, vr, vs), count = prim.compact(matched, [ks, vid_r, vid_s], out_size,
                                                   fill=KEY_SENTINEL)
            valid = torch.arange(out_size, dtype=torch.int32, device=dev) < count
        else:
            vs, ranks, valid, total = prim.expand_offsets(counts, out_size)
            vr = probe_kth_match(pos_r, first, vs, ranks)
            del pos_r, first, ranks
            keys_o = torch.where(valid, ks[vs], KEY_SENTINEL)
            count = torch.clamp(total, max=out_size)
        ID_R = torch.where(valid, vr, -1)
        ID_S = torch.where(valid, vs, -1)

    with phase(phases, "gathers", dev):
        cols = {key: keys_o}
        if pattern == "gfur":
            # UM: physical IDs of the untransformed inputs, unclustered gathers
            pid_r = torch.where(valid, perm_r[vr.clamp(0, R.num_rows - 1)], -1)
            pid_s = torch.where(valid, perm_s[vs.clamp(0, S.num_rows - 1)], -1)
            for n in r_pay:
                cols[n] = prim.gather(R[n], pid_r, fill=0)
            for n in s_pay:
                cols[n] = prim.gather(S[n], pid_s, fill=0)
        else:
            # OM: gather from the partitioned relations. Probe-side IDs are
            # perfectly clustered, build-side IDs within partitions (§4.3).
            for n in r_pay:
                cols[n] = kops.clustered_gather(prim.apply_permutation(perm_r, R[n]), ID_R,
                                                gather_impl)
            for n in s_pay:
                cols[n] = kops.clustered_gather(prim.apply_permutation(perm_s, S[n]), ID_S,
                                                gather_impl)
    return Table(cols), count


def phj_overflowed(R: Table, *, key: str = "k", build_block: int = BUILD_BLOCK,
                   partition_bits: int | None = None, hash_keys: bool = True):
    """Host-side check: would any build partition exceed the build block?
    Returns (overflowed, p_bits). The sentinel partition P may overflow: it
    never gets a block."""
    p_bits = (partition_bits if partition_bits is not None
              else choose_partition_bits(R.num_rows, build_block))
    dig = _digits(R[key], p_bits, hash_keys)
    sizes = torch.bincount(dig, minlength=(1 << p_bits) + 1)[:1 << p_bits]
    return bool(sizes.max() > build_block), p_bits


def phj_join_checked(R: Table, S: Table, *, key: str = "k", max_extra_bits: int = 4,
                     build_block: int = BUILD_BLOCK, max_attempts: int = 8,
                     with_report: bool = False, **kw):
    """phj_join on the escalation ladder: add partition bits while a build
    co-partition would overflow its block; when more bits cannot help (one
    key's duplicates share a partition at any fan-out), fall back to the
    sort-merge join, which is exact for any multiplicity. Either the ladder
    converges or it raises `EscalationExhausted`; it never drops matches.

    `with_report=True` also returns the `EscalationReport`. The sort-merge
    rung takes only the keywords both joins share (pattern, out_size, mode,
    find_impl)."""
    hash_keys = kw.get("hash_keys", True)
    base_bits = kw.pop("partition_bits", None)
    if base_bits is None:
        base_bits = choose_partition_bits(R.num_rows, build_block)
    knobs = {"algorithm": "phj", "partition_bits": base_bits, "build_block": build_block}

    def check(kn):
        if kn["algorithm"] != "phj":
            return True, "smj fallback (exact for any multiplicity)", None
        over, _ = phj_overflowed(R, key=key, build_block=kn["build_block"],
                                 partition_bits=kn["partition_bits"], hash_keys=hash_keys)
        return (not over, f"build partition > {kn['build_block']} rows" if over else "", None)

    def grow_bits(kn, diag):
        if kn["algorithm"] != "phj" or kn["partition_bits"] >= 20:
            return None
        return {**kn, "partition_bits": kn["partition_bits"] + 1}

    def to_smj(kn, diag):
        return {**kn, "algorithm": "smj"}

    ladder = Ladder("phj", [
        EscalationStep("partition_bits", grow_bits, max_times=max_extra_bits),
        EscalationStep("strategy:smj", to_smj, max_times=1),
    ], max_attempts=max_attempts)
    report = ladder.resolve(knobs, check)
    kn = report.final_knobs
    if kn["algorithm"] == "smj":
        smj_kw = {k: v for k, v in kw.items() if k in ("pattern", "out_size", "mode", "find_impl")}
        out = smj_join(R, S, key=key, **smj_kw)
    else:
        out = phj_join(R, S, key=key, build_block=kn["build_block"],
                       partition_bits=kn["partition_bits"], **kw)
    return (out, report) if with_report else out
