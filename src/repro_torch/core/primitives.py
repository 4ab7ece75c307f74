"""GPU primitives of the paper (§2.3) on PyTorch.

  RADIX-PARTITION(kin, vin, i, j) -> stable partition on radix bits [i, j)
  SORT-PAIRS(kin, vin)            -> stable sort by key
  GATHER(in, map, out)            -> out[i] = in[map[i]]

`radix_sort_pairs` builds SORT-PAIRS from 8-bit RADIX-PARTITION passes, the
pass structure the paper's cost model counts.

Partitioning and sorting are planned once (`plan_partition_permutation`,
`plan_sort_permutation`) and every payload column is then materialized
with one gather (`apply_permutation`):
the one-permutation layer of the reference. Layout tensors are int32 on
every path; torch's arange, cumsum and bincount default to int64, so they
are cast here.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import ops as kops

RADIX_BITS_PER_PASS = 8  # paper §2.3: one RADIX-PARTITION pass does at most 8 bits


# ---------------------------------------------------------------------------
# SORT-PAIRS
# ---------------------------------------------------------------------------
def sort_pairs(keys: torch.Tensor, *values: torch.Tensor):
    """Stable key-value sort: (sorted_keys, *values_permuted_alike), or the
    sorted keys alone when no values are given."""
    sk, order = torch.sort(keys, stable=True)
    return (sk,) + tuple(v[order] for v in values) if values else sk


def argsort_stable(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort, int32: out[i] = index of the i-th smallest key."""
    return torch.sort(keys, stable=True).indices.to(torch.int32)


def apply_permutation(perm: torch.Tensor, *cols: torch.Tensor):
    """out[i] = col[perm[i]] per column, one gather each. A single tensor for
    one column, a tuple for several."""
    outs = tuple(c[perm] for c in cols)
    return outs if len(cols) != 1 else outs[0]


def plan_sort_permutation(keys: torch.Tensor):
    """Plan a stable key sort once, payloads later: (sorted_keys, perm int32),
    where `apply_permutation(perm, col)` gives any payload column in key
    order at one gather."""
    return kops.sort_plan(keys)


def plan_partition_permutation(digits: torch.Tensor, num_partitions: int, *,
                               carry: Sequence[torch.Tensor] = (),
                               impl: str | None = None):
    """Plan a stable radix partition once, payloads later.

    Returns (perm, offsets, sizes), or (perm, carried, offsets, sizes) when
    `carry` is non-empty, all layout tensors int32:
      perm[j]    = source row landing at output position j (gather form)
      offsets[p] = first output position of partition p
      sizes[p]   = rows in partition p

    impl=None takes `REPRO_PARTITION_PLAN_IMPL` when it is set, else the
    tensor's device: the histogram/rank kernels on the card, a stable sort
    on the CPU. Carried columns come back already partitioned."""
    impl = kops.partition_plan_impl() if impl is None else impl
    perm, carried, offsets, sizes = kops.partition_plan(
        digits, num_partitions, carry=carry, impl=impl)
    if carry:
        return perm, carried, offsets, sizes
    return perm, offsets, sizes


# ---------------------------------------------------------------------------
# RADIX-PARTITION
# ---------------------------------------------------------------------------
def radix_digits(keys: torch.Tensor, start_bit: int, num_bits: int) -> torch.Tensor:
    """The radix digit of each key, int32: bits [start_bit, start_bit +
    num_bits) of its unsigned pattern (32 bits for keys of up to 4 bytes, 64
    for 8-byte keys)."""
    if keys.element_size() <= 4:
        # the 32-bit unsigned pattern, held in int64
        u = keys.to(torch.int64) & 0xFFFFFFFF
        return ((u >> start_bit) & ((1 << num_bits) - 1)).to(torch.int32)
    # an arithmetic shift brings in sign bits from the top; the unsigned
    # pattern has none past bit 63
    mask = (1 << min(num_bits, max(64 - start_bit, 0))) - 1
    return ((keys.to(torch.int64) >> start_bit) & mask).to(torch.int32)


def radix_partition(keys: torch.Tensor, *values: torch.Tensor, start_bit: int,
                    num_bits: int):
    """RADIX-PARTITION: stable partition of (keys, values...) by the radix
    digit, each partition stored contiguously. Returns (keys_out,
    *values_out, offsets, sizes)."""
    digits = radix_digits(keys, start_bit, num_bits)
    perm, offsets, sizes = plan_partition_permutation(digits, 1 << num_bits)
    return tuple(a[perm] for a in (keys,) + values) + (offsets, sizes)


def multi_pass_radix_partition(keys: torch.Tensor, *values: torch.Tensor, total_bits: int,
                               start_bit: int = 0):
    """RADIX-PARTITION over more than 8 bits (paper §3.2/§4.3). On the card
    the plan runs rank passes of 8 bits in LSD order, and stability makes
    them one stable partition on all `total_bits` bits; the passes compose
    into one permutation, and every column is gathered once. Returns
    (keys_out, *values_out, offsets, sizes)."""
    digits = radix_digits(keys, start_bit, total_bits)
    perm, offsets, sizes = plan_partition_permutation(digits, 1 << total_bits)
    return tuple(a[perm] for a in (keys,) + values) + (offsets, sizes)


def num_radix_passes(total_bits: int) -> int:
    """Passes of at most 8 bits for `total_bits` bits (15-16 bits: 2)."""
    return -(-total_bits // RADIX_BITS_PER_PASS)


def radix_sort_pairs(keys: torch.Tensor, *values: torch.Tensor, key_bits: int | None = None):
    """LSD radix sort of non-negative keys from stable RADIX-PARTITION
    passes of 8 bits (SORT-PAIRS' pass structure, §4.2). Equals
    `sort_pairs`."""
    if key_bits is None:
        key_bits = 8 * keys.element_size() - 1  # non-negative keys
    arrs = (keys,) + values
    bit = 0
    while bit < key_bits:
        bits = min(RADIX_BITS_PER_PASS, key_bits - bit)
        arrs = radix_partition(arrs[0], *arrs[1:], start_bit=bit, num_bits=bits)[:-2]
        bit += bits
    return arrs if values else arrs[0]


def gather(src: torch.Tensor, idx: torch.Tensor, *, fill=None) -> torch.Tensor:
    """GATHER: out[i] = src[idx[i]]; idx < 0 or >= len gives `fill` when
    given, else the clipped row."""
    n = src.shape[0]
    out = src[idx.clamp(0, max(n - 1, 0))]
    if fill is not None:
        valid = (idx >= 0) & (idx < n)
        out = torch.where(valid.reshape(valid.shape + (1,) * (out.dim() - 1)), out,
                          torch.as_tensor(fill, dtype=src.dtype, device=src.device))
    return out


def histogram(x: torch.Tensor, num_bins: int) -> torch.Tensor:
    return torch.bincount(x, minlength=num_bins)[:num_bins].to(torch.int32)


def compact(mask: torch.Tensor, arrays: Sequence[torch.Tensor], capacity: int, fill=0):
    """Stable stream compaction: rows where mask is True move to the front,
    in order, of capacity-sized outputs. Returns (compacted, valid_count) with
    valid_count a 0-d int32 tensor; rows beyond `capacity` are dropped.
    Stability keeps monotone tuple-ID columns monotone (GFTR's clustering)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int32) - 1  # output slot per kept row
    last = pos[-1] + 1 if n else torch.zeros((), dtype=torch.int32, device=mask.device)
    count = torch.clamp(last, max=capacity)
    dest = torch.where(mask & (pos < capacity), pos, capacity)  # capacity -> cut off
    outs = []
    for a in arrays:
        out = a.new_full((capacity + 1,) + tuple(a.shape[1:]), fill)
        out[dest] = a
        outs.append(out[:capacity])
    return outs, count


def expand_offsets(counts: torch.Tensor, capacity: int):
    """m:n expansion helper: for `capacity` output rows, (row_of_output,
    rank_within_row, valid, total). Output t belongs to input row
    j = max{j : offsets[j] <= t} and is its (t - offsets[j])-th match."""
    dev = counts.device
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(counts, 0, dtype=torch.int32)])
    total = offsets[-1]
    t = torch.arange(capacity, dtype=torch.int32, device=dev)
    row = torch.searchsorted(offsets, t, right=True, out_int32=True) - 1
    row_c = row.clamp(0, counts.shape[0] - 1)
    rank = t - offsets[row_c]
    valid = t < total
    return row_c, rank, valid, total
