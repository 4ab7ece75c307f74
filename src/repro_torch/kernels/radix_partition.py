"""Stable radix-partition passes and the sort-free partition planner.

One pass is the classic GPU partitioning pipeline, with prefix sums where
the order matters and atomics only where it does not:

  block_histograms  per-tile digit counts            (CUDA kernel)
  prefix            exclusive prefix over (digit, tile) -> base offsets (torch)
  partition_ranks   dest[i] = base[tile, digit] + stable rank in the tile
                                                     (CUDA kernel)

`partition_plan` composes LSD passes of at most 8 bits into one gather-form
permutation: pass k ranks bits [8k, 8k+8) of the digit over the order left
by pass k-1, and stability makes the composition equal the single stable
partition on all bits. No comparison sort anywhere, so the plan is linear
in n. `sort_plan_radix` composes the same passes over whole int32 keys.

For a CPU tensor each pass runs the kernels' plain versions (`ref`), so the
composition itself is tested without a card.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .common import LAUNCHES, SMEM_PER_BLOCK, ceil_div

# digits per tile of the histogram and rank kernels (the TPU kernel's
# 8 x 128 block)
TILE = 1024
PASS_BITS = 8
# the histogram and rank kernels keep num_bins counts per tile (per warp) in
# shared memory
MAX_BINS = 1 << 10
# the rank kernel's shared memory: 4 warps a block, each with two buffers of
# a tile's digits and its base row and three sets of peer words per digit
_RANK_WARPS = 4


def _rank_smem(num_bins: int, tile: int) -> int:
    return _RANK_WARPS * (5 * ceil_div(num_bins, 4) + 2 * ceil_div(tile, 4)) * 16


def _check_digits(digits: torch.Tensor, num_bins: int) -> None:
    if digits.dtype != torch.int32 or digits.dim() != 1 or not digits.is_contiguous():
        raise TypeError(f"digits must be a contiguous 1-D int32 tensor, got "
                        f"{digits.dtype} {tuple(digits.shape)}")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins must be in [1, {MAX_BINS}], got {num_bins}")


def block_histograms(digits: torch.Tensor, num_bins: int, *, tile: int = TILE) -> torch.Tensor:
    """(ceil(n / tile), num_bins) int32 per-tile histograms; pad digits
    (negative) are not counted."""
    if not digits.is_cuda:
        return ref.block_histograms(digits, num_bins, tile)
    _check_digits(digits, num_bins)
    n = digits.shape[0]
    out = torch.empty((ceil_div(n, tile), num_bins), dtype=torch.int32, device=digits.device)
    if n == 0:
        return out
    lib = _build.load("block_histograms")
    err = lib.block_histograms(digits.data_ptr(), n, num_bins, tile, out.data_ptr(),
                               *_build.launch_on(digits))
    _build.check(lib, "block_histograms", err)
    LAUNCHES["block_histograms"] += 1
    return out


def tile_base(hist: torch.Tensor):
    """(base, offsets, sizes) from per-tile histograms:
    base[t, d] = offsets[d] + sum_{t' < t} hist[t', d], which is the
    exclusive prefix of the counts in (digit, tile) order. It is taken as one
    flat scan over the transposed counts: a scan down the tile axis of the
    (tiles, bins) array runs one thread per bin on the card and took most of
    the query's device time."""
    num_tiles, num_bins = hist.shape
    by_digit = hist.t().contiguous().reshape(-1)
    excl = (torch.cumsum(by_digit, 0, dtype=torch.int32) - by_digit).reshape(num_bins, num_tiles)
    sizes = hist.sum(dim=0, dtype=torch.int32)
    offsets = torch.cumsum(sizes, 0, dtype=torch.int32) - sizes
    return excl.t().contiguous(), offsets, sizes


def rank_with_base(digits: torch.Tensor, base: torch.Tensor, num_bins: int, *,
                   tile: int = TILE) -> torch.Tensor:
    """Launch the rank kernel: dest[i] = base[tile(i), d] + stable rank of i
    among its tile's rows with digit d; -1 for pad digits."""
    _check_digits(digits, num_bins)
    n = digits.shape[0]
    if base.dtype != torch.int32 or tuple(base.shape) != (ceil_div(n, tile), num_bins) \
            or not base.is_contiguous() or base.device != digits.device:
        raise ValueError(f"base must be a contiguous int32 ({ceil_div(n, tile)}, {num_bins}) "
                         f"tensor on {digits.device}, got {base.dtype} {tuple(base.shape)}")
    if tile < 1 or _rank_smem(num_bins, tile) > SMEM_PER_BLOCK:
        raise ValueError(f"tiles of {tile} digits with {num_bins} bins do not fit the rank "
                         "kernel's shared memory")
    dest = torch.empty(n, dtype=torch.int32, device=digits.device)
    if n == 0:
        return dest
    lib = _build.load("partition_ranks")
    err = lib.partition_ranks(digits.data_ptr(), base.data_ptr(), n, num_bins, tile,
                              dest.data_ptr(),
                              *_build.launch_on(digits))
    _build.check(lib, "partition_ranks", err)
    LAUNCHES["partition_ranks"] += 1
    return dest


def partition_ranks(digits: torch.Tensor, num_bins: int, *, tile: int = TILE):
    """One stable partition pass. Returns (dest, offsets, sizes): dest[i] is
    the output position of element i (-1 for pad digits); offsets/sizes
    describe the contiguous partition layout. On the card: histogram kernel,
    prefix in torch, rank kernel."""
    hist = block_histograms(digits, num_bins, tile=tile)
    base, offsets, sizes = tile_base(hist)
    if digits.is_cuda:
        dest = rank_with_base(digits, base, num_bins, tile=tile)
    else:
        dest = ref.partition_ranks(digits, num_bins)
    return dest, offsets, sizes


def _compose_lsd(extract_digit, n: int, total_bits: int, pass_bits: int,
                 tail_mask, device) -> torch.Tensor:
    """Compose stable LSD passes into one gather-form permutation.

    extract_digit(perm, bit, bits) returns the pass digits IN CURRENT ORDER
    (of source rows perm[0..n)). `tail_mask`, when given, marks rows of a
    dedicated trailing class (the planner's sentinel partition): each pass
    ranks them into one extra bin past the bit bins, which keeps them stably
    behind every real digit without widening the bit passes. Each pass costs
    one rank computation plus one n-sized scatter that folds its
    destinations into the running permutation."""
    perm = torch.arange(n, dtype=torch.int32, device=device)
    bit = 0
    first = True
    while first or bit < total_bits:
        bits = min(pass_bits, max(total_bits - bit, 0))
        nb = (1 << bits) + (1 if tail_mask is not None else 0)
        pd = extract_digit(perm, bit, bits)
        if tail_mask is not None:
            tm = tail_mask if first else tail_mask[perm]
            pd = torch.where(tm, nb - 1, pd)
        dest = partition_ranks(pd.contiguous(), nb)[0]
        new = torch.empty_like(perm)
        new[dest] = perm  # dest is a permutation: every slot written once
        perm = new
        bit += bits
        first = False
    return perm


def partition_plan(digits: torch.Tensor, num_partitions: int, *, carry=()):
    """Sort-free stable partition plan: histogram -> prefix -> rank passes,
    LSD-composed for any fan-out. Returns (perm, carried, offsets, sizes),
    layout tensors int32:
      perm[j]    = source row landing at output position j (gather form)
      offsets[p] = first output position of partition p
      sizes[p]   = rows in partition p
    digits must lie in [0, num_partitions). Each carried column costs one
    gather through the composed permutation.

    When num_partitions - 1 crosses a pass boundary that num_partitions - 2
    does not (the 2^k + 1 layout whose last partition swallows sentinel
    rows), the top partition is ranked as a tail class inside each pass
    instead of paying an extra whole pass for one bin."""
    n = digits.shape[0]
    digits = digits.to(torch.int32)
    B = num_partitions
    full_bits = max(1, (B - 1).bit_length())
    tail_bits = max((B - 2).bit_length(), 0) if B >= 2 else 0
    use_tail = B >= 2 and ceil_div(tail_bits, PASS_BITS) < ceil_div(full_bits, PASS_BITS)
    tail_mask = (digits == B - 1) if use_tail else None
    total_bits = tail_bits if use_tail else full_bits

    def extract(perm, bit, bits):
        cur = digits if bit == 0 else digits[perm]
        return (cur >> bit) & ((1 << bits) - 1)

    perm = _compose_lsd(extract, n, total_bits, PASS_BITS, tail_mask, digits.device)
    dsort = digits[perm]  # sorted by construction
    offsets = torch.searchsorted(
        dsort, torch.arange(B, dtype=torch.int32, device=digits.device), out_int32=True)
    sizes = torch.diff(offsets, append=torch.full((1,), n, dtype=torch.int32,
                                                  device=digits.device))
    carried = tuple(c[perm] for c in carry)
    return perm, carried, offsets, sizes


def sort_plan_radix(keys: torch.Tensor):
    """Sort-free stable sort plan over int32 keys: four 8-bit LSD rank
    passes over the sign-biased 32-bit pattern (the sign bit flipped, so
    that unsigned digit order is signed key order). Returns (sorted_keys,
    perm int32), equal to a stable sort's."""
    if keys.dtype != torch.int32:
        raise TypeError(f"the radix sort plan takes int32 keys, got {keys.dtype}")
    u = keys ^ torch.iinfo(torch.int32).min

    def extract(perm, bit, bits):
        cur = u if bit == 0 else u[perm]
        # the mask drops the sign bits an arithmetic shift brings in
        return (cur >> bit) & ((1 << bits) - 1)

    perm = _compose_lsd(extract, keys.shape[0], 32, PASS_BITS, None, keys.device)
    return keys[perm], perm
