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
partition on all bits. Each pass ends in one scatter by its destinations
that moves the permutation and the digits together (`pass_scatter`, a CUDA
kernel), so no pass gathers through the composed permutation and the last
leaves the digits sorted. No comparison sort anywhere, so the plan is
linear in n. `sort_plan_radix` composes the same passes over whole int32
keys.

For a CPU tensor each pass runs the kernels' plain versions (`ref`), so the
composition itself is tested without a card.
"""
from __future__ import annotations

import torch

from . import _build, ref
from ._build import I32, I64, PTR
from .common import SMEM_DEFAULT_PER_BLOCK, SMEM_PER_BLOCK, Launch, ceil_div, register

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


@register("block_histograms", rows="n",
          entries={"block_histograms": (PTR, I64, I32, I32, PTR, PTR, I32)},
          config=lambda a: (PTR(a.get("addr", 0)), I64(a["n"]), I32(a["num_bins"]),
                            I32(a.get("tile", TILE))),
          instances=("block_histograms<false>", "block_histograms<true>"))
def BLOCK_HISTOGRAMS(a, sms, per_sm):
    # block_histograms.cu, config: 8 warps a block, a sub-histogram each;
    # the occupancy asked at 32 KB, the limit raised to it
    n, bins, tile = a["n"], a["num_bins"], a.get("tile", TILE)
    inst = BLOCK_HISTOGRAMS.instances[int(tile == 1024 and a.get("addr", 0) % 16 == 0)]
    fill = sms * per_sm(inst, 256, 32 * 1024)
    return Launch("block_histograms", inst, 256, 8 * bins * 4,
                  (min(ceil_div(ceil_div(n, tile), 8), fill), 1, 1), opt_in=32 * 1024)


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
    _build.launch("block_histograms", "block_histograms", digits.data_ptr(), n, num_bins, tile,
                  out.data_ptr(), on=digits)
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


@register("partition_ranks", rows="n",
          entries={"partition_ranks": (PTR, PTR, I64, I32, I32, PTR, PTR, I32)},
          config=lambda a: (I64(a["n"]), I32(a["num_bins"]), I32(a.get("tile", TILE))),
          instances=("partition_ranks",))
def PARTITION_RANKS(a, sms, per_sm):
    # partition_ranks.cu, config: 4 warps a block, each with two (base row,
    # tile) buffers and three sets of peer words
    n, bins, tile = a["n"], a["num_bins"], a.get("tile", TILE)
    inst = PARTITION_RANKS.instances[0]
    smem = _rank_smem(bins, tile)
    fill = sms * per_sm(inst, 32 * _RANK_WARPS, smem)
    return Launch("partition_ranks", inst, 32 * _RANK_WARPS, smem,
                  (min(ceil_div(ceil_div(n, tile), _RANK_WARPS), fill), 1, 1),
                  opt_in=smem if smem > SMEM_DEFAULT_PER_BLOCK else 0)


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
    _build.launch("partition_ranks", "partition_ranks", digits.data_ptr(), base.data_ptr(), n,
                  num_bins, tile, dest.data_ptr(), on=digits)
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


@register("pass_scatter", rows="n",
          entries={"pass_scatter": (PTR, PTR, PTR, I64, I32, I32, I32, I32, PTR, PTR, PTR, I32)},
          config=lambda a: (PTR(a.get("dest_addr", 0)), PTR(a.get("dig_addr", 0)),
                            PTR(a.get("perm_addr", 0)), I64(a["n"])),
          instances=("pass_scatter<false>", "pass_scatter<true>"))
def PASS_SCATTER(a, sms, per_sm):
    # pass_scatter.cu, config: 1,024 threads staging chunks of 8,192 rows
    # (destinations, permutation entries, keys), 260 counts, least
    # destinations and offsets, 32 warp sums and a flag; vector loads where
    # dest, the keys and perm_in lie on 16-byte boundaries
    vec = all(a.get(k, 0) % 16 == 0 for k in ("dest_addr", "dig_addr", "perm_addr"))
    inst = PASS_SCATTER.instances[int(vec)]
    smem = (3 * 8192 + 3 * 260 + 32 + 1) * 4
    fill = sms * per_sm(inst, 1024, smem)
    return Launch("pass_scatter", inst, 1024, smem, (min(ceil_div(a["n"], 8192), fill), 1, 1),
                  opt_in=smem)


def pass_scatter(dest: torch.Tensor, digits: torch.Tensor, perm: torch.Tensor | None = None, *,
                 shift: int = 0, bits: int = PASS_BITS, tail_key: int | None = None):
    """Move the running permutation and the keys it orders by one pass's
    destinations, in one launch: (perm_out, dig_out) int32 with
    perm_out[dest[i]] = perm[i] (i itself where perm is None, a first pass)
    and dig_out[dest[i]] = digits[i]. dest must be a permutation of [0, n).

    shift, bits and tail_key name the pass's digit of a key (as
    `_compose_lsd` ranks it): the kernel groups each bin's rows before it
    writes them, so that its stores are contiguous. The result does not
    depend on them."""
    if not dest.is_cuda:
        return ref.pass_scatter(dest, digits, perm)
    if not 0 <= bits <= PASS_BITS or not 0 <= shift < 32:
        raise ValueError(f"a pass's digit is at most {PASS_BITS} bits from a shift in [0, 32), "
                         f"got {bits} bits from {shift}")
    n = dest.shape[0]
    for name, t in (("dest", dest), ("digits", digits), ("perm", perm)):
        if t is None:
            continue
        if t.dtype != torch.int32 or tuple(t.shape) != (n,) or not t.is_contiguous() \
                or t.device != dest.device:
            raise TypeError(f"{name} must be a contiguous ({n},) int32 tensor on {dest.device}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if n >= 1 << 31:
        raise ValueError(f"a pass moves at most 2^31 - 1 rows (int32 positions), got {n}")
    perm_out = torch.empty(n, dtype=torch.int32, device=dest.device)
    dig_out = torch.empty(n, dtype=torch.int32, device=dest.device)
    if n == 0:
        return perm_out, dig_out
    _build.launch("pass_scatter", "pass_scatter", dest.data_ptr(), digits.data_ptr(),
                  None if perm is None else perm.data_ptr(), n, shift, bits,
                  0 if tail_key is None else tail_key, tail_key is not None,
                  perm_out.data_ptr(), dig_out.data_ptr(), on=dest)
    return perm_out, dig_out


def _compose_lsd(keys: torch.Tensor, total_bits: int, pass_bits: int,
                 tail_key: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Compose stable LSD passes over int32 `keys` into one gather-form
    permutation. Returns (perm, keys[perm]).

    Pass k ranks bits [bit, bit + bits) of each row's key. `tail_key`, when
    given, marks rows of a dedicated trailing class (the planner's sentinel
    partition, key == tail_key): each pass ranks them into one extra bin past
    the bit bins, which keeps them stably behind every real digit without
    widening the bit passes. Each pass reads its digits from the keys in the
    current order, ranks them, and moves the permutation and the keys
    together by one scatter through its destinations (`pass_scatter`), so
    the keys are never gathered through the composed permutation and come
    out sorted. A pass's digits are freed before its scatter allocates, and
    its destinations before the next pass's digits."""
    perm = None
    bit = 0
    while perm is None or bit < total_bits:
        bits = min(pass_bits, max(total_bits - bit, 0))
        nb = (1 << bits) + (tail_key is not None)
        pd = (keys >> bit).bitwise_and_((1 << bits) - 1)
        if tail_key is not None:
            pd.masked_fill_(keys == tail_key, nb - 1)
        dest = partition_ranks(pd, nb)[0]
        del pd
        perm, keys = pass_scatter(dest, keys, perm, shift=bit, bits=bits, tail_key=tail_key)
        del dest
        bit += bits
    return perm, keys


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
    digits = digits.to(torch.int32).contiguous()
    B = num_partitions
    full_bits = max(1, (B - 1).bit_length())
    tail_bits = max((B - 2).bit_length(), 0) if B >= 2 else 0
    use_tail = B >= 2 and ceil_div(tail_bits, PASS_BITS) < ceil_div(full_bits, PASS_BITS)
    total_bits = tail_bits if use_tail else full_bits
    perm, dsort = _compose_lsd(digits, total_bits, PASS_BITS, B - 1 if use_tail else None)
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
    flip = torch.iinfo(torch.int32).min
    # each pass's mask drops the sign bits an arithmetic shift brings in
    perm, u_sorted = _compose_lsd((keys ^ flip).contiguous(), 32, PASS_BITS, None)
    return u_sorted ^ flip, perm
