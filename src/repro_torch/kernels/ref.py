"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes, with ordinary torch ops.
The wrappers run these for CPU tensors; on the card they are what each
kernel is held against, and they must agree with it exactly."""
from __future__ import annotations

import torch

from .common import KEY_SENTINEL, ceil_div


def block_histograms(digits: torch.Tensor, num_bins: int, tile: int) -> torch.Tensor:
    """(ceil(n / tile), num_bins) int32 digit counts per tile of `tile`
    digits. Pad digits (< 0, or >= num_bins) are not counted."""
    n = digits.shape[0]
    num_tiles = ceil_div(n, tile)
    valid = (digits >= 0) & (digits < num_bins)
    tile_id = torch.arange(n, device=digits.device, dtype=torch.int64) // tile
    flat = torch.where(valid, tile_id * num_bins + digits, num_tiles * num_bins)
    counts = torch.bincount(flat, minlength=num_tiles * num_bins + 1)
    return counts[: num_tiles * num_bins].to(torch.int32).reshape(num_tiles, num_bins)


def partition_ranks(digits: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Stable-partition destination per element, -1 for pad digits: the
    inverse of the stable sort permutation of the digits. Pads sort behind
    every real digit, so real destinations fill [0, n_valid)."""
    n = digits.shape[0]
    valid = (digits >= 0) & (digits < num_bins)
    order = torch.sort(torch.where(valid, digits, num_bins), stable=True).indices
    dest = torch.empty(n, dtype=torch.int32, device=digits.device)
    dest[order] = torch.arange(n, dtype=torch.int32, device=digits.device)
    return torch.where(valid, dest, -1)


def hash_probe_blocks(bkeys: torch.Tensor, off_r: torch.Tensor, probe_keys: torch.Tensor,
                      probe_part: torch.Tensor, chunk: int = 1 << 16):
    """Co-partition probe, row by row: probe row j looks for its key in the
    build block of partition probe_part[j]. Returns (vid, hit) int32: the
    first matching slot's position off_r[part] + slot and 1, or -1 and 0.
    Sentinel keys never match. Runs in chunks of rows to bound the
    (chunk, capR) compare."""
    vids, hits = [], []
    cap_r = bkeys.shape[1]
    for s in range(0, probe_keys.shape[0], chunk):
        pk = probe_keys[s:s + chunk]
        part = probe_part[s:s + chunk]
        eq = (bkeys[part] == pk[:, None]) & (pk[:, None] != KEY_SENTINEL)
        matched = eq.any(dim=1)
        slot = torch.where(eq, torch.arange(cap_r, dtype=torch.int32, device=eq.device),
                           cap_r).amin(dim=1)
        vids.append(torch.where(matched, off_r[part] + slot, -1).to(torch.int32))
        hits.append(matched.to(torch.int32))
    if not vids:
        empty = probe_keys.new_empty((0,), dtype=torch.int32)
        return empty, empty.clone()
    return torch.cat(vids), torch.cat(hits)


def probe_pk_fk(bkeys: torch.Tensor, off_r: torch.Tensor, probe_keys_part: torch.Tensor,
                probe_off: torch.Tensor, chunk: int = 1 << 16):
    """The pk_fk probe on a partitioned probe side: each row's partition
    comes from the layout (probe_off), then `hash_probe_blocks`. Rows past
    the last real partition (the sentinel partition's overhang) map to P - 1;
    their keys are KEY_SENTINEL, so they never match."""
    row = torch.arange(probe_keys_part.shape[0], dtype=torch.int32,
                       device=probe_keys_part.device)
    part = (torch.searchsorted(probe_off, row, right=True, out_int32=True) - 1
            ).clamp(0, bkeys.shape[0] - 1)
    return hash_probe_blocks(bkeys, off_r, probe_keys_part, part, chunk)


def clustered_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[clip(idx[i], 0, n_src - 1)] where idx[i] >= 0, else 0."""
    safe = idx.clamp(0, src.shape[0] - 1)
    out = src.index_select(0, safe)
    return torch.where(idx >= 0, out, torch.zeros((), dtype=src.dtype, device=src.device))
