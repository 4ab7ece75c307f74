"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes, with ordinary torch ops.
The wrappers run these for CPU tensors; on the card they are what each
kernel is held against. Keys, layouts and counts must agree exactly; the
float32 sums are taken in the kernel's order (row order within a slot), so
they agree too unless a compiler reorders an add."""
from __future__ import annotations

import torch

from .common import KEY_SENTINEL, ceil_div

_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64. The constant is
    split into 16-bit halves so no product leaves int64's range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3-style finalizer; avalanches all input bits into 32. Returns
    the uint32 hash as int64 values in [0, 2^32)."""
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        raise TypeError(f"hash32 takes integer keys, got {x.dtype}")
    wide = x.element_size() > 4
    x = x.to(torch.int64)
    x = (x ^ (x >> 32) if wide else x) & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def partition_digits(keys: torch.Tensor, p_bits: int, hash_keys: bool) -> torch.Tensor:
    """Partition digit per row, int32 in [0, 2^p_bits] (the
    partition_digits kernel): 2^p_bits for KEY_SENTINEL rows, else the low
    p_bits of hash32 of the key (of its low 32 bits where not hash_keys)."""
    h = hash32(keys) if hash_keys else keys.to(torch.int64) & _U32
    d = (h & ((1 << p_bits) - 1)).to(torch.int32)
    return torch.where(keys == KEY_SENTINEL, 1 << p_bits, d)


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


def histogram(digits: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(num_bins,) int32 counts of the digits in [0, num_bins); digits < 0
    (pads) and >= num_bins count nowhere, as in the kernel."""
    valid = (digits >= 0) & (digits < num_bins)
    counts = torch.bincount(torch.where(valid, digits, num_bins).to(torch.int64),
                            minlength=num_bins + 1)
    return counts[:num_bins].to(torch.int32)


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


def pass_scatter(dest: torch.Tensor, digits: torch.Tensor, perm: torch.Tensor | None = None):
    """One LSD pass's move (kernels/radix_partition.pass_scatter): (perm_out,
    dig_out) int32 with perm_out[dest[i]] = perm[i] (i where perm is None)
    and dig_out[dest[i]] = digits[i]; dest is a permutation of [0, n)."""
    if perm is None:
        perm = torch.arange(dest.shape[0], dtype=torch.int32, device=dest.device)
    perm_out = torch.empty_like(perm).index_put_((dest,), perm)
    dig_out = torch.empty_like(digits).index_put_((dest,), digits)
    return perm_out, dig_out


def lower_bound(build_sorted: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """#{i : build_sorted[i] < probe[j]} per probe key, int32."""
    return torch.searchsorted(build_sorted, probe, out_int32=True)


def upper_bound(build_sorted: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """#{i : build_sorted[i] <= probe[j]} per probe key, int32."""
    return torch.searchsorted(build_sorted, probe, right=True, out_int32=True)


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


def hash_probe(build_keys: torch.Tensor, off_r: torch.Tensor, sz_r: torch.Tensor,
               probe_keys: torch.Tensor, probe_off: torch.Tensor, probe_sz: torch.Tensor,
               cap: int, chunk: int = 1 << 16):
    """The co-partition probe over the partitioned columns
    (kernels/hash_probe.hash_probe): each partition's first min(sz_r, cap)
    build keys padded to a (P, cap) block with KEY_SENTINEL, each probe
    row's partition found from the layout (the last p with probe_off[p] <=
    row), its key masked to KEY_SENTINEL where the row lies past its
    partition's end, then `hash_probe_blocks`. Returns (vid int32, hit
    bool)."""
    P = off_r.shape[0]
    dev = probe_keys.device
    slot = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    live = slot < sz_r[:, None]
    if build_keys.shape[0]:
        idx = (off_r[:, None] + slot).clamp(0, build_keys.shape[0] - 1)
        bkeys = torch.where(live, build_keys[idx], KEY_SENTINEL)
    else:
        bkeys = torch.full((P, cap), KEY_SENTINEL, dtype=torch.int32, device=dev)
    row = torch.arange(probe_keys.shape[0], dtype=torch.int32, device=dev)
    part = (torch.searchsorted(probe_off, row, right=True, out_int32=True) - 1).clamp(0, P - 1)
    inside = (row >= probe_off[part]) & (row < probe_off[part] + probe_sz[part])
    vid, hit = hash_probe_blocks(bkeys, off_r, torch.where(inside, probe_keys, KEY_SENTINEL),
                                 part, chunk)
    return vid, hit.bool()


def clustered_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[clip(idx[i], 0, n_src - 1)] where idx[i] >= 0, else 0."""
    safe = idx.clamp(0, src.shape[0] - 1)
    out = src.index_select(0, safe)
    return torch.where(idx >= 0, out, torch.zeros((), dtype=src.dtype, device=src.device))


def first_equal_rows(keys: torch.Tensor) -> torch.Tensor:
    """For (B, cap) keys, the index of the first row of each row's block
    that holds the same key (int64), by a stable sort within each block."""
    ks, order = torch.sort(keys, dim=1, stable=True)
    head = torch.cat([torch.ones_like(ks[:, :1], dtype=torch.bool), ks[:, 1:] != ks[:, :-1]],
                     dim=1)
    pos = torch.arange(keys.shape[1], device=keys.device)
    run_start = torch.cummax(torch.where(head, pos, 0), dim=1).values
    return torch.empty_like(order).scatter_(1, order, torch.gather(order, 1, run_start))


def probe_agg_blocks(bkeys: torch.Tensor, bvals: torch.Tensor, probe_blocks: torch.Tensor,
                     gk_blocks: torch.Tensor, pv_blocks: torch.Tensor, block_part: torch.Tensor,
                     col_sides, chunk: int = 1 << 15):
    """Fused probe + tile-local group partials (kernels/hash_probe.probe_agg),
    for `chunk` sub-blocks at a time. Per sub-block: each row's first hit in
    its build block (`hash_probe_blocks` with zero offsets gives the slot),
    the group key masked to KEY_SENTINEL on a miss, the row's slot (the
    first row of the sub-block with the same masked key, from a stable
    sort), then per slot the key, a float32 sum per column of col_sides and
    an int32 count, summed over the slot's rows in row order."""
    B, cap_s = probe_blocks.shape
    P = bkeys.shape[0]
    C = len(col_sides)
    dev = probe_blocks.device
    pk = torch.full((B, cap_s), KEY_SENTINEL, dtype=gk_blocks.dtype, device=dev)
    ps = torch.zeros((B, C, cap_s), dtype=torch.float32, device=dev)
    pc = torch.zeros((B, cap_s), dtype=torch.int32, device=dev)
    zero_off = torch.zeros(P, dtype=torch.int32, device=dev)
    for b0 in range(0, B, chunk):
        part = block_part[b0:b0 + chunk]
        nb = part.shape[0]
        hit, matched = hash_probe_blocks(bkeys, zero_off, probe_blocks[b0:b0 + chunk].reshape(-1),
                                         part.repeat_interleave(cap_s))
        hit, matched = hit.reshape(nb, cap_s), matched.bool().reshape(nb, cap_s)
        gke = torch.where(matched, gk_blocks[b0:b0 + chunk], KEY_SENTINEL)
        rep = first_equal_rows(gke)
        rep = torch.where(gke != KEY_SENTINEL, rep, cap_s)  # cap_s: a spare slot
        hs = hit.clamp(min=0).long()
        vals = torch.zeros((nb, C, cap_s), dtype=torch.float32, device=dev)
        for c, (side, j) in enumerate(col_sides):
            v = (torch.gather(bvals[part, j], 1, hs) if side == "build"
                 else pv_blocks[b0:b0 + chunk, j])
            vals[:, c] = torch.where(matched, v.to(torch.float32), 0.0)
        acc = torch.zeros((nb, C, cap_s + 1), dtype=torch.float32, device=dev)
        cnt = torch.zeros((nb, cap_s + 1), dtype=torch.int32, device=dev)
        bi = torch.arange(nb, device=dev)
        for i in range(cap_s):  # row order: each step adds one row to its slot
            r = rep[:, i]
            acc[bi, :, r] += vals[:, :, i]
            cnt[bi, r] += 1
        pc[b0:b0 + chunk] = cnt[:, :cap_s]
        ps[b0:b0 + chunk] = acc[:, :, :cap_s]
        pk[b0:b0 + chunk] = torch.where(cnt[:, :cap_s] > 0, gke, KEY_SENTINEL)
    return pk, ps, pc


def segsum_partials(sorted_keys: torch.Tensor, values: torch.Tensor, tile: int):
    """Per-tile partials over key-sorted rows (kernels/segsum.py), the live
    ones only, in tile order: tile t's run g of equal valid keys as (key,
    float32 sum in row order, int32 count). Computed in the reference's slot
    layout (slot t * tile + g; KEY_SENTINEL and zeros past the last run; the
    last tile padded with KEY_SENTINEL keys), then its live slots selected.
    Raises ValueError when a key is smaller than the one before it."""
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    if n > 1 and bool((sorted_keys[1:] < sorted_keys[:-1]).any()):
        raise ValueError("segsum_partials: sorted_keys are not sorted (a key is smaller than "
                         "the one before it)")
    pad = ceil_div(n, tile) * tile - n
    k = torch.cat([sorted_keys, torch.full((pad,), KEY_SENTINEL, dtype=sorted_keys.dtype,
                                           device=dev)]).reshape(-1, tile)
    v = torch.cat([values.to(torch.float32),
                   torch.zeros(pad, dtype=torch.float32, device=dev)]).reshape(-1, tile)
    T = k.shape[0]
    valid = k != KEY_SENTINEL
    head = torch.cat([torch.ones((T, 1), dtype=torch.bool, device=dev),
                      k[:, 1:] != k[:, :-1]], dim=1) & valid
    lgid = torch.where(valid, torch.cumsum(head, 1) - 1, tile)  # tile: a spare slot
    acc = torch.zeros((T, tile + 1), dtype=torch.float32, device=dev)
    cnt = torch.zeros((T, tile + 1), dtype=torch.int32, device=dev)
    ti = torch.arange(T, device=dev)
    for i in range(tile):  # row order: each step adds one row to its run
        g = lgid[:, i]
        acc[ti, g] += v[:, i]
        cnt[ti, g] += 1
    pk = torch.full((T, tile + 1), KEY_SENTINEL, dtype=sorted_keys.dtype, device=dev)
    pk.scatter_(1, torch.where(head, lgid, tile), k)  # one head per run; the spare is cut
    pk, ps, pc = pk[:, :tile].reshape(-1), acc[:, :tile].reshape(-1), cnt[:, :tile].reshape(-1)
    live = pk != KEY_SENTINEL
    return pk[live], ps[live], pc[live]
