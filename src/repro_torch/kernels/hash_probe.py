"""Co-partition hash probe (PHJ match finding).

Probe rows are laid out partition-major in capS-wide sub-blocks, each of
which belongs to exactly one partition (`layout_probe_blocks`, the paper's
probe-side sub-partitioning). The kernel stages that partition's padded
build block (capR keys) in shared memory and finds each probe key's first
match in it.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .common import KEY_SENTINEL, LAUNCHES


def hash_probe(bkeys: torch.Tensor, off_r: torch.Tensor, probe_blocks: torch.Tensor,
               block_part: torch.Tensor):
    """(vid, hit): (B, capS) int32 match position in the partitioned build
    array (or -1) and 0/1 hit flags, for bkeys (P, capR), off_r (P,),
    probe_blocks (B, capS) and block_part (B,), all int32."""
    B, cap_s = probe_blocks.shape
    P, cap_r = bkeys.shape
    if not probe_blocks.is_cuda:
        part = block_part.repeat_interleave(cap_s)
        vid, hit = ref.hash_probe_blocks(bkeys, off_r, probe_blocks.reshape(-1), part)
        return vid.reshape(B, cap_s), hit.reshape(B, cap_s)
    for name, t in (("bkeys", bkeys), ("off_r", off_r), ("probe_blocks", probe_blocks),
                    ("block_part", block_part)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != probe_blocks.device:
            raise TypeError(f"{name} must be a contiguous int32 tensor on "
                            f"{probe_blocks.device}, got {t.dtype} on {t.device}")
    if off_r.shape != (P,) or block_part.shape != (B,):
        raise ValueError(f"off_r must be ({P},) and block_part ({B},), got "
                         f"{tuple(off_r.shape)} and {tuple(block_part.shape)}")
    if not 1 <= cap_r <= 12288:
        raise ValueError(f"build block of {cap_r} keys does not fit shared memory")
    vid = torch.empty((B, cap_s), dtype=torch.int32, device=probe_blocks.device)
    hit = torch.empty_like(vid)
    if B == 0 or cap_s == 0:
        return vid, hit
    lib = _build.load("hash_probe")
    err = lib.hash_probe(bkeys.data_ptr(), off_r.data_ptr(), probe_blocks.data_ptr(),
                         block_part.data_ptr(), B, P, cap_r, cap_s, vid.data_ptr(),
                         hit.data_ptr(),
                         torch.cuda.current_stream(probe_blocks.device).cuda_stream)
    _build.check(lib, "hash_probe", err)
    LAUNCHES["hash_probe"] += 1
    return vid, hit


def layout_probe_blocks(keys_part: torch.Tensor, off: torch.Tensor, sz: torch.Tensor,
                        cap_s: int, max_blocks: int):
    """Decompose contiguous partitions into capS-aligned sub-blocks. Static
    worst case: n / capS + P blocks.

    Returns (probe_blocks (B, capS), block_part (B,), src_idx (B, capS)),
    int32, where src_idx maps each slot back to its position in keys_part
    (-1 = padding, whose key is KEY_SENTINEL)."""
    P = off.shape[0]
    n = keys_part.shape[0]
    dev = keys_part.device
    blocks_per = (sz + cap_s - 1) // cap_s
    boff = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(blocks_per, 0, dtype=torch.int32)])
    b = torch.arange(max_blocks, dtype=torch.int32, device=dev)
    part = (torch.searchsorted(boff, b, right=True, out_int32=True) - 1).clamp(0, P - 1)
    sub = b - boff[part]
    valid_block = b < boff[-1]
    j = torch.arange(cap_s, dtype=torch.int32, device=dev)[None, :]
    rel = sub[:, None] * cap_s + j
    in_part = rel < sz[part][:, None]
    src_idx = torch.where(valid_block[:, None] & in_part, off[part][:, None] + rel, -1)
    pk = torch.where(src_idx >= 0, keys_part[src_idx.clamp(0, max(n - 1, 0))], KEY_SENTINEL)
    return pk, part, src_idx
