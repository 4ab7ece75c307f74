"""Clustered GATHER (GFTR materialization).

For a gather map that is clustered, as GFTR's tuple IDs are, neighbouring
outputs read neighbouring source rows. The kernel copies 4- or 8-byte
elements, eight outputs a thread; a warp stages the source window of its 256
outputs in shared memory when it is at most 256 rows wide, and reads device
memory directly when it is wider, so it needs no span check: it is right for
any index.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .common import LAUNCHES


def clustered_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[clip(idx[i], 0, n_src - 1)] where idx[i] >= 0, else 0.
    src is 1-D with 4- or 8-byte elements; idx is int32."""
    if not src.is_cuda:
        return ref.clustered_gather(src, idx)
    if src.dim() != 1 or src.element_size() not in (4, 8) or not src.is_contiguous():
        raise TypeError(f"src must be a contiguous 1-D tensor of 4- or 8-byte elements, "
                        f"got {src.dtype} {tuple(src.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous() \
            or idx.device != src.device:
        raise TypeError(f"idx must be a contiguous 1-D int32 tensor on {src.device}, got "
                        f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
    out = torch.empty(idx.shape[0], dtype=src.dtype, device=src.device)
    if idx.shape[0] == 0:
        return out
    if src.shape[0] == 0:  # no row to read: every index is out of range
        return out.zero_()
    lib = _build.load("clustered_gather")
    err = lib.clustered_gather(src.data_ptr(), idx.data_ptr(), src.shape[0], idx.shape[0],
                               src.element_size(), out.data_ptr(),
                               *_build.launch_on(src))
    _build.check(lib, "clustered_gather", err)
    LAUNCHES["clustered_gather"] += 1
    return out
