"""Per-tile partial sums over key-sorted rows (the sort-based group-by).

Each tile of `tile` sorted rows is reduced to one (key, float32 sum, int32
count) partial per run of equal keys, at the run's local index; the combine
(`ops.groupby_sorted_sum`) merges the partials of runs that span tiles.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .common import LAUNCHES, ceil_div

TILE = 256


def segsum_partials(sorted_keys: torch.Tensor, values: torch.Tensor, tile: int = TILE):
    """(pk, ps, pc), each of ceil(n / tile) * tile slots: slot t * tile + g
    holds tile t's run g (key, float32 sum, int32 count), KEY_SENTINEL and
    zeros past its last run. sorted_keys are int32 or int64, values
    float32."""
    if not sorted_keys.is_cuda:
        return ref.segsum_partials(sorted_keys, values, tile)
    dev = sorted_keys.device
    if sorted_keys.dtype not in (torch.int32, torch.int64) or sorted_keys.dim() != 1 \
            or not sorted_keys.is_contiguous():
        raise TypeError(f"sorted_keys must be a contiguous 1-D int32 or int64 tensor, got "
                        f"{sorted_keys.dtype} {tuple(sorted_keys.shape)}")
    if values.dtype != torch.float32 or values.shape != sorted_keys.shape \
            or not values.is_contiguous() or values.device != dev:
        raise TypeError(f"values must be a contiguous float32 tensor of shape "
                        f"{tuple(sorted_keys.shape)} on {dev}, got {values.dtype} "
                        f"{tuple(values.shape)} on {values.device}")
    if not 1 <= tile <= 1024:
        raise ValueError(f"tile must be in [1, 1024] (one thread per row), got {tile}")
    n = sorted_keys.shape[0]
    slots = ceil_div(n, tile) * tile
    pk = torch.empty(slots, dtype=sorted_keys.dtype, device=dev)
    ps = torch.empty(slots, dtype=torch.float32, device=dev)
    pc = torch.empty(slots, dtype=torch.int32, device=dev)
    if n == 0:
        return pk, ps, pc
    lib = _build.load("segsum_partials")
    err = lib.segsum_partials(sorted_keys.data_ptr(), values.data_ptr(), n, tile,
                              sorted_keys.element_size(), pk.data_ptr(), ps.data_ptr(),
                              pc.data_ptr(), *_build.launch_on(pk))
    _build.check(lib, "segsum_partials", err)
    LAUNCHES["segsum_partials"] += 1
    return pk, ps, pc
