"""Per-tile partial sums over key-sorted rows (the sort-based group-by).

Each tile of `tile` sorted rows is reduced to one (key, float32 sum, int32
count) partial per run of equal keys. The partials come back compactly, in
tile order, so over sorted rows they are in key order and the partials of
one key are neighbours; the combine (`ops.groupby_sorted_sum`) merges those
of runs that span tiles without sorting them.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .common import LAUNCHES

TILE = 256


def segsum_partials(sorted_keys: torch.Tensor, values: torch.Tensor, tile: int = TILE):
    """(pk, ps, pc) of the n_live partials: for each tile of `tile` rows in
    order, each run of equal valid keys (not KEY_SENTINEL) as (key, float32
    sum of its values in row order, int32 count). sorted_keys are int32 or
    int64 and must not decrease (ValueError otherwise); values are float32.

    The reference (`repro.kernels.segsum.segsum_partials_pallas`) writes
    ceil(n / tile) * tile slots, tile t's run g at slot t * tile + g and
    KEY_SENTINEL with zeros in the rest; these are its live slots, in slot
    order. Reading n_live (and the sort check) costs one host sync."""
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
        raise ValueError(f"tile must be in [1, 1024], got {tile}")
    n = sorted_keys.shape[0]
    # room for one partial per row; filled from the front
    pk = torch.empty(n, dtype=sorted_keys.dtype, device=dev)
    ps = torch.empty(n, dtype=torch.float32, device=dev)
    pc = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return pk, ps, pc
    lib = _build.load("segsum_partials")
    # the kernel's scratch (a chunk ticket, n_live, a look-back word per
    # chunk), which it zeroes itself
    state = torch.empty(lib.segsum_partials_state_words(n, tile), dtype=torch.int64,
                        device=dev)
    err = lib.segsum_partials(sorted_keys.data_ptr(), values.data_ptr(), n, tile,
                              sorted_keys.element_size(), pk.data_ptr(), ps.data_ptr(),
                              pc.data_ptr(), state.data_ptr(), *_build.launch_on(pk))
    _build.check(lib, "segsum_partials", err)
    LAUNCHES["segsum_partials"] += 1
    n_live = int(state[1])
    if n_live < 0:
        raise ValueError("segsum_partials: sorted_keys are not sorted (a key is smaller than "
                         "the one before it)")
    return pk[:n_live], ps[:n_live], pc[:n_live]
