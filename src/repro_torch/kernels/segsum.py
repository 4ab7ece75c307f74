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
from ._build import I32, I64, PTR
from .common import Launch, ceil_div, register

TILE = 256


@register("segsum_partials", rows="n",
          entries={"segsum_partials": (PTR, PTR, I64, I32, I32, PTR, PTR, PTR, PTR, PTR, I32),
                   "segsum_partials_state_words": (I64, I32)},
          restypes={"segsum_partials_state_words": I64},
          config=lambda a: (I64(a["n"]), I32(a.get("tile", TILE)), I32(a["key_bytes"])),
          instances=("segsum_partials<4>", "segsum_partials<8>"),
          # s_before (2 keys), s_first, s_next, the STAGES slots' chunk, offset,
          # count and flag, s_handed, s_answered, s_closed, the ROW_WARPS warps'
          # heads and flags, s_edges (CHUNK / 32 + 1 words): 232 or 240 bytes,
          # 240 for both key widths once the compiler aligns them
          static_smem={"segsum_partials<4>": 240, "segsum_partials<8>": 240})
def SEGSUM_PARTIALS(a, sms, per_sm):
    # segsum_partials.cu, config: 2 warps of row threads and the look-back
    # warp; two buffers of 1,024 rows and 2 slots of staged partials, each
    # padded one element every 128 bytes
    n, tile, kb = a["n"], a.get("tile", TILE), a["key_bytes"]
    inst = SEGSUM_PARTIALS.instances[int(kb == 8)]
    smem = 4 * (1024 + 1024 // (128 // kb)) * kb + 6 * (1024 + 32) * 4
    fill = sms * per_sm(inst, 96, smem)
    return Launch("segsum_partials", inst, 96, smem,
                  (min(ceil_div(n, 1024 // tile * tile), fill), 1, 1), opt_in=smem)


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
    # the kernel's scratch (a chunk ticket, n_live, a look-back word per
    # chunk), which it zeroes itself
    state = torch.empty(_build.call("segsum_partials", "segsum_partials_state_words", n, tile),
                        dtype=torch.int64, device=dev)
    _build.launch("segsum_partials", "segsum_partials", sorted_keys.data_ptr(),
                  values.data_ptr(), n, tile, sorted_keys.element_size(), pk.data_ptr(),
                  ps.data_ptr(), pc.data_ptr(), state.data_ptr(), on=pk)
    n_live = int(state[1])
    if n_live < 0:
        raise ValueError("segsum_partials: sorted_keys are not sorted (a key is smaller than "
                         "the one before it)")
    return pk[:n_live], ps[:n_live], pc[:n_live]
