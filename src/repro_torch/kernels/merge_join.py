"""Lower bounds of sorted probe keys in a sorted build column: the
sort-merge join's match finding (one bound per probe key for pk_fk).

The kernel searches each tile of probe keys inside the range of the build
column that the tile's smallest and largest keys bound: staged in shared
memory when it is narrow, through a sampled index of it when it is wide. It
is right for any span and any probe order, so no check of the spans picks the
arm.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .common import LAUNCHES

# the kernel's ring of build keys in shared memory (32 KB: 8192 int32 or 4096
# int64 keys; a tile whose range is wider stages a sampled index of it, of at
# most SAMPLE keys); the tiles hold 256 to 2048 probe keys
RING_BYTES = 32 * 1024
SAMPLE = 512
TILE_KEYS = (256, 2048)
_KEY_TYPES = (torch.int32, torch.int64)


def lower_bound(build_sorted: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """out[j] = #{i : build_sorted[i] < probe[j]}, int32 in [0, n_build].
    Both columns are 1-D, of one type (int32 or int64); build_sorted is
    sorted ascending, and probe usually is too (the kernel is fastest then)."""
    if not probe.is_cuda:
        return ref.lower_bound(build_sorted, probe)
    b, p = build_sorted, probe
    if (p.dtype not in _KEY_TYPES or b.dtype != p.dtype or b.dim() != 1 or p.dim() != 1
            or not b.is_contiguous() or not p.is_contiguous()
            or b.get_device() != p.get_device()):
        raise TypeError("build_sorted and probe must be contiguous 1-D tensors of one type, "
                        f"int32 or int64, on one card; got {b.dtype} {tuple(b.shape)} on "
                        f"{b.device} and {p.dtype} {tuple(p.shape)} on {p.device}")
    n_b = b.shape[0]
    if n_b >= 1 << 31:
        raise ValueError(f"{n_b} build keys: an int32 bound holds fewer than 2^31")
    out = p.new_empty(p.shape[0], dtype=torch.int32)
    if p.shape[0] == 0:
        return out
    lib = _build.load("lower_bound")
    err = lib.lower_bound(b.data_ptr(), n_b, p.data_ptr(), p.shape[0], p.element_size(),
                          out.data_ptr(), *_build.launch_on(p))
    _build.check(lib, "lower_bound", err)
    LAUNCHES["lower_bound"] += 1
    return out
