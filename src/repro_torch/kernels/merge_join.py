"""Lower bounds of sorted probe keys in a sorted build column: the
sort-merge join's match finding (one bound per probe key for pk_fk).

The kernel searches each tile of probe keys inside the range of the build
column that the tile's smallest and largest keys bound, staged in shared
memory when it is narrow. It is right for any span, so no check of the
spans picks the arm.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .common import LAUNCHES


def lower_bound(build_sorted: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """out[j] = #{i : build_sorted[i] < probe[j]}, int32 in [0, n_build].
    Both columns are 1-D, of one type (int32 or int64); build_sorted is
    sorted ascending, and probe usually is too (the kernel is fastest then)."""
    if not probe.is_cuda:
        return ref.lower_bound(build_sorted, probe)
    for name, t in (("build_sorted", build_sorted), ("probe", probe)):
        if t.dtype not in (torch.int32, torch.int64) or t.dim() != 1 or not t.is_contiguous() \
                or t.device != probe.device:
            raise TypeError(f"{name} must be a contiguous 1-D int32 or int64 tensor on "
                            f"{probe.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if build_sorted.dtype != probe.dtype:
        raise TypeError(f"build_sorted and probe differ in type: {build_sorted.dtype} and "
                        f"{probe.dtype}")
    n_b = build_sorted.shape[0]
    if n_b >= 1 << 31:
        raise ValueError(f"{n_b} build keys: an int32 bound holds fewer than 2^31")
    out = torch.empty(probe.shape[0], dtype=torch.int32, device=probe.device)
    if probe.shape[0] == 0:
        return out
    lib = _build.load("lower_bound")
    err = lib.lower_bound(build_sorted.data_ptr(), n_b, probe.data_ptr(), probe.shape[0],
                          probe.element_size(), out.data_ptr(),
                          torch.cuda.current_stream(probe.device).cuda_stream)
    _build.check(lib, "lower_bound", err)
    LAUNCHES["lower_bound"] += 1
    return out
