"""Global digit histogram.

Each thread block counts a grid-stride share of the digits into its own
histogram in shared memory and adds it into the output; counts that do not
fit shared memory are added straight into the output. Pad digits (< 0) and
digits >= num_bins count nowhere.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .common import LAUNCHES

# bins the kernel counts in shared memory (48 KB of int32); more go straight
# to device memory
SMEM_BINS = 12288


def histogram(digits: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(num_bins,) int32 counts of the int32 digits in [0, num_bins)."""
    if not digits.is_cuda:
        return ref.histogram(digits, num_bins)
    if digits.dtype != torch.int32 or digits.dim() != 1 or not digits.is_contiguous():
        raise TypeError(f"digits must be a contiguous 1-D int32 tensor, got {digits.dtype} "
                        f"{tuple(digits.shape)}")
    if not 1 <= num_bins < 1 << 31:
        raise ValueError(f"num_bins must be in [1, 2^31), got {num_bins}")
    out = torch.zeros(num_bins, dtype=torch.int32, device=digits.device)
    if digits.shape[0] == 0:
        return out
    lib = _build.load("histogram")
    err = lib.histogram(digits.data_ptr(), digits.shape[0], num_bins, out.data_ptr(),
                        *_build.launch_on(digits))
    _build.check(lib, "histogram", err)
    LAUNCHES["histogram"] += 1
    return out
