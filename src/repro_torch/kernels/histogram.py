"""Global digit histogram.

Each thread block counts a grid-stride share of the digits into its own
histogram in shared memory and adds it into the output; counts that do not
fit shared memory are added straight into the output. Pad digits (< 0) and
digits >= num_bins count nowhere.
"""
from __future__ import annotations

import torch

from . import _build, ref
from ._build import I32, I64, PTR
from .common import Launch, ceil_div, register

# bins the kernel counts in shared memory (48 KB of int32); more go straight
# to device memory
SMEM_BINS = 12288


@register("histogram", rows="n",
          entries={"histogram": (PTR, I64, I32, PTR, PTR, I32)},
          config=lambda a: (PTR(a.get("addr", 0)), I64(a["n"]), I32(a["num_bins"])),
          instances=("histogram<false>", "histogram<true>"))
def HISTOGRAM(a, sms, per_sm):
    # histogram.cu, config: the counts in shared memory up to SMEM_BINS,
    # one 16-byte vector a thread, at most 8 blocks an SM (not occupancy)
    n, bins = a["n"], a["num_bins"]
    shared = bins <= SMEM_BINS
    inst = HISTOGRAM.instances[int(shared)]
    head = min((16 - a.get("addr", 0) % 16) % 16 // 4, n)
    want = ceil_div(max((n - head) // 4, 4), 256)
    return Launch("histogram", inst, 256, 4 * bins if shared else 0,
                  (min(want, sms * 8), 1, 1))


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
    _build.launch("histogram", "histogram", digits.data_ptr(), digits.shape[0], num_bins,
                  out.data_ptr(), on=digits)
    return out
