"""Shared constants and helpers for the Hopper kernels and their plain twins.

Conventions:
  * Padding slots in digit arrays carry PAD_DIGIT (< 0). Kernels and plain
    versions exclude them from histograms and ranks by construction.
  * Which arm runs is decided by the tensor's device (`resolve_impl`): a CUDA
    tensor gets the hand-written kernel, a CPU tensor the plain PyTorch
    version, and asking for the kernel on a CPU tensor raises. There is no
    fallback from a failing kernel to the plain arm.
  * Every kernel wrapper adds one to its entry in `LAUNCHES` where it
    launches its kernel, and nowhere else (`ops.launch_counts`).
  * Every dispatch site of `ops` marks its call, kernel or plain version,
    with `kernel_call`, for the run auditor (`analysis.dispatch_audit`).
"""
from __future__ import annotations

import contextlib

import torch

# The fill value for padded digit slots.
PAD_DIGIT = -1
# Sentinel for padded / invalid key slots. Valid keys must be >= 0.
KEY_SENTINEL = -1

IMPLS = ("torch", "cuda")

# Shared memory one thread block may use on the H100 (227 KB, dynamic,
# after cudaFuncSetAttribute).
SMEM_PER_BLOCK = 232_448

# One launch counter per hand-written kernel.
KERNELS = ("block_histograms", "partition_ranks", "hash_probe", "clustered_gather",
           "probe_agg", "segsum_partials", "lower_bound", "histogram")
LAUNCHES = dict.fromkeys(KERNELS, 0)

# Auditors watching kernel calls (`analysis.dispatch_audit`); empty unless a
# run is audited.
KERNEL_CALL_OBSERVERS: list = []


@contextlib.contextmanager
def kernel_call(name: str):
    """Marks one call of a kernel (on a CUDA tensor) or of its plain version
    (on a CPU tensor): an active auditor counts one kernel call and none of
    the ops inside, so a plan's budget is the same on every device."""
    if not KERNEL_CALL_OBSERVERS:
        yield
        return
    for ob in KERNEL_CALL_OBSERVERS:
        ob.kernel_enter(name)
    try:
        yield
    finally:
        for ob in KERNEL_CALL_OBSERVERS:
            ob.kernel_exit(name)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def resolve_impl(impl: str | None, *tensors: torch.Tensor) -> str:
    """Arm for a dispatch site: None picks 'cuda' for CUDA tensors and
    'torch' otherwise; 'cuda' on a tensor that is not on a CUDA device
    raises instead of silently running the plain arm."""
    if impl is None:
        return "cuda" if tensors[0].is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; allowed: {'/'.join(IMPLS)}")
    if impl == "cuda" and not all(t.is_cuda for t in tensors):
        raise ValueError("impl='cuda' needs CUDA tensors; got a tensor on "
                         f"{[str(t.device) for t in tensors if not t.is_cuda][0]}")
    return impl

