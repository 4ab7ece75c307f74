"""Shared constants and helpers for the Hopper kernels and their plain twins.

Conventions:
  * Padding slots in digit arrays carry PAD_DIGIT (< 0). Kernels and plain
    versions exclude them from histograms and ranks by construction.
  * Which arm runs is decided by the tensor's device (`resolve_impl`): a CUDA
    tensor gets the hand-written kernel, a CPU tensor the plain PyTorch
    version, and asking for the kernel on a CPU tensor raises. There is no
    fallback from a failing kernel to the plain arm.
  * Each hand-written kernel is declared once, by a `Kernel` record that
    its wrapper's module registers: its build, its launch counter and its
    launch lint read the record. Every launch goes through
    `_build.launch`, which adds one to the kernel's entry in `LAUNCHES`
    (`ops.launch_counts`).
  * Every dispatch site of `ops` marks its call, kernel or plain version,
    with `kernel_call`, for the run auditor (`analysis.dispatch_audit`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

# The fill value for padded digit slots.
PAD_DIGIT = -1
# Sentinel for padded / invalid key slots. Valid keys must be >= 0.
KEY_SENTINEL = -1

IMPLS = ("torch", "cuda")

# Shared memory one thread block may use on the H100 (227 KB, dynamic,
# after cudaFuncSetAttribute), and without raising the kernel's limit.
SMEM_PER_BLOCK = 232_448
SMEM_DEFAULT_PER_BLOCK = 48 * 1024


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch as declared: the kernel instance a call picks, threads a
    block, bytes of dynamic shared memory, the grid, and the dynamic
    shared-memory limit the launch raises the instance's to first (0: it
    keeps the 48 KB default)."""
    kernel: str
    instance: str
    threads: int
    smem: int
    grid: tuple
    opt_in: int = 0


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One hand-written kernel, declared beside the wrapper that launches it
    (`register`): what its build, its launch counter and its launch lint
    (`analysis.kernel_lint`) know of it. A shape is a dict of a call's
    arguments, as the lint registers them."""
    name: str  # its csrc/<name>.cu, its LAUNCHES key, its library's prefix
    rows: str  # the shape's argument that counts rows; at 0 no launch
    # (shape, sms, per_sm) -> the Launch its host code makes, or None
    declare: Callable
    # C entry point -> argtypes (a launch's end with the stream and the card)
    entries: dict
    # shape -> <name>_launch_config's leading arguments as ctypes values of
    # the C side's types; pointers carry only the alignment the shape names
    config: Callable[[dict], tuple]
    instances: tuple  # in the order of the source's INSTANCES table
    # instance -> bytes of its `__shared__` arrays, where it has any
    static_smem: dict = dataclasses.field(default_factory=dict)
    # entry point -> result type, where it returns no error code
    restypes: dict = dataclasses.field(default_factory=dict)


# Every registered kernel by name, and its launches so far.
KERNELS: dict[str, Kernel] = {}
LAUNCHES: dict[str, int] = {}


def register(name: str, **fields):
    """Declare the kernel `name` by its launch declaration, the function
    this decorates, and the record's other `fields`: its build, its launch
    counter and its lint follow. The decorated name holds the record."""
    def declare(fn) -> Kernel:
        if name in KERNELS:
            raise ValueError(f"kernel {name!r} is declared twice")
        kernel = KERNELS[name] = Kernel(name, declare=fn, **fields)
        LAUNCHES[name] = 0
        return kernel
    return declare

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

