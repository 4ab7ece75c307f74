"""Auditor of one eager run: primitive budgets, the live-bytes watermark,
and 64-bit widenings. The port's counterpart of the JAX package's
`analysis.jaxpr_audit`.

The paper's cost models price plans in *primitive* terms — number of sort
passes, partition passes, gathers/scatters — so the only way to know that
the plan that ran is the plan the model priced is to count those
primitives. The JAX package counts them in a traced jaxpr; eager PyTorch
has no program to read, so this module watches one run through a
`TorchDispatchMode` and sees every aten op it dispatches:

  * a `PrimitiveBudget` — counts of the plan-shaping ops (sorts, gathers,
    scatters, scatter-adds, all_to_alls) and of the port's kernel calls;
  * the peak of live bytes — every storage an op creates is live until
    the last reference to it dies (a finalizer on the storage), views and
    in-place ops add nothing, and the run's inputs are live from the
    start. On a card each op's own workspace (what the allocator held at
    the op's peak beyond the storages it returned) counts too, so the
    watermark is what the run allocated at its worst: the figure a memory
    governor admits against;
  * the 64-bit widenings — ops whose outputs are 8 bytes wide while none
    of their inputs was; an op with no tensor input (a factory: arange,
    zeros, full) widens silently only where no dtype was asked for.

Kernel calls: each dispatch site of `kernels/ops.py` marks its call
(`kernels.common.kernel_call`). Inside a mark nothing is counted — what
runs there is the kernel on the card and the kernel's plain version on the
CPU — and the mark itself counts one kernel call, so a plan's budget is
the same on every device. On a card the mark also reads the launch
counters (`ops.launch_counts`): `launches` holds the launches each kernel
made inside the marks.

Counting is per op as dispatched: a sort inside a Python loop counts once
per iteration that ran (an eager run has no static program to count
against).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.table import tensors_of
from ..kernels import common as kcommon

SORT_OPS = frozenset({"sort", "argsort", "topk", "msort", "kthvalue", "_unique",
                      "_unique2", "unique_dim"})
GATHER_OPS = frozenset({"index", "index_select", "gather", "take", "take_along_dim"})
SCATTER_SET_OPS = frozenset({"index_put", "scatter", "index_copy", "index_fill",
                             "masked_scatter"})
SCATTER_COMBINE_OPS = frozenset({"scatter_add", "index_add", "scatter_reduce",
                                 "index_reduce", "bincount"})
ALL_TO_ALL_OPS = frozenset({"all_to_all_single", "alltoall", "alltoall_base"})
WIDE_BYTES = 8  # itemsize threshold for the 64-bit widening check
# Ops whose 64-bit output is torch's index type, which has no 32-bit form:
# the indices of a sort, the positions of nonzero, bincount's counts.
INDEX_OPS = frozenset({"sort", "argsort", "topk", "kthvalue", "nonzero", "bincount",
                       "_unique", "_unique2", "unique_dim", "unique_consecutive",
                       "argmax", "argmin"})
# Functions of the port that widen to 64 bits by design, and why: torch has
# no unsigned 32-bit arithmetic, so the hash and the radix digits of int32
# keys take their uint32 bits in int64; scatter_reduce takes int64 indices.
DELIBERATE_WIDENINGS = {
    ("hash_join.py", "hash32"): "uint32 hash arithmetic in int64",
    ("hash_join.py", "_digits"): "uint32 bits of the keys in int64",
    ("primitives.py", "radix_digits"): "uint32 bits of the keys in int64",
    ("groupby.py", "_min_max_segments"): "scatter_reduce takes int64 indices",
    ("nphj.py", "build_table"): "scatter_reduce takes int64 indices",
    ("nphj.py", "probe_table"): "the probe's int64 slot indices",
}


@dataclasses.dataclass(frozen=True)
class PrimitiveBudget:
    """Counts of the plan-shaping ops of one run. Addition/subtraction
    compose budgets across plan subtrees. `kernel_calls` is the JAX
    package's `pallas_calls`: calls of the port's kernels."""
    sorts: int = 0
    gathers: int = 0
    scatters: int = 0
    scatter_adds: int = 0
    float_scatter_adds: int = 0
    all_to_alls: int = 0
    kernel_calls: int = 0

    def __add__(self, other: "PrimitiveBudget") -> "PrimitiveBudget":
        return PrimitiveBudget(*(a + b for a, b in zip(self.astuple(), other.astuple())))

    def __sub__(self, other: "PrimitiveBudget") -> "PrimitiveBudget":
        return PrimitiveBudget(*(a - b for a, b in zip(self.astuple(), other.astuple())))

    def astuple(self) -> tuple:
        return dataclasses.astuple(self)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        return " ".join(f"{k}={v}" for k, v in self.as_dict().items() if v)


@dataclasses.dataclass(frozen=True)
class AuditReport:
    """Everything the contract layer needs to judge one run."""
    budget: PrimitiveBudget
    peak_live_bytes: int
    peak_live_at: str  # op at the watermark ('<args>' if the inputs)
    arg_bytes: int  # bytes of the inputs' storages
    out_bytes: int  # bytes of the outputs' storages
    promotions: tuple  # ops that widened to 64 bits with no 64-bit input
    launches: tuple = ()  # (kernel, launches) inside the marks, on a card

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["budget"] = self.budget.as_dict()
        d["promotions"] = list(self.promotions)
        d["launches"] = dict(self.launches)
        return d


def _storage_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def _deliberate() -> bool:
    """Whether a caller up the stack is one of DELIBERATE_WIDENINGS."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        if (os.path.basename(code.co_filename), code.co_name) in DELIBERATE_WIDENINGS:
            return True
        f = f.f_back
    return False


class _Auditor(TorchDispatchMode):
    """The dispatch mode behind `audit_fn`: counts ops outside the kernel
    marks and tracks the storages every op creates."""

    def __init__(self, inputs, device, workspace: bool):
        super().__init__()
        self.counts = dict.fromkeys(
            ("sorts", "gathers", "scatters", "scatter_adds", "float_scatter_adds",
             "all_to_alls", "kernel_calls"), 0)
        self.promotions: list[str] = []
        self.live: dict[int, int] = {}  # id(storage) -> bytes
        self.finalizers: list = []
        self.live_bytes = 0
        self.depth = 0  # nesting of kernel marks
        self.launch0 = None
        self.launches: dict[str, int] = {}
        self.device = device
        self.workspace = workspace and device.type == "cuda"
        for t in inputs:
            self._track(t)
        self.arg_bytes = self.live_bytes
        self.peak, self.peak_at = self.live_bytes, "<args>"

    # -- liveness ------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        """Start tracking `t`'s storage; the bytes it adds (0 when the storage
        is already live: a view, an in-place op, an input)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return 0
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        self.finalizers.append(weakref.finalize(st, self._drop, key))
        return n

    def _drop(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def close(self) -> None:
        for f in self.finalizers:
            f.detach()
        self.finalizers.clear()

    # -- kernel marks --------------------------------------------------------
    def kernel_enter(self, name: str) -> None:
        if self.depth == 0:
            self.counts["kernel_calls"] += 1
            if self.device.type == "cuda":
                self.launch0 = dict(kcommon.LAUNCHES)
        self.depth += 1

    def kernel_exit(self, name: str) -> None:
        self.depth -= 1
        if self.depth == 0 and self.launch0 is not None:
            for k, v in kcommon.LAUNCHES.items():
                if v != self.launch0[k]:
                    self.launches[k] = self.launches.get(k, 0) + v - self.launch0[k]
            self.launch0 = None

    # -- the dispatch hook ---------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.workspace:
            before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.rstrip("_")
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if self.depth == 0:
            self._count(name, func, args, kwargs, outs)
        live_before = self.live_bytes
        new = sum(self._track(t) for t in outs)
        here = live_before + new
        if self.workspace:
            # the op's own peak: what it held beyond the live storages, its
            # outputs and any workspace it freed before returning
            here = max(here, live_before + torch.cuda.max_memory_allocated(self.device) - before)
        if here > self.peak:
            self.peak, self.peak_at = here, name
        return out

    def _count(self, name, func, args, kwargs, outs) -> None:
        c = self.counts
        if name in SORT_OPS:
            c["sorts"] += 1
        elif name in GATHER_OPS:
            c["gathers"] += 1
        elif name == "index_put" and (kwargs.get("accumulate") or
                                      (len(args) > 3 and args[3])):
            self._scatter_add(outs)
        elif name == "scatter" and "reduce" in kwargs:
            self._scatter_add(outs)
        elif name in SCATTER_SET_OPS:
            c["scatters"] += 1
        elif name in SCATTER_COMBINE_OPS:
            self._scatter_add(outs)
        elif name in ALL_TO_ALL_OPS:
            c["all_to_alls"] += 1
        wide = [t for t in outs if t.element_size() >= WIDE_BYTES]
        inputs = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        silent = (not any(a.element_size() >= WIDE_BYTES for a in inputs) if inputs
                  else kwargs.get("dtype") is None)
        if wide and silent and name not in INDEX_OPS and not _deliberate():
            self.promotions.append(
                f"{func} -> {', '.join(f'{t.dtype}{list(t.shape)}' for t in wide)}")

    def _scatter_add(self, outs) -> None:
        self.counts["scatter_adds"] += 1
        if any(t.dtype.is_floating_point for t in outs):
            self.counts["float_scatter_adds"] += 1


def audit_fn(fn, *args, workspace: bool = True, **kwargs):
    """Run `fn(*args, **kwargs)` once under the auditor. Returns
    (result, AuditReport). The tensors in `args` (Tables and mappings of
    them included) are the inputs: live from the start. `workspace=False`
    leaves the ops' own workspace out of the watermark on a card (the
    storages alone)."""
    inputs = list(tensors_of(args))
    device = inputs[0].device if inputs else torch.device("cpu")
    mode = _Auditor(inputs, device, workspace)
    kcommon.KERNEL_CALL_OBSERVERS.append(mode)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        kcommon.KERNEL_CALL_OBSERVERS.remove(mode)
        mode.close()
    report = AuditReport(
        budget=PrimitiveBudget(**mode.counts),
        peak_live_bytes=int(mode.peak),
        peak_live_at=mode.peak_at,
        arg_bytes=int(mode.arg_bytes),
        out_bytes=_storage_bytes(tensors_of(out)),
        promotions=tuple(mode.promotions),
        launches=tuple(sorted(mode.launches.items())),
    )
    return out, report


def audit(fn, *args, **kwargs) -> AuditReport:
    """The AuditReport of one run of `fn(*args, **kwargs)`."""
    return audit_fn(fn, *args, **kwargs)[1]


def budget_of(fn, *args, **kwargs) -> PrimitiveBudget:
    return audit(fn, *args, **kwargs).budget


def count_sorts(fn, *args, **kwargs) -> int:
    """Sort count of one run of `fn(*args, **kwargs)`."""
    return budget_of(fn, *args, **kwargs).sorts
