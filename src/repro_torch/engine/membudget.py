"""Per-device byte budget and in-flight reservation ledger (DESIGN.md §15):
the port's copy of the JAX package's `engine.membudget`. On the card the
budget is the card's memory (`torch.cuda.mem_get_info`), and a
`torch.cuda.OutOfMemoryError` is a memory error.

The paper's §4.4 point is that memory, not time, bounds the solvable
problem size on a GPU; this module is the governor that makes a serving
layer obey that bound. A `MemoryBudget` holds the device's byte budget —
detected (`detect_budget_bytes`), overridable with
``REPRO_MEM_BUDGET_BYTES`` — plus a tagged reservation ledger for work in
flight: the sum of in-flight tickets never exceeds the budget.

The env override follows the repo's read-time-validation convention: the
variable is parsed and validated on every `detect_budget_bytes()` call —
never frozen at import — and an unrecognized value raises ValueError
naming what is allowed.

`is_memory_error` is the classifier the executor and server share to
decide whether a failure should degrade onto the morsel rung
(physical.degrade_plan(memory=True)) instead of the capacity-doubling
rung: allocation failures get a SMALLER working set, not a bigger one.
"""
from __future__ import annotations

import os

ENV_VAR = "REPRO_MEM_BUDGET_BYTES"

# Devices that report no byte limit (the CPU) get an effectively-unbounded
# budget: the governor must not
# change behavior where memory was never the constraint. Tests and the
# chaos harness force small budgets explicitly.
FALLBACK_BUDGET_BYTES = 64 << 30

# Substrings that mark a backend runtime error as an allocation failure.
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OOM", "Failed to allocate")


class MemoryBudgetExceeded(MemoryError):
    """A plan can NEVER fit the budget — not even at the smallest morsel
    factor (or it has no morsel axis at all). The typed rejection error:
    the server turns it into ``error="rejected"`` instead of crashing or
    retrying something that cannot succeed."""

    def __init__(self, need_bytes: int, budget_bytes: int, detail: str = ""):
        self.need_bytes = int(need_bytes)
        self.budget_bytes = int(budget_bytes)
        msg = (f"plan needs {self.need_bytes} bytes but the device budget "
               f"is {self.budget_bytes} bytes")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


def is_memory_error(e: BaseException) -> bool:
    """True when `e` is an allocation failure: a MemoryError subclass
    (including the injected `faults.OOMInjected`), PyTorch's
    `torch.cuda.OutOfMemoryError`, or a runtime error whose message carries
    an OOM marker. Used to route failures onto the morsel rung instead of
    the capacity-doubling rung."""
    import torch

    if isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    text = f"{type(e).__name__}: {e}"
    return any(marker in text for marker in _OOM_MARKERS)


def detect_budget_bytes(device=None) -> int:
    """This process's byte budget on `device` (default: the card when there
    is one, else the CPU).

    ``REPRO_MEM_BUDGET_BYTES`` (a positive integer, parsed and validated
    per call — the read-time convention) wins when set; otherwise the
    card's total memory (`torch.cuda.mem_get_info`); otherwise
    FALLBACK_BUDGET_BYTES (the CPU reports no limit)."""
    env = os.environ.get(ENV_VAR)
    if env is not None:
        try:
            val = int(env.strip())
        except ValueError:
            val = -1
        if val <= 0:
            raise ValueError(
                f"{ENV_VAR}={env!r} is not a recognized value; allowed: a "
                "positive integer byte count (e.g. 1073741824 for 1 GiB)")
        return val
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return FALLBACK_BUDGET_BYTES


class MemoryBudget:
    """Byte budget + tagged in-flight reservation ledger.

    Reservation lifecycle (DESIGN.md §15): `try_reserve(tag, nbytes)` at
    admission (False when the ticket does not fit ``budget - reserved`` —
    the caller defers, it never over-commits), `release(tag)` when the
    tagged work leaves the system on ANY path (success, failure,
    deadline eviction). Tags are idempotent: re-reserving a live tag
    replaces its ticket; releasing an unknown tag is a no-op, so every
    exit path can release unconditionally. `peak_reserved` is the
    high-water mark the chaos harness pins against the budget."""

    def __init__(self, total_bytes: int | None = None, device=None):
        self.total = int(total_bytes if total_bytes is not None
                         else detect_budget_bytes(device))
        if self.total <= 0:
            raise ValueError(f"budget must be positive, got {self.total}")
        self._ledger: dict[str, int] = {}
        self.peak_reserved = 0

    @property
    def reserved(self) -> int:
        return sum(self._ledger.values())

    def available(self) -> int:
        return self.total - self.reserved

    def fits(self, nbytes: int) -> bool:
        return int(nbytes) <= self.available()

    def try_reserve(self, tag: str, nbytes: int) -> bool:
        """Reserve `nbytes` under `tag` iff it fits the remaining budget.
        Returns False (ledger untouched) otherwise — never raises, never
        over-commits."""
        nbytes = int(nbytes)
        held = self._ledger.get(tag, 0)
        if nbytes - held > self.available():
            return False
        self._ledger[tag] = nbytes
        self.peak_reserved = max(self.peak_reserved, self.reserved)
        return True

    def release(self, tag: str) -> int:
        """Drop `tag`'s reservation; returns the bytes freed (0 if the
        tag was not held — release is safe on every exit path)."""
        return self._ledger.pop(tag, 0)

    def __repr__(self):
        return (f"MemoryBudget(total={self.total}, reserved={self.reserved},"
                f" tags={len(self._ledger)})")
