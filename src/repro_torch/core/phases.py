"""Per-phase wall times of a join, for the `phases=` dicts of the joins."""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def phase(times: dict | None, name: str, device: torch.device):
    """Add the wall time of the enclosed phase to times[name], synchronising
    the card at both ends; does nothing when times is None."""
    if times is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times[name] = times.get(name, 0.0) + time.perf_counter() - t0
