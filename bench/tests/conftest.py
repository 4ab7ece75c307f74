"""CPU tests of the benchmark: `python -m pytest bench/tests`. Tests that
need the card are marked `cuda` and look for it inside the test."""
import copy
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness, registry  # noqa: E402

# the tests' tables: each configuration's row counts divided by this
SHRINK = 4096


def tiny_parts(cell: str, root: Path = ROOT, shrink: int = SHRINK) -> dict:
    """A cell's parts with every table's rows divided by `shrink`."""
    parts = registry.cell_parts(registry.load_spec(root), cell, root)
    cfg = copy.deepcopy(parts["config"])
    for t in cfg["tables"].values():
        t["rows"] = max(t["rows"] // shrink, 64)
    parts["config"] = cfg
    return parts


def run_tiny(parts: dict, *, seed: int = 2**31 + 11, seconds: float = 0.5, trace=False,
             device="cpu", **kw) -> dict:
    return harness.run_cell(parts, seed, seconds, trace, device,
                            t_start=time.perf_counter(), **kw)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
