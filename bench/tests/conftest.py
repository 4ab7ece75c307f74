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

# A configuration that no cell of BENCHMARK.json runs: 60M int32 keys
# (zipf(1.5) - 1) mod 4096 and float32 values in [0, 1), grouped by the
# `skew_groupby` query. Its shapes are those of the group-by skew sweep in
# benchmarks/groupby_bench.py, which no public source backs, so it is no
# cell; the tests hold the `zipf` and `real` recipes, the float judge and
# the query to it, under each traffic mix, as if it were one.
HELD_CONFIG = {
    "name": "skew-groupby",
    "query": "skew_groupby",
    "tables": {"facts": {"rows": 60_000_000, "columns": {
        "k": {"kind": "zipf", "s": 1.5, "fold": 4096, "dtype": "int32"},
        "v": {"kind": "real", "low": 0.0, "high": 1.0, "dtype": "float32"}}}},
}
HELD = {"skew-groupby.served4": "served4", "skew-groupby.embedded": "embedded"}


def cell_parts(cell: str, root: Path = ROOT) -> dict:
    """A cell's parts as `registry.cell_parts` gives them, or a held cell's,
    with the end-to-end metrics that every cell reports and no per-layer one."""
    spec = registry.load_spec(root)
    if cell not in HELD:
        return registry.cell_parts(spec, cell, root)
    return {
        "cell": {"name": cell, "config": HELD_CONFIG["name"], "traffic": HELD[cell], "chips": 1},
        "config": HELD_CONFIG,
        "query": registry.load_query(HELD_CONFIG["query"], root),
        "traffic": registry.load_traffic(HELD[cell], root),
        "end_to_end": [m for m in spec["end_to_end"] if "workloads" not in m],
        "per_layer": [],
    }


def tiny_parts(cell: str, root: Path = ROOT, shrink: int = SHRINK) -> dict:
    """A cell's parts with every table's rows divided by `shrink`."""
    parts = cell_parts(cell, root)
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
