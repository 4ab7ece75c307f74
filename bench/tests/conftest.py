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

# lineitem's columns that TPC-H Q1 reads, at SF10's 59,986,052 rows, drawn
# by dbgen's rules (TPC-H v3, clause 4.2.3): dates in days since
# 1992-01-01, the order's date in [0, 2405] (ENDDATE - 151), CURRENTDATE
# 1995-06-17 = 1263; decimals in hundredths; flags as ASCII codes. The
# order's date is a column of its own that Q1 does not read, and each row
# draws its own, so lines of one order share no date. No cell runs it yet:
# the tests hold the recipes to the rules with it.
Q1_CONFIG = {
    "name": "tpch-q1-lineitem",
    "tables": {"lineitem": {"rows": 59_986_052, "columns": {
        "o_orderdate": {"kind": "randint", "low": 0, "high": 2405, "dtype": "int32"},
        "l_quantity": {"kind": "randint", "low": 1, "high": 50, "dtype": "int64"},
        "l_partkey": {"kind": "randint", "low": 1, "high": 2_000_000, "dtype": "int32"},
        "l_extendedprice": {"kind": "tpch_extendedprice", "quantity": "l_quantity",
                            "partkey": "l_partkey", "dtype": "int64"},
        "l_discount": {"kind": "randint", "low": 0, "high": 10, "dtype": "int64"},
        "l_tax": {"kind": "randint", "low": 0, "high": 8, "dtype": "int64"},
        "l_shipdate": {"kind": "shift", "of": "o_orderdate", "low": 1, "high": 121,
                       "dtype": "int32"},
        "l_receiptdate": {"kind": "shift", "of": "l_shipdate", "low": 1, "high": 30,
                          "dtype": "int32"},
        "l_returnflag": {"kind": "tpch_returnflag", "receiptdate": "l_receiptdate",
                         "currentdate": 1263, "dtype": "int8"},
        "l_linestatus": {"kind": "tpch_linestatus", "shipdate": "l_shipdate",
                         "currentdate": 1263, "dtype": "int8"}}}},
}


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


def shrink_config(config: dict, shrink: int = SHRINK) -> dict:
    """A copy of a configuration with every table's rows divided by `shrink`."""
    cfg = copy.deepcopy(config)
    for t in cfg["tables"].values():
        t["rows"] = max(t["rows"] // shrink, 64)
    return cfg


def tiny_parts(cell: str, root: Path = ROOT, shrink: int = SHRINK) -> dict:
    """A cell's parts with every table's rows divided by `shrink`."""
    parts = cell_parts(cell, root)
    parts["config"] = shrink_config(parts["config"], shrink)
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
