"""Finds a cell's parts by name: `BENCHMARK.json`, then one file each for the
configuration, the query, the traffic mix and every per-layer metric."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(f"bench_{path.parent.name}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_query(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root / BENCH.name / "queries" / f"{name}.py", name)


def load_metric(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root / BENCH.name / "metrics" / f"{name}.py", name)


def load_traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / BENCH.name / "traffic" / f"{name}.json") as f:
        return json.load(f)


def cell_parts(spec: dict, cell_name: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration (the file's contents), query
    module and traffic mix, and its end-to-end and per-layer metric entries
    (those whose `workloads` list names the cell, or that have none)."""
    cell = _by_name(spec["workloads"], cell_name, "workload")
    cfg_entry = _by_name(spec["configs"], cell["config"], "configuration")
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)

    def mine(m):
        return cell_name in m.get("workloads", [cell_name])

    return {
        "cell": cell,
        "config": config,
        "query": load_query(config["query"], root),
        "traffic": load_traffic(cell["traffic"], root),
        "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
        "per_layer": [m for m in spec["per_layer"] if mine(m)],
    }
