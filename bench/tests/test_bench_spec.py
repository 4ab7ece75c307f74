"""BENCHMARK.json's shape, and every part of every cell found by name."""
import json
import re
import shutil
import textwrap

import pytest

from bench import registry

from .conftest import ROOT, run_tiny, tiny_parts

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SPEC = registry.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    parts = registry.cell_parts(SPEC, cell)
    assert parts["config"]["name"] == parts["cell"]["config"]
    assert callable(parts["query"].plan) and callable(parts["query"].reference)
    assert parts["traffic"]["entry"] in ("server", "executor")
    for m in parts["end_to_end"] + parts["per_layer"]:
        assert callable(registry.load_metric(m["name"]).read)
    assert [m["name"] for m in parts["end_to_end"]] == [m["name"] for m in SPEC["end_to_end"]]
    assert parts["per_layer"]


def test_config_files_lie_under_paths_and_differ():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.split("/")[0] in SPEC["paths"] and (ROOT / f).is_file()


NEW_QUERY = textwrap.dedent('''
    """A grouped sum over one table, the 5 largest first."""
    import torch

    from bench import refops

    KEY, ORDER, LIMIT = "g", "v_sum", 5
    READS = (("t", "g"), ("t", "v"))
    # numbers of its own: the largest gap of a group's sum, and wrong answers
    LIMITS = {"sum_gap_max": 0, "answers_wrong": 0}


    def judge(answers, groups, ref):
        right = [a is not None and list(a["v_sum"]) == sorted(ref["v_sum"].tolist(),
                                                             reverse=True)[:LIMIT]
                 for a in answers]
        gap = (abs(torch.from_numpy(groups["v_sum"]).sort().values
                   - ref["v_sum"].sort().values).max().item()
               if groups is not None and len(groups["g"]) == ref["g"].numel() else 1)
        return {"sum_gap_max": gap, "answers_wrong": right.count(False)}, right


    def plan(scan):
        return scan("t").group_by("g", v="sum").order_by("v_sum", limit=LIMIT, descending=True)


    def reference(tables, acc=torch.int64):
        gk, inv, _ = refops.groups(tables["t"]["g"])
        return {"g": gk, "v_sum": refops.group_sum(inv, gk.numel(), tables["t"]["v"], acc)
                .to(torch.int64)}
''')


def test_new_cell_needs_only_new_files(tmp_path):
    """A configuration, query, traffic mix and metric added as new files
    and new entries of BENCHMARK.json run through the harness as it is."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "bench"
    (b / "configs" / "onetable.json").write_text(json.dumps({
        "name": "onetable", "query": "groupsum", "tables": {"t": {"rows": 4096, "columns": {
            "g": {"kind": "uniform", "domain": "t", "dtype": "int32"},
            "v": {"kind": "payload", "of": "g", "j": 5, "dtype": "int64"}}}}}))
    (b / "queries" / "groupsum.py").write_text(NEW_QUERY)
    (b / "traffic" / "open20.json").write_text(json.dumps({
        "entry": "server", "loop": "open", "rate_per_s": 20, "burst": 2,
        "warmup_per_client": 1}))
    (b / "metrics" / "answers.count.py").write_text(
        "def read(ctx):\n    return ctx.completed\n")
    # a per-layer metric that captures launches of a wrapper no metric
    # captured before (on the CPU nothing launches: it reads 0 launches)
    (b / "metrics" / "kernels.probe_launches.py").write_text(textwrap.dedent('''
        CAPTURE = {"hash_probe": ("repro_torch.kernels.hash_probe", "hash_probe",
                                  lambda keys, *a, **kw: keys.numel() * 4)}


        def read(ctx):
            return float(len(ctx.launch_bytes["hash_probe"]))
    '''))
    spec["configs"].append({"name": "onetable", "source": "a test", "reduced": [],
                            "file": "bench/configs/onetable.json", "why": "a test"})
    spec["workloads"].append({"name": "onetable.open20", "config": "onetable",
                              "traffic": "open20", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "answers.count", "unit": "queries", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["onetable.open20"]})
    spec["per_layer"].append({"name": "kernels.probe_launches", "unit": "launches",
                              "better": "lower", "source": "program_counter",
                              "layer": "kernels", "moves": "answers.count",
                              "workloads": ["onetable.open20"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    parts = tiny_parts("onetable.open20", root=tmp_path, shrink=1)
    res = run_tiny(parts, seconds=1.0, root=tmp_path)["result"]
    assert res["correct"], res
    assert res["metrics"]["answers.count"]["value"] == res["attempted"] >= 10
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert res["checks"] == {"sum_gap_max": {"value": 0, "limit": 0},
                             "answers_wrong": {"value": 0, "limit": 0}}
    traced = run_tiny(parts, seconds=0.5, trace=True, root=tmp_path)
    assert traced["result"]["metrics"]["kernels.probe_launches"]["value"] == 0.0
