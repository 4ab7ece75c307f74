"""The port's dry run (`repro_torch.launch.dryrun`) and what it reads —
`named_shardings` on the production meshes, the roofline terms, the report
tables — held against the JAX package's.

The dry run shards train and prefill activations' sequence over 'model'
(`seq_shard`), as the JAX package's does. The port's side runs in
subprocesses, each the rank 0 of a fake process group
(`torch.testing._internal.distributed.fake_pg`) that owns its process's
default group; the JAX side in subprocesses with 512 or 8
placeholder host devices (`conftest.run_subtest`'s flag), nothing compiled.
All of them start together, so the file's wall time is its slowest one's.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
ARCHS = ("olmo-1b", "mixtral-8x7b", "zamba2-2.7b", "whisper-large-v3")

# every arch's template on both production meshes: JAX's specs and shard shapes
JAX_SPECS = r'''
import json, jax
from jax.sharding import NamedSharding
from repro.configs.base import get_config, list_archs
from repro.dist import sharding as SH
from repro.launch.mesh import make_production_mesh
from repro.models import model as M
from repro.models.params import P
out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    rules = SH.default_rules(multi_pod=mp)
    for arch in list_archs():
        tmpl = M.template(get_config(arch))
        shs = jax.tree_util.tree_leaves(SH.named_shardings(tmpl, mesh, rules),
                                        is_leaf=lambda x: isinstance(x, NamedSharding))
        leaves = jax.tree_util.tree_leaves(tmpl, is_leaf=lambda x: isinstance(x, P))
        out[f"{arch}/{int(mp)}"] = [
            [[list(a) if isinstance(a, tuple) else a for a in s.spec]
             + [None] * (len(l.shape) - len(s.spec)), list(s.shard_shape(l.shape))]
            for s, l in zip(shs, leaves)]
print("JSON" + json.dumps(out))
'''

PORT_SPECS = r'''
import json, torch
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs.base import get_config, list_archs
from repro_torch.dist import sharding as SH
from repro_torch.launch.dryrun import join_fake_group
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.params import P, leaves
out = {}
for mp in (False, True):
    join_fake_group(512 if mp else 256)
    mesh = make_production_mesh(multi_pod=mp, device_type="cpu")
    rules = SH.default_rules(multi_pod=mp)
    for arch in list_archs():
        tmpl = M.template(get_config(arch))
        shs = leaves(SH.named_shardings(tmpl, mesh, rules),
                     lambda x: isinstance(x, SH.NamedSharding))
        rows = []
        for s, l in zip(shs, leaves(tmpl)):
            pl = s.placements
            local = distribute_tensor(torch.empty(l.shape, device="meta"), mesh, pl,
                                      src_data_rank=None).to_local().shape
            spec = SH.spec_of(pl, mesh, len(l.shape))
            rows.append([[list(a) if isinstance(a, tuple) else a for a in spec],
                         list(local)])
        out[f"{arch}/{int(mp)}"] = rows
print("JSON" + json.dumps(out))
'''

# the reduced cells of the JAX package's test_dryrun_tiny_both_meshes (the
# dry run shards train and prefill activations' seq over 'model', as the
# JAX package's does)
PORT_DRYRUN = r'''
import json, sys, torch
torch.set_num_threads(1)
from repro_torch.configs.base import get_reduced_config
from repro_torch.launch import dryrun as DR
out = sys.argv[1]
for arch in sys.argv[2].split(","):
    for sizes, axes in (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
        rec = DR.run_cell(arch, "train_4k", "pod" in axes, cfg=get_reduced_config(arch),
                          shape=DR.REDUCED_SHAPES["train_4k"], mesh_dims=(sizes, axes),
                          microbatches=1)
        tag = f"{arch}__train_4k__{'multi' if 'pod' in axes else 'single'}"
        with open(f"{out}/{tag}.json", "w") as f:
            json.dump(rec, f)
        print(tag, rec["status"], rec.get("error", ""), flush=True)
'''

# the four archs' prefill_32k cells on (2, 4), and the olmo-1b train cell
# there without sequence sharding
PORT_DRYRUN_MORE = r'''
import json, sys, torch
torch.set_num_threads(1)
from repro_torch.configs.base import get_reduced_config
from repro_torch.launch import dryrun as DR
out = sys.argv[1]
mesh = ((2, 4), ("data", "model"))
cells = [(arch, "prefill_32k", None) for arch in sys.argv[2].split(",")]
cells.append(("olmo-1b", "train_4k", {"act": {"seq": None}}))
for arch, shape, over in cells:
    rec = DR.run_cell(arch, shape, False, cfg=get_reduced_config(arch),
                      shape=DR.REDUCED_SHAPES[shape], mesh_dims=mesh, microbatches=1,
                      rule_overrides=over)
    tag = f"{arch}__{shape}__single" + ("__noseq" if over else "")
    with open(f"{out}/{tag}.json", "w") as f:
        json.dump(rec, f)
    print(tag, rec["status"], rec.get("error", ""), flush=True)
'''

# the JAX package's in-shardings of the reduced olmo-1b train cell on (2, 4)
JAX_ARG_BYTES = r'''
import json, math, jax, jax.numpy as jnp
from repro.configs.base import get_reduced_config
from repro.dist import sharding as SH
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.models.params import P
from repro.train import step as STEP
from repro.train.optimizer import AdamW
cfg = get_reduced_config("olmo-1b")
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for seq_shard in (False, True):
    rules = SH.default_rules(seq_shard=seq_shard)
    _, psh, bsh = STEP.build_train_step(cfg, mesh, rules, AdamW(master_weights=True))
    tmpl = M.template(cfg)
    shapes = [l.shape for l in jax.tree_util.tree_leaves(tmpl, is_leaf=lambda x: isinstance(x, P))]
    shs = jax.tree_util.tree_leaves(psh,
                                    is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    param = sum(math.prod(s.shard_shape(shape)) for s, shape in zip(shs, shapes))
    batch = math.prod(bsh["tokens"].shard_shape((4, 33)))
    # bf16 parameters; float32 mu, nu and master; the int32 step; the int32 batch
    out[str(int(seq_shard))] = param * 2 + 3 * param * 4 + 4 + batch * 4
print("JSON" + json.dumps(out))
'''


def _env(jax_devices=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("PYTEST_", "REPRO_"))}
    env.update(PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    if jax_devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={jax_devices}"
    return env


def _start(code, *args, jax_devices=None):
    return subprocess.Popen([sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(jax_devices), cwd=REPO)


def _finish(proc, timeout=400):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (out[-3000:], err[-6000:])
    return out


def _json(out):
    return json.loads(next(line[4:] for line in out.splitlines() if line.startswith("JSON")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    more = out / "more"  # report.load(out) reads out's own records alone
    more.mkdir()
    procs = {
        "jax_specs": _start(JAX_SPECS, jax_devices=512),
        "port_specs": _start(PORT_SPECS),
        "dry_a": _start(PORT_DRYRUN, str(out), "olmo-1b,zamba2-2.7b"),
        "dry_b": _start(PORT_DRYRUN, str(out), "mixtral-8x7b,whisper-large-v3"),
        "dry_more": _start(PORT_DRYRUN_MORE, str(more), ",".join(ARCHS)),
        "jax_bytes": _start(JAX_ARG_BYTES, jax_devices=8),
    }
    res = {k: _finish(p) for k, p in procs.items()}
    return out, res


@pytest.fixture(scope="module")
def more(runs):
    """The records of PORT_DRYRUN_MORE's cells."""
    from repro_torch.launch import report

    out, _ = runs
    return report.load(out / "more")


def test_named_shardings_equal_the_jax_package_on_both_production_meshes(runs):
    """All ten archs on 16 x 16 and 2 x 16 x 16: each leaf's placements
    give the JAX package's PartitionSpec, and DTensor's local shard of each
    leaf has the shape of its NamedSharding's shard_shape."""
    _, res = runs
    want, got = _json(res["jax_specs"]), _json(res["port_specs"])
    assert sorted(got) == sorted(want) and len(want) == 20
    for key in want:
        assert got[key] == want[key], key


def test_dryrun_reduced_cells_on_both_fake_meshes(runs):
    """The four reduced archs' train step traced on (2, 4) and (2, 2, 2)
    fake meshes with the sequence sharded over 'model' (the JAX package's
    seq_shard=True): status ok, collectives counted, memory and FLOPs
    recorded."""
    out, _ = runs
    for arch in ARCHS:
        for mesh, sizes, chips in (("single", [2, 4], 8), ("multi", [2, 2, 2], 8)):
            rec = json.loads((out / f"{arch}__train_4k__{mesh}.json").read_text())
            assert rec["status"] == "ok", (arch, mesh, rec.get("error"), rec.get("traceback"))
            assert rec["chips"] == chips and rec["mesh"] == "x".join(map(str, sizes))
            assert sum(rec["collectives"]["counts"].values()) > 0, (arch, mesh)
            assert rec["collectives"]["bytes_static"] == rec["collectives"][
                "bytes_trip_weighted"] > 0
            mem = rec["memory"]
            assert 0 < mem["argument_bytes_per_device"] <= mem["live_bytes_per_device"]
            assert mem["fits_h100_80GB"] is True
            assert rec["cost_analysis"]["flops_per_device"] > 0
            assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")


def test_dryrun_argument_bytes_equal_the_jax_in_shardings(runs):
    """olmo-1b reduced on (2, 4), its sequence (32) sharded over 'model':
    the local shards of the bf16 parameters, the float32 optimizer state
    and the int32 batch the dry run counts are the bytes of the JAX
    package's in-shardings' shard shapes with seq_shard=True."""
    out, res = runs
    rec = json.loads((out / "olmo-1b__train_4k__single.json").read_text())
    assert rec["memory"]["argument_bytes_per_device"] == _json(res["jax_bytes"])["1"]


def test_dryrun_argument_bytes_without_seq_sharding_equal_the_jax_in_shardings(runs, more):
    """The same cell traced with the sequence whole (rule override seq None)
    has the bytes of the JAX package's in-shardings with seq_shard=False:
    the batch enters with its sequence whole either way."""
    _, res = runs
    rec = more["olmo-1b__train_4k__single__noseq"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["argument_bytes_per_device"] == _json(res["jax_bytes"])["0"]


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_reduced_prefill_cells_with_seq_sharding(more, arch):
    """Each of the four archs' prefill_32k cell (reduced: b=4, s=32) traced
    on a (2, 4) fake mesh with the sequence sharded over 'model': status
    ok, collectives counted, its arguments within its live peak, FLOPs
    recorded."""
    rec = more[f"{arch}__prefill_32k__single"]
    assert rec["status"] == "ok", (arch, rec.get("error"), rec.get("traceback"))
    assert rec["chips"] == 8 and sum(rec["collectives"]["counts"].values()) > 0
    mem = rec["memory"]
    assert 0 < mem["argument_bytes_per_device"] <= mem["live_bytes_per_device"]
    assert rec["cost_analysis"]["flops_per_device"] > 0


def test_roofline_terms_follow_the_reference_formula_with_h100_constants():
    from repro.launch import roofline as JRL
    from repro_torch.launch import roofline as RL

    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.HBM_CAP, RL.LINK_BW) == (989e12, 3.35e12, 80e9, 50e9)
    for args in ((989e12 * 256, 3.35e12, 50e9, 256), (1e12, 3.35e12 * 10, 0.0, 256),
                 (3e15, 2e9, 7e9, 512), (0.0, 0.0, 0.0, 8)):
        got = RL.roofline_terms(*args)
        flops, hbm, coll, chips = args
        compute, memory, collective = (flops / (chips * RL.PEAK_FLOPS), hbm / RL.HBM_BW,
                                       coll / RL.LINK_BW)
        bound = max(compute, memory, collective)
        assert got == {"compute_s": compute, "memory_s": memory, "collective_s": collective,
                       "dominant": max({"compute_s": compute, "memory_s": memory,
                                        "collective_s": collective}.items(),
                                       key=lambda kv: kv[1])[0],
                       "roofline_fraction_compute": compute / bound if bound else 0.0,
                       "step_lower_bound_s": bound}
        # the reference's own formula with the port's constants
        ref = {"compute_s": flops / (chips * RL.PEAK_FLOPS), "memory_s": hbm / RL.HBM_BW,
               "collective_s": coll / RL.LINK_BW}
        assert sorted(JRL.roofline_terms(*args)) == sorted(got)
        assert all(got[k] == ref[k] for k in ref)
    t = RL.roofline_terms(989e12 * 256, 3.35e12, 50e9, chips=256)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0


def test_no_tpu_constant_in_the_port():
    for f in (REPO / "src" / "repro_torch").rglob("*.py"):
        text = f.read_text()
        for tpu in ("197e12", "819e9", "16e9", "v5e"):
            assert tpu not in text, (f, tpu)


def test_report_tables_on_the_ports_records(runs):
    from repro_torch.launch import report

    out, _ = runs
    recs = report.load(out)
    assert len(recs) == 2 * len(ARCHS)
    s = report.summarize(recs)
    assert s == {"ok": 8, "skipped": 0, "failed": 0, "nofit": 0}
    single = report.dryrun_table(recs, "__single").splitlines()
    multi = report.dryrun_table(recs, "__multi").splitlines()
    assert len(single) == len(multi) == 2 + len(ARCHS)
    assert all("| ok |" in row and "| yes |" in row for row in single[2:] + multi[2:])
    roof = report.roofline_table(recs).splitlines()
    assert len(roof) == 2 + len(ARCHS)
    # both meshes: a row an arch x shape, each mesh's cells side by side
    both = report.dryrun_table(recs, "__single", "__multi").splitlines()
    assert len(both) == 2 + len(ARCHS)
    assert both[0].count("16x16 status") == 2
    assert all(row.count("| ok |") == 2 and row.count("| yes |") == 2 for row in both[2:])
    assert all(row.startswith(one[:-1]) for row, one in zip(both[2:], single[2:]))
    # a skipped and a failed record have rows of their own
    recs["x__train_4k__single"] = {"status": "skipped", "reason": "no long context"}
    recs["y__train_4k__single"] = {"status": "FAILED", "error": "RuntimeError: boom"}
    rows = report.dryrun_table(recs, "__single")
    assert "| x | train_4k | skipped |" in rows and "| y | train_4k | **FAILED** |" in rows
    assert "| no long context |" in rows and "| RuntimeError: boom |" in rows
    both = report.dryrun_table(recs, "__single", "__multi")
    assert "| x | train_4k | skipped |" in both and "| y | train_4k | **FAILED** |" in both
    assert both.count("not run") == 2  # neither has a multi-pod record
    assert report.summarize(recs)["failed"] == 1
    # the memory deltas: none against itself
    assert report.memory_delta_table(recs, recs).count("\n") == 1


def test_mesh_helpers_read_axis_names():
    from repro_torch.launch.mesh import mesh_chips, mesh_shape

    class Named:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    class Mapping:
        shape = {"data": 4, "model": 2}

    assert mesh_shape(Named()) == {"pod": 2, "data": 16, "model": 16}
    assert mesh_chips(Named()) == 512 and mesh_chips(Mapping()) == 8
