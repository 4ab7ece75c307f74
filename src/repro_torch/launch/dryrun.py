"""Multi-pod dry run: for every (architecture x input shape x mesh) cell,
trace one sharded step of rank 0 on the production mesh and record its
memory, FLOPs and collectives.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out experiments/dryrun_torch
    # the same sweep, a process a cell, 8 at a time
    PYTHONPATH=src python -c 'from repro_torch.launch.dryrun import SHAPES, list_archs
    print(*(f"--arch {a} --shape {s} --mesh {m}" for a in list_archs() for s in SHAPES
            for m in ("single", "multi")), sep="\\n")' | xargs -L 1 -P 8 timeout 2400 \\
        env PYTHONPATH=src python -m repro_torch.launch.dryrun --out experiments/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.report experiments/dryrun_torch

The JAX package lowers and compiles the step for 512 placeholder devices.
The port needs neither devices nor a compiler: the process joins a fake
process group of the mesh's size as rank 0
(`torch.testing._internal.distributed.fake_pg`: every collective returns
at once), builds the production `DeviceMesh` on it, and runs one step of
the same step builders the trainer and the server use, on DTensors whose
local shards are meta tensors (shapes and dtypes, no storage). A
`roofline.StepTracer` watches rank 0's local ops:

  * memory: `argument_bytes_per_device` (the local shards of the
    parameters, the optimizer state and the batch, or of the cache and the
    token) and `live_bytes_per_device`, the peak of live storage during
    the step (the watermark of `analysis.dispatch_audit`), against the
    H100's 80 GB (`fits_h100_80GB`);
  * cost_analysis: the FLOPs of rank 0's ops (`torch.utils.flop_counter`);
  * collectives: DTensor's collectives, by kind and bytes.

The trace runs the kernels' plain versions (a meta tensor is not a CUDA
tensor), with the MoE plans' sizes known from the capacity. Failures here
(a placement DTensor cannot take, an op without a sharding rule) are bugs
in the system; skipped cells (long_500k on full-attention archs) are
recorded with their DESIGN.md §5 rationale. Train and prefill cells shard
the activations' sequence over 'model' (`seq_shard`), as the JAX
package's do. Run each invocation in a process of its own: it owns the
process's default process group. Cells already recorded in `--out` are
skipped.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from ..configs.base import (SHAPES, ShapeSpec, cell_is_runnable, get_config,
                            get_reduced_config, list_archs)
from ..dist import sharding as SH
from ..models import flops as FL
from ..models import model as M
from ..models.params import abstract_from_template, leaves
from ..train import step as STEP
from ..train.optimizer import AdamW, AdamWState
from . import roofline as RL
from .mesh import make_mesh, mesh_chips


def abstract_opt_state(tmpl, master=True):
    """The AdamW state of `tmpl` without storage (meta tensors: float32
    moments and master weights, an int32 step)."""
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device="meta"),
        mu=abstract_from_template(tmpl, torch.float32),
        nu=abstract_from_template(tmpl, torch.float32),
        master=abstract_from_template(tmpl, torch.float32) if master else None,
    )


# Gradient-accumulation microbatch count per train cell: the memory knob
# for big-activation architectures (the JAX package's table). Default 1.
MICROBATCHES = {
    "mixtral-8x7b": 4,
    "qwen2-moe-a2.7b": 4,
    "llama-3.2-vision-11b": 4,
    "zamba2-2.7b": 4,
    "starcoder2-7b": 2,
    "whisper-large-v3": 2,
    "granite-8b": 2,
    "h2o-danube-3-4b": 2,
}


# Named sharding variants. "flat_dp" retires TP entirely: both mesh axes
# do DP/FSDP (for small models whose TP activation all-reduces dominate);
# "ep" maps the expert dim onto the model axis.
VARIANTS = {
    "baseline": {},
    "flat_dp": {
        "param": {"heads": None, "kv_heads": None, "mlp": None, "vocab": None,
                  "inner": None, "embed": ("data", "model"),
                  "expert_mlp": ("data", "model"), "expert_embed": None},
        "act": {"batch": ("pod", "data", "model"), "seq": None, "heads": None,
                "kv_heads": None, "mlp": None, "vocab": None, "inner": None,
                "head_dim": None, "tokens": ("pod", "data", "model")},
    },
    "ep": {
        "param": {"experts": "model", "expert_mlp": ("data",), "expert_embed": None},
        "act": {},
    },
    # serving: weights TP-only resident (no FSDP), so decode steps carry no
    # per-step parameter all-gathers
    "serve_tp": {
        "param": {"embed": None, "expert_embed": None},
        "act": {},
    },
    # training: remat policy saves matmul outputs (backward multiplier 4->3)
    "remat_dots": {"param": {}, "act": {}},
    "flat_dp_dots": {},  # filled below: flat_dp sharding + dots remat
}
VARIANTS["flat_dp_dots"] = VARIANTS["flat_dp"]


# the smoke run's shapes (--reduced): each cell's kind at a size the reduced
# configs take
REDUCED_SHAPES = {"train_4k": ShapeSpec("train_4k", 32, 4, "train"),
                  "prefill_32k": ShapeSpec("prefill_32k", 32, 4, "prefill"),
                  "decode_32k": ShapeSpec("decode_32k", 32, 4, "decode"),
                  "long_500k": ShapeSpec("long_500k", 64, 1, "decode")}


def join_fake_group(chips: int) -> None:
    """Make this process rank 0 of a fake process group of `chips` ranks
    (replacing a default group of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == chips and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=chips)


def _local_bytes(tensors) -> int:
    return sum(SH.local(t).numel() * t.element_size() for t in tensors)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             rule_overrides: dict | None = None, dtype=torch.bfloat16,
             microbatches: int | None = None, variant: str = "baseline",
             cfg=None, shape=None, mesh_dims: tuple | None = None) -> dict:
    """Trace one cell. `cfg`, `shape` and `mesh_dims` ((sizes, axes))
    replace the published config, the named shape and the production mesh
    (the tests' reduced cells)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh_dims is None:
        mesh_dims = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                     else ((16, 16), ("data", "model")))
    sizes, axes = mesh_dims
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, sizes)) if not multi_pod or sizes != (2, 16, 16)
           else "pod2x16x16"}
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    chips = math.prod(sizes)
    rules = SH.default_rules(multi_pod="pod" in axes, fsdp=True,
                             seq_shard=(shape.kind in ("train", "prefill")))
    if variant != "baseline":
        rec["variant"] = variant
        vo = VARIANTS[variant]
        rule_overrides = {
            "param": {**vo.get("param", {}), **(rule_overrides or {}).get("param", {})},
            "act": {**vo.get("act", {}), **(rule_overrides or {}).get("act", {})},
        }
    if rule_overrides:
        rules = SH.ShardingRules(param={**rules.param, **rule_overrides.get("param", {})},
                                 act={**rules.act, **rule_overrides.get("act", {})})
    rec["seq_shard"] = rules.act.get("seq") is not None

    t0 = time.time()
    try:
        join_fake_group(chips)
        mesh = make_mesh(sizes, axes, device_type="cpu")
        tmpl = M.template(cfg)
        aparams = abstract_from_template(tmpl, dtype)
        if shape.kind == "train":
            opt = AdamW(master_weights=True)
            mbs = microbatches if microbatches is not None else MICROBATCHES.get(arch, 1)
            rec["microbatches"] = mbs
            remat = "dots" if variant in ("remat_dots", "flat_dp_dots") else True
            step, psh, bsh = STEP.build_train_step(cfg, mesh, rules, opt,
                                                   microbatches=mbs, remat=remat)
            args = (SH.place_tree(aparams, psh),
                    STEP._place_opt_state(abstract_opt_state(tmpl),
                                          STEP.opt_state_shardings(psh, mesh)),
                    M.input_specs(cfg, shape, dtype=dtype))
        elif shape.kind == "prefill":
            step, psh, bsh = STEP.build_prefill_step(cfg, mesh, rules)
            args = (SH.place_tree(aparams, psh),
                    STEP.place_batch(M.input_specs(cfg, shape, dtype=dtype), mesh, rules))
        else:  # decode
            specs = M.input_specs(cfg, shape, dtype=dtype)
            step, psh, csh, tsh = STEP.build_serve_step(
                cfg, mesh, rules, shape.global_batch, shape.seq_len)
            args = (SH.place_tree(aparams, psh), SH.place_tree(specs["cache"], csh),
                    SH.place(specs["token"], tsh), specs["pos"])
        del aparams
        inputs = [SH.local(t) for t in leaves(args, torch.is_tensor)]
        if shape.kind == "train":  # the batch enters as local shards
            inputs = inputs[:-len(args[2])] + [
                SH.local(v) for v in STEP.place_batch(args[2], mesh, rules).values()]
        arg_bytes = _local_bytes(inputs)
        tracer = RL.StepTracer(inputs)
        try:
            with tracer:
                out = step(*args)
            del out
        finally:
            tracer.close()
        t_trace = time.time() - t0
    except Exception as e:  # a failing cell is a bug: record it loudly
        rec.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        return rec

    live = int(tracer.peak)
    mem = {"argument_bytes_per_device": int(arg_bytes),
           "live_bytes_per_device": live,
           "peak_live_at": tracer.peak_at,
           "fits_h100_80GB": bool(live < RL.HBM_CAP)}
    colls = tracer.stats()
    by_kind: dict = {}
    for op in colls.per_op:
        by_kind[op["kind"]] = by_kind.get(op["kind"], 0) + op["bytes"]
    est = FL.estimate(cfg, shape, SH.mesh_shape(mesh),
                      remat_factor=3.0 if variant in ("remat_dots", "flat_dp_dots") else 4.0)
    # variants change the collective schedule away from the analytic
    # model's assumptions: trust the traced bytes there
    if variant == "baseline":
        coll_bytes_dev = max(colls.bytes_weighted, est.collective_bytes_per_device)
    else:
        coll_bytes_dev = colls.bytes_weighted
    terms = RL.roofline_terms(est.flops_total, est.hbm_bytes_per_device,
                              coll_bytes_dev, chips)
    rec.update(
        status="ok",
        chips=mesh_chips(mesh),
        trace_s=round(t_trace, 2),
        memory=mem,
        cost_analysis={"flops_per_device": float(tracer.flops)},
        collectives={"counts": colls.counts,
                     "bytes_static": colls.bytes_static,
                     "bytes_trip_weighted": colls.bytes_weighted,
                     "bytes_by_kind": by_kind},
        analytic={
            "flops_total": est.flops_total,
            "flops_layer_fwd": est.flops_layer_fwd,
            "model_flops_6ND": est.model_flops,
            "useful_ratio": est.model_flops / est.flops_total if est.flops_total else 0.0,
            "hbm_bytes_per_device": est.hbm_bytes_per_device,
            "collective_bytes_per_device": est.collective_bytes_per_device,
        },
        roofline=terms,
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs on (2, 4) / (2, 2, 2) meshes (a smoke run)")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failed = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                if args.variant != "baseline":
                    tag += f"__{args.variant}"
                path = outdir / f"{tag}.json"
                if path.exists():
                    print(f"[skip-cached] {tag}")
                    continue
                print(f"[run] {tag}", flush=True)
                kw = {}
                if args.reduced:
                    kw = dict(cfg=get_reduced_config(arch), shape=REDUCED_SHAPES[shape],
                              mesh_dims=(((2, 2, 2), ("pod", "data", "model")) if mp
                                         else ((2, 4), ("data", "model"))))
                rec = run_cell(arch, shape, mp, variant=args.variant,
                               microbatches=args.microbatches, **kw)
                path.write_text(json.dumps(rec, indent=1, default=str))
                status = rec["status"]
                extra = ""
                if status == "ok":
                    extra = (f" trace={rec['trace_s']}s"
                             f" live={rec['memory']['live_bytes_per_device'] / 1e9:.2f}GB"
                             f" dom={rec['roofline']['dominant']}"
                             f" collectives={sum(rec['collectives']['counts'].values())}")
                    print(f"  memory:        {rec['memory']}")
                    print(f"  cost_analysis: {rec['cost_analysis']}")
                elif status == "FAILED":
                    failed += 1
                    extra = " " + rec["error"][:160]
                print(f"[{status}] {tag}{extra}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
