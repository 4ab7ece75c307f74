"""`python -m repro_torch.obs` — run the standard traced workload, write
TRACE.json (+ TRACE.perfetto.json), update the calibration store, and print
the predicted-vs-measured table per plan node (DESIGN.md §12). The port's
counterpart of `python -m repro.obs`.

Two optimizer-chosen queries cover the residual surfaces that matter:

  star     join + grouped aggregation (the fusion pass decides fused vs
           unfused — joins and accumulators both get residuals)
  highcard high-cardinality integer-key group-by, the partition-vs-sort
           crossover the cost model prices from its measured profile

Each run feeds the measured/modeled residuals back into the calibration
store's per-(operator, strategy) EWMAs under the device's fingerprint, so
the next `optimize()` on this device sees the regret flag wherever the
model's winner lost by >2x.

Usage:
    python -m repro_torch.obs [--smoke] [--device cuda|cpu]
                              [--trace-out TRACE.json] [--iters K] [--warmup W]

The tables live on `--device` (default: the card). Without a card the
command exits 1 unless `--device cpu` is given; it never falls back to the
CPU by itself.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _workloads(smoke: bool, device: str):
    """(name, PhysicalPlan) pairs over freshly generated tables."""
    from ..core import table_from_numpy
    from ..engine import Catalog, Optimizer, scan

    rng = np.random.default_rng(7)
    n_r, n_s = (512, 4096) if smoke else (4096, 65536)
    n_hc = 4096 if smoke else 65536

    R = {"k": rng.permutation(n_r).astype(np.int32),
         "rv": rng.integers(0, 100, n_r).astype(np.int32)}
    S = {"k": rng.integers(0, n_r, n_s).astype(np.int32),
         "g": rng.integers(0, 64, n_s).astype(np.int32),
         "sv": rng.integers(0, 100, n_s).astype(np.int32)}
    # high-cardinality sparse integer keys: unique (multiplicity 1, so the
    # partition guard's exact proof holds) but spread over a domain too
    # wide for the scatter accumulator -> the chooser routes to the
    # paper's partition strategy
    hk = (rng.permutation(n_hc) * 97).astype(np.int32)
    T = {"k": hk, "v": rng.normal(size=n_hc).astype(np.float32)}
    cat = Catalog({name: table_from_numpy(cols, device)
                   for name, cols in (("R", R), ("S", S), ("T", T))})

    opt = Optimizer(cat)  # profile measured on the device, via the store
    star = opt.optimize(
        scan("S").join(scan("R"), key="k").group_by("g", rv="sum", sv="mean"))
    highcard = opt.optimize(scan("T").group_by("k", v="sum"))
    return [("star", star), ("highcard_groupby", highcard)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes for CI (seconds, not minutes)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--trace-out", default="TRACE.json")
    ap.add_argument("--perfetto-out", default="TRACE.perfetto.json")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        return 1

    from ..engine import calibrated_profile
    from . import CalibrationStore, backend_fingerprint, residuals_of

    fp = backend_fingerprint(device)
    print(f"backend: {fp}")

    traces = {}
    all_residuals = []
    for name, plan in _workloads(args.smoke, str(device)):
        _, _, trace = plan.run(trace=True, trace_iters=args.iters,
                               trace_warmup=args.warmup)
        traces[name] = trace
        all_residuals.extend(residuals_of(trace))
        print(f"\n== {name} ==")
        print(plan.explain(actuals=trace))
        print(trace.table())

    with open(args.trace_out, "w") as f:
        json.dump({"backend": fp,
                   "queries": {n: t.as_dict() for n, t in traces.items()}},
                  f, indent=2, sort_keys=True)
    print(f"\nwrote {args.trace_out} "
          f"({sum(len(t.spans()) for t in traces.values())} spans)")
    events = [dict(e, pid=i) for i, t in enumerate(traces.values())
              for e in t.chrome_trace()]
    with open(args.perfetto_out, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    print(f"wrote {args.perfetto_out} (Perfetto-loadable)")

    # feed the residuals back: the profile stays (calibrated_profile already
    # stored it), EWMAs sharpen with this run's measured/modeled ratios
    store = CalibrationStore()
    rs = store.residual_store(fp)
    rs.update(all_residuals)
    store.put_residuals(fp, rs)
    if not store.data.get(fp, {}).get("profiles"):
        store.put_profile(fp, 1 << 16, calibrated_profile(device=device))
    store.save()
    print(f"updated {store.path}: "
          f"{len(rs.data)} residual key(s) for this backend")
    print("\nresidual EWMAs (measured/modeled; 1.0 = model exact):")
    for key, ent in sorted(rs.data.items()):
        flag = "  <-- >2x" if ent["ewma"] >= 2.0 or ent["ewma"] <= 0.5 else ""
        print(f"  {key:<28} ewma={ent['ewma']:.2f}x "
              f"count={ent['count']}{flag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
