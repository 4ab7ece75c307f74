"""TPC-style analytics through the PyTorch port's query engine: declarative
plans over scaled TPC-H/DS extracts (paper Table 6) and a star schema,
optimized with engine-estimated statistics (no hand-written JoinStats) and
run by `plan.run()`. `explain()` shows the per-operator algorithm/pattern
choice and the cost model's prediction. The same data, from the same numpy
seeds, and the same lines as `examples/relational_analytics.py`; the
extracts' payload columns are 4-byte, as the JAX package holds them (x64
off).

    PYTHONPATH=src python examples/relational_analytics_torch.py
    PYTHONPATH=src python examples/relational_analytics_torch.py --device cpu

Runs on the card by default; without one it exits 1 unless given
--device cpu. The cost model prices with the profile measured for the
device (cached in CALIBRATION.json, or `REPRO_CALIBRATION_PATH`).
"""
import argparse
import sys

import torch

from repro_torch.core import table_from_numpy
from repro_torch.data import relgen
from repro_torch.engine import Catalog, optimize, scan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        raise SystemExit(1)

    # -- single TPC extracts: R join S, planner-selected algorithm ---------
    for jid in ("J1", "J3", "J4"):
        Rn, Sn, mode = relgen.generate_tpc(jid, scale=1 / 1024, payload_bytes=4)
        R, S = table_from_numpy(Rn, device), table_from_numpy(Sn, device)
        cat = Catalog({"R": R, "S": S})
        plan = optimize(scan("R").join(scan("S"), key="k", mode=mode), cat)
        T, count = plan.run()
        join_line = next(line for line in plan.explain().splitlines() if "Join[" in line)
        print(f"{jid}: |R|={R.num_rows} |S|={S.num_rows} -> {int(count)} rows")
        print(f"    {join_line.strip()}")

    # -- end-to-end: two joins + grouped aggregation + top-k ---------------
    fact, dims, fks, dks = relgen.generate_star(1 << 15, 1 << 12, 2, payloads_per_dim=1)
    cat = Catalog({"fact": table_from_numpy(fact, device),
                   "dim0": table_from_numpy(dims[0], device),
                   "dim1": table_from_numpy(dims[1], device)})
    q = (scan("fact")
         .join(scan("dim0"), left_key="fk0", right_key="k0")
         .join(scan("dim1"), left_key="fk1", right_key="k1")
         .group_by("fk0", p1_0="sum")
         .order_by("p1_0_sum", limit=8, descending=True))
    plan = optimize(q, cat)
    print("\nstar query:")
    print(plan.explain())
    G, g_cnt = plan.run()
    print(f"top-8 of {int(g_cnt)} surviving rows; "
          f"best group sum={int(torch.max(G['p1_0_sum']))}")


if __name__ == "__main__":
    main()
