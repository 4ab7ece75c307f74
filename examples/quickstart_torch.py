"""Quickstart with the PyTorch port: the paper's technique in 30 lines.

Builds two relations, runs all four join implementations (SMJ/PHJ x
GFUR/GFTR), a grouped aggregation, and asks the planner (paper Fig. 18)
which algorithm to use. The same data, from the same numpy seed, and the
same lines as `examples/quickstart.py`; on the card the joins and the
group-by run the port's CUDA kernels.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Runs on the card by default; without one it exits 1 unless given
--device cpu.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.core import (KEY_SENTINEL, JoinStats, Table, choose_algorithm,
                              group_aggregate, join)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        raise SystemExit(1)

    def col(a):
        return torch.from_numpy(a).to(device)

    rng = np.random.default_rng(0)
    n_r, n_s = 10_000, 30_000

    # R: primary-key side with two payload columns; S: foreign-key side.
    R = Table({
        "k": col(rng.permutation(n_r).astype(np.int32)),
        "price": col(rng.gamma(2.0, 10.0, n_r).astype(np.float32)),
        "stock": col(rng.integers(0, 100, n_r).astype(np.int32)),
    })
    S = Table({
        "k": col(rng.integers(0, n_r, n_s).astype(np.int32)),
        "qty": col(rng.integers(1, 10, n_s).astype(np.int32)),
    })

    for alg in ("smj", "phj"):
        for pattern in ("gfur", "gftr"):
            T, count = join(R, S, key="k", algorithm=alg, pattern=pattern)
            print(f"{alg.upper()}-{'OM' if pattern == 'gftr' else 'UM'}: "
                  f"{int(count)} matches, first row k={int(T['k'][0])} "
                  f"price={float(T['price'][0]):.2f} qty={int(T['qty'][0])}")

    # grouped aggregation over the join result
    T, count = join(R, S, key="k", algorithm="phj", pattern="gftr")
    G, g_count = group_aggregate(
        Table({"k": T["k"], "rev": T["price"] * T["qty"].to(torch.float32)}),
        key="k", aggs={"rev": "sum"}, num_groups=16_384, strategy="partition_hash",
    )
    revenue = float(torch.where(G["k"] != KEY_SENTINEL, G["rev_sum"], 0).sum())
    print(f"group-by: {int(g_count)} groups, total revenue {revenue:.0f}")

    # the paper's decision tree (Fig. 18)
    stats = JoinStats(n_r=n_r, n_s=n_s, r_payload_cols=2, s_payload_cols=1,
                      match_ratio=1.0, zipf=0.0)
    alg, pattern, why = choose_algorithm(stats)
    print(f"planner picks: {alg.upper()}-{'OM' if pattern == 'gftr' else 'UM'} — {why}")


if __name__ == "__main__":
    main()
