"""`python -m repro_torch.serve --chaos` — chaos/soak gate for the query
server: the port's counterpart of `python -m repro.serve --chaos`.

Drives the mixed-query soak (serve/chaos.py) under every fault family the
port has (overflow, raise, estimates), writes the scoreboard JSON (p50/p99
latency + throughput baseline, per-family blast-radius reports,
degradation counters), and exits non-zero if any delivered result
diverged from its fault-free oracle or any blast-radius / counter
assertion failed.

Usage: python -m repro_torch.serve --chaos [--smoke] [--out PATH] [--device cuda|cpu]
  --smoke   CI scale (<= 48 queries per family instead of 200)
  --out     output path (default BENCH_serve_torch.json)
  --device  where the tables live (default: the card). Without a card the
            command exits 1 unless --device cpu is given; it never falls
            back to the CPU by itself.
"""
from __future__ import annotations

import json
import sys


def main(argv: list[str]) -> int:
    if "--chaos" not in argv:
        print(__doc__)
        return 0 if argv in ([], ["--help"]) else 2
    out = argv[argv.index("--out") + 1] if "--out" in argv else "BENCH_serve_torch.json"
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        return 1
    from .chaos import run_chaos

    report = run_chaos(smoke="--smoke" in argv, device=device)
    with open(out, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(json.dumps({"ok": report["ok"], "failures": report["failures"],
                      "baseline": {k: report["baseline"][k] for k in
                                   ("p50_s", "p99_s", "throughput_qps")},
                      "wrote": out}, indent=2, sort_keys=True))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
