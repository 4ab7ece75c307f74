"""The check's control: the plain reference put in the program's place and
accumulated one precision below what the configuration states (int32 sums
for its int64 ones; a query whose configuration states another precision
names the one below it as its `NARROW`, bfloat16 for float32). The check
has to find its answers wrong.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Each seed is one run of the cell through the benchmark's own loop and
check, in one process, on the card; the benchmark's runs never run it.
Prints one JSON line per seed: the seed, `correct` and the numbers
compared.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


class ControlEntry:
    """Answers each query with the reference's top rows, summed in `acc`,
    and its group output with all of the reference's groups."""

    def __init__(self, query, tables: dict, acc: torch.dtype):
        self.query, self.tables, self.acc = query, tables, acc
        self.queue: list = []

    def submit(self, q) -> None:
        self.queue.append(q)

    def poll(self) -> list:
        from bench import refops

        q = self.queue.pop(0)
        ref = self.query.reference(self.tables, self.acc)
        top = refops.top_rows(ref, self.query.ORDER, self.query.LIMIT)
        q.answer = {c: v.cpu().numpy() for c, v in top.items()}
        q.done = time.perf_counter()
        return [q]

    def plan(self):
        return None, None, None

    def groups(self, late_s: float) -> dict:
        """Every group of the reference, summed in `acc`."""
        ref = self.query.reference(self.tables, self.acc)
        return {c: v.cpu().numpy() for c, v in ref.items()}


def narrow(query) -> torch.dtype:
    """The control's accumulator for `query`: its `NARROW`, else int32."""
    return getattr(query, "NARROW", torch.int32)


def control_entry():
    def make(parts, tables, device):
        return ControlEntry(parts["query"], tables, narrow(parts["query"]))
    return make


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness, registry

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    parts = registry.cell_parts(registry.load_spec(), args.workload)
    for seed in args.seeds:
        out = harness.run_cell(parts, seed, args.seconds, False, "cuda",
                               t_start=time.perf_counter(), make_entry=control_entry())
        print(json.dumps({"seed": seed, "correct": out["result"]["correct"],
                          "attempted": out["result"]["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
