#!/usr/bin/env python3
"""Times the launch path of the port's routing kernels on one NVIDIA GPU with
this checkout's libraries and with another commit's, in one process:
`block_histograms` and `partition_ranks` at the MoE routing shape of
`chip_smoke.py` (u) (32 digits, 60 experts: one pass of 64 bins), where a
call costs its host path (the Python wrapper, the C entry's launch
configuration, the launch), not its work.

    python3 scripts/launch_ab.py PARENT_SRC [--calls 2000] [--single 200] [--rounds 12]

PARENT_SRC is the `src` directory of another commit unpacked with
`git archive`. Its `block_histograms.cu` and `partition_ranks.cu` are built
with this checkout's nvcc flags into `build/launch_ab/` and loaded beside
this checkout's libraries with the same argument types; the Python wrapper
(`kernels/radix_partition.py`) is this checkout's for both, so the two sides
differ in their C entry points alone. Each round times both sides, in the
order parent, change, change, parent (change first on odd rounds), each
after a warm-up of 50 calls: `calls` back-to-back calls by CUDA events and
by the host clock (microseconds a call), and `single` calls one at a time
between two events, as `chip_smoke.py`'s `cuda_ms` times a row (their
median, in ms). A first round is run and dropped. Prints the card's name
and power limit, then one JSON line per kernel with each side's median and
min over the rounds and the per-round ratio change / parent (min, median,
max) of each measure. Exits non-zero without a CUDA device.
"""
import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
NAMES = ("block_histograms", "partition_ranks")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent_src")
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--single", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=12)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card", file=sys.stderr)
        raise SystemExit(1)
    from repro_torch.kernels import _build
    from repro_torch.kernels import radix_partition as krp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)

    # both sides' libraries: this checkout's through _build, the parent's
    # built here with the same flags
    _build.build_all(NAMES)
    out = ROOT / "build" / "launch_ab"
    out.mkdir(parents=True, exist_ok=True)
    csrc = Path(args.parent_src).resolve() / "repro_torch" / "csrc"
    jobs = {n: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{n}.so"),
                                 str(csrc / f"{n}.cu")]) for n in NAMES}
    for n, proc in jobs.items():
        if proc.wait():
            print(f"nvcc failed for the parent's {n}.cu", file=sys.stderr)
            raise SystemExit(1)
    libs = {"change": {n: _build.load(n) for n in NAMES}, "parent": {}}
    for n in NAMES:
        libs["parent"][n] = _build.bind(ctypes.CDLL(str(out / f"{n}.so")), n)

    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.integers(0, 60, 32).astype(np.int32)).cuda()
    base = krp.tile_base(krp.block_histograms(d, 64))[0]
    fns = {"block_histograms": lambda: krp.block_histograms(d, 64),
           "partition_ranks": lambda: krp.rank_with_base(d, base, 64)}
    want = {n: fn() for n, fn in fns.items()}

    def measure(fn):
        for _ in range(50):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(args.calls):
            fn()
        end.record()
        end.synchronize()
        host = (time.perf_counter() - t0) / args.calls * 1e6
        events = start.elapsed_time(end) / args.calls * 1e3
        single = []
        for _ in range(args.single):
            start.record()
            fn()
            end.record()
            end.synchronize()
            single.append(start.elapsed_time(end))
        return {"us_per_call_events": events, "us_per_call_host": host,
                "single_call_ms": float(np.median(single))}

    for name, fn in fns.items():
        t = {side: [] for side in libs}
        for i in range(args.rounds + 1):
            order = ("parent", "change", "change", "parent")
            for side in order if i % 2 == 0 else order[::-1]:
                _build._libs[name] = libs[side][name]
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, want[name]):
                    print(f"{name}: the {side}'s library gives another result", file=sys.stderr)
                    raise SystemExit(1)
                m = measure(fn)
                if i:  # the first round warms both sides up and is dropped
                    t[side].append(m)
        _build._libs[name] = libs["change"][name]
        result = {"kernel": name, "calls": args.calls, "single": args.single,
                  "rounds": args.rounds}
        for key in ("us_per_call_events", "us_per_call_host", "single_call_ms"):
            a = {side: np.array([m[key] for m in t[side]]) for side in t}
            # two readings a side a round: a round's ratio is of their means
            ratio = a["change"].reshape(-1, 2).mean(1) / a["parent"].reshape(-1, 2).mean(1)
            result[key] = {**{f"{side}_{s}": float(f(a[side])) for side in a
                              for s, f in (("median", np.median), ("min", np.min))},
                           "ratio_min": float(ratio.min()), "ratio_median": float(np.median(ratio)),
                           "ratio_max": float(ratio.max())}
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
