#!/usr/bin/env python3
"""Times the LM decode server's step on the port found under each given
source directory, on one NVIDIA GPU: the workload of `chip_smoke.py` (u)
(qwen2-moe-a2.7b at its published widths and depth in bf16, random weights
from seed 0, 16 requests of 2 to 8 prompt tokens and 16 new tokens each
over 8 slots and a 128-token cache).

    python3 scripts/lm_decode_ab.py SRC [--runs 2]

SRC is a directory that holds `repro_torch` (`src` of this checkout, or of
another commit unpacked with `git archive`). Run it once per tree, in
turns (parent, change, change, parent), to compare two commits on one
card: host times of an eager decode step vary by tens of percent from one
process to the next. Prints the card's name and power limit, then one JSON
line: per run, the step median and p90 in ms over the steady ticks (all but
the first two) and the number of steps. Exits non-zero without a CUDA
device.
"""
import argparse
import json
import subprocess
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card", file=sys.stderr)
        raise SystemExit(1)
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import Request, ServeEngine

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    cfg = get_config("qwen2-moe-a2.7b")
    params = LM.init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=rng.integers(2, 9)).tolist()
               for _ in range(16)]
    runs = []
    for _ in range(args.runs):
        eng = ServeEngine(cfg, params, max_batch=8, max_len=128, dtype=torch.bfloat16)
        real_step, ms = eng._step, []

        def step_fn(p, c, tok, pos, real_step=real_step, ms=ms):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_step(p, c, tok, pos)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            return out

        eng._step = step_fn
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=list(pr), max_tokens=16))
        eng.run()
        runs.append({"step_ms_median": float(np.median(ms[2:])),
                     "step_ms_p90": float(np.percentile(ms[2:], 90)), "steps": len(ms)})
    print(json.dumps({"src": args.src, "runs": runs}))


if __name__ == "__main__":
    main()
