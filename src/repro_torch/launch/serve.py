"""Serving launcher: --arch <id>, batched requests through the continuous-
batching engine (reduced configs by default; --full for the published
widths and depth).

    python -m repro_torch.launch.serve --arch olmo-1b [--requests 8]
        [--max-tokens 16] [--max-batch 4] [--full] [--seed 0] [--device cuda]

The parameters are float32, drawn from `torch.Generator(device)` seeded
with --seed. The vision and audio families get stub embeddings (patches or
audio frames) drawn from numpy's seed --seed before the prompts, as the JAX
package's launcher draws them, so that both launchers serve the same
prompts. --device defaults to the card; without one the launcher exits 1
unless given --device cpu.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..configs.base import get_config, get_reduced_config, list_archs
from ..models import model as M
from ..serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        raise SystemExit(1)
    cfg = get_config(args.arch) if args.full else get_reduced_config(args.arch)
    params = M.init_params(cfg, torch.Generator(device).manual_seed(args.seed),
                           torch.float32, device)
    rng = np.random.default_rng(args.seed)
    stub = {}
    if cfg.family == "vlm":
        stub["vision_emb"] = torch.tensor(
            rng.normal(size=(args.max_batch, cfg.vision_tokens, cfg.d_model)) * 0.02,
            dtype=torch.float32, device=device)
    if cfg.family == "audio":
        stub["enc_emb"] = torch.tensor(
            rng.normal(size=(args.max_batch, cfg.encoder_len, cfg.d_model)) * 0.02,
            dtype=torch.float32, device=device)
    eng = ServeEngine(cfg, params, max_batch=args.max_batch, max_len=128, batch_stub=stub)
    for r in range(args.requests):
        prompt = rng.integers(3, cfg.vocab_size, size=rng.integers(2, 8)).tolist()
        eng.submit(Request(rid=r, prompt=prompt, max_tokens=args.max_tokens))
    ticks = eng.run()
    print(f"[serve] {args.arch}: {args.requests} requests in {ticks} ticks "
          f"(continuous batching over {args.max_batch} slots)")
    return ticks


if __name__ == "__main__":
    main()
