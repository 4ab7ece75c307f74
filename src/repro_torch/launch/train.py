"""Training launcher: --arch <id> --steps N, through the fault-tolerant loop.

    python -m repro_torch.launch.train --arch olmo-1b --steps 100
        [--batch 8] [--seq 64] [--lr 3e-3] [--full] [--ckpt-dir DIR]
        [--ckpt-every 50] [--seed 0] [--device cuda]

Reduced configs by default (--full for the published widths and depth).
Wires together the config registry, the one-card train step (float32
parameters and AdamW moments, each layer recomputed in the backward), the
deterministic data stream, and the loop with checkpoint/resume and
straggler logging. The parameters are drawn from `torch.Generator(device)`
seeded with --seed; the vision and audio families' batches carry stub
patch or frame embeddings. --device defaults to the card; without one the
launcher exits 1 unless given --device cpu.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..configs.base import get_config, get_reduced_config, list_archs
from ..data.synthetic import make_batch_fn
from ..models import model as M
from ..train.loop import LoopConfig, train_loop
from ..train.optimizer import AdamW, cosine_schedule
from ..train.step import build_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true", help="published widths and depth")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
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
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=10, total=args.steps),
                master_weights=False)
    opt_state = opt.init(params)
    step, _, _ = build_train_step(cfg, None, None, opt)
    data_iter = make_batch_fn(cfg.vocab_size, args.batch, args.seq,
                              seed=args.seed, cfg=cfg, device=device)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every)
    params, opt_state, report = train_loop(step, params, opt_state, data_iter, loop_cfg)
    print(f"[train] {args.arch}: {report.steps_run} steps, "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}")
    return report


if __name__ == "__main__":
    main()
