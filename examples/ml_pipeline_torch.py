"""Relational preprocessing on the card feeding LM training with the PyTorch
port — the paper's §1 motivating use case:

    PYTHONPATH=src python examples/ml_pipeline_torch.py --steps 200
    PYTHONPATH=src python examples/ml_pipeline_torch.py --steps 20 --device cpu

Per step: a fact table of (user, item, label) events is joined against two
feature dimension tables with the GFTR-optimized PHJ join (on the card its
partition plans, probes and gathers launch the block_histograms,
partition_ranks, hash_probe and clustered_gather kernels), per-user history
aggregates come from the partition-hash group-by, the joined features are
tokenized, and an xLSTM LM (the reduced xlstm-125m, its vocabulary the 512
token bins) takes one AdamW step on them. Runs on the card by default;
without one it exits 1 unless given --device cpu.
"""
import argparse
import sys
import time

import torch

from repro_torch.configs.base import get_reduced_config
from repro_torch.core.phases import phase
from repro_torch.data.pipeline import (FeatureJoinConfig, assemble_batch, history_aggregates,
                                       make_dim_tables, make_fact_batch)
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamW, cosine_schedule
from repro_torch.train.step import build_train_step


def build_pipeline_step(pcfg: FeatureJoinConfig, mcfg, U, I, opt: AdamW, batch: int,
                        seq: int):
    """step(params, opt_state, fact, times=None) -> (params, opt_state,
    metrics): the join, the group-by and one train step. `times`, when
    given, receives each part's wall seconds ("join", "group_by", "train"),
    with a device synchronisation at each edge. metrics holds the train
    step's (0-d tensors) and the batch's "tokens" and "users" (the distinct
    users of the fact batch, which has batch * seq rows: the group-by's
    capacity)."""
    train_step, _, _ = build_train_step(mcfg, None, None, opt)

    def step(params, opt_state, fact, times=None):
        dev = fact.device
        with phase(times, "join", dev):
            lm_batch, _joined, _count = assemble_batch(pcfg, U, I, fact, batch, seq)
        with phase(times, "group_by", dev):
            _G, users = history_aggregates(pcfg, fact, num_groups=batch * seq)
        with phase(times, "train", dev):
            params, opt_state, metrics = train_step(params, opt_state, lm_batch)
        return params, opt_state, dict(metrics, tokens=lm_batch["tokens"], users=users)

    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--pattern", default="gftr", choices=["gftr", "gfur"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        raise SystemExit(1)
    pcfg = FeatureJoinConfig(algorithm="phj", pattern=args.pattern, vocab=512)
    mcfg = get_reduced_config("xlstm-125m").replace(vocab_size=pcfg.vocab)
    U, I = make_dim_tables(pcfg, device)
    params = M.init_params(mcfg, torch.Generator(device).manual_seed(0), torch.float32, device)
    opt = AdamW(lr=cosine_schedule(3e-3, 10, args.steps), master_weights=False)
    opt_state = opt.init(params)
    step = build_pipeline_step(pcfg, mcfg, U, I, opt, args.batch, args.seq)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        fact = make_fact_batch(pcfg, args.batch, args.seq, i, device)
        params, opt_state, metrics = step(params, opt_state, fact)
        losses.append(float(metrics["loss"]))
        if i % 25 == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f}")

    print(f"\njoin({args.pattern})+train: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({args.steps} steps, {time.time() - t0:.1f}s)")
    print(f"per-user history aggregates: {int(metrics['users'])} users")
    if losses[-1] >= losses[0]:
        raise SystemExit("pipeline training must reduce loss")
    return losses


if __name__ == "__main__":
    main()
