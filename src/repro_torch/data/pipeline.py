"""On-device feature-join input pipeline (the paper's ML motivation, §1:
100%-match joins feeding model training on the accelerator).

A training example is assembled relationally, on the tables' device:

  fact table   F(sample_id, fk_user, fk_item, label)
  dim tables   U(user_id, user feature cols), I(item_id, item feature cols)

  batch = (F ⋈ U ⋈ I) with GFTR materialization      [repro_torch.core.join]
  aggregate features = GROUP BY over recent history  [repro_torch.core.groupby]

The joined feature columns are binned into token ids so the same LM train
step consumes them (examples/ml_pipeline_torch.py runs this end to end). On
the card, PHJ's partition plans, probes and GFTR gathers launch the
block_histograms, partition_ranks, hash_probe and clustered_gather kernels.
The tables are numpy's draws from the JAX package's seeds, so both packages
assemble the same batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import Table, group_aggregate, join_sequence


@dataclasses.dataclass(frozen=True)
class FeatureJoinConfig:
    n_users: int = 4096
    n_items: int = 8192
    user_features: int = 3
    item_features: int = 3
    algorithm: str = "phj"
    pattern: str = "gftr"
    vocab: int = 512  # token bins
    seed: int = 0


def make_dim_tables(cfg: FeatureJoinConfig, device="cuda"):
    rng = np.random.default_rng(cfg.seed)

    def col(a):
        return torch.from_numpy(a).to(device)

    U = {"uid": col(rng.permutation(cfg.n_users).astype(np.int32))}
    for j in range(cfg.user_features):
        U[f"uf{j}"] = col(rng.normal(size=cfg.n_users).astype(np.float32))
    I = {"iid": col(rng.permutation(cfg.n_items).astype(np.int32))}
    for j in range(cfg.item_features):
        I[f"if{j}"] = col(rng.normal(size=cfg.n_items).astype(np.float32))
    return Table(U), Table(I)


def make_fact_batch(cfg: FeatureJoinConfig, batch: int, seq: int, step: int, device="cuda"):
    rng = np.random.default_rng((cfg.seed, step))
    n = batch * seq
    return Table({
        "fk_user": torch.from_numpy(rng.integers(0, cfg.n_users, n).astype(np.int32)).to(device),
        "fk_item": torch.from_numpy(rng.integers(0, cfg.n_items, n).astype(np.int32)).to(device),
        "label": torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(device),
    })


def tokenize(feature: torch.Tensor, vocab: int) -> torch.Tensor:
    """Bin a float32 feature into token ids 1..vocab-1: clip to [-3, 3],
    shift, scale, truncate. Each step rounds in float32 as the JAX package's
    does; the division is by a tensor, since a division by a Python float
    runs as a multiplication by its reciprocal on the card."""
    six = torch.tensor(6.0, dtype=torch.float32, device=feature.device)
    return (torch.clamp(feature, -3.0, 3.0) + 3.0).div(six).mul(vocab - 2).to(torch.int32) + 1


def assemble_batch(cfg: FeatureJoinConfig, U: Table, I: Table, fact: Table,
                   batch: int, seq: int):
    """Join features on the tables' device and tokenize into an LM batch."""
    joined, count = join_sequence(
        fact, [U.rename({"uid": "k0"}), I.rename({"iid": "k1"})],
        fk_cols=["fk_user", "fk_item"], dim_keys=["k0", "k1"],
        algorithm=cfg.algorithm, pattern=cfg.pattern,
        restore_order=True, keep_ids=True,  # canonical sample order
    )
    # bin the first user/item feature into token ids (toy featurization)
    tokens = tokenize(joined["uf0"] + joined["if0"], cfg.vocab).reshape(batch, seq)
    tokens = torch.cat([tokens, tokens[:, :1]], dim=1)  # (b, s+1)
    return {"tokens": tokens}, joined, count


def history_aggregates(cfg: FeatureJoinConfig, fact: Table, num_groups: int = 1024,
                       strategy: str = "partition_hash"):
    """GROUP BY fk_user: per-user engagement stats (count + label mean) —
    the grouped-aggregation half of the paper's title, used as pipeline
    features. `num_groups` bounds the distinct users a fact batch may hold."""
    t = Table({"k": fact["fk_user"], "label": fact["label"].to(torch.float32)})
    return group_aggregate(t, key="k", aggs={"label": "mean"}, num_groups=num_groups,
                           strategy=strategy)
