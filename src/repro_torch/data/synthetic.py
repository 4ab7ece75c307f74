"""Deterministic synthetic LM data: resumable by construction.

Batches are a pure function of (seed, step), so crash-resume replays the
exact stream with no iterator state to checkpoint. The token process is a
mixture of Zipf-ish unigrams and short copy motifs so small models have
learnable structure (loss drops measurably within tens of steps). The numpy
stream is the JAX package's, draw for draw, so both packages train on the
same tokens."""
from __future__ import annotations

import numpy as np
import torch


def make_batch_fn(vocab: int, batch: int, seq: int, *, seed: int = 0, cfg=None,
                  device="cuda"):
    """Returns data_iter(step) -> batch dict of tensors on `device` for the
    given arch config."""

    def data_iter(step: int):
        rng = np.random.default_rng((seed, step))
        # zipf-ish unigram base
        ranks = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
        toks = (ranks - 1) % max(vocab - 2, 1) + 1
        # copy motif: repeat a short window to create learnable bigrams
        motif = rng.integers(1, vocab, size=(batch, 8))
        pos = rng.integers(0, max(seq - 16, 1))
        toks[:, pos : pos + 8] = motif
        toks[:, pos + 8 : pos + 16] = motif
        out = {"tokens": torch.tensor(toks[:, : seq + 1].astype(np.int32), device=device)}
        if cfg is not None and cfg.family == "vlm":
            out["vision_emb"] = torch.tensor(
                (rng.normal(size=(batch, cfg.vision_tokens, cfg.d_model)) * 0.02)
                .astype(np.float32), device=device)
        if cfg is not None and cfg.family == "audio":
            out["enc_emb"] = torch.tensor(
                (rng.normal(size=(batch, cfg.encoder_len, cfg.d_model)) * 0.02)
                .astype(np.float32), device=device)
        return out

    return data_iter
