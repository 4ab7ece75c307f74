"""The port's dense and MoE models end to end against the JAX package's, on
the CPU (tests/test_torch_models_families_decode.py holds the other
families): prefill logits, decode steps and KV caches of the six dense and MoE
archs (reduced configs, float32) on the JAX package's own weights, with the
tolerances of tests/test_torch_models.py (its helpers are shared)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ops as jops
from repro.models import model as JM
from repro_torch.configs import base as tbase
from repro_torch.models import model as TM
from test_torch_models import DECODERS, close, t, weights


@pytest.fixture(autouse=True)
def jax_partition_plan_on_its_xla_arm(monkeypatch):
    monkeypatch.setattr(jops, "partition_plan_impl", lambda: "xla")


# ---------------------------------------------------------------------------
def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_and_decode_equal_reference(arch):
    """Prefill logits and aux, then 8 decode steps (logits and the KV cache,
    batch 2): equal to the JAX package's on its own weights. The port's
    decode also matches its own forward within test_decode_matches_forward's
    5e-2 (MoE at capacity factor 8, so nothing is dropped)."""
    cfg_j = jbase.get_reduced_config(arch)
    cfg_t = tbase.get_reduced_config(arch)
    jp, tp = weights(arch)
    tok = _tokens(cfg_j, 2, 8)
    jl, ja = JM.forward(cfg_j, jp, {"tokens": jnp.asarray(tok)}, remat=False)
    tl, ta = TM.forward(cfg_t, tp, {"tokens": t(tok)})
    close(tl, jl, what="forward logits")
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-12)
    jc = JM.init_cache(cfg_j, jp, 2, 32, None, jnp.float32)
    tc = TM.init_cache(cfg_t, tp, 2, 32, None, torch.float32)
    assert jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                  JM.cache_shapes(cfg_j, 2, 32, jnp.float32)) == \
        jax.tree_util.tree_map(lambda s: (s.shape, str(s.dtype).replace("torch.", "")),
                               TM.cache_shapes(cfg_t, 2, 32, torch.float32),
                               is_leaf=lambda x: isinstance(x, TM.TensorSpec))
    assert repr(TM.cache_axes(cfg_t, 2, 32)) == repr(JM.cache_axes(cfg_j, 2, 32))
    for step in range(8):
        jlog, jc = JM.decode_step(cfg_j, jp, jc, jnp.asarray(tok[:, step]), jnp.int32(step))
        tlog, tc = TM.decode_step(cfg_t, tp, tc, t(tok[:, step]), step)
        close(tlog, jlog, what=f"decode logits step {step}")
    close(tc["kv"]["k"], jc["kv"]["k"], what="k cache")
    close(tc["kv"]["v"], jc["kv"]["v"], what="v cache")

    if cfg_t.moe is not None:
        cfg_t = cfg_t.replace(moe=dataclasses.replace(cfg_t.moe, capacity_factor=8.0))
    fwd, _ = TM.forward(cfg_t, tp, {"tokens": t(tok)})
    cache = TM.init_cache(cfg_t, tp, 2, 32, None, torch.float32)
    for step in range(8):
        logits, cache = TM.decode_step(cfg_t, tp, cache, t(tok[:, step]), step)
        assert float((logits - fwd[:, step]).abs().max()) < 5e-2, (arch, step)


def test_vector_pos_decode_and_untouched_cache():
    """decode_step with a constant (b,) pos vector equals a scalar pos, and
    never writes the cache it is given."""
    cfg = tbase.get_reduced_config("granite-8b")
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    tok = t(_tokens(cfg, 2, 4))
    c1 = TM.init_cache(cfg, p, 2, 16, None, torch.float32)
    c2 = jax.tree_util.tree_map(torch.clone, c1)
    for step in range(3):
        snap = jax.tree_util.tree_map(torch.clone, c1)
        l1, n1 = TM.decode_step(cfg, p, c1, tok[:, step], step)
        l2, c2 = TM.decode_step(cfg, p, c2, tok[:, step],
                                torch.full((2,), step, dtype=torch.int32))
        assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(snap),
                                                     jax.tree_util.tree_leaves(c1)))
        assert float((l1 - l2).abs().max()) < 1e-6
        c1 = n1


def test_sliding_window_decode_past_the_window_equals_reference():
    """h2o-danube reduced (window 16): 20 decode steps at per-sequence
    positions wrap the model's ring buffers."""
    arch = "h2o-danube-3-4b"
    cfg_j, cfg_t = jbase.get_reduced_config(arch), tbase.get_reduced_config(arch)
    jp, tp = weights(arch)
    tok = _tokens(cfg_j, 2, 20, seed=1)
    jc = JM.init_cache(cfg_j, jp, 2, 64, None, jnp.float32)
    tc = TM.init_cache(cfg_t, tp, 2, 64, None, torch.float32)
    assert tc["kv"]["k"].shape[2] == 16
    for step in range(20):
        pos = np.array([step, max(step - 3, 0)], np.int32)
        jlog, jc = JM.decode_step(cfg_j, jp, jc, jnp.asarray(tok[:, step]), jnp.asarray(pos))
        tlog, tc = TM.decode_step(cfg_t, tp, tc, t(tok[:, step]), t(pos))
        close(tlog, jlog, what=f"step {step}")
    close(tc["kv"]["k"], jc["kv"]["k"])
