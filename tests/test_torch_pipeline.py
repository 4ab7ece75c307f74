"""The port's feature-join pipeline (`repro_torch.data.pipeline`) and its
example (`examples/ml_pipeline_torch.py`), on the CPU.

Every feature-join assertion of tests/test_data_and_serve.py holds on the
port. Against the JAX package, on the same seeds: the same tokens exactly,
the same joined columns (row for row) and count, and the same history
aggregates (group keys and count exactly, label means within rtol 1e-5).
The example trains the reduced xlstm-125m on the joined tokens with a
falling loss, and exits 1 without a card unless given --device cpu.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro_torch.core import KEY_SENTINEL
from repro_torch.data.pipeline import (FeatureJoinConfig, assemble_batch, history_aggregates,
                                       make_dim_tables, make_fact_batch, tokenize)

EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / "ml_pipeline_torch.py"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_of(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# tests/test_data_and_serve.py's feature-join assertions, on the port
# ---------------------------------------------------------------------------
def test_feature_join_pipeline_correct():
    cfg = FeatureJoinConfig(n_users=256, n_items=512)
    U, I = make_dim_tables(cfg, device="cpu")
    fact = make_fact_batch(cfg, 2, 32, step=0, device="cpu")
    batch, joined, count = assemble_batch(cfg, U, I, fact, 2, 32)
    assert int(count) == 64
    assert batch["tokens"].shape == (2, 33) and batch["tokens"].dtype == torch.int32
    # verify joined features against a numpy join
    umap = {int(k): float(v) for k, v in zip(np_of(U["uid"]), np_of(U["uf0"]))}
    fk = np_of(fact["fk_user"])
    got = np_of(joined["uf0"])
    fid = np_of(joined["_fact_id"])
    assert (fid == np.arange(64)).all()  # restore_order: canonical sample order
    for i in range(64):
        assert abs(got[i] - umap[int(fk[fid[i]])]) < 1e-6
    toks = np_of(batch["tokens"])
    assert toks.min() >= 1 and toks.max() <= cfg.vocab - 1
    np.testing.assert_array_equal(toks[:, -1], toks[:, 0])


def test_feature_join_patterns_agree():
    cfg_a = FeatureJoinConfig(algorithm="phj", pattern="gftr")
    cfg_b = FeatureJoinConfig(algorithm="smj", pattern="gfur")
    U, I = make_dim_tables(cfg_a, device="cpu")
    fact = make_fact_batch(cfg_a, 2, 16, step=3, device="cpu")
    ba, ja, _ = assemble_batch(cfg_a, U, I, fact, 2, 16)
    bb, jb, _ = assemble_batch(cfg_b, U, I, fact, 2, 16)
    assert torch.equal(ba["tokens"], bb["tokens"])


def test_history_aggregates():
    cfg = FeatureJoinConfig(n_users=64)
    fact = make_fact_batch(cfg, 4, 64, step=0, device="cpu")
    G, count = history_aggregates(cfg, fact, num_groups=256)
    labels = np_of(fact["label"]).astype(np.float64)
    users = np_of(fact["fk_user"])
    ks = np_of(G["k"])
    means = np_of(G["label_mean"])
    assert int(count) == len(np.unique(users))
    for i, k in enumerate(ks):
        if k == KEY_SENTINEL:
            continue
        ref = labels[users == int(k)].mean()
        assert abs(means[i] - ref) < 1e-5


def test_tokenize_rounds_in_float32_as_numpy_does():
    """Each step of the binning rounds in float32: numpy's float32 ops give
    the same ids, edges and clipped values included."""
    rng = np.random.default_rng(0)
    f = np.concatenate([rng.normal(size=4096) * 2,
                        np.array([-3, 3, -2.9999998, 0, 1 / 3, 7, -7])]).astype(np.float32)
    for vocab in (512, 50_304):
        ref = ((np.clip(f, np.float32(-3), np.float32(3)) + np.float32(3)) / np.float32(6)
               * np.float32(vocab - 2)).astype(np.int32) + 1
        np.testing.assert_array_equal(tokenize(torch.from_numpy(f), vocab).numpy(), ref)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alg,pattern", [("phj", "gftr"), ("phj", "gfur"), ("smj", "gftr")])
def test_pipeline_equals_reference(alg, pattern):
    jcfg = JP.FeatureJoinConfig(n_users=1024, n_items=2048, algorithm=alg, pattern=pattern,
                                vocab=1000, seed=3)
    tcfg = FeatureJoinConfig(**dataclasses.asdict(jcfg))
    U, I = JP.make_dim_tables(jcfg)
    Ut, It = make_dim_tables(tcfg, device="cpu")
    for name, a, b in (("U", U, Ut), ("I", I, It)):
        assert a.column_names == b.column_names, name
        for c in a.column_names:
            np.testing.assert_array_equal(np_of(b[c]), np_of(a[c]), err_msg=f"{name}.{c}")
    for step in range(2):
        f = JP.make_fact_batch(jcfg, 4, 32, step)
        ft = make_fact_batch(tcfg, 4, 32, step, device="cpu")
        jb, jj, jc = JP.assemble_batch(jcfg, U, I, f, 4, 32)
        tb, tj, tc = assemble_batch(tcfg, Ut, It, ft, 4, 32)
        np.testing.assert_array_equal(np_of(tb["tokens"]), np_of(jb["tokens"]))
        assert int(tc) == int(jc) == 128
        assert tj.column_names == jj.column_names
        for c in jj.column_names:
            np.testing.assert_array_equal(np_of(tj[c]), np_of(jj[c]), err_msg=c)
        G, gc = JP.history_aggregates(jcfg, f, num_groups=128)
        Gt, gct = history_aggregates(tcfg, ft, num_groups=128)
        assert int(gct) == int(gc)
        n = int(gc)
        np.testing.assert_array_equal(np_of(Gt["k"])[:n], np_of(G["k"])[:n])
        np.testing.assert_allclose(np_of(Gt["label_mean"])[:n], np_of(G["label_mean"])[:n],
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------
def _example():
    spec = importlib.util.spec_from_file_location("ml_pipeline_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_trains_on_the_cpu(capsys):
    losses = _example().main(["--steps", "12", "--batch", "2", "--seq", "16",
                              "--device", "cpu"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "join(gftr)+train" in out and "users" in out


def test_example_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _example().main(["--steps", "1"])
    assert e.value.code == 1
    assert "--device cpu" in capsys.readouterr().err


def test_pipeline_step_times_its_parts_and_feeds_the_batch():
    """The example's step: the join's tokens are the batch it trains on,
    the group-by counts the fact batch's users, and `times` gets each part."""
    mod = _example()
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import AdamW

    pcfg = FeatureJoinConfig(n_users=300, n_items=500)
    mcfg = get_reduced_config("xlstm-125m").replace(vocab_size=pcfg.vocab)
    U, I = make_dim_tables(pcfg, device="cpu")
    params = M.init_params(mcfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    opt = AdamW(lr=1e-3)
    step = mod.build_pipeline_step(pcfg, mcfg, U, I, opt, 2, 8)
    fact = make_fact_batch(pcfg, 2, 8, 0, device="cpu")
    times = {}
    _, _, metrics = step(params, opt.init(params), fact, times)
    assert sorted(times) == ["group_by", "join", "train"]
    want, _, _ = assemble_batch(pcfg, U, I, fact, 2, 8)
    assert torch.equal(metrics["tokens"], want["tokens"])
    assert int(metrics["users"]) == len(np.unique(np_of(fact["fk_user"])))
    assert np.isfinite(float(metrics["loss"]))
