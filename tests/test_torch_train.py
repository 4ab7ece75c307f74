"""The port's training substrate against the JAX package's, on the CPU:
`model.loss_fn` and its gradients, `data.synthetic`, `models.flops`,
`train.optimizer`, `train.checkpoint`, `train.loop` and the launcher.

The same seeded numpy inputs and the JAX package's own weights (carried
across with `params_from_numpy`) go through both packages; the JAX
package's MoE plans take its 'xla' partition arm. Tolerances (float32,
reduced configs): loss, ce and aux within 1e-5 relative; every gradient
leaf within 1e-4 of its leaf's max |g| (against `jax.grad`); optimizer
states within 1e-6 of their largest magnitude.
"""
from __future__ import annotations

import dataclasses
import json
import runpy
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import synthetic as jdata
from repro.kernels import ops as jops
from repro.models import flops as jflops
from repro.models import model as JM
from repro.train import checkpoint as JCKPT
from repro.train import optimizer as JOPT
from repro_torch.configs import base as tbase
from repro_torch.data import synthetic as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.models import flops as tflops
from repro_torch.models import model as TM
from repro_torch.models.params import leaves, map_leaves, params_from_numpy
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import (AdamW, AdamWState, cosine_schedule, global_norm,
                                         linear_warmup, state_from_numpy)

ARCHS = jbase.list_archs()
DECODERS = [a for a in ARCHS if jbase.get_config(a).family in ("dense", "moe")]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def jax_partition_plan_on_its_xla_arm(monkeypatch):
    monkeypatch.setattr(jops, "partition_plan_impl", lambda: "xla")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The reduced models' eager steps are many small ops: one thread runs
    them fastest, and keeps them fast when the suite's workers share the
    cores (eight threads a worker slowed a 30-step launcher run ~100x)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def tensors(tree):
    return leaves(tree, torch.is_tensor)


def grads_of(cfg, params, batch, remat=True):
    """(loss, metrics, grads as a list in leaf order) of the port's loss_fn."""
    ps = [p.detach().requires_grad_() for p in tensors(params)]
    it = iter(ps)
    tree = map_leaves(lambda _: next(it), params, is_leaf=torch.is_tensor)
    loss, metrics = TM.loss_fn(cfg, tree, batch, remat=remat)
    return loss.detach(), metrics, torch.autograd.grad(loss, ps)


def assert_grads_close(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float64)
        err = np.abs(g.detach().numpy().astype(np.float64) - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-30), (i, err, np.abs(w).max())


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DECODERS)
def test_loss_and_grads_equal_reference(arch, rng):
    cj, ct = jbase.get_reduced_config(arch), tbase.get_reduced_config(arch)
    jp = JM.init_params(cj, jax.random.PRNGKey(0))
    toks = rng.integers(0, cj.vocab_size, (2, 17)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(cj, p, {"tokens": jnp.asarray(toks)}), has_aux=True)(jp)
    tl, tm, tg = grads_of(ct, carried(jp), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["aux"].detach()), float(jm["aux"]), rtol=LOSS_RTOL)
    if cj.moe is not None:
        assert float(jm["aux"]) > 0
    assert_grads_close(tg, jax.tree_util.tree_leaves(jg))


# ---------------------------------------------------------------------------
# data and FLOPs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmo-1b", "llama-3.2-vision-11b", "whisper-large-v3"])
def test_batches_equal_reference(arch):
    cfg = jbase.get_reduced_config(arch)
    jb = jdata.make_batch_fn(cfg.vocab_size, 3, 40, seed=5, cfg=cfg)
    tb = tdata.make_batch_fn(cfg.vocab_size, 3, 40, seed=5, cfg=tbase.get_reduced_config(arch),
                             device="cpu")
    for step in (0, 1, 17):
        j, t = jb(step), tb(step)
        assert sorted(j) == sorted(t)
        assert t["tokens"].dtype == torch.int32
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_equal_reference(arch):
    for get in ("get_config", "get_reduced_config"):
        cj, ct = getattr(jbase, get)(arch), getattr(tbase, get)(arch)
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            for mesh in ({}, {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}):
                j = jflops.estimate(cj, jbase.SHAPES[name], mesh)
                t = tflops.estimate(ct, tbase.SHAPES[name], mesh)
                assert dataclasses.asdict(t) == dataclasses.asdict(j)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_adamw_minimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = opt.init(params)
    for _ in range(300):
        g = {"w": 2 * params["w"]}
        params, state, _ = opt.update(g, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_clipping_and_gnorm():
    opt = AdamW(lr=0.0, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    _, _, gnorm = opt.update({"w": torch.tensor([3.0, 4.0, 0.0])}, state, params)
    assert abs(float(gnorm) - 5.0) < 1e-5


def test_adamw_master_weights_bf16():
    """bf16 params + f32 master track the f32-only trajectory closely."""
    opt32 = AdamW(lr=0.05, weight_decay=0.0, clip_norm=None, master_weights=False)
    optbf = AdamW(lr=0.05, weight_decay=0.0, clip_norm=None, master_weights=True)
    p32 = {"w": torch.full((4,), 2.0, dtype=torch.float32)}
    pbf = {"w": torch.full((4,), 2.0, dtype=torch.bfloat16)}
    s32, sbf = opt32.init(p32), optbf.init(pbf)
    for _ in range(100):
        p32, s32, _ = opt32.update({"w": 2 * p32["w"]}, s32, p32)
        pbf, sbf, _ = optbf.update({"w": 2 * pbf["w"].float()}, sbf, pbf)
    assert pbf["w"].dtype == torch.bfloat16
    assert float((sbf.master["w"] - p32["w"]).abs().max()) < 5e-2


def test_cosine_schedule():
    f = cosine_schedule(1.0, warmup=10, total=100, floor=0.1)
    assert float(f(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(f(torch.tensor(10, dtype=torch.int32))) - 1.0) < 1e-6
    assert abs(float(f(torch.tensor(100, dtype=torch.int32))) - 0.1) < 1e-6


def test_schedules_equal_reference():
    for jf, tf in ((JOPT.cosine_schedule(3e-4, 7, 40), cosine_schedule(3e-4, 7, 40)),
                   (JOPT.linear_warmup(2e-3, 9), linear_warmup(2e-3, 9))):
        for s in range(0, 45, 3):
            np.testing.assert_allclose(float(tf(torch.tensor(s, dtype=torch.int32))),
                                       float(jf(jnp.int32(s))), rtol=1e-6)


@pytest.mark.parametrize("master", [False, True])
def test_adamw_updates_equal_reference(master, rng):
    """Five updates of a two-leaf tree (one leaf bf16 under master weights),
    clipped, from the JAX package's state carried across after the first."""
    kw = dict(lr=JOPT.cosine_schedule(1e-2, 2, 5), clip_norm=0.5, master_weights=master)
    jopt = JOPT.AdamW(**kw)
    topt = AdamW(**{**kw, "lr": cosine_schedule(1e-2, 2, 5)})
    dt = jnp.bfloat16 if master else jnp.float32
    jp = {"a": jnp.asarray(rng.normal(size=(5, 3)), jnp.float32),
          "b": {"c": jnp.asarray(rng.normal(size=7), dt)}}
    grads = [{"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=7).astype(np.float32)}} for _ in range(5)]
    js = jopt.init(jp)
    jp, js, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads[0]), js, jp)
    tp = carried(jp)
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    assert (ts.master is None) == (not master) and int(ts.step) == 1
    cast = {"a": jnp.float32, "b": {"c": dt}}
    for g in grads[1:]:
        jg = jax.tree_util.tree_map(lambda x, d: jnp.asarray(x).astype(d), g, cast)
        jp, js, jn = jopt.update(jg, js, jp)
        tp, ts, tn = topt.update(carried(jg), ts, tp)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    for t, j in zip(tensors((tp, ts)), jax.tree_util.tree_leaves((jp, js))):
        j = np.asarray(j)
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        j = j.astype(np.float64)
        err = np.abs(t.double().numpy() - j).max()
        # float32 leaves to 1e-6 of their magnitude; a bf16 leaf to one
        # bf16 rounding of it
        rel = 2.0 ** -8 if t.dtype == torch.bfloat16 else 1e-6
        assert err <= rel * max(np.abs(j).max(), 1.0), (err, np.abs(j).max())


def test_adamw_update_writes_in_place():
    opt = AdamW(lr=0.1, master_weights=True)
    params = {"w": torch.ones(3, dtype=torch.bfloat16)}
    state = opt.init(params)
    ids = [id(t) for t in tensors((params, state))]
    ptrs = [t.data_ptr() for t in tensors((params, state))]
    p2, s2, _ = opt.update({"w": torch.ones(3)}, state, params)
    assert [id(t) for t in tensors((p2, s2))] == ids
    assert [t.data_ptr() for t in tensors((params, state))] == ptrs
    assert int(state.step) == 1 and float(params["w"][0]) < 1.0


def test_global_norm_equals_reference(rng):
    tree = {"a": rng.normal(size=(4, 5)).astype(np.float32), "b": rng.normal(size=3)
            .astype(np.float32)}
    np.testing.assert_allclose(float(global_norm(params_from_numpy(tree, device="cpu"))),
                               float(JOPT.global_norm(tree)), rtol=1e-6)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    state = ({"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3), dtype=torch.int32)}},
             torch.tensor(7, dtype=torch.int32))
    CKPT.save_checkpoint(tmp_path, 12, state, extra={"note": "x"})
    like = map_leaves(torch.zeros_like, state, is_leaf=torch.is_tensor)
    restored, step, extra = CKPT.restore_checkpoint(tmp_path, like)
    assert step == 12 and extra == {"note": "x"}
    for a, b in zip(tensors(state), tensors(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_gc_and_latest(tmp_path):
    state = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4, 5):
        CKPT.save_checkpoint(tmp_path, s, state, keep=2)
    assert CKPT.latest_step(tmp_path) == 5
    kept = sorted(d.name for d in tmp_path.iterdir() if d.name.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]


def test_checkpoint_survives_stale_pointer(tmp_path):
    state = {"w": torch.zeros(3)}
    CKPT.save_checkpoint(tmp_path, 3, state)
    # simulate a crash that wrote LATEST but not the directory
    (tmp_path / "LATEST").write_text("step_00000099")
    assert CKPT.latest_step(tmp_path) == 3


def test_async_checkpointer(tmp_path):
    ck = CKPT.AsyncCheckpointer(tmp_path, keep=2)
    state = {"w": torch.arange(10.0)}
    for s in (1, 2, 3):
        ck.save(s, map_leaves(lambda x: x + s, state, is_leaf=torch.is_tensor))
    ck.wait()
    restored, step, _ = CKPT.restore_checkpoint(tmp_path, state)
    assert step == 3
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(10.0) + 3)


@pytest.mark.parametrize("master", [False, True])
def test_checkpoints_cross_between_packages(tmp_path, master):
    """A (params, AdamW state) checkpoint written by each package restores
    in the other: the same files, leaf paths and values."""
    cfg = jbase.get_reduced_config("qwen2-moe-a2.7b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(3))
    jopt = JOPT.AdamW(master_weights=master)
    js = jopt.init(jp)
    js = js._replace(step=jnp.int32(4), mu=jax.tree_util.tree_map(lambda x: x + 1.5, js.mu))
    JCKPT.save_checkpoint(tmp_path / "j", 4, (jp, js), extra={"by": "jax"})
    tp = carried(jp)
    topt = AdamW(master_weights=master)
    like = (map_leaves(torch.zeros_like, tp, is_leaf=torch.is_tensor), topt.init(tp))
    (rp, rs), step, extra = CKPT.restore_checkpoint(tmp_path / "j", like)
    assert step == 4 and extra == {"by": "jax"} and isinstance(rs, AdamWState)
    got, want = tensors((rp, rs)), jax.tree_util.tree_leaves((jp, js))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    CKPT.save_checkpoint(tmp_path / "t", 9, (rp, rs), extra={"by": "torch"})
    jlike = jax.tree_util.tree_map(jnp.zeros_like, (jp, js))
    (jr, jrs), step, extra = JCKPT.restore_checkpoint(tmp_path / "t", jlike)
    assert step == 9 and extra == {"by": "torch"}
    for a, b in zip(jax.tree_util.tree_leaves((jr, jrs)), want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    j_manifest = (tmp_path / "j" / "step_00000004" / "manifest.json").read_text()
    t_manifest = (tmp_path / "t" / "step_00000009" / "manifest.json").read_text()
    def layout(m):
        return [(l["path"], l["shape"], l["dtype"]) for l in json.loads(m)["leaves"]]

    assert layout(t_manifest) == layout(j_manifest)


# ---------------------------------------------------------------------------
# fault-tolerant loop
# ---------------------------------------------------------------------------
def _toy_step():
    opt = AdamW(lr=0.05, weight_decay=0.0, clip_norm=None)

    def step(params, opt_state, batch):
        w = params["w"].detach().requires_grad_()
        loss = torch.mean((w * batch["x"] - batch["y"]) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        params, opt_state, _ = opt.update({"w": g}, opt_state, params)
        return params, opt_state, {"loss": loss.detach()}

    return opt, step


def _toy_data(step):
    rng = np.random.default_rng(step)
    x = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    return {"x": x, "y": 3.0 * x}


def test_loop_loss_drops_and_resume_equivalence(tmp_path):
    """The update writes its parameters in place (the donated step), so
    each run starts from parameters of its own."""
    opt, step = _toy_step()

    def fresh():
        params = {"w": torch.zeros(8)}
        return params, opt.init(params)

    # one continuous 40-step run
    p1, s1, rep1 = train_loop(step, *fresh(), _toy_data, LoopConfig(total_steps=40),
                              log=lambda *_: None)
    assert rep1.losses[-1] < rep1.losses[0]

    # 20 steps, "crash", resume to 40 — must match bitwise
    ck = str(tmp_path / "ck")
    p2, s2, _ = train_loop(step, *fresh(), _toy_data,
                           LoopConfig(total_steps=20, ckpt_dir=ck, ckpt_every=10),
                           log=lambda *_: None)
    p3, s3, rep3 = train_loop(step, *fresh(), _toy_data,
                              LoopConfig(total_steps=40, ckpt_dir=ck, ckpt_every=10),
                              log=lambda *_: None)
    assert rep3.resumed_from == 20
    assert torch.equal(p1["w"], p3["w"])


def test_loop_straggler_detection():
    opt, step = _toy_step()
    calls = {"n": 0}

    def slow_step(p, s, b):
        calls["n"] += 1
        if calls["n"] == 15:
            time.sleep(0.5)  # inject one straggler step
        return step(p, s, b)

    params = {"w": torch.zeros(8)}
    _, _, rep = train_loop(slow_step, params, opt.init(params), _toy_data,
                           LoopConfig(total_steps=20, straggler_factor=3.0),
                           log=lambda *_: None)
    assert any(s[0] == 15 for s in rep.straggler_steps)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x7b"])
def test_launcher_reduces_loss(arch):
    report = tlaunch.main(["--arch", arch, "--steps", "30", "--batch", "4", "--seq", "32",
                           "--lr", "3e-3", "--device", "cpu"])
    assert report.steps_run == 30 and all(np.isfinite(report.losses))
    assert report.losses[-1] < report.losses[0] - 0.05


def test_launcher_resumes_from_its_checkpoints(tmp_path):
    ck = str(tmp_path / "ck")
    tlaunch.main(["--arch", "olmo-1b", "--steps", "10", "--batch", "2", "--seq", "16",
                  "--ckpt-dir", ck, "--ckpt-every", "5", "--device", "cpu"])
    rep = tlaunch.main(["--arch", "olmo-1b", "--steps", "20", "--batch", "2", "--seq", "16",
                        "--ckpt-dir", ck, "--ckpt-every", "5", "--device", "cpu"])
    assert rep.resumed_from == 10
    assert rep.steps_run == 10


def test_launcher_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--arch", "olmo-1b", "--steps", "1"])
    assert e.value.code == 1
    assert "--device cpu" in capsys.readouterr().err


def test_example_runs_the_launcher(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train_lm_torch.py", "--arch", "qwen2-moe-a2.7b",
                                      "--steps", "2", "--batch", "2", "--seq", "16",
                                      "--device", "cpu"])
    runpy.run_path(str(Path(__file__).resolve().parent.parent / "examples" / "train_lm_torch.py"),
                   run_name="__main__")
