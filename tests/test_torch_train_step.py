"""The port's step builders (`repro_torch.train.step`), its remat modes and
the MoE plan gathers' backward against the JAX package's, on the CPU.

The same seeded numpy inputs and the JAX package's own weights (carried
across) go through both packages; the JAX package's MoE plans take its 'xla'
partition arm, and its train step runs jitted on a 1 x 1 mesh. Tolerances
(float32, reduced configs), stated per test: a step's first metrics within
1e-5 relative; after it, Adam turns noise-level gradients into updates of
+-lr, so parameters are held within 2 x (the sum of the steps' learning
rates) everywhere and within 1e-6 + 1e-5 |p| on all but 1% of elements,
and the later steps' loss, ce and aux within 1e-4 relative, their gradient
norm within 1e-3.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.dist import sharding as JSH
from repro.kernels import ops as jops
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.train import optimizer as JOPT
from repro.train import step as JSTEP
from repro_torch.configs import base as tbase
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.params import leaves, map_leaves, params_from_numpy
from repro_torch.train import optimizer as TOPT
from repro_torch.train import step as TSTEP

PEAK_LR = 1e-3


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


def _setup(arch, seed=0):
    cj, ct = jbase.get_reduced_config(arch), tbase.get_reduced_config(arch)
    jp = JM.init_params(cj, jax.random.PRNGKey(seed))
    return cj, ct, jp, carried(jp)


def _tokens(cfg, rng, b=4, s=16):
    return rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)


def _grads(cfg, params, toks, remat):
    ps = [p.detach().requires_grad_() for p in tensors(params)]
    it = iter(ps)
    tree = map_leaves(lambda _: next(it), params, is_leaf=torch.is_tensor)
    loss, m = TM.loss_fn(cfg, tree, {"tokens": torch.from_numpy(toks)}, remat=remat)
    return [loss.detach(), m["aux"].detach()] + list(torch.autograd.grad(loss, ps))


# ---------------------------------------------------------------------------
# build_train_step against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,microbatches", [("olmo-1b", 1), ("qwen2-moe-a2.7b", 1),
                                               ("qwen2-moe-a2.7b", 2)])
def test_three_train_steps_equal_reference(arch, microbatches, rng):
    """Three steps of each package's build_train_step (master weights on:
    the JAX package's state shardings expect them), cosine schedule,
    clipping; microbatches=2 against the reference's scanned accumulation."""
    cj, ct, jp, tp = _setup(arch)
    kw = dict(master_weights=True, clip_norm=1.0)
    jopt = JOPT.AdamW(lr=JOPT.cosine_schedule(PEAK_LR, 1, 3), **kw)
    topt = TOPT.AdamW(lr=TOPT.cosine_schedule(PEAK_LR, 1, 3), **kw)
    jstep, _, _ = JSTEP.build_train_step(cj, make_mesh((1, 1), ("data", "model")),
                                         JSH.default_rules(), jopt, donate=False,
                                         microbatches=microbatches)
    tstep, psh, bsh = TSTEP.build_train_step(ct, None, None, topt, microbatches=microbatches)
    assert psh is None and bsh is None
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        toks = _tokens(cj, rng)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.from_numpy(toks)})
        assert sorted(tm) == sorted(jm) == ["aux", "ce", "grad_norm", "loss"]
        for k in jm:
            rtol = 1e-5 if i == 0 else 1e-3 if k == "grad_norm" else 1e-4
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    lr_sum = sum(float(JOPT.cosine_schedule(PEAK_LR, 1, 3)(jnp.int32(s))) for s in (1, 2, 3))
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(jp)])
    b = np.concatenate([x.double().numpy().ravel() for x in tensors(tp)])
    d = np.abs(a - b)
    assert d.max() <= 2 * lr_sum, d.max()
    assert (d > 1e-6 + 1e-5 * np.abs(a)).mean() <= 0.01
    assert int(ts.step) == 3


def test_microbatched_gradient_is_the_mean_of_its_halves(rng):
    """microbatches=2 on a batch equals the mean of two one-microbatch
    gradients of its halves (checked through the update with lr 0: the
    moments carry the gradient)."""
    _, ct, _, tp = _setup("qwen2-moe-a2.7b")
    opt = TOPT.AdamW(lr=0.0, clip_norm=None, b1=0.0, b2=0.0)
    toks = _tokens(ct, rng)
    _, s2, m2 = TSTEP.build_train_step(ct, None, None, opt, microbatches=2)[0](
        tp, opt.init(tp), {"tokens": torch.from_numpy(toks)})
    halves = [_grads(ct, tp, toks[h * 2:(h + 1) * 2], True) for h in (0, 1)]
    for got, g0, g1 in zip(tensors(s2.mu), halves[0][2:], halves[1][2:]):
        torch.testing.assert_close(got, (g0 + g1) / 2, rtol=0, atol=0)
    torch.testing.assert_close(m2["loss"], (halves[0][0] + halves[1][0]) / 2, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b"])
def test_remat_modes_agree_bit_for_bit(arch, rng):
    """remat False, True and "dots" recompute the same operations: the same
    loss, aux and gradients, bit for bit."""
    _, ct, _, tp = _setup(arch)
    toks = _tokens(ct, rng, 2, 12)
    runs = {r: _grads(ct, tp, toks, r) for r in (False, True, "dots")}
    for r in (True, "dots"):
        assert all(torch.equal(a, b) for a, b in zip(runs[False], runs[r])), r


def test_donation_writes_in_place_and_its_absence_does_not(rng):
    _, ct, _, tp = _setup("olmo-1b")
    opt = TOPT.AdamW(lr=1e-2)
    toks = {"tokens": torch.from_numpy(_tokens(ct, rng))}
    before = [t.clone() for t in tensors(tp)]
    state = opt.init(tp)
    p1, s1, _ = TSTEP.build_train_step(ct, None, None, opt, donate=False)[0](tp, state, toks)
    assert all(torch.equal(a, b) for a, b in zip(before, tensors(tp)))
    assert int(state.step) == 0 and int(s1.step) == 1
    p2, s2, _ = TSTEP.build_train_step(ct, None, None, opt)[0](tp, state, toks)
    assert all(a is b for a, b in zip(tensors(p2), tensors(tp))) and s2.step is state.step
    assert all(torch.equal(a, b) for a, b in zip(tensors(p1), tensors(p2)))


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) ("data", "model") DeviceMesh over a one-rank gloo group (an
    in-process store: no port, no network)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh as t_make_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield t_make_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_the_builders_return_shardings_on_a_one_rank_mesh(one_rank_mesh, rng):
    """On a (1, 1) mesh the three builders return their shardings, and each
    step equals the one-card step: the same metrics and parameters, logits
    and cache."""
    from repro_torch.dist import sharding as TSH

    mesh, rules = one_rank_mesh, TSH.default_rules()
    _, ct, _, tp = _setup("qwen2-moe-a2.7b")
    opt = TOPT.AdamW(lr=1e-2)
    step, psh, bsh = TSTEP.build_train_step(ct, mesh, rules, opt, donate=False)
    assert sorted(bsh) == ["tokens"] and bsh["tokens"].mesh is mesh
    assert all(isinstance(s, TSH.NamedSharding) and s.spec == (None,) * len(s.spec)
               for s in leaves(psh, lambda x: isinstance(x, TSH.NamedSharding)))
    assert len(leaves(psh, lambda x: isinstance(x, TSH.NamedSharding))) == len(tensors(tp))
    toks = {"tokens": torch.from_numpy(_tokens(ct, rng))}
    p1, s1, m1 = TSTEP.build_train_step(ct, None, None, opt, donate=False)[0](
        tp, opt.init(tp), toks)
    p2, s2, m2 = step(tp, opt.init(tp), toks)
    assert all(not TSH.is_dtensor(v) for v in m2.values())
    for k in m1:
        torch.testing.assert_close(m2[k], m1[k], rtol=1e-6, atol=0, msg=k)
    for a, b in zip(tensors(p1), tensors(p2)):
        torch.testing.assert_close(TSH.full(b), a, rtol=0, atol=1e-6)
    prefill, psh2, bsh2 = TSTEP.build_prefill_step(ct, mesh, rules)
    assert psh2 is not None and sorted(bsh2) == ["tokens"]
    want = TSTEP.build_prefill_step(ct, None, None)[0](tp, {"tokens": toks["tokens"][:, :8]})
    torch.testing.assert_close(TSH.full(prefill(tp, {"tokens": toks["tokens"][:, :8]})), want,
                               rtol=0, atol=1e-5)
    serve, psh3, csh, tsh_ = TSTEP.build_serve_step(ct, mesh, rules, 4, 8)
    assert psh3 is not None and tsh_.shard_shape((4,)) == (4,)
    assert sorted(csh) == ["kv"] and csh["kv"]["k"].shard_shape((2, 4, 8, 2, 16)) == (
        2, 4, 8, 2, 16)
    cache = TM.init_cache(ct, tp, 4, 8, None, torch.float32)
    tok = toks["tokens"][:, 0]
    l1, c1 = TSTEP.build_serve_step(ct, None, None, 4, 8)[0](tp, cache, tok, 0)
    l2, c2 = serve(tp, cache, tok, 0)
    torch.testing.assert_close(TSH.full(l2), l1, rtol=0, atol=1e-5)
    torch.testing.assert_close(TSH.full(c2["kv"]["k"]), c1["kv"]["k"], rtol=0, atol=1e-6)


def test_prefill_and_serve_steps_equal_reference(rng):
    cj, ct, jp, tp = _setup("qwen2-moe-a2.7b")
    toks = _tokens(cj, rng, 2, 6)[:, :6]
    prefill = TSTEP.build_prefill_step(ct, None, None)[0]
    want = JM.forward(cj, jp, {"tokens": jnp.asarray(toks)}, remat=False)[0]
    got = prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    serve = TSTEP.build_serve_step(ct, None, None, 2, 8)[0]
    jc, tc = JM.init_cache(cj, jp, 2, 8, None, jnp.float32), TM.init_cache(ct, tp, 2, 8, None,
                                                                           torch.float32)
    for pos in range(3):
        jl, jc = JM.decode_step(cj, jp, jc, jnp.asarray(toks[:, pos]), pos)
        tl, tc = serve(tp, tc, torch.from_numpy(toks[:, pos]), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


# ---------------------------------------------------------------------------
# the MoE dispatch's backward
# ---------------------------------------------------------------------------
def _moe(E=4, k=2, cf=8.0, dispatch="sort", seed=0):
    cfg = jbase.get_reduced_config("mixtral-8x7b")
    mcfg = cfg.moe.__class__(**{**cfg.moe.__dict__, "num_experts": E, "top_k": k,
                                "capacity_factor": cf, "dispatch": dispatch})
    jp = JMOE.moe_tmpl(16, mcfg)
    from repro.models.params import init_from_template

    jp = init_from_template(jp, jax.random.PRNGKey(seed))
    return mcfg, jp, carried(jp)


@pytest.mark.parametrize("cf", [8.0, 0.25])
@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
def test_dispatch_gradients_equal_reference(dispatch, cf, rng):
    """d(sum(y * w)) / d(x2, gates, expert weights) of each dispatch against
    jax.grad of the reference's; at capacity_factor 0.25 assignments drop."""
    E, k, T = 4, 2, 64
    mcfg, jp, tp = _moe(E=E, k=k, cf=cf)
    x2 = rng.normal(size=(T, 16)).astype(np.float32) * 0.3
    w = rng.normal(size=(T, 16)).astype(np.float32)
    je, jg, _ = JMOE._route(jp, jnp.asarray(x2), k)
    C = 16 if cf < 1 else JMOE._capacity(T, k, E, cf)
    jfn = {"sort": JMOE._dispatch_sort, "einsum": JMOE._dispatch_einsum}[dispatch]
    tfn = {"sort": TMOE._dispatch_sort, "einsum": TMOE._dispatch_einsum}[dispatch]

    def jloss(p, x, g):
        return jnp.sum(jfn(p, x, je, g, C) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x2), jg)
    tx = torch.from_numpy(x2).requires_grad_()
    tg = torch.from_numpy(np.asarray(jg)).requires_grad_()
    ps = {key: v.detach().requires_grad_() for key, v in tp.items()}
    y = tfn(ps, tx, torch.from_numpy(np.asarray(je)), tg, C)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                              [ps[key] for key in ("wd", "wg", "wu")] + [tx, tg])
    want = [want[0][key] for key in ("wd", "wg", "wu")] + [want[1], want[2]]
    for g, r in zip(got, want):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-5 * max(np.abs(r).max(), 1.0)


def test_plan_gather_backward_equals_autograd_through_plain_gathers(rng):
    """The plan gathers' inverse-plan backward against autograd through
    `_gather_rows` (whose backward adds rows by index): the combine gather
    reads each slot once, so its gradient is equal bit for bit; the
    dispatch gather adds a token's k slots in order, within float32
    rounding of the indexed accumulation."""
    E, k, T, D = 8, 4, 96, 16
    eidx = torch.from_numpy(np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
                            .astype(np.int32))
    for C in (TMOE._capacity(T, k, E, 1.25), 20):
        blk_tok, slot_a, keep_a, blk_asg = TMOE._plan_sort(eidx, E, C)
        at = torch.where(keep_a, slot_a, -1)
        x = torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32)).requires_grad_()
        out = torch.from_numpy(rng.normal(size=(E * C, D)).astype(np.float32)).requires_grad_()
        g_in = torch.from_numpy(rng.normal(size=(E * C, D)).astype(np.float32))
        g_out = torch.from_numpy(rng.normal(size=(T * k, D)).astype(np.float32))
        plan = torch.autograd.grad(
            (TMOE._PlanGather.apply(x, blk_tok.reshape(-1), at.reshape(T, k)) * g_in).sum()
            + (TMOE._PlanGather.apply(out, at, blk_asg.reshape(-1, 1)) * g_out).sum(),
            [x, out])
        plain = torch.autograd.grad(
            (TMOE._gather_rows(x, blk_tok.reshape(-1)) * g_in).sum()
            + (TMOE._gather_rows(out, at) * g_out).sum(), [x, out])
        torch.testing.assert_close(plan[0], plain[0], rtol=1e-6, atol=1e-6)
        assert torch.equal(plan[1], plain[1])
        assert bool(keep_a.all()) == (C > 20)


def test_loss_and_gradients_repeat_bit_for_bit(rng):
    _, ct, _, tp = _setup("qwen2-moe-a2.7b")
    toks = _tokens(ct, rng, 2, 12)
    a, b = _grads(ct, tp, toks, True), _grads(ct, tp, toks, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
