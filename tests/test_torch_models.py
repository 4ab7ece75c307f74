"""The port's LM models (`repro_torch.configs`, `.models`, `.dist.sharding`)
against the JAX package's, on the CPU.

The same numpy inputs and the JAX package's own weights (carried across with
`params_from_numpy`) go through both packages. Integer plans and cache
positions must be equal; gates agree to rtol 1e-6, aux losses to rtol 1e-5,
and outputs, logits and caches to max |diff| <= 1e-4 * max(1, max |reference|)
(float32, reduced configs). The JAX package's MoE plans take its 'xla'
partition arm, which gives the same permutation as its Pallas kernels.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.dist import sharding as jsh
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import params as jparams
from repro_torch.configs import base as tbase
from repro_torch.dist import sharding as tsh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import params as tparams
from repro_torch.models.params import params_from_numpy

ARCHS = jbase.list_archs()
DECODERS = [a for a in ARCHS if jbase.get_config(a).family in ("dense", "moe")]
TEMPLATED = [a for a in ARCHS if jbase.get_config(a).family in ("dense", "moe", "vlm", "audio")]
UNPORTED = [a for a in ARCHS if a not in TEMPLATED]
OUT_TOL = 1e-4


@pytest.fixture(autouse=True)
def jax_partition_plan_on_its_xla_arm(monkeypatch):
    monkeypatch.setattr(jops, "partition_plan_impl", lambda: "xla")


def close(got, ref, tol=OUT_TOL, what=""):
    """max |got - ref| <= tol * max(1, max |ref|)."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max()) if ref.size else 0
    bound = tol * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


def equal(got, ref, what=""):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref), err_msg=what)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def carried(jparams_tree):
    """The JAX package's weights as the port's tree on the CPU."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams_tree), device="cpu")


_WEIGHTS = {}


def weights(arch, cfg_j=None, seed=0):
    """(JAX params, carried port params) of an arch's reduced config."""
    key = (arch, seed, cfg_j)
    if key not in _WEIGHTS:
        cfg_j = cfg_j or jbase.get_reduced_config(arch)
        p = JM.init_params(cfg_j, jax.random.PRNGKey(seed))
        _WEIGHTS[key] = (p, carried(p))
    return _WEIGHTS[key]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_reduced_config"):
        j, p = getattr(jbase, get)(arch), getattr(tbase, get)(arch)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert (p.hd, p.padded_vocab, p.is_encdec, p.supports_long_context) == \
            (j.hd, j.padded_vocab, j.is_encdec, j.supports_long_context)
        for name, shape in jbase.SHAPES.items():
            assert tbase.cell_is_runnable(p, tbase.SHAPES[name]) == \
                jbase.cell_is_runnable(j, shape)


def test_registry_and_shapes_equal_reference():
    assert tbase.list_archs() == jbase.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_equal_reference(arch):
    for get in ("get_config", "get_reduced_config"):
        cfg = getattr(tbase, get)(arch)
        if arch in UNPORTED:
            with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
                TM.num_params(cfg)
        else:
            assert TM.num_params(cfg) == JM.num_params(getattr(jbase, get)(arch))


def test_param_counts_match_public_sizes():
    expected = {
        "qwen2-moe-a2.7b": (13.5, 15.0), "mixtral-8x7b": (45.5, 47.5),
        "olmo-1b": (1.0, 1.4), "granite-8b": (7.7, 8.6),
        "starcoder2-7b": (6.9, 7.8), "h2o-danube-3-4b": (3.5, 4.3),
        "llama-3.2-vision-11b": (9.0, 11.5), "whisper-large-v3": (1.3, 1.8),
    }
    assert sorted(expected) == sorted(TEMPLATED)
    for arch, (lo, hi) in expected.items():
        n = TM.num_params(tbase.get_config(arch)) / 1e9
        assert lo <= n <= hi, (arch, n)
    assert TM.num_params(tbase.get_config("qwen2-moe-a2.7b")) == 14_315_587_584


def _shapes(tree):
    return {"/".join(map(str, k)): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", TEMPLATED)
def test_param_tree_equals_reference(arch):
    """Keys and shapes of the initialized tree equal the JAX package's; the
    draws follow the template's init kinds and scales."""
    jp = JM.init_params(jbase.get_reduced_config(arch), jax.random.PRNGKey(0))
    tp = TM.init_params(tbase.get_reduced_config(arch), torch.Generator().manual_seed(0),
                        torch.float32, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert {"/".join(map(str, k)): tuple(v.shape) for k, v in flat} == _shapes(jp)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for _, v in flat)
    tmpl = jax.tree_util.tree_flatten_with_path(
        JM.template(jbase.get_reduced_config(arch)),
        is_leaf=lambda x: isinstance(x, jparams.P))[0]
    for (path, leaf), (_, v) in zip(tmpl, flat):
        if leaf.init == "zeros":
            assert torch.count_nonzero(v) == 0
        elif leaf.init == "ones":
            assert torch.all(v == 1)
        elif v.numel() >= 4096:
            want = leaf.scale or {"embed": 1.0, "small": 0.02}.get(
                leaf.init, 1 / np.sqrt(leaf.shape[-2] if len(leaf.shape) >= 2
                                       else leaf.shape[-1]))
            assert abs(float(v.std()) / want - 1) < 0.1, (path, float(v.std()), want)


def test_init_is_seeded_and_draws_in_dtype():
    cfg = tbase.get_reduced_config("qwen2-moe-a2.7b")
    a = TM.init_params(cfg, torch.Generator().manual_seed(3), torch.bfloat16, "cpu")
    b = TM.init_params(cfg, torch.Generator().manual_seed(3), torch.bfloat16, "cpu")
    c = TM.init_params(cfg, torch.Generator().manual_seed(4), torch.bfloat16, "cpu")
    la, lb, lc = (jax.tree_util.tree_leaves(x) for x in (a, b, c))
    assert all(x.dtype == torch.bfloat16 and torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["layers"]["moe"]["wg"], c["layers"]["moe"]["wg"])


def test_params_from_numpy_round_trips_exactly():
    jp, tp = weights("qwen2-moe-a2.7b")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [k for k, _ in jl] == [k for k, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # carried back and forth again, and cast on the way when asked
    again = params_from_numpy(jax.tree_util.tree_map(lambda x: x.numpy(), tp), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(again),
                                                 jax.tree_util.tree_leaves(tp)))
    half = params_from_numpy({"w": np.ones((2, 3), np.float32), "i": np.arange(3)},
                             dtype=torch.bfloat16, device="cpu")
    assert half["w"].dtype == torch.bfloat16 and half["i"].dtype == torch.int64


@pytest.mark.parametrize("mesh_shape", [{"data": 16, "model": 16},
                                        {"pod": 2, "data": 8, "model": 4},
                                        {"data": 1, "model": 3}])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b", "llama-3.2-vision-11b"])
def test_partition_specs_equal_reference(arch, mesh_shape):
    for kw in ({}, {"multi_pod": True, "fsdp": False}, {"seq_shard": True}):
        jr, tr = jsh.default_rules(**kw), tsh.default_rules(**kw)
        assert (tr.param, tr.act) == (jr.param, jr.act)
        js = jparams.specs_from_template(JM.template(jbase.get_config(arch)), jr.param,
                                         mesh_shape)
        ts = tparams.specs_from_template(TM.template(tbase.get_config(arch)), tr.param,
                                         mesh_shape)
        jflat = jax.tree_util.tree_flatten_with_path(
            js, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        tflat = jax.tree_util.tree_flatten_with_path(
            ts, is_leaf=lambda x: isinstance(x, tuple))[0]
        assert [(k, tuple(v)) for k, v in jflat] == tflat


# ---------------------------------------------------------------------------
# sharding context
# ---------------------------------------------------------------------------
class _Mesh:
    shape = {"data": 2, "model": 4}


def test_shard_act_identity_outside_and_raises_inside_a_context():
    x = torch.ones(2, 3)
    assert tsh.shard_act(x, ("batch", None)) is x
    assert tsh.current_ctx() is None
    rules = tsh.default_rules()
    with tsh.sharding_ctx(_Mesh(), rules) as ctx:
        assert tsh.current_ctx() == ctx
        assert tsh._mesh_axis_size(_Mesh(), ("data", "model", "pod")) == 8
        assert tsh._mesh_axis_size(_Mesh(), "model") == 4
        assert tsh._mesh_axis_size(_Mesh(), None) == 1
        with pytest.raises(ValueError, match="rank-2"):
            tsh.shard_act(x, ("batch",))
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1's dist/"):
            tsh.shard_act(x, ("batch", None))
        # the model code reaches it: no silent single-card run under a mesh
        p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams.init_from_template(
            JL.mlp_tmpl("swiglu", 3, 5), jax.random.PRNGKey(0))), device="cpu")
        with pytest.raises(NotImplementedError):
            TL.apply_mlp("swiglu", p, x[None])
    assert tsh.current_ctx() is None


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norm_equals_reference(kind, rng):
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3
    p = {k: rng.normal(size=(16,)).astype(np.float32) for k in JL.norm_tmpl(kind, 16)}
    close(TL.apply_norm(kind, {k: t(v) for k, v in p.items()}, t(x)),
          JL.apply_norm(kind, p, jnp.asarray(x)), what=kind)


def test_rope_and_sinusoids_equal_reference(rng):
    x = rng.normal(size=(2, 7, 4, 8)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    close(TL.rope(t(x), t(pos), 1e6), JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    close(TL.sinusoidal_positions(33, 16), JL.sinusoidal_positions(33, 16))
    close(TL.sinusoidal_at(t(pos), 16), JL.sinusoidal_at(jnp.asarray(pos), 16))


def _attn(rng, d=32, H=4, KV=2, hd=8):
    jp = jparams.init_from_template(JL.attn_tmpl(d, H, KV, hd), jax.random.PRNGKey(0))
    return jp, carried(jp)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_self_attn_equals_reference(window, causal, rng):
    jp, tp = _attn(rng)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32) * 0.5
    close(TL.apply_self_attn(tp, t(x), n_kv=2, theta=1e4, window=window, causal=causal),
          JL.apply_self_attn(jp, jnp.asarray(x), n_kv=2, theta=1e4, window=window,
                             causal=causal))


def test_blockwise_path_equals_reference(rng):
    """Past BLOCKWISE_SEQ_THRESHOLD both packages take the chunked
    online-softmax path; it also equals the port's direct _sdpa."""
    jp, tp = _attn(rng, d=16, H=2, KV=1, hd=8)
    s = TL.BLOCKWISE_SEQ_THRESHOLD + 100
    x = rng.normal(size=(1, s, 16)).astype(np.float32) * 0.5
    close(TL.apply_self_attn(tp, t(x), n_kv=1, theta=1e4, window=700),
          JL.apply_self_attn(jp, jnp.asarray(x), n_kv=1, theta=1e4, window=700))


def test_blockwise_sdpa_equals_reference_and_direct(rng):
    b, s, H, KV, hd = 2, 64, 4, 2, 8
    q, k, v = (rng.normal(size=(b, s, n, hd)).astype(np.float32) for n in (H, KV, KV))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    for ck in (8, 16, 48):
        for window in (None, 24):
            got = TL._blockwise_sdpa(t(q), t(k), t(v), t(pos), n_rep=2, causal=True,
                                     window=window, kv_chunk=ck)
            close(got, JL._blockwise_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(pos), n_rep=2, causal=True,
                                          window=window, kv_chunk=ck))
            qp, kp = t(pos)[:, :, None], t(pos)[:, None, :]
            mask = kp <= qp
            if window:
                mask &= kp > qp - window
            close(got, TL._sdpa(t(q), t(k), t(v), mask[:, None], 2))


def test_cross_attn_equals_reference(rng):
    jp, tp = _attn(rng)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    src = rng.normal(size=(2, 9, 32)).astype(np.float32)
    close(TL.apply_cross_attn(tp, t(x), t(src), n_kv=2),
          JL.apply_cross_attn(jp, jnp.asarray(x), jnp.asarray(src), n_kv=2))


def test_ring_buffer_decode_equals_reference(rng):
    """h2o-danube's reduced window (16): 40 steps wrap the ring twice; a
    vector pos puts the two sequences at different positions, and each step
    leaves the cache it was given as it was."""
    W, steps = jbase.get_reduced_config("h2o-danube-3-4b").sliding_window, 40
    assert W == 16
    jp, tp = _attn(rng)
    jc = JL.init_kv_cache(2, W, 2, 8, jnp.float32)
    tc = TL.init_kv_cache(2, W, 2, 8, torch.float32, "cpu")
    for step in range(steps):
        x = rng.normal(size=(2, 1, 32)).astype(np.float32)
        pos = np.array([step, max(step - 7, 0)], np.int32)
        before = {k: v.clone() for k, v in tc.items()}
        ty, tc2 = TL.apply_self_attn_decode(tp, t(x), tc, t(pos), n_kv=2, theta=1e4)
        jy, jc = JL.apply_self_attn_decode(jp, jnp.asarray(x), jc, jnp.asarray(pos), n_kv=2,
                                           theta=1e4)
        assert all(torch.equal(before[k], tc[k]) for k in tc)
        tc = tc2
        close(ty, jy, what=f"step {step}")
        close(tc["k"], jc["k"], what=f"k step {step}")
        close(tc["v"], jc["v"], what=f"v step {step}")
    # a scalar pos is the vector of that position
    y1, _ = TL.apply_self_attn_decode(tp, t(x), tc, 30, n_kv=2, theta=1e4)
    y2, _ = TL.apply_self_attn_decode(tp, t(x), tc, torch.full((2,), 30, dtype=torch.int32),
                                      n_kv=2, theta=1e4)
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_embed_and_head_equal_reference(kind, rng):
    jp = jparams.init_from_template(
        {"mlp": JL.mlp_tmpl(kind, 16, 24), "embed": JL.embed_tmpl(40, 16),
         "head": JL.head_tmpl(16, 40)}, jax.random.PRNGKey(1))
    tp = carried(jp)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    close(TL.apply_mlp(kind, tp["mlp"], t(x)), JL.apply_mlp(kind, jp["mlp"], jnp.asarray(x)))
    tok = rng.integers(0, 40, (2, 3))
    close(tp["embed"]["table"][t(tok)], jnp.take(jp["embed"]["table"], tok, axis=0))
    close(t(x) @ tp["head"]["w"], jnp.asarray(x) @ jp["head"]["w"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe(E=4, k=2, d=16, f=32, cf=8.0, shared=0, seed=0, **kw):
    cfg_j = jbase.MoEConfig(num_experts=E, top_k=k, d_expert=f, capacity_factor=cf,
                            num_shared_experts=shared, shared_d_ff=24 if shared else 0, **kw)
    cfg_t = tbase.MoEConfig(**dataclasses.asdict(cfg_j))
    jp = jparams.init_from_template(JMOE.moe_tmpl(d, cfg_j), jax.random.PRNGKey(seed))
    return cfg_j, cfg_t, jp, carried(jp)


@pytest.mark.parametrize("E,k,T", [(4, 2, 64), (8, 4, 33), (60, 4, 8), (60, 4, 1)])
def test_route_and_plan_equal_reference(E, k, T, rng):
    cfg_j, _, jp, tp = _moe(E=E, k=k)
    x2 = rng.normal(size=(T, 16)).astype(np.float32)
    je, jg, ja = JMOE._route(jp, jnp.asarray(x2), k)
    te, tg, ta = TMOE._route(tp, t(x2), k)
    assert te.dtype == torch.int32
    equal(te, je, "expert_idx")
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    for C in (JMOE._capacity(T, k, E, 1.25), 1, 3):
        jb, js, jk = JMOE._plan_sort(je, E, C)
        tb, ts, tk = TMOE._plan_sort(te, E, C)
        assert (tb.dtype, ts.dtype, tk.dtype) == (torch.int32, torch.int32, torch.bool)
        equal(tb, jb, "blk_tok")
        equal(ts, js, "slot_a")
        equal(tk, jk, "keep_a")


def test_route_breaks_ties_toward_the_lower_expert(rng):
    """Equal router columns give equal probabilities: the lower expert id
    comes first, as jax.lax.top_k orders them."""
    _, _, jp, tp = _moe(E=8, k=4)
    for src, dst in ((1, 6), (2, 3), (0, 7)):
        w = np.asarray(jp["router"]).copy()
        w[:, dst] = w[:, src]
        jp = dict(jp, router=jnp.asarray(w))
        tp = dict(tp, router=t(w))
    x2 = rng.normal(size=(40, 16)).astype(np.float32)
    je, jg, _ = JMOE._route(jp, jnp.asarray(x2), 4)
    te, tg, _ = TMOE._route(tp, t(x2), 4)
    equal(te, je, "expert_idx under ties")
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_dispatches_equal_reference(cf, rng):
    """Sort, grouped sort (4 groups) and einsum dispatch against the JAX
    package's; at capacity_factor 0.25 assignments are dropped, and the
    drops are the reference's."""
    E, k, T = 4, 2, 64
    _, _, jp, tp = _moe(E=E, k=k, cf=cf)
    x2 = rng.normal(size=(T, 16)).astype(np.float32) * 0.3
    je, jg, _ = JMOE._route(jp, jnp.asarray(x2), k)
    te, tg, _ = TMOE._route(tp, t(x2), k)
    C = 16 if cf < 1 else JMOE._capacity(T, k, E, cf)
    if cf < 1:
        assert not bool(TMOE._plan_sort(te, E, C)[2].all())  # something is dropped
    close(TMOE._dispatch_sort(tp, t(x2), te, tg, C),
          JMOE._dispatch_sort(jp, jnp.asarray(x2), je, jg, C), what="sort")
    close(TMOE._dispatch_einsum(tp, t(x2), te, tg, C),
          JMOE._dispatch_einsum(jp, jnp.asarray(x2), je, jg, C), what="einsum")
    close(TMOE._dispatch_sort_grouped(tp, t(x2), te, tg, k=k, E=E, cf=cf, groups=4),
          JMOE._dispatch_sort_grouped(jp, jnp.asarray(x2), je, jg, k=k, E=E, cf=cf, groups=4),
          what="grouped")


def test_moe_grouped_dispatch_equals_global(rng):
    _, cfg, _, p = _moe()
    T = 64
    x2 = t(rng.normal(size=(T, 16)).astype(np.float32) * 0.3)
    eidx, gates, _ = TMOE._route(p, x2, cfg.top_k)
    y1 = TMOE._dispatch_sort(p, x2, eidx, gates, TMOE._capacity(T, 2, 4, 8.0))
    y2 = TMOE._dispatch_sort_grouped(p, x2, eidx, gates, k=2, E=4, cf=8.0, groups=4)
    assert float((y1 - y2).abs().max()) < 1e-5


def test_moe_sort_vs_einsum_dispatch(rng):
    """The GFTR-pattern dispatch and the dense baseline agree when nothing
    is dropped."""
    _, cfg_s, _, p = _moe()
    cfg_e = dataclasses.replace(cfg_s, dispatch="einsum")
    x = t(rng.normal(size=(2, 32, 16)).astype(np.float32) * 0.3)
    y_s, _ = TMOE.apply_moe(p, x, cfg_s)
    y_e, _ = TMOE.apply_moe(p, x, cfg_e)
    assert float((y_s - y_e).abs().max()) < 1e-4


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
def test_apply_moe_equals_reference(dispatch, rng):
    cfg_j, cfg_t, jp, tp = _moe(E=8, k=4, shared=1, cf=1.25, dispatch=dispatch)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    ty, ta = TMOE.apply_moe(tp, t(x), cfg_t)
    jy, ja = JMOE.apply_moe(jp, jnp.asarray(x), cfg_j)
    close(ty, jy)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_capacity_equals_reference():
    for T, k, E, cf in ((8, 4, 60, 1.25), (32, 4, 60, 1.25), (4096, 4, 60, 1.25),
                        (64, 2, 4, 8.0), (100, 2, 8, 0.25)):
        assert TMOE._capacity(T, k, E, cf) == JMOE._capacity(T, k, E, cf)
        assert TMOE._capacity(T, k, E, cf, 128) == JMOE._capacity(T, k, E, cf, 128)
    assert TMOE._capacity(8, 4, 60, 1.25) == 512
