"""The port's hybrid, xLSTM, vision and audio families against the JAX
package's, on the CPU: the Mamba2 (SSD), mLSTM and sLSTM layer functions,
the port's mirrors of the reference's chunked-against-recurrent checks, and
`forward`, `loss_fn` and the gradients of zamba2, xlstm, llama-3.2-vision
and whisper (reduced configs, batch 2, 16 tokens).

The same numpy inputs and the JAX package's own weights (carried across with
`params_from_numpy`) go through both packages. Tolerances (float32): layer
outputs within 1e-5 of their largest magnitude; logits within 1e-4 of
theirs; loss within 1e-5 relative; every gradient leaf within 1e-4 of its
leaf's max |g| (against `jax.grad`). Two pinned differences (ROADMAP Queue
3), each in the gradient only: the port masks SSD's intra-chunk exponent
before taking it, and runs the chunked mLSTM's last chunk unpadded, so its
gradients stay finite where the JAX package's are NaN.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.base import SSMConfig, XLSTMConfig
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.models import xlstm as JXL
from repro.models.params import init_from_template
from repro_torch.configs import base as tbase
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.models import xlstm as TXL
from repro_torch.models.params import init_from_template as t_init
from repro_torch.models.params import leaves, map_leaves, params_from_numpy

FAMILIES = ["zamba2-2.7b", "xlstm-125m", "llama-3.2-vision-11b", "whisper-large-v3"]
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eager steps of many small ops run fastest on one thread, and stay fast
    when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close_to_max(got, ref, tol, what=""):
    """max |got - ref| <= tol * max |ref|."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max())
    bound = tol * float(np.abs(ref).max())
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


def carried(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def perturbed(tmpl, seed=0, scale=0.1):
    """A layer's JAX parameters with every leaf moved by seeded noise, so
    that the zero- and one-initialized leaves (A_log, dt_bias, D, gate
    biases, norms) take part."""
    p = init_from_template(tmpl, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + scale * rng.normal(size=a.shape).astype(np.float32)),
        p)


def x_of(b, s, d, seed=0, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(b, s, d)) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layer functions
# ---------------------------------------------------------------------------
SSM_CFG = SSMConfig(state_dim=8, head_dim=4, expand=2, conv_width=4, chunk=8)
XL_CFG = XLSTMConfig(num_heads=2)


def test_apply_ssm_equals_reference():
    d = 16
    jp = perturbed(JSSM.ssm_tmpl(d, SSM_CFG))
    x = x_of(2, 16, d)
    close_to_max(TSSM.apply_ssm(carried(jp), torch.from_numpy(x), SSM_CFG),
                 jax.jit(JSSM.apply_ssm, static_argnums=2)(jp, jnp.asarray(x), SSM_CFG),
                 LAYER_TOL, "apply_ssm")


@pytest.mark.parametrize("form", ["quadratic", 8, 13, 40])
def test_apply_mlstm_equals_reference(form):
    d = 16
    jp = perturbed(JXL.mlstm_tmpl(d, XL_CFG), seed=1)
    x = x_of(2, 16, d, seed=1)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if form == "quadratic":
        got = TXL.apply_mlstm(carried(jp), xt, XL_CFG)
        ref = jax.jit(JXL.apply_mlstm, static_argnums=2)(jp, xj, XL_CFG)
    else:
        got = TXL._apply_mlstm_chunked(carried(jp), xt, XL_CFG, form)
        ref = jax.jit(JXL._apply_mlstm_chunked, static_argnums=(2, 3))(jp, xj, XL_CFG, form)
    close_to_max(got, ref, LAYER_TOL, f"mlstm {form}")


def test_apply_slstm_equals_reference():
    d = 16
    jp = perturbed(JXL.slstm_tmpl(d, XL_CFG), seed=2)
    x = x_of(2, 16, d, seed=2)
    ty, tst = TXL.apply_slstm(carried(jp), torch.from_numpy(x), XL_CFG)
    jy, jst = jax.jit(JXL.apply_slstm, static_argnums=2)(jp, jnp.asarray(x), XL_CFG)
    close_to_max(ty, jy, LAYER_TOL, "slstm y")
    for name, a, b in zip("cnmh", tst, jst):
        close_to_max(a, b, LAYER_TOL, f"slstm state {name}")


def test_ssd_chunked_equals_recurrent(rng):
    """tests/test_models.py's check on the port: the chunked prefill equals
    the token-by-token decode recurrence."""
    cfg = SSMConfig(state_dim=8, head_dim=4, expand=2, conv_width=4, chunk=8)
    d, b, s = 16, 2, 32
    p = t_init(TSSM.ssm_tmpl(d, cfg), torch.Generator().manual_seed(0),
                              torch.float32, "cpu")
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)) * 0.5
    y_par = TSSM.apply_ssm(p, x, cfg)
    cache = TSSM.init_ssm_cache(b, d, cfg, torch.float32, "cpu")
    ys = []
    for t in range(s):
        yt, cache = TSSM.apply_ssm_decode(p, x[:, t:t + 1], cache, cfg)
        ys.append(yt)
    assert float((y_par - torch.cat(ys, 1)).abs().max()) < 1e-3


def test_mlstm_chunked_equals_quadratic(rng):
    """tests/test_models.py's check on the port, and the decode recurrence
    from the layer's own initial state against the quadratic form."""
    cfg = XLSTMConfig(num_heads=2)
    d, b, s = 16, 2, 40
    p = t_init(TXL.mlstm_tmpl(d, cfg), torch.Generator().manual_seed(0),
                              torch.float32, "cpu")
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)) * 0.5
    y_quad = TXL._apply_mlstm_quadratic(p, x, cfg)
    for Q in (8, 13, 40):
        y_chunk = TXL._apply_mlstm_chunked(p, x, cfg, Q)
        assert float((y_quad - y_chunk).abs().max()) < 1e-4
    cache = TXL.init_mlstm_cache(b, d, cfg, torch.float32, "cpu")
    ys = []
    for t in range(s):
        yt, cache = TXL.apply_mlstm_decode(p, x[:, t:t + 1], cache, cfg)
        ys.append(yt)
    assert float((y_quad - torch.cat(ys, 1)).abs().max()) < 1e-4


def test_ssd_masked_exponent_keeps_the_gradient_finite():
    """Pinned difference (ROADMAP Queue 3): at zamba2's published chunk
    (128) with the published initialization, exp(L_j - L_i) above the
    diagonal overflows float32. The JAX package's forward masks the inf
    away, but its gradient is NaN; the port masks before the exponent: the
    same forward values, and a finite gradient equal to its own at a chunk
    (16) whose exponents stay in range (SSD's output does not depend on the
    chunk; at small chunks the port's gradients equal the JAX package's,
    test_forward_loss_and_grads_equal_reference)."""
    d, s = 16, 128
    cfg128 = SSMConfig(state_dim=8, head_dim=4, expand=2, conv_width=4, chunk=128)
    cfg16 = SSMConfig(state_dim=8, head_dim=4, expand=2, conv_width=4, chunk=16)
    jp = init_from_template(JSSM.ssm_tmpl(d, cfg128), jax.random.PRNGKey(0))
    x = x_of(1, s, d)

    def fwd_and_grad(xx):
        y, vjp = jax.vjp(lambda v: JSSM.apply_ssm(jp, v, cfg128), xx)
        return y, vjp(jnp.ones_like(y))[0]

    ref, j_grad = jax.jit(fwd_and_grad)(jnp.asarray(x))
    assert bool(jnp.isfinite(ref).all())
    assert bool(jnp.isnan(j_grad).any())

    tp = carried(jp)
    grads = []
    for cfg in (cfg128, cfg16):
        xt = torch.from_numpy(x).requires_grad_()
        y = TSSM.apply_ssm(tp, xt, cfg)
        if cfg is cfg128:
            close_to_max(y, ref, LAYER_TOL, "forward at chunk 128")
        grads.append(torch.autograd.grad(y.sum(), xt)[0])
    assert bool(torch.isfinite(grads[0]).all())
    close_to_max(grads[0], grads[1], GRAD_TOL, "gradient at chunk 128 against chunk 16")


def test_mlstm_unpadded_last_chunk_keeps_the_gradient_finite():
    """Pinned difference (ROADMAP Queue 3): 300 tokens at MLSTM_CHUNK (256)
    leave 44 rows in the last chunk. The JAX package pads it with 212 rows
    whose stabilizer falls with the forget gates until exp(-m) overflows:
    the rows are cut off, but its gradient is NaN. The port runs the 44 rows
    alone: the same forward values, and a finite gradient equal to the JAX
    package's quadratic form's."""
    d, s = 16, 300
    jp = init_from_template(JXL.mlstm_tmpl(d, XL_CFG), jax.random.PRNGKey(0))
    x = x_of(2, s, d)

    def fwd_and_grad(fn):
        def f(xx):
            y, vjp = jax.vjp(fn, xx)
            return y, vjp(jnp.ones_like(y))[0]
        return jax.jit(f)(jnp.asarray(x))

    ref, j_grad = fwd_and_grad(lambda v: JXL._apply_mlstm_chunked(jp, v, XL_CFG, 256))
    assert bool(jnp.isnan(j_grad).any())
    _, q_grad = fwd_and_grad(lambda v: JXL._apply_mlstm_quadratic(jp, v, XL_CFG))
    assert bool(jnp.isfinite(q_grad).all())

    xt = torch.from_numpy(x).requires_grad_()
    y = TXL.apply_mlstm(carried(jp), xt, XL_CFG)  # past MLSTM_CHUNK: the chunked form
    close_to_max(y, ref, LAYER_TOL, "forward, 300 tokens in chunks of 256")
    (g,) = torch.autograd.grad(y.sum(), xt)
    assert bool(torch.isfinite(g).all())
    close_to_max(g, q_grad, GRAD_TOL, "gradient against the JAX package's quadratic form")


# ---------------------------------------------------------------------------
# forward, loss_fn and gradients of the four families
# ---------------------------------------------------------------------------
def family_batch(cfg, b=2, s=16, seed=0):
    """Numpy tokens (b, s + 1) and the family's stub embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_emb"] = (rng.normal(size=(b, cfg.vision_tokens, cfg.d_model))
                               * 0.02).astype(np.float32)
    if cfg.family == "audio":
        batch["enc_emb"] = (rng.normal(size=(b, cfg.encoder_len, cfg.d_model))
                            * 0.02).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_loss_and_grads_equal_reference(arch):
    cj, ct = jbase.get_reduced_config(arch), tbase.get_reduced_config(arch)
    assert TM.num_params(ct) == JM.num_params(cj)
    jp = JM.init_params(cj, jax.random.PRNGKey(0))
    nb = family_batch(cj)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}

    fwd_j = {**jb, "tokens": jb["tokens"][:, :-1]}
    fwd_t = {**tb, "tokens": tb["tokens"][:, :-1]}
    jl, _ = JM.forward(cj, jp, fwd_j, remat=False)
    tl, _ = TM.forward(ct, carried(jp), fwd_t, remat=False)
    close_to_max(tl, jl, LOGIT_TOL, "logits")

    (jloss, jm), jg = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(cj, p, jb),
                                                 has_aux=True))(jp)
    tp = carried(jp)
    ps = [p.requires_grad_() for p in leaves(tp, torch.is_tensor)]
    it = iter(ps)
    tree = map_leaves(lambda _: next(it), tp, is_leaf=torch.is_tensor)
    tloss, tm = TM.loss_fn(ct, tree, tb)
    grads = torch.autograd.grad(tloss, ps, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]), rtol=LOSS_RTOL)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for i, (g, r) in enumerate(zip(grads, jleaves)):
        r = np.asarray(r)
        err = float(np.abs(g.numpy().astype(np.float64) - r).max())
        assert err <= GRAD_TOL * max(float(np.abs(r).max()), 1e-30), (arch, i, err)
