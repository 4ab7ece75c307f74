"""xLSTM blocks: mLSTM (matrix memory, parallel quadratic form for training,
O(1) recurrent decode) and sLSTM (scalar memory, a true recurrence).

Stabilized exponential gating follows the xLSTM paper: all gate algebra runs
in log space with a running max stabilizer m, and the training-time parallel
form of mLSTM is the masked quadratic

    D[t,i] = F_t - F_i + ipre_i   (i <= t),  F = cumsum(log sigmoid(fpre))
    h_t    = sum_i exp(D-m_t) (q_t.k_i) v_i / max(|sum_i exp(D-m_t) q.k|, e^{-m_t})

which matches the decode recurrence. The stabilizers stay in float32 with
the JAX package's constants: -inf above the diagonal, and -1e30 for the
initial m of the chunked carry and of the layer's own sLSTM and mLSTM
states. The sLSTM recurrence is a Python loop of one cell step per token
(the JAX package's `lax.scan`).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..dist import sharding as SH
from ..dist.sharding import shard_act
from .layers import contract, gather_seq, linear, proj_heads, rms
from .params import P, axis_spec


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_tmpl(d: int, cfg):
    inner = int(cfg.proj_factor_mlstm * d)
    nh = cfg.num_heads
    dk = inner // nh
    return {
        "up": P((d, 2 * inner), ("embed", "inner")),
        "conv_w": P((4, inner), ("conv", "inner")),
        "conv_b": P((inner,), ("inner",), "zeros"),
        "wq": P((inner, nh, dk), ("inner", "heads", "head_dim")),
        "wk": P((inner, nh, dk), ("inner", "heads", "head_dim")),
        "wv": P((inner, nh, dk), ("inner", "heads", "head_dim")),
        "wgate": P((inner, nh, 2), ("inner", "heads", None), "small"),
        "gate_b": P((nh, 2), ("heads", None), "zeros"),
        "norm_scale": P((inner,), ("inner",), "ones"),
        "down": P((inner, d), ("inner", "embed")),
    }


def _conv_silu(x, w, b, state=None):
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    y = F.silu(y + b)
    return (y, xp[:, -(k - 1):, :]) if state is not None else y


def _mlstm_qkvg(p, x, cfg, d, conv_state=None):
    inner = int(cfg.proj_factor_mlstm * d)
    nh = cfg.num_heads
    dk = inner // nh
    up = linear(x, p["up"], "inner")
    xin, z = up[..., :inner], up[..., inner:]
    if conv_state is None:
        xc = _conv_silu(xin, p["conv_w"], p["conv_b"])
        new_state = None
    else:
        xc, new_state = _conv_silu(xin, p["conv_w"], p["conv_b"], conv_state)
    # sqrt(dk) rounded to float32 first, then to x's dtype (the JAX order)
    scale = torch.tensor(math.sqrt(dk), dtype=torch.float32).to(x.dtype).to(x.device)
    q = proj_heads(xc, p["wq"]) / scale
    k = proj_heads(xc, p["wk"])
    v = proj_heads(xin, p["wv"])
    g = contract("bsd,dhg->bshg", xc, p["wgate"], 1, ("batch", None, "heads", None)).float() \
        + p["gate_b"].float()
    ipre, fpre = g[..., 0], g[..., 1]
    return q, k, v, ipre, fpre, z, new_state, inner, nh, dk


MLSTM_CHUNK = 256  # chunked path kicks in above this sequence length


def apply_mlstm(p, x, cfg):
    """Training/prefill. Quadratic parallel form for short sequences; the
    chunked form (intra-chunk quadratic + inter-chunk (C, n, m) carry — the
    same structure as SSD) for long ones, bounding score memory at
    (b, Q, Q, h) per chunk."""
    x = gather_seq(x)  # the conv and the gates' cumulative sums run along the sequence
    if x.shape[1] > MLSTM_CHUNK:
        return _apply_mlstm_chunked(p, x, cfg, MLSTM_CHUNK)
    return _apply_mlstm_quadratic(p, x, cfg)


def _per_head(fn, q, k, v, ipre, fpre):
    """fn(q, k, v, ipre, fpre) -> (b, s, h, dk). On a mesh each rank runs
    its own batch rows and heads (`local_map`; the heads whole where they do
    not divide the model axis): the mLSTM is independent per sequence and
    per head, and DTensor's einsums over (batch, heads) merged would form a
    strided shard, whose propagation costs minutes an op on a 3-D mesh."""
    if not SH.is_dtensor(q):
        return fn(q, k, v, ipre, fpre)
    mesh, rules = SH.current_ctx()
    spec = axis_spec(q.shape, ("batch", None, "heads", None), rules.act, SH.mesh_shape(mesh))
    pq, pg = SH.placements_of(spec, mesh), SH.placements_of(spec[:3], mesh)
    return SH.local_map(lambda *a: (fn(*a),), out_placements=(pq,),
                        in_placements=(pq, pq, pq, pg, pg))(q, k, v, ipre, fpre)[0]


def _apply_mlstm_quadratic(p, x, cfg):
    b, s, d = x.shape
    q, k, v, ipre, fpre, z, _, inner, nh, dk = _mlstm_qkvg(p, x, cfg, d)
    hout = _per_head(_mlstm_quadratic, q, k, v, ipre, fpre)
    hout = rms(SH.pin(hout.reshape(b, s, inner)).to(x.dtype))
    hout = hout * p["norm_scale"] * F.silu(z)
    return shard_act(linear(hout, p["down"], "embed"), ("batch", "seq", "embed"))


def _mlstm_quadratic(q, k, v, ipre, fpre):
    s = q.shape[1]
    logf = F.logsigmoid(fpre)  # (b, s, h)
    Fc = torch.cumsum(logf, dim=1)
    Dm = Fc[:, :, None, :] - Fc[:, None, :, :] + ipre[:, None, :, :]  # (b, t, i, h)
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))[None, :, :, None]
    Dm = torch.where(tri, Dm, -torch.inf)
    m = Dm.amax(dim=2)  # (b, t, h)
    w = torch.exp(Dm - m[:, :, None, :])  # (b, t, i, h)
    qk = torch.einsum("bthk,bihk->btih", q.float(), k.float())
    S = w * qk
    denom = torch.maximum(S.sum(dim=2).abs(), torch.exp(-m))  # (b, t, h)
    return torch.einsum("btih,bihk->bthk", S, v.float()) / denom[..., None]


def _apply_mlstm_chunked(p, x, cfg, Q: int):
    """Chunked parallel mLSTM: `_mlstm_chunked`'s chunks of Q rows."""
    b, s, d = x.shape
    q, k, v, ipre, fpre, z, _, inner, nh, dk = _mlstm_qkvg(p, x, cfg, d)
    hout = _per_head(functools.partial(_mlstm_chunked, Q=Q), q, k, v, ipre, fpre)
    hout = SH.pin(hout.reshape(b, s, inner)).to(x.dtype)
    hout = rms(hout)
    hout = hout * p["norm_scale"] * F.silu(z)
    return shard_act(linear(hout, p["down"], "embed"), ("batch", "seq", "embed"))


def _mlstm_chunked(q, k, v, ipre, fpre, *, Q: int):
    """The chunked form over (b, s, h, dk). Derivation mirrors the decode
    recurrence: within chunk c, D[j,i] = F_j - F_i + ipre_i; the
    inter-chunk carry is the stabilized (C, n, m) state; m_j = max(intra
    max, F_j + m_prev).

    The last chunk holds the s % Q rows left, where the JAX package pads it
    to Q rows (ipre -1e30, q, k, v zero) for its scan: the real rows' values
    are the same. Its padded rows' stabilizer falls with the forget gates
    through the padding, and past ~130 rows exp(-m) overflows; their outputs
    are cut off, but the JAX package's gradient there is 0 * inf (NaN)."""
    b, s, nh, dk = q.shape
    dev = q.device
    logf = F.logsigmoid(fpre)
    C_p = torch.zeros((b, nh, dk, dk), dtype=torch.float32, device=dev)
    n_p = torch.zeros((b, nh, dk), dtype=torch.float32, device=dev)
    m_p = torch.full((b, nh), -1e30, dtype=torch.float32, device=dev)
    hs = []
    for c0 in range(0, s, Q):
        rows = slice(c0, min(c0 + Q, s))
        qj, kj, vj = (t[:, rows].float() for t in (q, k, v))  # (b, Qc, h, dk)
        icj = ipre[:, rows]  # (b, Qc, h)
        Fj = torch.cumsum(logf[:, rows], dim=1)  # in-chunk inclusive log decay
        Qc = Fj.shape[1]
        # intra-chunk stabilizer/base quantities
        Dmj = Fj[:, :, None, :] - Fj[:, None, :, :] + icj[:, None, :, :]  # (b, j, i, h)
        tri = torch.tril(torch.ones((Qc, Qc), dtype=torch.bool, device=dev))[None, :, :, None]
        Dmj = torch.where(tri, Dmj, -torch.inf)
        m_in = Dmj.amax(dim=2)  # (b, Qc, h)
        # stabilizer: intra vs carry path
        m_j = torch.maximum(m_in, Fj + m_p[:, None, :])  # (b, Qc, h)
        w = torch.exp(Dmj - m_j[:, :, None, :])  # (b, j, i, h)
        qk = torch.einsum("bjhk,bihk->bjih", qj, kj)
        Sw = w * qk
        num = torch.einsum("bjih,bihk->bjhk", Sw, vj)
        den = Sw.sum(dim=2)  # (b, j, h)
        carry_scale = torch.exp(Fj + m_p[:, None, :] - m_j)  # (b, Qc, h)
        num = num + carry_scale[..., None] * torch.einsum("bjhk,bhkv->bjhv", qj, C_p)
        den = den + carry_scale * torch.einsum("bjhk,bhk->bjh", qj, n_p)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_j))[..., None])
        # carry update to the end of the chunk
        FQ = Fj[:, -1:, :]  # (b,1,h)
        m_end_intra = (FQ - Fj + icj).amax(dim=1)  # (b, h)
        m_new = torch.maximum(FQ[:, 0] + m_p, m_end_intra)
        wi = torch.exp(FQ - Fj + icj - m_new[:, None, :])  # (b, Qc, h)
        C_p = torch.exp(FQ[:, 0] + m_p - m_new)[:, :, None, None] * C_p + torch.einsum(
            "bih,bihk,bihv->bhkv", wi, kj, vj)
        n_p = torch.exp(FQ[:, 0] + m_p - m_new)[:, :, None] * n_p + torch.einsum(
            "bih,bihk->bhk", wi, kj)
        m_p = m_new
    return torch.cat(hs, dim=1)


def init_mlstm_cache(b: int, d: int, cfg, dtype, device="cuda"):
    inner = int(cfg.proj_factor_mlstm * d)
    nh = cfg.num_heads
    dk = inner // nh
    return {
        "C": torch.zeros((b, nh, dk, dk), dtype=torch.float32, device=device),
        "n": torch.zeros((b, nh, dk), dtype=torch.float32, device=device),
        "m": torch.full((b, nh), -1e30, dtype=torch.float32, device=device),
        "conv": torch.zeros((b, 3, inner), dtype=dtype, device=device),
    }


def _mlstm_step(q, k, v, ipre, fpre, C, n, m):
    """One token of the recurrence: q, k, v (b, h, dk) float32, ipre and
    fpre (b, h), the state (C, n, m) -> (h (b, h, dk), C, n, m)."""
    logf = F.logsigmoid(fpre)
    m_new = torch.maximum(logf + m, ipre)
    fs = torch.exp(logf + m - m_new)[..., None]
    is_ = torch.exp(ipre - m_new)[..., None]
    C = fs[..., None] * C + is_[..., None] * torch.einsum("bhk,bhv->bhkv", k, v)
    n = fs * n + is_ * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs(), torch.exp(-m_new))
    return num / den[..., None], C, n, m_new


def apply_mlstm_decode(p, x, cache, cfg):
    """Single-token decode. Returns (y, new_cache); `cache` is not written."""
    b, _, d = x.shape
    q, k, v, ipre, fpre, z, conv_state, inner, nh, dk = _mlstm_qkvg(
        p, x, cfg, d, cache["conv"])
    q, k, v = (t[:, 0].float() for t in (q, k, v))  # (b, h, dk)
    ipre, fpre = ipre[:, 0], fpre[:, 0]  # (b, h)
    args = (q, k, v, ipre, fpre, cache["C"], cache["n"], cache["m"])
    step = _mlstm_step
    if SH.is_dtensor(q):
        # each rank its own rows and heads, as in `_per_head`
        mesh, rules = SH.current_ctx()
        bx, hx = axis_spec(q.shape, ("batch", "heads", None), rules.act, SH.mesh_shape(mesh))[:2]

        def pl(t):
            return SH.placements_of((bx, hx) + (None,) * (t.dim() - 2), mesh)

        args = tuple(SH.replicated(t, mesh) for t in args)
        step = SH.local_map(_mlstm_step, out_placements=tuple(pl(t) for t in (q,) + args[5:]),
                            in_placements=tuple(pl(t) for t in args))
    hh, C, n, m_new = step(*args)
    hout = hh.reshape(b, 1, inner).to(x.dtype)
    hout = rms(hout)
    hout = hout * p["norm_scale"] * F.silu(z)
    y = linear(hout, p["down"], "embed")
    return y, {"C": C, "n": n, "m": m_new, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_tmpl(d: int, cfg):
    nh = cfg.num_heads
    hd = d // nh
    f = int(cfg.proj_factor_slstm * d)
    return {
        "W": P((d, nh, hd, 4), ("embed", "heads", "head_dim", None)),
        "R": P((nh, hd, hd, 4), ("heads", "head_dim", None, None), "small"),
        "b": P((nh, hd, 4), ("heads", "head_dim", None), "zeros"),
        "out_norm": P((d,), ("embed",), "ones"),
        "out_proj": P((d, d), ("embed", "embed")),
        "mlp_wi": P((d, f), ("embed", "mlp")),
        "mlp_wd": P((f, d), ("mlp", "embed")),
    }


def _slstm_cell(p, xt, state):
    """xt: (b, nh, hd, 4) pre-activations from the input; state (c, n, m, h)."""
    c, n, m, h = state
    pre = xt + torch.einsum("bhd,hdkf->bhkf", h, p["R"]) + p["b"]
    zt = torch.tanh(pre[..., 0])
    it = pre[..., 1].float()
    logf = F.logsigmoid(pre[..., 2].float())
    ot = torch.sigmoid(pre[..., 3])
    m_new = torch.maximum(logf + m, it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s * c + i_s * zt.float()
    n_new = f_s * n + i_s
    h_new = (ot.float() * c_new / torch.clamp(n_new, min=1e-6)).to(zt.dtype)
    return c_new, n_new, m_new, h_new


def _slstm_loop(xw, R, bias, *state):
    """The recurrence over xw (b, s, nh, hd, 4) from `state`: (the hidden
    states (b, s, nh, hd), c, n, m, h)."""
    p = {"R": R, "b": bias}
    hs = []
    for t in range(xw.shape[1]):
        state = _slstm_cell(p, xw[:, t], state)
        hs.append(state[3])
    return (torch.stack(hs, dim=1),) + tuple(state)


def _slstm_steps(xw, R, bias, state):
    """`_slstm_loop` as (hidden states, state); on a mesh each rank steps
    through its own batch rows and heads (`local_map`: the recurrence is
    independent per sequence and per head, R being block-diagonal), where
    DTensor would dispatch every op of every step."""
    if not SH.is_dtensor(xw):
        out = _slstm_loop(xw, R, bias, *state)
        return out[0], out[1:]
    mesh, rules = SH.current_ctx()
    bx, _, hx = axis_spec(xw.shape, ("batch", None, "heads", None, None), rules.act,
                          SH.mesh_shape(mesh))[:3]
    pst = SH.placements_of((bx, hx, None), mesh)
    loop = SH.local_map(_slstm_loop,
                        out_placements=(SH.placements_of((bx, None, hx, None), mesh),) + (pst,) * 4,
                        in_placements=(SH.placements_of((bx, None, hx, None, None), mesh),
                                       SH.placements_of((hx, None, None, None), mesh),
                                       SH.placements_of((hx, None, None), mesh)) + (pst,) * 4)
    out = loop(xw, *(SH.replicated(t, mesh) for t in (R, bias) + tuple(state)))
    return out[0], out[1:]


def init_slstm_state(b: int, d: int, cfg, dtype, device="cuda"):
    nh = cfg.num_heads
    hd = d // nh
    return (
        torch.zeros((b, nh, hd), dtype=torch.float32, device=device),
        torch.zeros((b, nh, hd), dtype=torch.float32, device=device),
        torch.full((b, nh, hd), -1e30, dtype=torch.float32, device=device),
        torch.zeros((b, nh, hd), dtype=dtype, device=device),
    )


def apply_slstm(p, x, cfg, state=None):
    """x: (b, s, d). A loop over time (true recurrence). Returns (y, state)."""
    b, s, d = x.shape
    x = gather_seq(x)  # the loop steps through the whole sequence
    if state is None:
        state = init_slstm_state(b, d, cfg, x.dtype, x.device)
    xw = contract("bsd,dhkf->bshkf", x, p["W"], 1,
                  ("batch", None, "heads", None, None))  # f = 4 gates
    hs, state = _slstm_steps(xw, p["R"], p["b"], state)
    h = SH.pin(hs.reshape(b, s, d))
    h = rms(h)
    h = linear(h * p["out_norm"], p["out_proj"], "embed")
    # jax.nn.gelu's default is the tanh approximation
    h = h + linear(F.gelu(linear(h, p["mlp_wi"], "mlp"), approximate="tanh"), p["mlp_wd"],
                   "embed")
    return shard_act(h, ("batch", "seq", "embed")), state


def apply_slstm_decode(p, x, cfg, state):
    return apply_slstm(p, x, cfg, state)
