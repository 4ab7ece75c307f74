"""Mamba2 (SSD) block — chunked parallel form for train/prefill, recurrent
state update for decode (zamba2 family).

The chunked SSD algorithm splits the sequence into chunks of Q steps:
intra-chunk contributions are a masked (decay-weighted) attention-like
quadratic form, inter-chunk state is carried by a short scan over chunks.
Decode keeps (conv window, SSM state) only — O(1) per token.

Simplifications vs the released model (the JAX package's): single B/C group
(ngroups=1), no dt/A/D per-group structure beyond per-head scalars.

One difference from the JAX package, in the gradient only: the intra-chunk
decay is exp(where(tri, L_j - L_i, -inf)), masked before the exponent. The
JAX package takes exp(L_j - L_i) first and masks after; above the diagonal
L_j - L_i is positive and can pass float32's exp limit (~88.7, reached at
chunk 128 with dt near 0.7), so its backward multiplies 0 by inf. Both
give the same forward values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.sharding import (current_ctx, is_dtensor, local_map, mesh_shape, placements_of,
                             shard_act)
from .layers import gather_seq, linear, rms
from .params import P, axis_spec


def ssm_tmpl(d: int, cfg):
    inner = cfg.expand * d
    nheads = inner // cfg.head_dim
    n = cfg.state_dim
    conv_ch = inner + 2 * n
    return {
        "in_proj": P((d, 2 * inner + 2 * n + nheads), ("embed", "inner")),
        "conv_w": P((cfg.conv_width, conv_ch), ("conv", "inner")),
        "conv_b": P((conv_ch,), ("inner",), "zeros"),
        "A_log": P((nheads,), (None,), "zeros"),
        "D": P((nheads,), (None,), "ones"),
        "dt_bias": P((nheads,), (None,), "zeros"),
        "norm_scale": P((inner,), ("inner",), "ones"),
        "out_proj": P((inner, d), ("inner", "embed")),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv followed by SiLU. x: (b, s, c); w: (k, c). If
    state (b, k-1, c) is given, runs in streaming mode and returns
    (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([state, x], dim=1)
    ys = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    y = F.silu(ys + b)
    if state is None:
        return y
    return y, xp[:, -(k - 1):, :]


def _split(p, x, cfg, d):
    inner = cfg.expand * d
    n = cfg.state_dim
    nheads = inner // cfg.head_dim
    zxbcdt = linear(x, p["in_proj"], "inner")
    z = zxbcdt[..., :inner]
    xbc = zxbcdt[..., inner:inner + inner + 2 * n]
    dt = zxbcdt[..., -nheads:]
    return z, xbc, dt, inner, n, nheads


def _gated_norm_out(p, y, z):
    """Gated RMSNorm then the out projection."""
    return linear(rms(y * F.silu(z)) * p["norm_scale"], p["out_proj"], "embed")


def apply_ssm(p, x, cfg):
    """Training/prefill. x: (b, s, d) -> (b, s, d)."""
    b, s, d = x.shape
    x = gather_seq(x)  # the conv and the scan run along the whole sequence
    z, xbc, dt, inner, n, nheads = _split(p, x, cfg, d)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :inner]
    B = xbc[..., inner:inner + n]
    C = xbc[..., inner + n:]
    hdim = cfg.head_dim
    Q = min(cfg.chunk, s)
    if s % Q:
        raise ValueError(f"seq {s} not divisible by chunk {Q}")
    dt = F.softplus(dt + p["dt_bias"]).float()  # (b, s, h)
    A = -torch.exp(p["A_log"].float())  # (h,)
    dA = dt * A  # log-decay per step, (b, s, h)
    u = xs.reshape(b, s, nheads, hdim).float() * dt[..., None]
    y = _scan(dA, u, B, C, Q)
    xs_h = xs.reshape(b, s, nheads, hdim).float()
    y = y + p["D"].float()[None, None, :, None] * xs_h
    y = y.reshape(b, s, inner).to(x.dtype)
    out = _gated_norm_out(p, y, z)
    return shard_act(out, ("batch", "seq", "embed"))


def _scan(dA, u, B, C, Q: int):
    """The chunked SSD scan: dA (b, s, h) log decays, u (b, s, h, p) inputs,
    B and C (b, s, n) -> y (b, s, h, p) float32. On a mesh each rank scans
    its own sequences (`local_map`, heads whole: the scan is independent
    per sequence, and B and C are shared by every head)."""
    if not is_dtensor(u):
        return _scan_local(dA, u, B, C, Q)
    mesh, rules = current_ctx()
    bx = axis_spec(u.shape, ("batch", None, None, None), rules.act, mesh_shape(mesh))[0]

    def pl(t):
        return placements_of((bx,) + (None,) * (t.dim() - 1), mesh)

    scan = local_map(lambda *a: (_scan_local(*a, Q),), out_placements=(pl(u),),
                     in_placements=(pl(dA), pl(u), pl(B), pl(C)))
    return scan(dA, u, B, C)[0]


def _scan_local(dA, u, B, C, Q: int):
    b, s, nheads, hdim = u.shape
    n = B.shape[-1]
    nc = s // Q
    # chunked views
    dA_c = dA.reshape(b, nc, Q, nheads)
    u_c = u.reshape(b, nc, Q, nheads, hdim)
    B_c = B.reshape(b, nc, Q, n).float()
    C_c = C.reshape(b, nc, Q, n).float()
    L = torch.cumsum(dA_c, dim=2)  # (b, nc, Q, h) inclusive log decay

    # intra-chunk: Y[j] = sum_{i<=j} exp(L_j - L_i) (C_j . B_i) u_i
    seg = L[:, :, :, None, :] - L[:, :, None, :, :]  # (b,nc,j,i,h)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    M = torch.exp(torch.where(tri[None, None, :, :, None], seg, -torch.inf))
    CB = torch.einsum("bcjn,bcin->bcji", C_c, B_c)  # (b,nc,Q,Q)
    W = CB[..., None] * M  # (b,nc,j,i,h)
    W = shard_act(W, ("batch", None, None, None, "heads"))
    y_intra = torch.einsum("bcjih,bcihp->bcjhp", W, u_c)
    y_intra = shard_act(y_intra, ("batch", None, None, "heads", None))

    # chunk-end states: S_c = sum_i exp(L_Q - L_i) u_i B_i^T  (h,p,n)
    decay_to_end = torch.exp(L[:, :, -1:, :] - L)  # (b,nc,Q,h)
    S = torch.einsum("bcih,bcihp,bcin->bchpn", decay_to_end, u_c, B_c)
    S = shard_act(S, ("batch", None, "heads", None, None))

    # inter-chunk scan: H_{c+1} = exp(L_Q^c) H_c + S_c; H_starts[c] is the
    # state at chunk c's start
    a_chunk = torch.exp(L[:, :, -1, :])  # (b,nc,h)
    H = torch.zeros((b, nheads, hdim, n), dtype=torch.float32, device=u.device)
    starts = []
    for c in range(nc):
        starts.append(H)
        H = a_chunk[:, c, :, None, None] * H + S[:, c]
    H_starts = torch.stack(starts, dim=1)  # (b, nc, h, p, n)

    # inter contribution: Y[j] += C_j . (exp(L_j) H_start)
    H_starts = shard_act(H_starts, ("batch", None, "heads", None, None))
    y_inter = torch.einsum("bcjn,bcjh,bchpn->bcjhp", C_c, torch.exp(L), H_starts)
    return (y_intra + y_inter).reshape(b, s, nheads, hdim)


def init_ssm_cache(b: int, d: int, cfg, dtype, device="cuda"):
    inner = cfg.expand * d
    n = cfg.state_dim
    nheads = inner // cfg.head_dim
    conv_ch = inner + 2 * n
    return {
        "conv": torch.zeros((b, cfg.conv_width - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros((b, nheads, cfg.head_dim, n), dtype=torch.float32, device=device),
    }


def apply_ssm_decode(p, x, cache, cfg):
    """Single-token decode. x: (b, 1, d). Returns (y, new_cache); `cache`
    is not written."""
    b, _, d = x.shape
    z, xbc, dt, inner, n, nheads = _split(p, x, cfg, d)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], cache["conv"])
    xs = xbc[..., :inner]
    B = xbc[:, 0, inner:inner + n].float()  # (b, n)
    C = xbc[:, 0, inner + n:].float()
    hdim = cfg.head_dim
    dt = F.softplus(dt + p["dt_bias"])[:, 0].float()  # (b, h)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A)  # (b, h)
    u = xs.reshape(b, nheads, hdim).float() * dt[..., None]
    H = cache["ssm"] * a[:, :, None, None] + torch.einsum("bhp,bn->bhpn", u, B)
    y = torch.einsum("bhpn,bn->bhp", H, C)
    y = y + p["D"].float()[None, :, None] * xs.reshape(b, nheads, hdim)
    y = y.reshape(b, 1, inner).to(x.dtype)
    return _gated_norm_out(p, y, z), {"conv": conv_state, "ssm": H}
