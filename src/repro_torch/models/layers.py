"""Shared transformer layers: norms, RoPE, GQA/SWA/cross attention, MLPs.

Functional style: parameters are plain trees declared by `*_tmpl` template
functions (see params.py) and consumed by `apply_*` functions. Activation
sharding is constrained through repro_torch.dist.sharding.shard_act (the
identity outside a mesh context).

Attention is plain torch ops in the JAX package's order: scores in float32,
masked with -1e30, a float32 softmax, and the weights cast back to the
values' dtype.

Attention decode uses a ring-buffer KV cache of capacity W: slot = pos % W.
With W = max_len this is a dense cache; with W = sliding_window it is the
O(window) cache of SWA archs (DESIGN.md §5). RoPE is applied at insert time
with absolute positions, so ring wrap-around needs no re-rotation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist.sharding import shard_act
from .params import P


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_tmpl(kind: str, d: int):
    if kind == "rmsnorm":
        return {"scale": P((d,), ("embed",), "ones")}
    if kind == "layernorm":
        return {"scale": P((d,), ("embed",), "ones"), "bias": P((d,), ("embed",), "zeros")}
    if kind == "nonparam_ln":  # OLMo: non-parametric LayerNorm
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, p, x, eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (self, GQA, optional sliding window; cross)
# ---------------------------------------------------------------------------
def attn_tmpl(d: int, n_heads: int, n_kv: int, hd: int):
    return {
        "wq": P((d, n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, n_kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, n_kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((n_heads, hd, d), ("heads", "head_dim", "embed")),
    }


def _sdpa(q, k, v, mask, n_rep: int):
    """q: (b, sq, h, hd); k/v: (b, sk, kv, hd); mask broadcast (b, 1, sq, sk)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(b, sq, kv, n_rep, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q, k).float()
    scores = shard_act(scores, ("batch", "kv_heads", None, "seq", None))
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, :, None] if mask.dim() == 4 else mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v)
    return out.reshape(b, sq, h, hd)


BLOCKWISE_SEQ_THRESHOLD = 2048  # above this, use online-softmax chunking
BLOCKWISE_KV_CHUNK = 1024


def _blockwise_sdpa(q, k, v, positions, *, n_rep, causal, window,
                    kv_chunk=BLOCKWISE_KV_CHUNK):
    """Flash-style attention: a loop over KV chunks with a running
    (max, denom, acc) online softmax. Peak score memory is
    (b, heads, s_q, kv_chunk) instead of (b, heads, s_q, s_kv)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    sk = k.shape[1]
    pad = -sk % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = k.shape[1] // kv_chunk
    qg = q.reshape(b, sq, kvh, n_rep, hd)
    qpos = positions  # (b, sq)
    scale = 1.0 / math.sqrt(hd)
    m = shard_act(torch.full((b, kvh, n_rep, sq), -1e30, dtype=torch.float32, device=q.device),
                  ("batch", "kv_heads", None, "seq"))
    l = shard_act(torch.zeros((b, kvh, n_rep, sq), dtype=torch.float32, device=q.device),
                  ("batch", "kv_heads", None, "seq"))
    acc = shard_act(torch.zeros((b, kvh, n_rep, sq, hd), dtype=torch.float32, device=q.device),
                    ("batch", "kv_heads", None, "seq", None))
    for ci in range(n_chunks):
        kb = k[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        vb = v[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        kpos = ci * kv_chunk + torch.arange(kv_chunk, dtype=torch.int32, device=q.device)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb).float() * scale
        s = shard_act(s, ("batch", "kv_heads", None, "seq", None))
        kp = kpos[None, None, None, None, :]
        mask = kp < sk  # padding
        if causal:
            mask = mask & (kp <= qpos[:, None, None, :, None])
        if window is not None:
            mask = mask & (kp > qpos[:, None, None, :, None] - window)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p_ = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p_.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p_.to(vb.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def _qkv(p, x):
    return (torch.einsum("bsd,dhk->bshk", x, p["wq"]),
            torch.einsum("bsd,dhk->bshk", x, p["wk"]),
            torch.einsum("bsd,dhk->bshk", x, p["wv"]))


def apply_self_attn(p, x, *, n_kv: int, theta: float, window: int | None = None,
                    causal: bool = True, positions=None):
    """Training/prefill path. x: (b, s, d). Sequences past
    BLOCKWISE_SEQ_THRESHOLD use the online-softmax chunked path."""
    b, s, d = x.shape
    n_heads = p["wq"].shape[1]
    n_rep = n_heads // n_kv
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    q, k, v = _qkv(p, x)
    q = shard_act(q, ("batch", "seq", "heads", None))
    k = shard_act(k, ("batch", "seq", "kv_heads", None))
    if theta is not None:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    if s > BLOCKWISE_SEQ_THRESHOLD:
        out = _blockwise_sdpa(q, k, v, positions, n_rep=n_rep, causal=causal, window=window)
    else:
        qp = positions[:, :, None]
        kp = positions[:, None, :]
        mask = torch.ones((b, s, s), dtype=torch.bool, device=x.device) if not causal \
            else (kp <= qp)
        if window is not None:
            mask = mask & (kp > qp - window)
        out = _sdpa(q, k, v, mask[:, None], n_rep)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return shard_act(y, ("batch", "seq", "embed"))


def apply_cross_attn(p, x, kv_src, *, n_kv: int):
    """Cross attention: queries from x (b,s,d), keys/values from kv_src
    (b, t, d) (encoder frames / vision patches). No RoPE, no mask."""
    n_heads = p["wq"].shape[1]
    n_rep = n_heads // n_kv
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", kv_src, p["wk"])
    v = torch.einsum("btd,dhk->bthk", kv_src, p["wv"])
    mask = torch.ones((x.shape[0], 1, x.shape[1], kv_src.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _sdpa(q, k, v, mask, n_rep)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def init_kv_cache(b: int, w: int, n_kv: int, hd: int, dtype, device="cuda"):
    return {
        "k": torch.zeros((b, w, n_kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((b, w, n_kv, hd), dtype=dtype, device=device),
    }


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """A scalar or (b,) position as an int32 (b,) tensor on `device`."""
    return torch.as_tensor(pos, dtype=torch.int32, device=device).expand(b).contiguous()


def self_attn_decode_into(p, x, ck, cv, pos, *, n_kv: int, theta: float):
    """`apply_self_attn_decode` writing the new key and value into the
    caller's ring buffers `ck`/`cv` (b, W, kv, hd) in place; returns y.
    decode_step gives it its own copy of the stacked cache, so the caller's
    cache is never written."""
    b = x.shape[0]
    pos_vec = _pos_vector(pos, b, x.device)
    n_heads = p["wq"].shape[1]
    n_rep = n_heads // n_kv
    W = ck.shape[1]
    q, k, v = _qkv(p, x)
    # the JAX package pins q, k and v batch-only under a mesh whose model
    # axis kv_heads does not divide; under any mesh shard_act raises here
    # (in _sdpa) until dist/ is ported
    posv = pos_vec[:, None]
    if theta is not None:
        q = rope(q, posv, theta)
        k = rope(k, posv, theta)  # absolute-position RoPE at insert time
    slot = torch.remainder(pos_vec, W).long()  # (b,) per-sequence ring slot
    bidx = torch.arange(b, device=x.device)
    ck[bidx, slot] = k[:, 0].to(ck.dtype)
    cv[bidx, slot] = v[:, 0].to(cv.dtype)
    # slot i holds timestep t_i = pos - ((pos - i) mod W); valid iff t_i >= 0
    i = torch.arange(W, dtype=torch.int32, device=x.device)
    t_i = pos_vec[:, None] - torch.remainder(pos_vec[:, None] - i[None, :], W)
    mask = (t_i >= 0)[:, None, None, :]
    out = _sdpa(q, ck, cv, mask, n_rep)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def apply_self_attn_decode(p, x, cache, pos, *, n_kv: int, theta: float):
    """Single-token decode with ring-buffer cache. x: (b, 1, d); pos is a
    scalar int (slot-synchronous decode) or an int32 (b,) vector
    (continuous batching: every sequence at its own position).
    Returns (y, new_cache); `cache` itself is left as it was."""
    ck, cv = cache["k"].clone(), cache["v"].clone()
    y = self_attn_decode_into(p, x, ck, cv, pos, n_kv=n_kv, theta=theta)
    return y, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_tmpl(kind: str, d: int, f: int):
    if kind == "swiglu":
        return {
            "wg": P((d, f), ("embed", "mlp")),
            "wu": P((d, f), ("embed", "mlp")),
            "wd": P((f, d), ("mlp", "embed")),
        }
    return {"wi": P((d, f), ("embed", "mlp")), "wd": P((f, d), ("mlp", "embed"))}


def apply_mlp(kind: str, p, x):
    if kind == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    h = shard_act(h, ("batch", "seq", "mlp"))
    return shard_act(h @ p["wd"], ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def embed_tmpl(v: int, d: int):
    return {"table": P((v, d), ("vocab", "embed"), "embed", scale=0.02)}


def head_tmpl(d: int, v: int):
    return {"w": P((d, v), ("embed", "vocab"))}


def sinusoidal_positions(max_len: int, d: int):
    return sinusoidal_at(torch.arange(max_len), d)


def sinusoidal_at(positions: torch.Tensor, d: int):
    """Sinusoidal embedding rows for arbitrary positions.
    positions: (...,) int -> (..., d) f32."""
    pos = positions.float()[..., None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    out = torch.zeros(tuple(positions.shape) + (d,), dtype=torch.float32,
                      device=positions.device)
    out[..., 0::2] = torch.sin(ang)
    out[..., 1::2] = torch.cos(ang[..., : d // 2])
    return out
