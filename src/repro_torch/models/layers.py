"""Shared transformer layers: norms, RoPE, GQA/SWA/cross attention, MLPs.

Functional style: parameters are plain trees declared by `*_tmpl` template
functions (see params.py) and consumed by `apply_*` functions. Activation
sharding is constrained through repro_torch.dist.sharding.shard_act (the
identity outside a mesh context; on a mesh the tensors are DTensors).

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

from ..dist.sharding import (constrain, current_ctx, is_dtensor, local_map, merge_lead,
                             mesh_shape, pin, placements_of, replicated, shard_act, spec_of,
                             split_lead)
from .params import P, axis_spec


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


def rms(x, eps: float = 1e-5):
    """RMS normalization without a scale, taken in float32 and returned in
    x's dtype (the xLSTM and Mamba2 blocks' inner norms)."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)).to(x.dtype)


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


def _attention(fn, q, k, v, *batched, **kw):
    """fn(q, k, v, *batched, **kw): an attention over q (b, sq, h, hd) and
    k/v (b, sk, kv, hd), `batched` tensors (a mask, positions) leading with
    the batch dim (or 1). On a mesh each rank attends over its own batch
    rows and heads (`local_map`): attention is independent per sequence and
    per head, so the head-parallel split needs no communication. The heads
    stay whole where q's heads and k/v's kv_heads cannot split alike."""
    if not is_dtensor(q):
        return fn(q, k, v, *batched, **kw)
    mesh, rules = current_ctx()
    sizes = mesh_shape(mesh)
    b = q.shape[0]
    qs = axis_spec(q.shape, ("batch", None, "heads", None), rules.act, sizes)
    ks = axis_spec(k.shape, ("batch", None, "kv_heads", None), rules.act, sizes)
    if qs[2] != ks[2]:
        qs = ks = (qs[0], None, None, None)
    extra = [(qs[0] if t.shape[0] == b else None,) + (None,) * (t.dim() - 1) for t in batched]
    pq, pk = placements_of(qs, mesh), placements_of(ks, mesh)
    attend = local_map(lambda *a: (fn(*a, **kw),), out_placements=(pq,),
                       in_placements=(pq, pk, pk) + tuple(placements_of(e, mesh) for e in extra))
    return attend(q, k, v, *(replicated(t, mesh) for t in batched))[0]


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


def contract(eq: str, x, w, n_in: int, out_axes: tuple):
    """torch.einsum(eq, x, w) where x's last `n_in` dims contract with w's
    first `n_in`. On a mesh: one matmul of the flattened leading,
    contracted and output dims, its output constrained to the logical
    `out_axes` (one per output dim) before it unflattens. DTensor's own
    einsum may split a flattened dim where its parts cannot split (heads
    that do not divide the model axis), or reach a strided placement whose
    propagation costs seconds an op on a 3-D mesh. A sequence-sharded `x`
    contracts on each rank's shards instead (`_contract_local`)."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return torch.einsum(eq, x, w)
    lead, inner, tail = x.shape[:-n_in], w.shape[:n_in], w.shape[n_in:]
    if seq_sharded(x, len(lead)):
        return _contract_local(x, w, n_in)
    mesh, rules = current_ctx()
    spec = axis_spec(tuple(lead) + tuple(tail), out_axes, rules.act, mesh_shape(mesh))

    def merged(sp):  # a flattened dim keeps its outermost part's sharding alone
        return sp[0] if all(a is None for a in sp[1:]) else None

    x2 = pin(merge_lead(x, len(lead)).reshape(-1, math.prod(inner)))
    y = x2 @ pin(replicated(w, mesh).reshape(math.prod(inner), math.prod(tail)))
    y = constrain(y, (merged(spec[:len(lead)]), merged(spec[len(lead):])))
    return split_lead(y.reshape((y.shape[0],) + tuple(tail)), lead)


def seq_sharded(x, n_lead: int = 2) -> bool:
    """Whether `x` is a DTensor sharded along one of its `n_lead` leading
    dims after the first: an activation (b, s, ...) whose sequence is split
    (`seq_shard`)."""
    return is_dtensor(x) and any(p.is_shard() and 0 < p.dim < n_lead for p in x.placements)


def _contract_local(x, w, n_in: int):
    """`contract` of a sequence-sharded `x`, on each rank's local shards:
    x keeps its leading dims' sharding and has its contracted dims whole;
    `w` (flattened to (prod(inner), prod(tail))) is gathered over the mesh
    dims that split x, and keeps its output dim's sharding on the others.
    Flattening (batch, seq) on the mesh would make a strided shard, whose
    sharding propagation costs tens of seconds an op on a 3-D mesh and
    which a view in the backward cannot take. The output leads with x's
    dims, sharded as they were, then w's (their first split where w's
    output dim was)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    n_lead = x.dim() - n_in
    w = replicated(w, mesh)
    inner, tail = tuple(w.shape[:n_in]), tuple(w.shape[n_in:])
    w2 = w.reshape(math.prod(inner), math.prod(tail))
    xp, wp, op = [], [], []
    for px, pw in zip(x.placements, w2.placements):
        if px.is_shard() and px.dim < n_lead:
            xp.append(px), wp.append(Replicate()), op.append(Shard(px.dim))
        elif pw.is_shard(1):
            xp.append(Replicate()), wp.append(pw), op.append(Shard(n_lead))
        else:
            for acc in (xp, wp, op):
                acc.append(Replicate())

    def mm(a, b):
        lead = a.shape[:n_lead]
        y = a.reshape(math.prod(lead), -1) @ b
        return (y.reshape(lead + (-1,) + tail[1:]),)

    return local_map(mm, out_placements=(tuple(op),),
                     in_placements=(tuple(xp), tuple(wp)))(x, w2)[0]


def gather_seq(x):
    """`x` (b, s, ...) with its sequence whole on every rank, its other dims
    as they were (and its gradient so): a recurrence or a scan over the
    sequence reads all of it. `x` itself where the sequence is not split."""
    if not seq_sharded(x):
        return x
    spec = spec_of(x.placements, x.device_mesh, x.dim())
    return constrain(x, (spec[0], None) + spec[2:])


def linear(x, w, out_axis: str | None):
    """x @ w of an activation x (b, s, d) and a weight w (d, f), f the
    logical `out_axis`. On a mesh it is a `contract`: DTensor's own matmul
    of a 3-D activation may split the rows where f does not divide and
    unflatten them into a strided shard."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    return contract("...d,df->...f", x, w, 1, ("batch",) + (None,) * (x.dim() - 2) + (out_axis,))


def proj_heads(x, w, head_axis: str = "heads"):
    """einsum("bsd,dhk->bshk", x, w): a projection into heads."""
    return contract("bsd,dhk->bshk", x, w, 1, ("batch", None, head_axis, None))


def proj_out(x, w):
    """einsum("bshk,hkd->bsd", x, w): the heads' output projection."""
    return contract("bshk,hkd->bsd", x, w, 2, ("batch", None, "embed"))


def _qkv(p, x):
    return (proj_heads(x, p["wq"]), proj_heads(x, p["wk"], "kv_heads"),
            proj_heads(x, p["wv"], "kv_heads"))


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
        out = _attention(_blockwise_sdpa, q, k, v, positions, n_rep=n_rep, causal=causal,
                         window=window)
    else:
        qp = positions[:, :, None]
        kp = positions[:, None, :]
        mask = torch.ones((b, s, s), dtype=torch.bool, device=x.device) if not causal \
            else (kp <= qp)
        if window is not None:
            mask = mask & (kp > qp - window)
        out = _attention(_sdpa, q, k, v, mask[:, None], n_rep=n_rep)
    y = proj_out(out, p["wo"])
    return shard_act(y, ("batch", "seq", "embed"))


def apply_cross_attn(p, x, kv_src, *, n_kv: int):
    """Cross attention: queries from x (b,s,d), keys/values from kv_src
    (b, t, d) (encoder frames / vision patches). No RoPE, no mask."""
    n_heads = p["wq"].shape[1]
    n_rep = n_heads // n_kv
    q = proj_heads(x, p["wq"])
    k = proj_heads(kv_src, p["wk"], "kv_heads")
    v = proj_heads(kv_src, p["wv"], "kv_heads")
    mask = torch.ones((x.shape[0], 1, x.shape[1], kv_src.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _attention(_sdpa, q, k, v, mask, n_rep=n_rep)
    return proj_out(out, p["wo"])


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
    # The decode attention's layout must match the cache's, or every step
    # regathers the whole KV cache. When kv_heads divides the model axis the
    # cache is head-sharded and head-parallel attention is free; otherwise
    # pin everything batch-only (redundant model-axis compute is negligible
    # at one token a step).
    ctx = current_ctx()
    head_parallel = ctx is None or n_kv % mesh_shape(ctx[0]).get("model", 1) == 0
    if not head_parallel:
        q = shard_act(q, ("batch", None, None, None))
        k = shard_act(k, ("batch", None, None, None))
        v = shard_act(v, ("batch", None, None, None))
    posv = pos_vec[:, None]
    if theta is not None:
        q = rope(q, posv, theta)
        k = rope(k, posv, theta)  # absolute-position RoPE at insert time
    slot = torch.remainder(pos_vec, W).long()  # (b,) per-sequence ring slot
    if is_dtensor(ck):
        _cache_write_sharded(ck, cv, k, v, slot)
    else:
        _cache_write(ck, cv, k, v, slot)
    # slot i holds timestep t_i = pos - ((pos - i) mod W); valid iff t_i >= 0
    i = torch.arange(W, dtype=torch.int32, device=x.device)
    t_i = pos_vec[:, None] - torch.remainder(pos_vec[:, None] - i[None, :], W)
    mask = (t_i >= 0)[:, None, None, :]
    out = _attention(_sdpa, q, ck, cv, mask, n_rep=n_rep)
    if not head_parallel:
        # keep the AV product batch-sharded too, or wo's head sharding
        # regathers the V cache
        out = shard_act(out, ("batch", None, None, None))
    return proj_out(out, p["wo"])


def _cache_write(ck, cv, k, v, slot):
    """Write each sequence's new key and value (b, 1, kv, hd) into its ring
    slot of `ck`/`cv` (b, W, kv, hd), in place."""
    bidx = torch.arange(ck.shape[0], device=ck.device)
    ck[bidx, slot] = k[:, 0].to(ck.dtype)
    cv[bidx, slot] = v[:, 0].to(cv.dtype)
    return ck, cv


def _cache_write_sharded(ck, cv, k, v, slot):
    """`_cache_write` on a mesh: each rank writes its own rows and heads of
    the cache DTensors in place; k and v take the cache's sharding, the
    slots its batch sharding."""
    from torch.distributed.tensor import Replicate

    mesh, pl = ck.device_mesh, tuple(ck.placements)
    slot_pl = tuple(p if p.is_shard(0) else Replicate() for p in pl)
    write = local_map(_cache_write, out_placements=(pl, pl),
                      in_placements=(pl, pl, pl, pl, slot_pl))
    write(ck, cv, k, v, replicated(slot, mesh))


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
        h = F.silu(linear(x, p["wg"], "mlp")) * linear(x, p["wu"], "mlp")
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(linear(x, p["wi"], "mlp"), approximate="tanh")
    h = shard_act(h, ("batch", "seq", "mlp"))
    return shard_act(linear(h, p["wd"], "embed"), ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def embed_tmpl(v: int, d: int):
    return {"table": P((v, d), ("vocab", "embed"), "embed", scale=0.02)}


def head_tmpl(d: int, v: int):
    return {"w": P((d, v), ("embed", "vocab"))}


def sinusoidal_positions(max_len: int, d: int, device=None):
    return sinusoidal_at(torch.arange(max_len, device=device), d)


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
