"""Model assembly behind one API, on PyTorch tensors.

    template(cfg)                        parameter template (P leaves)
    init_params(cfg, generator, dtype, device)   real parameters
    num_params(cfg)                      parameter count
    forward(cfg, params, batch, remat)   (logits, aux_loss)   [train / prefill]
    loss_fn(cfg, params, batch, remat)   (loss, {"ce", "aux"})   [train]
    cache_shapes(cfg, b, w, dtype)       decode-cache TensorSpecs
    init_cache(cfg, params, b, w, batch, dtype)   zero cache, cross K/V filled
    decode_step(cfg, params, cache, token, pos)   (logits, new_cache)

Every family of the JAX package runs: dense, MoE, the xLSTM pairs, the
zamba2 hybrid (groups of Mamba2 layers, each followed by one shared
attention block), the vision family (self-attention groups closed by a
gated cross-attention layer over stub patch embeddings) and the audio
encoder-decoder (stub frame embeddings, sinusoidal positions). Stacked
layers run as a Python loop over views of the stacked tensors: `forward`
takes them with one `unbind` per leaf (both levels of the hybrid's stack of
stacks), whose backward stacks the layers' gradients once (indexing each
layer would make every layer's backward write a zero tensor the size of the
whole stacked leaf); the shared block's gradient is the sum over its uses.
`forward` records autograd history where its inputs ask for it, with each
scan body of the JAX package (a layer, a pair or a group) recomputed in the
backward (`remat=True`) or with its matmul outputs kept (`remat="dots"`);
`decode_step` records none.

decode_step never writes the cache it is given: it copies a stacked KV
cache once and writes each layer's new key and value into the copy, and it
stacks the recurrent states' new tensors once. A step that fails part-way
therefore leaves the caller's cache as it was (the serve engine keeps the
old cache and retries).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..configs.base import ArchConfig
from ..dist import sharding as SH
from ..dist.sharding import shard_act
from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from . import xlstm as XL
from .params import P, count_params, init_from_template, map_leaves, stack


# ===========================================================================
# Templates
# ===========================================================================
def _attn_layer_tmpl(cfg: ArchConfig):
    d = cfg.d_model
    t = {
        "ln1": L.norm_tmpl(cfg.norm, d),
        "attn": L.attn_tmpl(d, cfg.num_heads, cfg.num_kv_heads, cfg.hd),
        "ln2": L.norm_tmpl(cfg.norm, d),
    }
    if cfg.moe is not None:
        t["moe"] = MOE.moe_tmpl(d, cfg.moe)
    else:
        t["mlp"] = L.mlp_tmpl(cfg.act, d, cfg.d_ff)
    return t


def _cross_layer_tmpl(cfg: ArchConfig):
    d = cfg.d_model
    return {
        "ln1": L.norm_tmpl(cfg.norm, d),
        "xattn": L.attn_tmpl(d, cfg.num_heads, cfg.num_kv_heads, cfg.hd),
        "gate_attn": P((1,), (None,), "zeros"),
        "ln2": L.norm_tmpl(cfg.norm, d),
        "mlp": L.mlp_tmpl(cfg.act, d, cfg.d_ff),
        "gate_mlp": P((1,), (None,), "zeros"),
    }


def _encdec_dec_layer_tmpl(cfg: ArchConfig):
    d = cfg.d_model
    return {
        "ln1": L.norm_tmpl(cfg.norm, d),
        "attn": L.attn_tmpl(d, cfg.num_heads, cfg.num_kv_heads, cfg.hd),
        "ln2": L.norm_tmpl(cfg.norm, d),
        "xattn": L.attn_tmpl(d, cfg.num_heads, cfg.num_kv_heads, cfg.hd),
        "ln3": L.norm_tmpl(cfg.norm, d),
        "mlp": L.mlp_tmpl(cfg.act, d, cfg.d_ff),
    }


def template(cfg: ArchConfig):
    d, V = cfg.d_model, cfg.padded_vocab
    t: dict[str, Any] = {"embed": L.embed_tmpl(V, d), "ln_f": L.norm_tmpl(cfg.norm, d)}
    if not cfg.tie_embeddings:
        t["head"] = L.head_tmpl(d, V)

    fam = cfg.family
    if fam in ("dense", "moe"):
        t["layers"] = stack(_attn_layer_tmpl(cfg), cfg.num_layers)
    elif fam == "ssm" and cfg.xlstm is not None:  # xLSTM
        pair = {"mlstm": XL.mlstm_tmpl(d, cfg.xlstm), "slstm": XL.slstm_tmpl(d, cfg.xlstm)}
        t["pairs"] = stack(pair, _n_pairs(cfg))
    elif fam == "hybrid":  # zamba2: mamba groups + one shared attn block
        group = stack(SSM.ssm_tmpl(d, cfg.ssm), cfg.shared_attn_every)
        t["groups"] = stack(group, _n_groups(cfg))
        t["shared_attn"] = _attn_layer_tmpl(cfg)  # single copy, reused per group
    elif fam == "vlm":
        group = {
            "self": stack(_attn_layer_tmpl(cfg), cfg.cross_attn_every - 1),
            "cross": _cross_layer_tmpl(cfg),
        }
        t["groups"] = stack(group, _n_groups(cfg))
    elif fam == "audio":  # whisper backbone: enc self-attn + dec self/cross
        enc_cfg = cfg.replace(moe=None)
        t["enc_layers"] = stack(_attn_layer_tmpl(enc_cfg), cfg.encoder_layers)
        t["enc_ln_f"] = L.norm_tmpl(cfg.norm, d)
        t["dec_layers"] = stack(_encdec_dec_layer_tmpl(cfg), cfg.num_layers)
    else:
        raise ValueError(f"unknown family {fam}")
    return t


def init_params(cfg: ArchConfig, generator: torch.Generator, dtype=torch.float32,
                device="cuda"):
    """Random parameters drawn leaf by leaf from `generator` (on `device`)."""
    return init_from_template(template(cfg), generator, dtype, device)


def num_params(cfg: ArchConfig) -> int:
    return count_params(template(cfg))


def _layer(tree, i: int):
    """Layer i of a stacked parameter or cache tree: views, no copies."""
    return map_leaves(lambda t: t[i], tree, is_leaf=torch.is_tensor)


def _unbind_layers(tree, n: int) -> list:
    """The n layers of a stacked tree, from one `unbind` per leaf."""
    per_leaf = map_leaves(lambda t: t.unbind(0), tree, is_leaf=torch.is_tensor)
    return [map_leaves(lambda u: u[i], per_leaf, is_leaf=lambda x: isinstance(x, tuple))
            for i in range(n)]


def _n_pairs(cfg: ArchConfig) -> int:
    return cfg.num_layers // cfg.xlstm.slstm_every


def _n_groups(cfg: ArchConfig) -> int:
    """Groups of the hybrid (mamba layers + the shared block) and vision
    (self layers + a cross layer) families."""
    every = cfg.shared_attn_every if cfg.family == "hybrid" else cfg.cross_attn_every
    return cfg.num_layers // every


# ===========================================================================
# Forward (train / prefill)
# ===========================================================================
def _theta(cfg: ArchConfig):
    """RoPE's base; the audio family has sinusoidal positions instead."""
    return cfg.rope_theta if cfg.family != "audio" else None


def _dense_layer_apply(cfg: ArchConfig, p, x, causal=True):
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    x = x + L.apply_self_attn(p["attn"], h, n_kv=cfg.num_kv_heads, theta=_theta(cfg),
                              window=cfg.sliding_window, causal=causal)
    h = L.apply_norm(cfg.norm, p["ln2"], x)
    if "moe" in p:
        y, aux = MOE.apply_moe(p["moe"], h, cfg.moe)
        return x + y, aux
    return x + L.apply_mlp(cfg.act, p["mlp"], h), torch.zeros((), device=x.device)


def _cross_layer_apply(cfg: ArchConfig, p, x, kv_src):
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    a = L.apply_cross_attn(p["xattn"], h, kv_src, n_kv=cfg.num_kv_heads)
    x = x + torch.tanh(p["gate_attn"].to(x.dtype)) * a
    h = L.apply_norm(cfg.norm, p["ln2"], x)
    return x + torch.tanh(p["gate_mlp"].to(x.dtype)) * L.apply_mlp(cfg.act, p["mlp"], h)


def _xlstm_pair_apply(cfg: ArchConfig, lp, h):
    """Pre-norm residual around each mLSTM / sLSTM block."""
    h = h + XL.apply_mlstm(lp["mlstm"], L.rms(h), cfg.xlstm)
    y, _state = XL.apply_slstm(lp["slstm"], L.rms(h), cfg.xlstm)
    return h + y


def _hybrid_group_apply(cfg: ArchConfig, gp, shared, h):
    """One zamba2 group: its mamba layers, then the shared attention block."""
    for lp in _unbind_layers(gp, cfg.shared_attn_every):
        h = h + SSM.apply_ssm(lp, L.rms(h), cfg.ssm)
    return _dense_layer_apply(cfg, shared, h)[0]


def _vlm_group_apply(cfg: ArchConfig, gp, kv_src, h):
    """One vision group: its self-attention layers, then the cross layer."""
    for lp in _unbind_layers(gp["self"], cfg.cross_attn_every - 1):
        h = _dense_layer_apply(cfg, lp, h)[0]
    return _cross_layer_apply(cfg, gp["cross"], h, kv_src)


def _encoder_layer_apply(cfg: ArchConfig, lp, h):
    return _dense_layer_apply(cfg, lp, h, causal=False)[0]


def _decoder_layer_apply(cfg: ArchConfig, lp, h, enc):
    """One whisper decoder layer: causal self attention, cross attention to
    the encoder's output, MLP."""
    hn = L.apply_norm(cfg.norm, lp["ln1"], h)
    h = h + L.apply_self_attn(lp["attn"], hn, n_kv=cfg.num_kv_heads, theta=None, causal=True)
    hn = L.apply_norm(cfg.norm, lp["ln2"], h)
    h = h + L.apply_cross_attn(lp["xattn"], hn, enc, n_kv=cfg.num_kv_heads)
    hn = L.apply_norm(cfg.norm, lp["ln3"], h)
    return h + L.apply_mlp(cfg.act, lp["mlp"], hn)


def _encode(cfg: ArchConfig, params, enc_emb, dtype, remat=False):
    """The whisper encoder over the stub frame embeddings."""
    enc = enc_emb.to(dtype)
    enc = enc + L.sinusoidal_positions(enc.shape[1], cfg.d_model, enc.device).to(dtype)
    layer = _remat(functools.partial(_encoder_layer_apply, cfg), remat)
    for lp in _unbind_layers(params["enc_layers"], cfg.encoder_layers):
        enc = layer(lp, enc)
    return L.apply_norm(cfg.norm, params["enc_ln_f"], enc)


def _embed(cfg: ArchConfig, params, tokens):
    # F.embedding's backward on the card sorts the tokens and sums each
    # token's rows in a fixed order: the same bits every run
    x = _embed_rows(params["embed"]["table"], tokens.long())
    return shard_act(x, ("batch", "seq", "embed"))


def _embed_rows(table, ids):
    """table[ids]. On a mesh the table is gathered first: DTensor's
    vocab-parallel lookup cannot take ids sharded over the batch."""
    if SH.is_dtensor(table):
        return F.embedding(ids, SH.replicate_all(table))
    return F.embedding(ids, table)


def _logits(cfg: ArchConfig, params, x):
    x = L.apply_norm(cfg.norm, params["ln_f"], x)
    w = params["embed"]["table"].t() if cfg.tie_embeddings else params["head"]["w"]
    logits = L.linear(x, w, "vocab")
    # mask vocab padding
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return shard_act(logits, ("batch", "seq", "vocab"))


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat="dots": keep matmul outputs,
    recompute the rest."""
    if op in _MATMULS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat):
    """remat: False | True (full recompute) | "dots" (save matmul outputs —
    trades memory for a 4x->3x backward FLOPs multiplier)."""
    if not remat or not torch.is_grad_enabled():
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _save_matmuls)
    # the recompute runs in the backward: under the mesh context of now
    return functools.partial(ckpt.checkpoint, SH.bind_ctx(fn), use_reentrant=False, **kw)


def forward(cfg: ArchConfig, params, batch, *, remat=True):
    """Returns (logits (b, s, V), aux_loss scalar). Each remat unit is the
    JAX package's scan body: a layer, an xLSTM pair, a zamba2 group (its
    mamba layers and the shared block) or a vision group."""
    fam = cfg.family
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if fam in ("dense", "moe"):
        layer = _remat(functools.partial(_dense_layer_apply, cfg), remat)
        for lp in _unbind_layers(params["layers"], cfg.num_layers):
            x, a = layer(lp, x)
            aux = aux + a
    elif fam == "ssm" and cfg.xlstm is not None:
        pair = _remat(functools.partial(_xlstm_pair_apply, cfg), remat)
        for lp in _unbind_layers(params["pairs"], _n_pairs(cfg)):
            x = pair(lp, x)
    elif fam == "hybrid":
        group = _remat(functools.partial(_hybrid_group_apply, cfg), remat)
        for gp in _unbind_layers(params["groups"], _n_groups(cfg)):
            x = group(gp, params["shared_attn"], x)
    elif fam == "vlm":
        kv_src = batch["vision_emb"].to(x.dtype)
        group = _remat(functools.partial(_vlm_group_apply, cfg), remat)
        for gp in _unbind_layers(params["groups"], _n_groups(cfg)):
            x = group(gp, kv_src, x)
    elif fam == "audio":
        enc = _encode(cfg, params, batch["enc_emb"], x.dtype, remat)
        x = x + L.sinusoidal_positions(tokens.shape[1], cfg.d_model, x.device).to(x.dtype)
        layer = _remat(functools.partial(_decoder_layer_apply, cfg), remat)
        for lp in _unbind_layers(params["dec_layers"], cfg.num_layers):
            x = layer(lp, x, enc)
    else:
        raise ValueError(fam)
    return _logits(cfg, params, x), aux


def _logprob_of(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (torch.gather(logp, -1, targets[..., None])[..., 0],)


def _target_logprob(logits, targets):
    """log_softmax(logits)[target] per position, in float32. On a mesh the
    vocabulary gathers first and each rank takes its own rows
    (`local_map`): DTensor's gather would build its gradient at the global
    shape."""
    if not SH.is_dtensor(logits):
        return _logprob_of(logits, targets)[0]
    logits = shard_act(logits, ("batch", "seq", None))
    pl = tuple(logits.placements)
    return SH.local_map(_logprob_of, out_placements=(pl,), in_placements=(pl, pl))(
        logits, targets)[0]


def loss_fn(cfg: ArchConfig, params, batch, *, remat=True):
    """Next-token CE. batch['tokens']: (b, s+1). The log-softmax is taken in
    float32."""
    tokens = batch["tokens"]
    inp = dict(batch)
    inp["tokens"] = tokens[:, :-1]
    targets = tokens[:, 1:].long()
    logits, aux = forward(cfg, params, inp, remat=remat)
    ce = -_target_logprob(logits, targets).mean()
    return ce + aux, {"ce": ce, "aux": aux}


# ===========================================================================
# Decode
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one cache leaf (the JAX package's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


def _cache_len(cfg: ArchConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def _cache_layout(cfg: ArchConfig, b: int, max_len: int, dtype, emit):
    """Single source of truth for decode-cache leaves: emit(shape, dtype,
    logical_axes) is called per leaf; used for both TensorSpecs and
    sharding specs."""
    d, kv, hd = cfg.d_model, cfg.num_kv_heads, cfg.hd
    W = _cache_len(cfg, max_len)
    f32 = torch.float32

    def kvc(n, w=W, extra=()):
        axes = ("layers",) + (None,) * len(extra) + ("batch", None, "kv_heads", "head_dim")
        shape = (n,) + extra + (b, w, kv, hd)
        return {"k": emit(shape, dtype, axes), "v": emit(shape, dtype, axes)}

    fam = cfg.family
    if fam in ("dense", "moe"):
        return {"kv": kvc(cfg.num_layers)}
    if fam == "ssm" and cfg.xlstm is not None:
        n_pairs = _n_pairs(cfg)
        inner = int(cfg.xlstm.proj_factor_mlstm * d)
        nh = cfg.xlstm.num_heads
        dk = inner // nh
        hd_s = d // nh
        return {
            "mlstm": {
                "C": emit((n_pairs, b, nh, dk, dk), f32, ("layers", "batch", "heads", None, None)),
                "n": emit((n_pairs, b, nh, dk), f32, ("layers", "batch", "heads", None)),
                "m": emit((n_pairs, b, nh), f32, ("layers", "batch", "heads")),
                "conv": emit((n_pairs, b, 3, inner), dtype, ("layers", "batch", None, "inner")),
            },
            "slstm": tuple(
                emit((n_pairs, b, nh, hd_s), f32 if i < 3 else dtype,
                     ("layers", "batch", "heads", None))
                for i in range(4)
            ),
        }
    if fam == "hybrid":
        n_groups, per = _n_groups(cfg), cfg.shared_attn_every
        inner = cfg.ssm.expand * d
        nheads = inner // cfg.ssm.head_dim
        conv_ch = inner + 2 * cfg.ssm.state_dim
        return {
            "ssm": {
                "conv": emit((n_groups, per, b, cfg.ssm.conv_width - 1, conv_ch), dtype,
                             ("layers", None, "batch", None, "inner")),
                "ssm": emit((n_groups, per, b, nheads, cfg.ssm.head_dim, cfg.ssm.state_dim),
                            f32, ("layers", None, "batch", "heads", None, None)),
            },
            "attn_kv": kvc(n_groups),
        }
    cross_axes = ("layers", "batch", None, "kv_heads", "head_dim")
    if fam == "vlm":
        n_groups = _n_groups(cfg)
        shape = (n_groups, b, cfg.vision_tokens, kv, hd)
        return {
            "self_kv": kvc(n_groups, extra=(cfg.cross_attn_every - 1,)),
            "cross_kv": {"k": emit(shape, dtype, cross_axes), "v": emit(shape, dtype, cross_axes)},
        }
    if fam == "audio":
        shape = (cfg.num_layers, b, cfg.encoder_len, kv, hd)
        return {
            "self_kv": kvc(cfg.num_layers),
            "cross_kv": {"k": emit(shape, dtype, cross_axes), "v": emit(shape, dtype, cross_axes)},
        }
    raise ValueError(fam)


def cache_shapes(cfg: ArchConfig, b: int, max_len: int, dtype=torch.bfloat16):
    """TensorSpec tree of the decode cache."""
    return _cache_layout(cfg, b, max_len, dtype,
                         lambda shape, dt, axes: TensorSpec(tuple(shape), dt))


class AxesLeaf:
    """Tree *leaf* wrapping a logical-axes tuple (a plain tuple would be
    walked as a container)."""

    def __init__(self, axes):
        self.axes = tuple(axes)

    def __repr__(self):
        return f"AxesLeaf{self.axes}"


def cache_axes(cfg: ArchConfig, b: int, max_len: int, dtype=torch.bfloat16):
    """Logical-axis tree matching cache_shapes (for sharding specs)."""
    return _cache_layout(cfg, b, max_len, dtype,
                         lambda shape, dt, axes: AxesLeaf(axes))


def _cross_kv(kv_src, wk, wv, dtype):
    """Cross-attention keys and values of `kv_src` (b, t, d) under stacked
    projections (n, d, kv, hd): (n, b, t, kv, hd) each, in `dtype`."""
    kv_src = kv_src.to(torch.promote_types(kv_src.dtype, wk.dtype))
    return {"k": torch.einsum("btd,ndhk->nbthk", kv_src, wk).to(dtype),
            "v": torch.einsum("btd,ndhk->nbthk", kv_src, wv).to(dtype)}


@torch.no_grad()
def init_cache(cfg: ArchConfig, params, b: int, max_len: int, batch=None,
               dtype=torch.bfloat16):
    """Zero cache on the parameters' device (the recurrent states' m
    included, as in the JAX package); for the cross-attention families the
    cross K/V are computed from the stub embeddings in `batch`
    (vision_emb / enc_emb: the vision patches, or the encoder's output over
    the audio frames)."""
    device = params["embed"]["table"].device
    shapes = cache_shapes(cfg, b, max_len, dtype)
    cache = map_leaves(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), shapes,
                       is_leaf=lambda x: isinstance(x, TensorSpec))
    if cfg.family == "vlm":
        xattn = params["groups"]["cross"]["xattn"]
        cache["cross_kv"] = _cross_kv(batch["vision_emb"].to(dtype), xattn["wk"], xattn["wv"],
                                      dtype)
    if cfg.family == "audio":
        enc = _encode(cfg, params, batch["enc_emb"], dtype)
        xattn = params["dec_layers"]["xattn"]
        cache["cross_kv"] = _cross_kv(enc, xattn["wk"], xattn["wv"], dtype)
    return cache


def _attn_decode_block(cfg, lp, x, ck, cv, pos):
    h = L.apply_norm(cfg.norm, lp["ln1"], x)
    x = x + L.self_attn_decode_into(lp["attn"], h, ck, cv, pos, n_kv=cfg.num_kv_heads,
                                    theta=_theta(cfg))
    h = L.apply_norm(cfg.norm, lp["ln2"], x)
    if "moe" in lp:
        y, _aux = MOE.apply_moe(lp["moe"], h, cfg.moe)
        return x + y
    return x + L.apply_mlp(cfg.act, lp["mlp"], h)


def _cross_decode(cfg, p_attn, x, ck, cv):
    """Cross attention against precomputed K/V."""
    n_heads = p_attn["wq"].shape[1]
    n_rep = n_heads // cfg.num_kv_heads
    q = L.proj_heads(x, p_attn["wq"])
    mask = torch.ones((x.shape[0], 1, 1, ck.shape[1]), dtype=torch.bool, device=x.device)
    out = L._attention(L._sdpa, q, ck.to(q.dtype), cv.to(q.dtype), mask, n_rep=n_rep)
    return L.proj_out(out, p_attn["wo"])


def _stack_states(states: list):
    """A list of per-layer state trees as one tree of stacked tensors."""
    if isinstance(states[0], dict):
        return {k: _stack_states([s[k] for s in states]) for k in states[0]}
    if isinstance(states[0], tuple):
        return tuple(_stack_states(list(col)) for col in zip(*states))
    return torch.stack(states)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache, token, pos):
    """token: (b,) int; pos: scalar int (slot-synchronous) or (b,) int32
    (continuous batching, per-sequence positions).
    Returns (logits (b, V), new_cache); `cache` is not written: KV caches
    are copied once and written layer by layer, recurrent states are new
    tensors stacked once, and cross K/V are passed on as they are."""
    x = _embed_rows(params["embed"]["table"], token.long()[:, None])
    fam = cfg.family

    if fam in ("dense", "moe"):
        ck, cv = cache["kv"]["k"].clone(), cache["kv"]["v"].clone()
        for i in range(cfg.num_layers):
            x = _attn_decode_block(cfg, _layer(params["layers"], i), x, ck[i], cv[i], pos)
        new_cache = {"kv": {"k": ck, "v": cv}}

    elif fam == "ssm" and cfg.xlstm is not None:
        mstates, sstates = [], []
        for i in range(_n_pairs(cfg)):
            lp = _layer(params["pairs"], i)
            y, mc = XL.apply_mlstm_decode(lp["mlstm"], L.rms(x), _layer(cache["mlstm"], i),
                                          cfg.xlstm)
            x = x + y
            y, sc = XL.apply_slstm_decode(lp["slstm"], L.rms(x), cfg.xlstm,
                                          _layer(cache["slstm"], i))
            x = x + y
            mstates.append(mc)
            sstates.append(sc)
        new_cache = {"mlstm": _stack_states(mstates), "slstm": _stack_states(sstates)}

    elif fam == "hybrid":
        ck, cv = cache["attn_kv"]["k"].clone(), cache["attn_kv"]["v"].clone()
        groups = []
        for g in range(_n_groups(cfg)):
            gp, gc = _layer(params["groups"], g), _layer(cache["ssm"], g)
            states = []
            for i in range(cfg.shared_attn_every):
                y, c = SSM.apply_ssm_decode(_layer(gp, i), L.rms(x), _layer(gc, i), cfg.ssm)
                x = x + y
                states.append(c)
            groups.append(_stack_states(states))
            x = _attn_decode_block(cfg, params["shared_attn"], x, ck[g], cv[g], pos)
        new_cache = {"ssm": _stack_states(groups), "attn_kv": {"k": ck, "v": cv}}

    elif fam == "vlm":
        ck, cv = cache["self_kv"]["k"].clone(), cache["self_kv"]["v"].clone()
        xk, xv = cache["cross_kv"]["k"], cache["cross_kv"]["v"]
        for g in range(_n_groups(cfg)):
            gp = _layer(params["groups"], g)
            for i in range(cfg.cross_attn_every - 1):
                x = _attn_decode_block(cfg, _layer(gp["self"], i), x, ck[g, i], cv[g, i], pos)
            cp = gp["cross"]
            hn = L.apply_norm(cfg.norm, cp["ln1"], x)
            x = x + torch.tanh(cp["gate_attn"].to(x.dtype)) * _cross_decode(
                cfg, cp["xattn"], hn, xk[g], xv[g])
            hn = L.apply_norm(cfg.norm, cp["ln2"], x)
            x = x + torch.tanh(cp["gate_mlp"].to(x.dtype)) * L.apply_mlp(cfg.act, cp["mlp"], hn)
        new_cache = {"self_kv": {"k": ck, "v": cv}, "cross_kv": cache["cross_kv"]}

    elif fam == "audio":
        pos_vec = L._pos_vector(pos, x.shape[0], x.device)
        x = x + L.sinusoidal_at(pos_vec[:, None], cfg.d_model).to(x.dtype)
        ck, cv = cache["self_kv"]["k"].clone(), cache["self_kv"]["v"].clone()
        xk, xv = cache["cross_kv"]["k"], cache["cross_kv"]["v"]
        for i in range(cfg.num_layers):
            lp = _layer(params["dec_layers"], i)
            hn = L.apply_norm(cfg.norm, lp["ln1"], x)
            x = x + L.self_attn_decode_into(lp["attn"], hn, ck[i], cv[i], pos,
                                            n_kv=cfg.num_kv_heads, theta=None)
            hn = L.apply_norm(cfg.norm, lp["ln2"], x)
            x = x + _cross_decode(cfg, lp["xattn"], hn, xk[i], xv[i])
            hn = L.apply_norm(cfg.norm, lp["ln3"], x)
            x = x + L.apply_mlp(cfg.act, lp["mlp"], hn)
        new_cache = {"self_kv": {"k": ck, "v": cv}, "cross_kv": cache["cross_kv"]}
    else:
        raise ValueError(fam)

    return _logits(cfg, params, x)[:, 0], new_cache


# ===========================================================================
# Dry-run input specs
# ===========================================================================
def input_specs(cfg: ArchConfig, shape, *, dtype=torch.bfloat16):
    """Stand-ins without storage (on the meta device) for every model input
    of this cell: the batch of a train or prefill cell; for a decode cell
    the token, the position and the cache."""
    b, s = shape.global_batch, shape.seq_len

    def empty(shape_, dt):
        return torch.empty(shape_, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": empty((b, s + 1) if shape.kind == "train" else (b, s), torch.int32)}
        if cfg.family == "vlm":
            batch["vision_emb"] = empty((b, cfg.vision_tokens, cfg.d_model), dtype)
        if cfg.family == "audio":
            batch["enc_emb"] = empty((b, cfg.encoder_len, cfg.d_model), dtype)
        return batch
    # decode: one new token against a cache of length seq_len
    return {
        "token": empty((b,), torch.int32),
        "pos": torch.zeros((), dtype=torch.int32, device="meta"),
        "cache": map_leaves(lambda t: empty(t.shape, t.dtype), cache_shapes(cfg, b, s, dtype),
                            is_leaf=lambda x: isinstance(x, TensorSpec)),
    }
