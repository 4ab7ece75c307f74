"""Model assembly behind one API, on PyTorch tensors.

    template(cfg)                        parameter template (P leaves)
    init_params(cfg, generator, dtype, device)   real parameters
    num_params(cfg)                      parameter count
    forward(cfg, params, batch, remat)   (logits, aux_loss)   [train / prefill]
    loss_fn(cfg, params, batch, remat)   (loss, {"ce", "aux"})   [train]
    cache_shapes(cfg, b, w, dtype)       decode-cache TensorSpecs
    init_cache(cfg, params, b, w, batch, dtype)   zero cache
    decode_step(cfg, params, cache, token, pos)   (logits, new_cache)

Templates exist for the dense, MoE, vision and audio families. The forward
pass and decode exist for the dense and MoE families; the others raise
NotImplementedError naming the ROADMAP item that brings them. Stacked layers
run as a Python loop over views of the stacked tensors: `forward` takes them
with one `unbind` per leaf, whose backward stacks the layers' gradients once
(indexing each layer would make every layer's backward write a zero tensor
the size of the whole stacked leaf). `forward` records autograd history
where its inputs ask for it, with each layer recomputed in the backward
(`remat=True`) or with its matmul outputs kept (`remat="dots"`);
`decode_step` records none.

decode_step never writes the cache it is given: it copies the stacked cache
once and writes each layer's new key and value into the copy, which it
returns. A step that fails part-way therefore leaves the caller's cache as it
was (the serve engine keeps the old cache and retries).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..configs.base import ArchConfig
from ..dist.sharding import shard_act
from . import layers as L
from . import moe as MOE
from .params import P, count_params, init_from_template, map_leaves, stack

# what the families without a forward pass or decode wait for
FAMILY_TODO = ("ROADMAP Queue 1, item 3a: the vision, audio, hybrid and xLSTM families "
               "(models/ssm.py, models/xlstm.py, cross-attention caches)")


def _not_ported(cfg: ArchConfig, what: str):
    return NotImplementedError(f"{what} of {cfg.name} ({cfg.family}): {FAMILY_TODO}")


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
    fam = cfg.family
    if fam == "hybrid" or (fam == "ssm" and cfg.xlstm is not None):
        raise _not_ported(cfg, "the parameter template")
    t: dict[str, Any] = {"embed": L.embed_tmpl(V, d), "ln_f": L.norm_tmpl(cfg.norm, d)}
    if not cfg.tie_embeddings:
        t["head"] = L.head_tmpl(d, V)
    if fam in ("dense", "moe"):
        t["layers"] = stack(_attn_layer_tmpl(cfg), cfg.num_layers)
    elif fam == "vlm":
        n_groups = cfg.num_layers // cfg.cross_attn_every
        group = {
            "self": stack(_attn_layer_tmpl(cfg), cfg.cross_attn_every - 1),
            "cross": _cross_layer_tmpl(cfg),
        }
        t["groups"] = stack(group, n_groups)
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


def _check_decoder(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in ("dense", "moe"):
        raise _not_ported(cfg, what)


# ===========================================================================
# Forward (prefill)
# ===========================================================================
def _dense_layer_apply(cfg: ArchConfig, p, x):
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    x = x + L.apply_self_attn(p["attn"], h, n_kv=cfg.num_kv_heads, theta=cfg.rope_theta,
                              window=cfg.sliding_window)
    h = L.apply_norm(cfg.norm, p["ln2"], x)
    if "moe" in p:
        y, aux = MOE.apply_moe(p["moe"], h, cfg.moe)
        return x + y, aux
    return x + L.apply_mlp(cfg.act, p["mlp"], h), torch.zeros((), device=x.device)


def _embed(cfg: ArchConfig, params, tokens):
    # F.embedding's backward on the card sorts the tokens and sums each
    # token's rows in a fixed order: the same bits every run
    x = F.embedding(tokens.long(), params["embed"]["table"])
    return shard_act(x, ("batch", "seq", "embed"))


def _logits(cfg: ArchConfig, params, x):
    x = L.apply_norm(cfg.norm, params["ln_f"], x)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"]["table"])
    else:
        logits = x @ params["head"]["w"]
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
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def forward(cfg: ArchConfig, params, batch, *, remat=True):
    """Returns (logits (b, s, V), aux_loss scalar)."""
    _check_decoder(cfg, "forward")
    x = _embed(cfg, params, batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = _remat(functools.partial(_dense_layer_apply, cfg), remat)
    for lp in _unbind_layers(params["layers"], cfg.num_layers):
        x, a = layer(lp, x)
        aux = aux + a
    return _logits(cfg, params, x), aux


def loss_fn(cfg: ArchConfig, params, batch, *, remat=True):
    """Next-token CE. batch['tokens']: (b, s+1). The log-softmax is taken in
    float32."""
    tokens = batch["tokens"]
    inp = dict(batch)
    inp["tokens"] = tokens[:, :-1]
    targets = tokens[:, 1:].long()
    logits, aux = forward(cfg, params, inp, remat=remat)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    ce = -ll.mean()
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
    _check_decoder(cfg, "the decode cache")
    kv, hd = cfg.num_kv_heads, cfg.hd
    W = _cache_len(cfg, max_len)
    axes = ("layers", "batch", None, "kv_heads", "head_dim")
    shape = (cfg.num_layers, b, W, kv, hd)
    return {"kv": {"k": emit(shape, dtype, axes), "v": emit(shape, dtype, axes)}}


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


def init_cache(cfg: ArchConfig, params, b: int, max_len: int, batch=None,
               dtype=torch.bfloat16):
    """Zero cache on the parameters' device. `batch` carries the
    cross-attention families' stub embeddings, which have no port yet."""
    device = params["embed"]["table"].device
    shapes = cache_shapes(cfg, b, max_len, dtype)
    return map_leaves(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), shapes,
                      is_leaf=lambda x: isinstance(x, TensorSpec))


def _attn_decode_block(cfg, lp, x, ck, cv, pos):
    h = L.apply_norm(cfg.norm, lp["ln1"], x)
    x = x + L.self_attn_decode_into(lp["attn"], h, ck, cv, pos, n_kv=cfg.num_kv_heads,
                                    theta=cfg.rope_theta)
    h = L.apply_norm(cfg.norm, lp["ln2"], x)
    if "moe" in lp:
        y, _aux = MOE.apply_moe(lp["moe"], h, cfg.moe)
        return x + y
    return x + L.apply_mlp(cfg.act, lp["mlp"], h)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache, token, pos):
    """token: (b,) int; pos: scalar int (slot-synchronous) or (b,) int32
    (continuous batching, per-sequence positions).
    Returns (logits (b, V), new_cache); `cache` is not written."""
    _check_decoder(cfg, "decode_step")
    x = params["embed"]["table"][token.long()[:, None]]
    ck, cv = cache["kv"]["k"].clone(), cache["kv"]["v"].clone()
    for i in range(cfg.num_layers):
        x = _attn_decode_block(cfg, _layer(params["layers"], i), x, ck[i], cv[i], pos)
    logits = _logits(cfg, params, x)[:, 0]
    return logits, {"kv": {"k": ck, "v": cv}}
