"""Mixture-of-Experts layer with two dispatch strategies (DESIGN.md §3).

Token->expert dispatch *is* the paper's relational pattern: tokens are rows,
the routed expert id is the key, and the expert computation wants rows
grouped (clustered) by key.

  dispatch="einsum"  GFUR-analogue baseline: a dense (T, E, C) one-hot
                     dispatch/combine einsum (Switch-Transformer style).
                     Bytes/FLOPs scale with T*E*C.

  dispatch="sort"    GFTR pattern: stable radix-partition of the (token,
                     expert) assignments by expert id
                     (`core.primitives.plan_partition_permutation`: on the
                     card the block_histograms and partition_ranks kernels,
                     on the CPU their plain versions), contiguous per-expert
                     blocks, grouped matmuls, and an inverse-permutation
                     gather on the combine side. O(T*k*D) data movement.

Both honor a static capacity C per expert (overflow dropped, standard MoE
practice) and an auxiliary load-balance loss.

Every integer scatter here writes each kept slot once and sends what it
drops to a spare row or column that is cut off afterwards, so nothing is
written out of bounds and no float is ever added by scatter.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import primitives as prim
from ..dist import sharding as SH
from ..dist.sharding import shard_act
from .params import P


def moe_tmpl(d: int, cfg):
    t = {
        "router": P((d, cfg.num_experts), ("embed", "experts"), "small"),
        "wg": P((cfg.num_experts, d, cfg.d_expert), ("experts", "expert_embed", "expert_mlp")),
        "wu": P((cfg.num_experts, d, cfg.d_expert), ("experts", "expert_embed", "expert_mlp")),
        "wd": P((cfg.num_experts, cfg.d_expert, d), ("experts", "expert_mlp", "expert_embed")),
    }
    if cfg.num_shared_experts:
        t["shared"] = {
            "wg": P((d, cfg.shared_d_ff), ("embed", "mlp")),
            "wu": P((d, cfg.shared_d_ff), ("embed", "mlp")),
            "wd": P((cfg.shared_d_ff, d), ("mlp", "embed")),
        }
    return t


def _capacity(T: int, k: int, E: int, cf: float, multiple: int = 512) -> int:
    c = int(T * k / E * cf) + 1
    return max(multiple, -(-c // multiple) * multiple)


def _route(p, x2, k: int):
    """Returns (expert_idx (T,k) int32, gates (T,k), aux_loss).

    The top k come from a stable descending sort, so among equal
    probabilities the lower expert id comes first, as in `jax.lax.top_k`
    (`torch.topk` promises no order among ties)."""
    logits = (x2 @ p["router"]).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_idx = srt.values[:, :k], srt.indices[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux: E * sum_e f_e * p_e
    E = logits.shape[-1]
    me = probs.mean(dim=0)
    # a one-hot mean, as the JAX package takes it: bincount would wait for
    # the card to size its output, once per layer of every decode step
    fe = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(fe * me)
    return expert_idx.to(torch.int32), gates.to(x2.dtype), aux


def _expert_ffn(xin, wg, wu, wd):
    """xin: (E, C, D) -> (E, C, D), grouped SwiGLU."""
    h = F.silu(torch.bmm(xin, wg)) * torch.bmm(xin, wu)
    return torch.bmm(h, wd)


def _plan_sort(expert_idx, E: int, C: int):
    """Integer dispatch plan for one token group.

    Returns (blk_tok (E, C), slot_a (t*k,), keep_a (t*k,)): the padded-
    partition layout of hash_join applied to token->expert assignments
    (transformation phase = stable partition by expert id)."""
    t, k = expert_idx.shape
    n = t * k
    dev = expert_idx.device
    eflat = expert_idx.reshape(-1).to(torch.int32).contiguous()
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    tok = ar // k
    perm, off, _sz = prim.plan_partition_permutation(eflat, E)
    perm = perm.long()
    sorted_e = eflat[perm]
    sorted_tok = tok[perm]
    pos_in_e = ar - off[sorted_e.long()]
    keep = pos_in_e < C
    # dropped assignments land in a spare row E, cut off below
    blk = torch.full((E + 1, C), -1, dtype=torch.int32, device=dev)
    blk[torch.where(keep, sorted_e, E).long(), torch.where(keep, pos_in_e, 0).long()] = sorted_tok
    inv = torch.empty(n, dtype=torch.long, device=dev)
    inv[perm] = ar.long()  # perm is a permutation: every slot written once
    slot = sorted_e * C + torch.clamp(pos_in_e, max=C - 1)
    return blk[:E], slot[inv], keep[inv]


def _gather_rows(x, idx):
    """out[i] = x[idx[i]] with idx == -1 -> 0 (one token group)."""
    safe = torch.clamp(idx, 0, x.shape[0] - 1).long()
    valid = (idx >= 0).reshape(idx.shape + (1,) * (x.dim() - 1))
    return torch.where(valid, x[safe], 0)


def _dispatch_sort(p, x2, expert_idx, gates, C: int):
    """GFTR-pattern dispatch, single group (the no-mesh path)."""
    T, D = x2.shape
    E = p["wg"].shape[0]
    k = expert_idx.shape[1]
    blk_tok, slot_a, keep_a = _plan_sort(expert_idx, E, C)
    xin = _gather_rows(x2, blk_tok.reshape(-1)).reshape(E, C, D)
    out = _expert_ffn(xin, p["wg"], p["wu"], p["wd"])
    ya = _gather_rows(out.reshape(E * C, D), torch.where(keep_a, slot_a, -1))
    y = (ya.reshape(T, k, D) * gates[..., None]).sum(dim=1)
    return y.to(x2.dtype)


def _dispatch_sort_grouped(p, x2, expert_idx, gates, *, k: int, E: int,
                           cf: float, groups: int):
    """Hierarchical GFTR dispatch: tokens split into `groups` shard-local
    blocks (the paper's probe-side sub-partitioning applied to MoE), each
    planned on its own, the expert matmuls batched over the group dim."""
    T, D = x2.shape
    t_loc = T // groups
    C_loc = _capacity(t_loc, k, E, cf, multiple=128)
    xg = shard_act(x2.reshape(groups, t_loc, D), ("tokens", None, "embed"))
    eg = expert_idx.reshape(groups, t_loc, k)
    plans = [_plan_sort(eg[g], E, C_loc) for g in range(groups)]
    blk = torch.stack([pl[0] for pl in plans])
    slot_a = torch.stack([pl[1] for pl in plans])
    keep_a = torch.stack([pl[2] for pl in plans])
    xin = torch.stack([_gather_rows(xg[g], blk[g].reshape(-1)) for g in range(groups)])
    xin = shard_act(xin.reshape(groups, E, C_loc, D), ("tokens", None, None, None))
    h = F.silu(torch.einsum("gecd,edf->gecf", xin, p["wg"])) * torch.einsum(
        "gecd,edf->gecf", xin, p["wu"])
    h = shard_act(h, ("tokens", None, None, "mlp"))
    out = torch.einsum("gecf,efd->gecd", h, p["wd"])
    out = shard_act(out, ("tokens", None, None, None)).reshape(groups, E * C_loc, D)
    idx = torch.where(keep_a, slot_a, -1)
    ya = torch.stack([_gather_rows(out[g], idx[g]) for g in range(groups)])
    ya = shard_act(ya, ("tokens", None, None))  # (G, t_loc*k, D)
    gg = gates.reshape(groups, t_loc, k)
    y = (ya.reshape(groups, t_loc, k, D) * gg[..., None]).sum(dim=2)
    y = shard_act(y, ("tokens", None, "embed"))
    return y.reshape(T, D).to(x2.dtype)


def _dispatch_einsum(p, x2, expert_idx, gates, C: int):
    """Dense one-hot dispatch/combine (GFUR-analogue baseline). The kept
    (token, expert, slot) triples are unique, so both tensors are written
    without accumulation; dropped assignments go to a spare slot C."""
    T, D = x2.shape
    E = p["wg"].shape[0]
    k = expert_idx.shape[1]
    n = T * k
    dev = x2.device
    eflat = expert_idx.reshape(-1).long()
    tok = torch.arange(n, device=dev) // k
    # position of each assignment within its expert (stable order)
    oh = F.one_hot(eflat, E).to(torch.int32)  # (n, E)
    excl = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh  # exclusive count per expert
    pos = torch.gather(excl, 1, eflat[:, None])[:, 0]
    keep = pos < C
    at = (tok, eflat, torch.where(keep, pos, C).long())
    disp = torch.zeros((T, E, C + 1), dtype=x2.dtype, device=dev)
    disp[at] = keep.to(x2.dtype)
    comb = torch.zeros((T, E, C + 1), dtype=x2.dtype, device=dev)
    comb[at] = (gates.reshape(-1) * keep).to(x2.dtype)
    xin = torch.einsum("tec,td->ecd", disp[..., :C], x2)
    out = _expert_ffn(xin, p["wg"], p["wu"], p["wd"])
    y = torch.einsum("tec,ecd->td", comb[..., :C], out)
    return y.to(x2.dtype)


def _num_token_groups(T: int) -> int:
    """Shard-local group count for hierarchical dispatch: the total number
    of shards along the 'tokens' axes (1 outside a mesh context)."""
    ctx = SH.current_ctx()
    if ctx is None:
        return 1
    mesh, rules = ctx
    ax = rules.act.get("tokens")
    if isinstance(ax, tuple):
        ax = tuple(a for a in ax if a in dict(mesh.shape))
    g = SH._mesh_axis_size(mesh, ax)
    return g if g > 1 and T % g == 0 and T // g >= 8 else 1


def apply_moe(p, x, moe_cfg):
    """x: (b, s, d). Returns (y, aux_loss)."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    expert_idx, gates, aux = _route(p, x2, moe_cfg.top_k)
    C = _capacity(b * s, moe_cfg.top_k, moe_cfg.num_experts, moe_cfg.capacity_factor)
    if moe_cfg.dispatch == "sort":
        groups = _num_token_groups(b * s)
        if groups > 1:
            y = _dispatch_sort_grouped(p, x2, expert_idx, gates, k=moe_cfg.top_k,
                                       E=moe_cfg.num_experts, cf=moe_cfg.capacity_factor,
                                       groups=groups)
        else:
            y = _dispatch_sort(p, x2, expert_idx, gates, C)
    elif moe_cfg.dispatch == "einsum":
        y = _dispatch_einsum(p, x2, expert_idx, gates, C)
    else:
        raise ValueError(moe_cfg.dispatch)
    if moe_cfg.num_shared_experts:
        sh = p["shared"]
        xs2 = shard_act(x2, ("tokens", "embed"))
        hs = F.silu(xs2 @ sh["wg"]) * (xs2 @ sh["wu"])
        hs = shard_act(hs, ("tokens", "mlp"))
        y = y + shard_act(hs @ sh["wd"], ("tokens", "embed"))
    return y.reshape(b, s, d), aux * moe_cfg.router_aux_coef
