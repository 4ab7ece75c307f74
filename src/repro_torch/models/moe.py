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
written out of bounds and no float is ever added by scatter. The sort
dispatch's two gathers keep that in the backward too (`_PlanGather`): the
gradient of a gather through the plan is a gather through its inverse.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..core import primitives as prim
from ..dist import sharding as SH
from ..dist.sharding import shard_act
from .params import P, axis_spec


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

    Returns (blk_tok (E, C), slot_a (t*k,), keep_a (t*k,), blk_asg (E, C)):
    the padded-partition layout of hash_join applied to token->expert
    assignments (transformation phase = stable partition by expert id).
    blk_asg holds the assignment (token * k + j) in each slot, -1 where the
    slot is empty: the inverse of slot_a over the kept assignments, which
    the plan gathers' backward reads."""
    t, k = expert_idx.shape
    n = t * k
    dev = expert_idx.device
    eflat = expert_idx.reshape(-1).to(torch.int32).contiguous()
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    perm, off, _sz = prim.plan_partition_permutation(eflat, E)
    sorted_a = perm  # the assignment at each sorted position
    perm = perm.long()
    sorted_e = eflat[perm]
    pos_in_e = ar - off[sorted_e.long()]
    keep = pos_in_e < C
    # dropped assignments land in a spare row E, cut off below
    blk = torch.full((E + 1, C), -1, dtype=torch.int32, device=dev)
    blk[torch.where(keep, sorted_e, E).long(), torch.where(keep, pos_in_e, 0).long()] = sorted_a
    blk_asg = blk[:E]
    inv = torch.empty(n, dtype=torch.long, device=dev)
    inv[perm] = ar.long()  # perm is a permutation: every slot written once
    slot = sorted_e * C + torch.clamp(pos_in_e, max=C - 1)
    blk_tok = torch.where(blk_asg >= 0, blk_asg // k, -1)
    return blk_tok, slot[inv], keep[inv], blk_asg


def _gather_rows(x, idx):
    """out[i] = x[idx[i]] with idx == -1 -> 0 (one token group)."""
    safe = torch.clamp(idx, 0, x.shape[0] - 1).long()
    valid = (idx >= 0).reshape(idx.shape + (1,) * (x.dim() - 1))
    return torch.where(valid, x[safe], 0)


class _PlanGather(torch.autograd.Function):
    """`_gather_rows(x, idx)` whose backward gathers through the inverse
    plan instead of adding rows by scatter: row r of x was read at the
    positions inv[r, 0..m-1] of the output (-1: none), so

        grad_x[r] = grad_out[inv[r, 0]] + ... + grad_out[inv[r, m-1]]

    summed in that order, with no atomics and the same bits every run. The
    dispatch gather (x = tokens, idx = each slot's token) has inv = each
    token's k assignment slots; the combine gather (x = expert slots, idx =
    each assignment's slot) has inv = each slot's one assignment."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return _gather_rows(x, idx)

    @staticmethod
    def backward(ctx, grad_out):
        (inv,) = ctx.saved_tensors
        grad_x = _gather_rows(grad_out, inv[:, 0])
        for j in range(1, inv.shape[1]):
            grad_x = grad_x + _gather_rows(grad_out, inv[:, j])
        return grad_x, None, None


def _dispatch_sort(p, x2, expert_idx, gates, C: int):
    """GFTR-pattern dispatch, single group (the no-mesh path)."""
    T, D = x2.shape
    E = p["wg"].shape[0]
    k = expert_idx.shape[1]
    blk_tok, slot_a, keep_a, blk_asg = _plan_sort(expert_idx, E, C)
    at = torch.where(keep_a, slot_a, -1)
    xin = _PlanGather.apply(x2, blk_tok.reshape(-1), at.reshape(T, k)).reshape(E, C, D)
    out = _expert_ffn(xin, p["wg"], p["wu"], p["wd"])
    ya = _PlanGather.apply(out.reshape(E * C, D), at, blk_asg.reshape(E * C, 1))
    y = (ya.reshape(T, k, D) * gates[..., None]).sum(dim=1)
    return y.to(x2.dtype)


def _plan_gather_local(xg, eg, *, E: int, C: int):
    """Plan and dispatch-gather each local token group: xg (G, t, D), eg
    (G, t, k) -> (xin (G, E, C, D), at (G, t*k), blk_asg (G, E*C)); `at` is
    each assignment's expert slot (-1: dropped), `blk_asg` each slot's
    assignment (-1: empty). Plain tensors: under a mesh it runs on each
    rank's own groups, so the routing kernels see ordinary tensors."""
    G, t, D = xg.shape
    k = eg.shape[2]
    xin, ats, asgs = [], [], []
    for g in range(G):
        blk_tok, slot_a, keep_a, blk_asg = _plan_sort(eg[g], E, C)
        at = torch.where(keep_a, slot_a, -1)
        xin.append(_PlanGather.apply(xg[g], blk_tok.reshape(-1), at.reshape(t, k)))
        ats.append(at)
        asgs.append(blk_asg.reshape(E * C))
    return (torch.stack(xin).reshape(G, E, C, D), torch.stack(ats), torch.stack(asgs))


def _combine_local(out, at, blk_asg):
    """The combine gather of each local group: out (G, E*C, D) -> ((G, t*k, D),)."""
    return (torch.stack([_PlanGather.apply(out[g], at[g], blk_asg[g][:, None])
                         for g in range(out.shape[0])]),)


def _grouped_swiglu(xin, wg, wu, wd):
    """xin (G, E, C, D) -> (G, E, C, D): each group's grouped SwiGLU."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xin, wg)) * torch.einsum("gecd,edf->gecf", xin, wu)
    return torch.einsum("gecf,efd->gecd", h, wd)


def _expert_ffn_groups(xin, wg, wu, wd):
    """`_grouped_swiglu`; on a mesh each rank runs its own token groups
    against the experts' weights gathered but for the hidden dim, which
    stays split over the 'mlp' axes (the expert-parallel-free TP layout of
    `default_rules`): the output is a partial sum over those axes. DTensor's
    own einsums may split the expert dim where it does not divide the
    mesh (60 experts over 16) and then view a permuted local shard."""
    if not SH.is_dtensor(xin):
        return _grouped_swiglu(xin, wg, wu, wd)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, rules = SH.current_ctx()
    names = mesh.mesh_dim_names
    gx = xin.placements
    fx = axis_spec(wg.shape, (None, None, "mlp"), rules.act, SH.mesh_shape(mesh))[2]
    fx = () if fx is None else (fx if isinstance(fx, tuple) else (fx,))
    split = [n in fx and not g.is_shard() for n, g in zip(names, gx)]

    def pl(shard, other):  # Shard(dim) on the hidden dim's mesh dims, `other` elsewhere
        return tuple(Shard(shard) if s else other for s in split)

    in_pl = (tuple(gx), pl(2, Replicate()), pl(2, Replicate()), pl(1, Replicate()))
    out_pl = tuple(Partial() if s else g for s, g in zip(split, gx))
    ffn = SH.local_map(lambda *a: (_grouped_swiglu(*a),), out_placements=(out_pl,),
                       in_placements=in_pl)
    return ffn(xin, *(SH.replicated(w, mesh) for w in (wg, wu, wd)))[0]


def _dispatch_sort_grouped(p, x2, expert_idx, gates, *, k: int, E: int,
                           cf: float, groups: int, C: int | None = None):
    """Hierarchical GFTR dispatch: tokens split into `groups` shard-local
    blocks (the paper's probe-side sub-partitioning applied to MoE), each
    planned on its own, the expert matmuls batched over the group dim.

    Under a mesh the groups are the token shards: each rank plans and
    gathers its own group on its local tensors (`local_map`), and the
    expert matmuls run on the mesh. `C` is the capacity of a single group
    (the no-group path's, a multiple of 512); groups of a split take
    their own (a multiple of 128)."""
    T, D = x2.shape
    t_loc = T // groups
    C_loc = C if groups == 1 and C is not None else _capacity(t_loc, k, E, cf, multiple=128)
    # each (T, ...) input on the tokens' sharding before it splits into groups
    x2, expert_idx, gates = (shard_act(x2, ("tokens", "embed")),
                             shard_act(expert_idx, ("tokens", None)),
                             shard_act(gates, ("tokens", None)))
    xg = shard_act(x2.reshape(groups, t_loc, D), ("tokens", None, "embed"))
    eg = shard_act(expert_idx.reshape(groups, t_loc, k), ("tokens", None, None))
    plan = functools.partial(_plan_gather_local, E=E, C=C_loc)
    combine = _combine_local
    if SH.is_dtensor(xg):
        pl = xg.placements
        plan = SH.local_map(plan, out_placements=(pl, pl, pl), in_placements=(pl, pl))
        combine = SH.local_map(combine, out_placements=(pl,), in_placements=(pl, pl, pl))
    xin, at, blk_asg = plan(xg, eg)
    xin = shard_act(xin, ("tokens", None, None, None))
    out = _expert_ffn_groups(xin, p["wg"], p["wu"], p["wd"])
    out = shard_act(out, ("tokens", None, None, None)).reshape(groups, E * C_loc, D)
    out = shard_act(out, ("tokens", None, None))
    ya = shard_act(combine(out, at, blk_asg)[0], ("tokens", None, None))  # (G, t_loc*k, D)
    gg = shard_act(gates.reshape(groups, t_loc, k), ("tokens", None, None))
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
        ax = tuple(a for a in ax if a in SH.mesh_shape(mesh))
    g = SH._mesh_axis_size(mesh, ax)
    return g if g > 1 and T % g == 0 and T // g >= 8 else 1


def apply_moe(p, x, moe_cfg):
    """x: (b, s, d). Returns (y, aux_loss)."""
    b, s, d = x.shape
    # tokens are sharded over the batch's axes alone: a sequence sharded
    # over another axis is gathered before (b, s) flattens, its gradient too
    x2 = SH.merge_lead(shard_act(x, ("batch", None, "embed")))
    expert_idx, gates, aux = _route(p, x2, moe_cfg.top_k)
    C = _capacity(b * s, moe_cfg.top_k, moe_cfg.num_experts, moe_cfg.capacity_factor)
    if moe_cfg.dispatch == "sort":
        groups = _num_token_groups(b * s)
        if groups > 1 or SH.current_ctx() is not None:
            # under a mesh every group is planned on its rank's local tensors
            y = _dispatch_sort_grouped(p, x2, expert_idx, gates, k=moe_cfg.top_k,
                                       E=moe_cfg.num_experts, cf=moe_cfg.capacity_factor,
                                       groups=groups, C=C)
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
    return SH.split_lead(y, (b, s)), aux * moe_cfg.router_aux_coef
