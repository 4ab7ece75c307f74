"""Train, prefill and serve step builders, on one card or on a device mesh.

`build_train_step` composes `model.loss_fn`, its gradients and the
optimizer into one callable, as the JAX package's builder does under jit.
With `mesh=None` the step runs on one card and the builders return None
where the JAX package returns shardings. With a `DeviceMesh` they return
the shardings (`dist.sharding.NamedSharding` trees), and the step places
each input on its sharding (a plain tensor is taken as the same global
tensor on every rank), runs the model on DTensors under the mesh context
(a tensor the model makes inside the step enters the mesh replicated), and
returns DTensors on the same shardings, the metrics as plain tensors.

Distribution strategy (DESIGN.md §6): DP over ('pod','data'), FSDP
parameter sharding over 'data', TP over 'model', optional SP/EP through
rule overrides. The gradient reductions come from DTensor's propagation
of the placements: there is no hand-written all-reduce.
"""
from __future__ import annotations

import contextlib

import torch

from ..configs.base import ArchConfig
from ..dist import sharding as SH
from ..models import model as M
from ..models.params import axis_spec, leaves, map_leaves
from .optimizer import AdamW, AdamWState


def _rebuild(tree, tensors):
    """`tree` with its tensor leaves replaced, in `leaves` order."""
    it = iter(tensors)
    return map_leaves(lambda _: next(it), tree, is_leaf=torch.is_tensor)


def _copy(tree):
    return map_leaves(torch.clone, tree, is_leaf=torch.is_tensor)


def _batch_axes(mesh, rules: SH.ShardingRules):
    """The batch's mesh axes present in `mesh`, or None."""
    bx = rules.act.get("batch")
    if isinstance(bx, tuple):
        bx = tuple(a for a in bx if a in SH.mesh_shape(mesh)) or None
    return bx


def batch_shardings(cfg: ArchConfig, mesh, rules: SH.ShardingRules, kind: str):
    """NamedShardings for the input batch of a train/prefill step."""
    bx = _batch_axes(mesh, rules)
    sh = {"tokens": SH.NamedSharding(mesh, (bx, None))}
    if cfg.family == "vlm":
        sh["vision_emb"] = SH.NamedSharding(mesh, (bx, None, None))
    if cfg.family == "audio":
        sh["enc_emb"] = SH.NamedSharding(mesh, (bx, None, None))
    return sh


def place_batch(batch, mesh, rules: SH.ShardingRules):
    """Each batch tensor on the mesh, its leading dim sharded over the
    batch's axes as far as the dim divides (the spec builder's fallback:
    trailing axes dropped, or replicated). The sequence enters whole, as in
    the JAX package's in-shardings, with `seq_shard` too: the embedding's
    constraint splits it."""
    sizes = SH.mesh_shape(mesh)
    return {k: SH.place(v, SH.NamedSharding(
                mesh, axis_spec(v.shape, ("batch",) + (None,) * (v.dim() - 1), rules.act, sizes)))
            for k, v in batch.items()}


def cache_shardings(cfg: ArchConfig, mesh, rules: SH.ShardingRules, b: int, w: int):
    """Decode-cache NamedShardings, from the same spec builder as shard_act,
    so that the cache layout matches the decode attention's."""
    shapes = leaves(M.cache_shapes(cfg, b, w), lambda x: isinstance(x, M.TensorSpec))
    sizes = SH.mesh_shape(mesh)
    it = iter(shapes)
    return map_leaves(
        lambda ax: SH.NamedSharding(mesh, axis_spec(next(it).shape, ax.axes, rules.act, sizes)),
        M.cache_axes(cfg, b, w), is_leaf=lambda x: isinstance(x, M.AxesLeaf))


def opt_state_shardings(param_sh, mesh):
    """AdamW state shardings: the moments and master weights as the
    parameters, the step count replicated."""
    return AdamWState(step=SH.NamedSharding(mesh, ()), mu=param_sh, nu=param_sh,
                      master=param_sh)


def _place_opt_state(opt_state: AdamWState, osh: AdamWState) -> AdamWState:
    return AdamWState(
        step=SH.place(opt_state.step, osh.step),
        mu=SH.place_tree(opt_state.mu, osh.mu),
        nu=SH.place_tree(opt_state.nu, osh.nu),
        master=(SH.place_tree(opt_state.master, osh.master)
                if opt_state.master is not None else None))


def _mesh_ctx(mesh, rules):
    """The mesh context of a step (none on one card)."""
    return contextlib.nullcontext() if mesh is None else SH.sharding_ctx(mesh, rules)


def build_train_step(cfg: ArchConfig, mesh, rules, opt: AdamW, *, remat=True,
                     donate: bool = True, microbatches: int = 1):
    """Returns (step, param_shardings, batch_shardings), the shardings None
    on one card (`mesh` None).

    step(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    {"ce", "aux", "loss", "grad_norm"} as 0-d tensors. With `donate` the
    step writes the parameters and the state it is given (on a mesh: the
    DTensors it places them on) and returns them; without it, it updates
    copies and leaves them as they were.

    microbatches > 1 runs gradient accumulation: the global batch is split
    into M sequential microbatches whose float32 gradients are summed and
    divided by M (activation peak divides by ~M at the cost of M x
    parameter traffic)."""
    psh = osh = bsh = None
    if mesh is not None:
        psh = SH.named_shardings(M.template(cfg), mesh, rules)
        osh = opt_state_shardings(psh, mesh)
        bsh = batch_shardings(cfg, mesh, rules, "train")
    p_sh = leaves(psh, lambda x: isinstance(x, SH.NamedSharding)) if psh else None

    def grads_of(params, batch):
        if mesh is not None:
            batch = place_batch(batch, mesh, rules)
        ps = [p.detach().requires_grad_() for p in leaves(params, torch.is_tensor)]
        loss, metrics = M.loss_fn(cfg, _rebuild(params, ps), batch, remat=remat)
        grads = torch.autograd.grad(loss, ps, allow_unused=True, materialize_grads=True)
        if p_sh is not None:  # each gradient on its parameter's sharding
            grads = [SH.place(g, s) for g, s in zip(grads, p_sh)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def step(params, opt_state: AdamWState, batch):
        if mesh is not None:
            params = SH.place_tree(params, psh)
            opt_state = _place_opt_state(opt_state, osh)
            batch = {k: SH.full(v) for k, v in batch.items()}
        with _mesh_ctx(mesh, rules):
            if microbatches == 1:
                loss, metrics, grads = grads_of(params, batch)
            else:
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])
                      for k, v in batch.items()}
                gsum, lsum, asum = None, 0.0, 0.0
                for i in range(microbatches):
                    l, m, g = grads_of(params, {k: v[i] for k, v in mb.items()})
                    if gsum is None:
                        gsum = [gg.float() for gg in g]
                    else:
                        for a, gg in zip(gsum, g):
                            a.add_(gg.float())
                    lsum, asum = lsum + l, asum + m["aux"]
                grads = [g / microbatches for g in gsum]
                loss = lsum / microbatches
                metrics = {"ce": loss - asum / microbatches, "aux": asum / microbatches}
            if not donate:
                params, opt_state = _copy(params), _copy(opt_state)
            params, opt_state, gnorm = opt.update(_rebuild(params, grads), opt_state, params)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return params, opt_state, {k: SH.full(v) for k, v in metrics.items()}

    return step, psh, bsh


def build_serve_step(cfg: ArchConfig, mesh, rules, b: int, w: int):
    """Returns (serve, param_shardings, cache_shardings, token_sharding),
    the shardings None on one card; serve(params, cache, token, pos) ->
    (logits, cache). `model.decode_step` never writes the cache it is
    given, so there is nothing to donate."""
    if mesh is None:
        def serve(params, cache, token, pos):
            return M.decode_step(cfg, params, cache, token, pos)

        return serve, None, None, None

    psh = SH.named_shardings(M.template(cfg), mesh, rules)
    csh = cache_shardings(cfg, mesh, rules, b, w)
    bx = _batch_axes(mesh, rules)
    if b % SH._mesh_axis_size(mesh, bx) != 0:
        bx = None
    tok_sh = SH.NamedSharding(mesh, (bx,))
    logits_sh = SH.NamedSharding(mesh, (bx, None))

    def serve(params, cache, token, pos):
        params = SH.place_tree(params, psh)
        cache = SH.place_tree(cache, csh)
        token = SH.place(token, tok_sh)
        with _mesh_ctx(mesh, rules):
            logits, cache = M.decode_step(cfg, params, cache, token, pos)
        return SH.place(logits, logits_sh), SH.place_tree(cache, csh)

    return serve, psh, csh, tok_sh


def build_prefill_step(cfg: ArchConfig, mesh, rules):
    """prefill(params, batch) -> logits (no optimizer), for inference-prefill
    cells; remat off, forward only. Returns (prefill, param_shardings,
    batch_shardings), the shardings None on one card."""
    psh = bsh = None
    if mesh is not None:
        psh = SH.named_shardings(M.template(cfg), mesh, rules)
        bsh = batch_shardings(cfg, mesh, rules, "prefill")

    @torch.no_grad()
    def prefill(params, batch):
        if mesh is not None:
            params = SH.place_tree(params, psh)
            batch = place_batch(batch, mesh, rules)
        with _mesh_ctx(mesh, rules):
            logits, _aux = M.forward(cfg, params, batch, remat=False)
        return logits

    return prefill, psh, bsh
