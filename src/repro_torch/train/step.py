"""Train, prefill and serve step builders on one card.

`build_train_step` composes `model.loss_fn`, its gradients and the
optimizer into one callable, as the JAX package's builder does under jit.
The JAX package also places each tensor on a mesh (its shardings); the port
runs on one card, so `mesh` must be None, and the builders return None
where the JAX package returns shardings. A mesh raises NotImplementedError
until ROADMAP Queue 1's dist/ item brings `named_shardings`.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import model as M
from ..models.params import leaves, map_leaves
from .optimizer import AdamW, AdamWState

DIST_TODO = ("sharded steps wait for ROADMAP Queue 1, item 3c (dist/: named_shardings, "
             "batch, cache and optimizer-state shardings on a device mesh)")


def _one_card(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(f"a step on a mesh: {DIST_TODO}")


def _rebuild(tree, tensors):
    """`tree` with its tensor leaves replaced, in `leaves` order."""
    it = iter(tensors)
    return map_leaves(lambda _: next(it), tree, is_leaf=torch.is_tensor)


def _copy(tree):
    return map_leaves(torch.clone, tree, is_leaf=torch.is_tensor)


def build_train_step(cfg: ArchConfig, mesh, rules, opt: AdamW, *, remat=True,
                     donate: bool = True, microbatches: int = 1):
    """Returns (step, None, None); `mesh` must be None (one card).

    step(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    {"ce", "aux", "loss", "grad_norm"} as 0-d tensors. With `donate` the
    step writes the parameters and the state it is given and returns them;
    without it, it updates copies and leaves them as they were.

    microbatches > 1 runs gradient accumulation: the global batch is split
    into M sequential microbatches whose float32 gradients are summed and
    divided by M (activation peak divides by ~M at the cost of M x
    parameter traffic)."""
    _one_card(mesh)

    def grads_of(params, batch):
        ps = [p.detach().requires_grad_() for p in leaves(params, torch.is_tensor)]
        loss, metrics = M.loss_fn(cfg, _rebuild(params, ps), batch, remat=remat)
        grads = torch.autograd.grad(loss, ps, allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def step(params, opt_state: AdamWState, batch):
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
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return step, None, None


def build_serve_step(cfg: ArchConfig, mesh, rules, b: int, w: int):
    """Returns (serve, None, None, None); serve(params, cache, token, pos)
    -> (logits, cache). `model.decode_step` never writes the cache it is
    given, so there is nothing to donate."""
    _one_card(mesh)

    def serve(params, cache, token, pos):
        return M.decode_step(cfg, params, cache, token, pos)

    return serve, None, None, None


def build_prefill_step(cfg: ArchConfig, mesh, rules):
    """prefill(params, batch) -> logits (no optimizer), for inference-prefill
    cells; remat off, forward only. Returns (prefill, None, None)."""
    _one_card(mesh)

    @torch.no_grad()
    def prefill(params, batch):
        logits, _aux = M.forward(cfg, params, batch, remat=False)
        return logits

    return prefill, None, None
