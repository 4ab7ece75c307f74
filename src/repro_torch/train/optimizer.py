"""AdamW + gradient clipping + LR schedules on trees of tensors, with the
JAX package's formulas.

Supports bf16 parameters with f32 master weights: when `master_weights` is
on, the optimizer state carries the f32 copy (the bf16 params are just the
compute view).

`update` writes the parameters and the state it is given in place, one leaf
at a time under `torch.no_grad()`, and returns them: the JAX package donates
both to its jitted step instead. The state costs 8 bytes a parameter (12
with master weights) and an update adds one leaf's temporaries, never a
second copy of the tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..models.params import leaves, map_leaves, params_from_numpy


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: object
    nu: object
    master: object  # f32 master params or None


def _tensors(tree) -> list:
    return leaves(tree, torch.is_tensor)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    master_weights: bool = False

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        master = (map_leaves(lambda p: p.detach().to(torch.float32, copy=True), params,
                             is_leaf=torch.is_tensor)
                  if self.master_weights else None)
        device = _tensors(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          map_leaves(zeros, params, is_leaf=torch.is_tensor),
                          map_leaves(zeros, params, is_leaf=torch.is_tensor), master)

    def _lr(self, step):
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """Returns (params, state, grad_norm), the first two written in
        place."""
        g_leaves = _tensors(grads)
        gnorm = global_norm(g_leaves)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        state.step.add_(1)
        b1, b2 = self.b1, self.b2
        s = state.step.float()
        bc1 = 1 - b1 ** s
        bc2 = 1 - b2 ** s
        lr = self._lr(state.step)
        masters = _tensors(state.master) if self.master_weights else [None] * len(g_leaves)
        for p, m, v, g, master in zip(_tensors(params), _tensors(state.mu),
                                      _tensors(state.nu), g_leaves, masters):
            g = g.float()
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            ref = master if master is not None else p.float()
            den = (v / bc2).sqrt_().add_(self.eps)
            u = (m / bc1).div_(den)
            del den
            u.add_(ref, alpha=self.weight_decay).mul_(lr)
            ref.sub_(u)
            del u
            if ref is not p:
                p.copy_(ref)
        return params, state, gnorm


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in _tensors(tree)))


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def f(step):
        s = torch.as_tensor(step).float()
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup, warm, cos)

    return f


def linear_warmup(peak_lr: float, warmup: int):
    return lambda step: peak_lr * torch.clamp(torch.as_tensor(step).float() / max(warmup, 1),
                                              max=1.0)


def state_from_numpy(state, *, device="cuda") -> AdamWState:
    """An AdamW state of numpy arrays (the JAX package's `AdamWState`
    converted leaf by leaf with `np.asarray`, `master` possibly None) as the
    port's, on `device`."""
    return AdamWState(*params_from_numpy(tuple(state), device=device))
