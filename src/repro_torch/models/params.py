"""Parameter templates: one source of truth for init AND sharding.

A model declares its parameters as a nested dict of `P` leaves, each carrying
(shape, logical_axes, init). From the same template we derive:

  * initialized parameter trees (init_from_template), a nested dict of
    tensors with the template's keys
  * partition specs (specs_from_template + repro_torch.dist.sharding rules);
    a spec is a plain tuple, one entry per dim: a mesh axis name, a tuple of
    names, or None
  * parameter counts (count_params)
  * tensors without storage for the dry run (abstract_from_template)

Stacked layers wrap a per-layer template with `stack(tmpl, L)`, which
prepends a (L,) 'layers' axis — always unsharded.

`params_from_numpy` carries a parameter tree across from numpy arrays (the
JAX package's trees, converted with `np.asarray`), so that both packages
can run on the same weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class P:
    """A parameter leaf declaration."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | embed | small
    scale: float | None = None  # override fan-in scale

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape/axes mismatch: {self.shape} vs {self.axes}")


def map_leaves(fn, tree, is_leaf=lambda x: isinstance(x, P)):
    """Apply `fn` to every leaf of a tree of dicts, lists, tuples and named
    tuples; dict keys are visited in sorted order and None holds no leaf
    (the JAX package's flattening order)."""
    if is_leaf(tree):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, is_leaf) for v in tree)
    return fn(tree)


def leaves(tree, is_leaf=lambda x: isinstance(x, P)) -> list:
    """The leaves of a tree in `map_leaves` order."""
    out = []
    map_leaves(out.append, tree, is_leaf)
    return out


def stack(template: Any, n: int) -> Any:
    """Prepend a stacked 'layers' dimension to every leaf."""
    return map_leaves(lambda l: P((n,) + l.shape, ("layers",) + l.axes, l.init, l.scale),
                      template)


def _leaf_scale(leaf: P) -> float:
    # fan-in scaled normal; 'embed' uses unit normal scaled by 1/sqrt(d_last)
    if leaf.scale is not None:
        return leaf.scale
    if leaf.init == "embed":
        return 1.0
    if leaf.init == "small":
        return 0.02
    fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def _init_leaf(leaf: P, generator: torch.Generator, dtype, device):
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    # drawn in `dtype` itself: a float32 scratch copy of the largest leaf
    # (a stacked expert weight) would take twice a bf16 model's bytes
    return torch.empty(leaf.shape, dtype=dtype, device=device).normal_(
        0.0, _leaf_scale(leaf), generator=generator)


def init_from_template(template: Any, generator: torch.Generator, dtype=torch.float32,
                       device="cuda"):
    """Real parameters, one leaf at a time in `map_leaves` order, drawn from
    `generator` (which must live on `device`) with the JAX package's scales.
    The random streams differ from JAX's; `params_from_numpy` carries the
    JAX package's own weights across."""
    return map_leaves(lambda l: _init_leaf(l, generator, dtype, device), template)


def abstract_from_template(template: Any, dtype=torch.float32):
    """The template's leaves as tensors without storage (on the meta
    device), for the dry run's trace."""
    return map_leaves(lambda l: torch.empty(l.shape, dtype=dtype, device="meta"), template)


def params_from_numpy(tree: Any, *, dtype=None, device="cuda"):
    """A tree of numpy arrays (or anything `np.asarray` takes) as the same
    tree of tensors on `device`; floating leaves are cast to `dtype` when it
    is given, integer leaves keep theirs, and bfloat16 arrays come across as
    bfloat16 tensors."""

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch cannot read
            t = torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
        else:
            t = torch.tensor(a, device=device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return map_leaves(one, tree,
                      is_leaf=lambda x: x is not None and not isinstance(x, (dict, list, tuple)))


def axis_spec(shape, axes, rules: dict[str, Any], mesh_shape: dict[str, int]) -> tuple:
    """Map one tensor's logical axes to a partition spec under a rule table.

    The single spec builder shared by parameter templates and activation
    constraints (dist.sharding.shard_act). Fallbacks, in order, per dim:
    axes absent from the mesh or of size 1 are dropped; within a tensor the
    first logical axis to claim a mesh axis wins; a dim that does not divide
    its mapped axes is replicated (tuple mappings greedily drop trailing
    axes until the dim divides)."""
    out, used = [], set()
    for dim, name in zip(shape, axes):
        ax = rules.get(name) if name else None
        if isinstance(ax, (tuple, list)):  # 2D sharding, e.g. expert FFN dims
            cand = tuple(a for a in ax if a not in used and mesh_shape.get(a, 1) > 1)
            while cand:
                size = math.prod(mesh_shape[a] for a in cand)
                if dim % size == 0:
                    break
                cand = cand[:-1]
            if cand:
                out.append(cand if len(cand) > 1 else cand[0])
                used.update(cand)
            else:
                out.append(None)
            continue
        size = mesh_shape.get(ax, 1) if ax is not None else 1
        if ax is None or ax in used or size <= 1 or dim % size != 0:
            out.append(None)
        else:
            out.append(ax)
            used.add(ax)
    return tuple(out)


def specs_from_template(template: Any, rules: dict[str, Any], mesh_shape: dict[str, int]):
    """Map logical axes to mesh axes with divisibility fallback (replicate
    any dim that does not divide its mesh axis)."""
    return map_leaves(lambda leaf: axis_spec(leaf.shape, leaf.axes, rules, mesh_shape),
                      template)


def count_params(template: Any) -> int:
    return sum(math.prod(l.shape) for l in leaves(template))
