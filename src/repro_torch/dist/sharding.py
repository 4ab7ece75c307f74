"""Logical-axis sharding rules and the mesh context (DESIGN.md §6).

Model code never names mesh axes. Parameters declare *logical* axes in their
templates (params.P) and activations are constrained through `shard_act`
with logical names; a `ShardingRules` table maps logical -> mesh axes.
Changing the distribution strategy (FSDP on/off, sequence sharding, expert
parallelism, the flat-DP variant) is a rule-table edit, never a model edit.

Every mapping applies a divisibility fallback: a tensor dim that does not
divide the product of its mapped mesh axes is replicated instead. Within one
tensor, the first logical axis to claim a mesh axis wins and later claims
are dropped (`params.axis_spec`).

`sharding_ctx` installs (mesh, rules) for a region of code; outside one,
`shard_act` is the identity, so the same model code runs on one card. The
port has no sharded execution yet: inside a context `shard_act` raises
`NotImplementedError` instead of running the model unsharded under a mesh
it was given. A mesh is any object whose `shape` maps axis names to sizes.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

from ..models.params import axis_spec

# what a sharded run waits for
SHARDING_TODO = "sharded execution is ROADMAP Queue 1's dist/ item, not ported yet"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Two logical->mesh tables: `param` for weight templates, `act` for
    activation constraints. Values are a mesh axis name, a tuple of mesh
    axis names (2D sharding), or None (replicate)."""

    param: dict[str, Any]
    act: dict[str, Any]


def default_rules(*, multi_pod: bool = False, seq_shard: bool = False,
                  fsdp: bool = True) -> ShardingRules:
    """The DESIGN.md §6 strategy: DP over ('pod','data'), FSDP parameter
    sharding over 'data', TP over 'model'; `seq_shard` adds sequence
    parallelism for train/prefill activations (decode keeps seq unsharded —
    one token has no seq dim to split)."""
    dp = ("pod", "data") if multi_pod else ("data",)
    fs = "data" if fsdp else None
    param = {
        "embed": fs,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "inner": "model",
        "conv": None,
        "experts": None,
        "expert_embed": fs,
        "expert_mlp": "model",
        "layers": None,  # stacked layer dim: always unsharded
    }
    act = {
        "batch": dp,
        "tokens": dp,  # flattened (b*s) dim of MoE dispatch
        "seq": "model" if seq_shard else None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "inner": "model",
        "vocab": "model",
    }
    return ShardingRules(param=param, act=act)


def _mesh_axis_size(mesh, ax) -> int:
    """Product of the sizes of `ax` (None | name | tuple of names); axes not
    present in the mesh count as 1."""
    if ax is None:
        return 1
    shape = dict(mesh.shape)
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= shape.get(a, 1)
        return n
    return shape.get(ax, 1)


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------
_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_sharding_ctx",
                                                      default=None)


@contextlib.contextmanager
def sharding_ctx(mesh, rules: ShardingRules):
    """Install (mesh, rules) for the enclosed code. Re-entrant; the inner
    context wins."""
    token = _CTX.set((mesh, rules))
    try:
        yield (mesh, rules)
    finally:
        _CTX.reset(token)


def current_ctx():
    """The active (mesh, rules) pair, or None outside any sharding_ctx."""
    return _CTX.get()


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------
def shard_act(x, axes):
    """Constrain activation `x` to the current context's mapping of logical
    `axes` (tuple of logical names / None, one per dim). The identity
    outside a sharding_ctx; inside one it raises NotImplementedError, since
    the port cannot yet place a tensor on a mesh."""
    ctx = current_ctx()
    if ctx is None:
        return x
    mesh, rules = ctx
    if len(axes) != x.dim():
        raise ValueError(f"shard_act: {len(axes)} axes for rank-{x.dim()} tensor")
    spec = axis_spec(x.shape, axes, rules.act, dict(mesh.shape))
    raise NotImplementedError(f"shard_act{spec}: {SHARDING_TODO}")
