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
`shard_act` is the identity, so the same model code runs on one card.
Inside one, a mesh is a `torch.distributed` `DeviceMesh` with named dims
and a sharded tensor is a `DTensor`: `shard_act` redistributes its input to
the placements of its spec, and a plain tensor made inside the step (a
mask, a position table, a cache) enters the mesh replicated.

A spec (one entry per tensor dim: None, a mesh axis name, or a tuple of
names) becomes DTensor placements (one per mesh dim: `Shard(d)` or
`Replicate()`) by `placements_of`. A dim sharded over a tuple of mesh axes
is split over them in mesh order, the first the outermost, which is what
the JAX package's PartitionSpec means by the same tuple; a tuple in
another order than the mesh's cannot be placed and raises ValueError.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any

import torch

from ..launch.mesh import mesh_shape  # noqa: F401  (re-exported)
from ..models.params import axis_spec, map_leaves


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
    shape = mesh_shape(mesh)
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= shape.get(a, 1)
        return n
    return shape.get(ax, 1)


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where one tensor lives on a mesh: its spec (one entry per tensor
    dim) and the DTensor placements it gives (one per mesh dim)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_of(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        """The local shape of a tensor of global `shape` on every rank (the
        divisibility fallback leaves only dims that divide)."""
        sizes = mesh_shape(self.mesh)
        out = []
        for dim, ax in zip(shape, tuple(self.spec) + (None,) * (len(shape) - len(self.spec))):
            names = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
            n = math.prod(sizes[a] for a in names)
            if dim % n:
                raise ValueError(f"dim {dim} does not divide over mesh axes {names}")
            out.append(dim // n)
        return tuple(out)


def placements_of(spec, mesh) -> tuple:
    """DTensor placements of a spec on `mesh`: Shard(d) on each mesh dim
    that tensor dim d names, Replicate() on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axs = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axs]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is sharded over {axs}, not in the mesh's order "
                             f"{tuple(names)}: DTensor splits a dim over mesh dims in mesh "
                             "order only")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(placements, mesh, ndim: int) -> tuple:
    """The spec that `placements` give a rank-`ndim` tensor (the inverse of
    `placements_of`)."""
    per_dim = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements):
        if pl.is_shard():
            per_dim[pl.dim % ndim].append(name)
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a)) for a in per_dim)


def named_shardings(template, mesh, rules: ShardingRules):
    """A NamedSharding per leaf of a parameter template (P leaves), via the
    same divisibility-fallback spec builder used for counting and init."""
    sizes = mesh_shape(mesh)
    return map_leaves(
        lambda leaf: NamedSharding(mesh, axis_spec(leaf.shape, leaf.axes, rules.param, sizes)),
        template)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicated(x, mesh):
    """A plain tensor, identical on every rank, as a replicated DTensor on
    `mesh` (no communication); a DTensor as it is."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def place(x, sharding: NamedSharding):
    """`x` as a DTensor on `sharding`. A plain tensor is taken as the same
    global tensor on every rank and sliced locally; a DTensor on the same
    mesh is redistributed; a DTensor of another mesh is gathered to the
    full tensor first (the elastic path)."""
    mesh, pl = sharding.mesh, sharding.placements
    if is_dtensor(x):
        if x.device_mesh == mesh:
            return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
        x = x.full_tensor()
    from torch.distributed.tensor import DTensor, distribute_tensor

    sharding.shard_shape(x.shape)  # every sharded dim divides evenly
    coord = mesh.get_coordinate()
    if coord is None:  # a rank outside the mesh holds an empty shard
        return distribute_tensor(x, mesh, pl, src_data_rank=None)
    # this rank's shard, sliced locally (mesh dims in order, the first the
    # outermost); a fully replicated tensor keeps its storage
    loc = x
    for i, p in enumerate(pl):
        if p.is_shard():
            n = loc.shape[p.dim] // mesh.size(i)
            loc = loc.narrow(p.dim, coord[i] * n, n)
    if loc is not x:
        loc = loc.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(loc, mesh, pl, run_check=False)


def place_tree(tree, shardings):
    """`place` over matching trees of tensors and NamedShardings."""
    flat_sh = []
    map_leaves(flat_sh.append, shardings, is_leaf=lambda s: isinstance(s, NamedSharding))
    it = iter(flat_sh)
    return map_leaves(lambda t: place(t, next(it)), tree, is_leaf=torch.is_tensor)


def replicate_all(x):
    """A DTensor gathered whole onto every rank of its mesh (still a
    DTensor); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def local_map(fn, *, out_placements, in_placements):
    """`fn` on each rank's local shards (torch's `local_map`, its inputs
    redistributed to `in_placements`, its outputs DTensors of
    `out_placements`), run outside the mesh context: the local code is the
    one-card code. The inputs' gradients are laid out by `grad_placements`."""
    from torch.distributed.tensor.experimental import local_map as _local_map

    def on_one_rank(*args):  # the local code sees no mesh context
        token = _CTX.set(None)
        try:
            return fn(*args)
        finally:
            _CTX.reset(token)

    return _local_map(on_one_rank, out_placements=out_placements,
                      in_placements=in_placements,
                      in_grad_placements=grad_placements(in_placements),
                      redistribute_inputs=True)


def grad_placements(in_placements):
    """The gradients' placements of a `local_map` region's inputs: where an
    input is replicated over a mesh dim that splits another input, each
    rank works on its own part with the same copy of it, so the gradient
    each rank returns is a partial sum there (a weight's, where the tokens
    are split; the tokens', where a weight's output dim is split); elsewhere
    it is laid out as the input."""
    from torch.distributed.tensor import Partial

    split = [any(pl is not None and pl[m].is_shard() for pl in in_placements)
             for m in range(max(len(pl) for pl in in_placements if pl is not None))]
    return tuple(None if pl is None else
                 tuple(Partial() if s and p.is_replicate() else p for s, p in zip(split, pl))
                 for pl in in_placements)


def local(x):
    """The local shard of a DTensor, or `x` itself."""
    return x.to_local() if is_dtensor(x) else x


def full(x):
    """The global tensor of a DTensor (gathered on every rank), or `x`."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------
_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_sharding_ctx",
                                                      default=None)


@contextlib.contextmanager
def sharding_ctx(mesh, rules: ShardingRules):
    """Install (mesh, rules) for the enclosed code. Re-entrant; the inner
    context wins. On a DeviceMesh, a plain tensor that meets a DTensor in
    the enclosed code is taken as replicated (DTensor's implicit
    replication): the masks, positions and tables the model makes."""
    token = _CTX.set((mesh, rules))
    dispatcher = prev = None
    if hasattr(mesh, "mesh_dim_names"):
        from torch.distributed.tensor import DTensor

        # the flag `implicit_replication()` sets, restored to what it was on
        # exit, so that a context entered again inside (a layer recomputed
        # in the backward) leaves the outer one's on
        dispatcher = DTensor._op_dispatcher
        prev = dispatcher._allow_implicit_replication
        dispatcher._allow_implicit_replication = True
    try:
        yield (mesh, rules)
    finally:
        if dispatcher is not None:
            dispatcher._allow_implicit_replication = prev
        _CTX.reset(token)


def bind_ctx(fn):
    """`fn` run under the context active now, wherever it is called later:
    a layer that autograd recomputes in the backward, which on a card runs
    on the engine's own thread, where the context variable is unset."""
    ctx = current_ctx()
    if ctx is None:
        return fn

    def bound(*args, **kwargs):
        with sharding_ctx(*ctx):
            return fn(*args, **kwargs)

    return bound


def current_ctx():
    """The active (mesh, rules) pair, or None outside any sharding_ctx."""
    return _CTX.get()


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------
def shard_act(x, axes):
    """Constrain activation `x` to the current context's mapping of logical
    `axes` (tuple of logical names / None, one per dim). The identity
    outside a sharding_ctx; inside one it returns a DTensor redistributed
    to the spec's placements, a plain tensor taken as replicated first."""
    ctx = current_ctx()
    if ctx is None:
        return x
    mesh, rules = ctx
    if len(axes) != x.dim():
        raise ValueError(f"shard_act: {len(axes)} axes for rank-{x.dim()} tensor")
    return constrain(x, axis_spec(x.shape, axes, rules.act, mesh_shape(mesh)))


def constrain(x, spec):
    """`x` on the current context's mesh with `spec` (mesh axes per dim),
    its gradient back on `x`'s placements (`_Constrain`); a plain tensor
    enters replicated first."""
    mesh = current_ctx()[0]
    return _Constrain.apply(replicated(x, mesh), placements_of(spec, mesh))


def pin(x):
    """`x` as it is, its gradient redistributed to `x`'s placements: a
    view's output whose gradient DTensor could otherwise shard along a
    flattened dim that the view back cannot split. `x` itself off a mesh."""
    return _Constrain.apply(x, tuple(x.placements)) if is_dtensor(x) else x


def merge_lead(x, n: int = 2):
    """`x` (d0, ..., d{n-1}, *rest) as (d0 * ... * d{n-1}, *rest): the
    (batch, seq) flatten of the MoE tokens and of `layers.contract`. On a
    mesh the merged dims are laid out on d0's mesh axes alone on both sides
    of the reshape, in the forward and, through `_Constrain`, in the
    backward: a dim sharded after the first (the sequence over 'model') is
    gathered first, so no strided shard reaches a view."""
    shape = (math.prod(x.shape[:n]),) + tuple(x.shape[n:])
    if not is_dtensor(x):
        return x.reshape(shape)
    mesh = x.device_mesh
    spec = spec_of(x.placements, mesh, x.dim())
    x = _Constrain.apply(x, placements_of((spec[0],) + (None,) * (n - 1) + spec[n:], mesh))
    return _Constrain.apply(x.reshape(shape), placements_of((spec[0],) + spec[n:], mesh))


def split_lead(y, lead):
    """`merge_lead`'s inverse: `y` (prod(lead), *rest) as (*lead, *rest),
    the result laid out on the first dim's mesh axes alone (replicated where
    lead[0] does not divide them), its gradient gathered there before the
    view."""
    shape = tuple(lead) + tuple(y.shape[1:])
    if not is_dtensor(y):
        return y.reshape(shape)
    mesh = y.device_mesh
    spec = spec_of(y.placements, mesh, y.dim())
    ax0 = spec[0] if lead[0] % _mesh_axis_size(mesh, spec[0]) == 0 else None
    y = _Constrain.apply(y, placements_of((ax0,) + spec[1:], mesh))
    return _Constrain.apply(y.reshape(shape),
                            placements_of((ax0,) + (None,) * (len(lead) - 1) + spec[1:], mesh))


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to `placements`, its gradient redistributed
    back to the placements the input had (a partial sum's gradient
    replicated): the backward mirrors the forward, so each op of the
    backward sees its output's gradient on the sharding its forward output
    had, every view's gradient reshapes as the view did, and a gradient
    never leaves a region laid out another way (the sequence split over
    'model') in that region's layout."""

    @staticmethod
    def forward(ctx, x, placements):
        from torch.distributed.tensor import Replicate

        ctx.in_placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.in_placements:
            g = g.redistribute(g.device_mesh, ctx.in_placements)
        return g, None
