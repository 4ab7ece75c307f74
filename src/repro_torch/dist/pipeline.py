"""Pipeline parallelism over a mesh axis (DESIGN.md §6).

GPipe-style schedule: the layer stack is split into S contiguous stages,
one per rank along the pipeline mesh axis; the batch is split into M
microbatches that stream through the stages, each tick's activation sent
to the next rank of the axis (`batch_isend_irecv`). Total ticks = M + S -
1; bubble fraction = (S-1)/(M+S-1).

Forward-only (the serving/inference pipeline). The stage function is
user-supplied so the same scheduler runs toy stacks (tests) and full
transformer blocks.
"""
from __future__ import annotations

import torch

from ..models.params import leaves, map_leaves
from .sharding import local, mesh_shape


def split_layers_to_stages(ws, n_stages: int):
    """Split stacked per-layer weights (a tree with a leading (L, ...) layer
    dim on every leaf) into `n_stages` contiguous stages: (S, L//S, ...).
    The stage count must divide the layer count evenly — stages must be
    load-balanced or the pipeline ticks at the slowest stage's rate."""

    def _split(w):
        L = w.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} stages")
        return w.reshape((n_stages, L // n_stages) + tuple(w.shape[1:]))

    return map_leaves(_split, ws, is_leaf=torch.is_tensor)


def _stage(stages, s: int):
    return map_leaves(lambda w: w[s], stages, is_leaf=torch.is_tensor)


def _sequential(stage_fn, stages, x):
    """Reference schedule: every stage on the full batch, in order."""
    n_stages = leaves(stages, torch.is_tensor)[0].shape[0]
    for s in range(n_stages):
        x = stage_fn(_stage(stages, s), x)
    return x


def pipeline_forward(stage_fn, stages, x, *, mesh=None, axis=None, n_micro: int = 1):
    """Run `stage_fn(stage_weights, x_micro)` as a pipeline.

    stages: tree with a leading (S, ...) stage dim (split_layers_to_stages),
            the same on every rank (each rank runs its own stage).
    x:      (B, ...) batch, the same on every rank; B must divide into
            n_micro microbatches.
    mesh/axis: the mesh axis hosting the stages. S must equal the axis size;
    otherwise (or with no mesh) the sequential reference schedule runs —
    same math, no parallelism — so callers need no topology case-split.

    Every rank returns the last stage's outputs (broadcast over the axis).
    Matches the sequential schedule exactly up to float32 reassociation
    (asserted to 1e-5 in tests/test_torch_distributed.py)."""
    n_stages = leaves(stages, torch.is_tensor)[0].shape[0]
    if mesh is None or axis is None or mesh_shape(mesh).get(axis, 1) != n_stages:
        return _sequential(stage_fn, stages, x)
    import torch.distributed as dist

    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
    x = local(x)
    xm = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    stage = mesh.get_local_rank(axis)
    nxt, prv = ranks[(stage + 1) % n_stages], ranks[(stage - 1) % n_stages]
    ws = _stage(map_leaves(local, stages, is_leaf=torch.is_tensor), stage)
    state = torch.zeros_like(xm[0])  # activation in flight
    out = torch.zeros_like(xm)  # valid on the last stage
    for t in range(n_micro + n_stages - 1):
        # stage s works on microbatch t-s this tick; stage 0 pulls fresh
        # input, later stages consume the received activation. Ticks
        # outside [0, n_micro) compute values that are never stored.
        inp = xm[min(t, n_micro - 1)] if stage == 0 else state
        y = stage_fn(ws, inp).contiguous()
        m = t - (n_stages - 1)
        if 0 <= m < n_micro and stage == n_stages - 1:
            out[m] = y
        state = torch.empty_like(y)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, y, nxt, group),
                                           dist.P2POp(dist.irecv, state, prv, group)]):
            req.wait()
    # the last stage's outputs to every rank of the axis
    dist.broadcast(out, src=ranks[n_stages - 1], group=group)
    return out.reshape((B,) + tuple(out.shape[2:]))
