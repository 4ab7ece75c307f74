"""Elastic scaling: re-shard a training state onto a different mesh.

When nodes join or leave, the controller rebuilds the mesh and calls
`reshard_state`: every leaf is placed on its sharding under the new mesh
(a DTensor of the old mesh is gathered to its full value and sliced anew,
the all-gather + re-slice path). The global batch stays fixed; the
per-rank batch changes with the data-axis size, so training dynamics are
unchanged (the parameters come back bit for bit,
tests/test_torch_distributed.py).
"""
from __future__ import annotations

import torch

from ..dist import sharding as SH
from ..models import model as M
from ..models.params import map_leaves
from .optimizer import AdamWState


def reshard_state(cfg, params, opt_state: AdamWState, new_mesh, rules=None):
    """Returns (params, opt_state) resident on `new_mesh`: DTensors on
    `named_shardings` of the template, the step count replicated. Takes
    plain tensors or DTensors of another mesh. `new_mesh=None` gathers
    every leaf to a plain tensor (one card)."""
    if new_mesh is None:
        def full(tree):
            return map_leaves(SH.full, tree, is_leaf=torch.is_tensor)

        return full(params), AdamWState(
            step=SH.full(opt_state.step), mu=full(opt_state.mu), nu=full(opt_state.nu),
            master=full(opt_state.master) if opt_state.master is not None else None)
    rules = rules or SH.default_rules(multi_pod="pod" in SH.mesh_shape(new_mesh))
    psh = SH.named_shardings(M.template(cfg), new_mesh, rules)
    return SH.place_tree(params, psh), AdamWState(
        step=SH.place(opt_state.step, SH.NamedSharding(new_mesh, ())),
        mu=SH.place_tree(opt_state.mu, psh),
        nu=SH.place_tree(opt_state.nu, psh),
        master=(SH.place_tree(opt_state.master, psh)
                if opt_state.master is not None else None))


def validate_batch_divisibility(global_batch: int, new_mesh) -> bool:
    shape = SH.mesh_shape(new_mesh)
    dp = shape.get("data", 1) * shape.get("pod", 1)
    return global_batch % dp == 0
