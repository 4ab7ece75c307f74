"""Roofline terms of one traced step, and the tracer that counts what they
read (collectives, FLOPs, live storage).

Three terms, per (arch x shape x mesh), in seconds:

    compute    = FLOPs / (chips x PEAK_FLOPS)
    memory     = HBM bytes / HBM_BW                 (per rank)
    collective = wire bytes / LINK_BW               (per rank)

The constants are one NVIDIA H100 SXM5's, from NVIDIA's H100 Tensor Core
GPU datasheet, and the DGX H100 layout:
  * PEAK_FLOPS: 989 TFLOP/s of dense bf16 tensor-core math (the datasheet's
    1,979 is with 2:4 sparsity);
  * HBM_BW: 3.35 TB/s of HBM3; HBM_CAP: 80 GB;
  * LINK_BW: 50 GB/s, one 400 Gb/s NDR InfiniBand port per GPU (a DGX H100
    has eight ConnectX-7 ports for its eight GPUs). An NVLink domain holds
    8 cards, so a 16-wide mesh axis crosses this link; NVLink 4's 450 GB/s
    per direction inside the domain is not the term.

The JAX package reads collectives and dot FLOPs from compiled HLO text;
the port traces one eager step instead. `StepTracer`, a
`TorchDispatchMode` under DTensor, sees each rank-local op (and skips the
fake-tensor ops of DTensor's own shape propagation): the
`_c10d_functional` collectives DTensor issues (kind and output bytes:
`CollectiveStats`), the FLOPs of each op from
`torch.utils.flop_counter`'s table, and the live-storage watermark of
`analysis.dispatch_audit.LiveStorageMode`. An eager trace runs every loop
iteration, so `bytes_weighted` (the JAX package's count weighted by while
trip counts) equals `bytes_static`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..analysis.dispatch_audit import LiveStorageMode

PEAK_FLOPS = 989e12  # bf16 dense, one H100 SXM5 (NVIDIA H100 datasheet)
HBM_BW = 3.35e12  # bytes/s, HBM3 of one H100 SXM5
LINK_BW = 50e9  # bytes/s, one 400 Gb/s NDR port per GPU (DGX H100)
HBM_CAP = 80e9  # bytes, one H100 SXM5

# the JAX package's names for the collectives DTensor issues
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_static: float  # summed once
    bytes_weighted: float  # equal to bytes_static: an eager trace unrolls its loops
    per_op: list


class StepTracer(LiveStorageMode):
    """Counts, over one step on each rank's local tensors: the collectives
    (`stats()`), the FLOPs (`flops`) and the peak of live storage (`peak`,
    the step's inputs counted from the start). Ops on DTensors are passed
    on to DTensor, whose local ops come back through the mode."""

    def __init__(self, inputs=()):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.fake_type = FakeTensor
        self.flops = 0
        self.per_op: list[dict] = []
        super().__init__(inputs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in torch.utils._pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, self.fake_type) for t in outs):
            # DTensor's sharding propagation runs the op on fake tensors of
            # the global shapes to read its output's shape: not the step's work
            return out
        packet = func.overloadpacket
        kind = COLLECTIVE_KINDS.get(packet.__name__) if func.namespace == "_c10d_functional" \
            else None
        if kind is not None:
            self.per_op.append({"kind": kind, "bytes": sum(t.nbytes for t in outs),
                                "trip_mult": 1})
        elif packet in self.flop_registry:
            self.flops += self.flop_registry[packet](*args, **kwargs, out_val=out)
        self._watermark(packet.__name__, outs)
        return out

    def stats(self) -> CollectiveStats:
        counts: dict = {}
        for op in self.per_op:
            counts[op["kind"]] = counts.get(op["kind"], 0) + 1
        total = float(sum(op["bytes"] for op in self.per_op))
        return CollectiveStats(counts, total, total, list(self.per_op))


def roofline_terms(flops_total: float, hbm_bytes_dev: float, coll_bytes_dev: float,
                   chips: int) -> dict:
    compute = flops_total / (chips * PEAK_FLOPS)
    memory = hbm_bytes_dev / HBM_BW
    collective = coll_bytes_dev / LINK_BW
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms["dominant"] = dom
    terms["roofline_fraction_compute"] = compute / bound if bound else 0.0
    terms["step_lower_bound_s"] = bound
    return terms
