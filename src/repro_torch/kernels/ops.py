"""Dispatch between the hand-written kernels and their plain arms.

Each entry takes `impl` in {"torch", "cuda"} or None. None resolves by the
tensor's device: a CUDA tensor gets the kernel, a CPU tensor the plain arm;
"cuda" on a CPU tensor raises (`common.resolve_impl`). A kernel that fails
to build or launch raises: no arm catches it and carries on.
"""
from __future__ import annotations

import os

import torch

from . import gather as _gather
from . import ref
from .common import KERNELS, LAUNCHES, ceil_div, resolve_impl
from .hash_probe import hash_probe as _hash_probe_kernel
from .hash_probe import layout_probe_blocks
from .radix_partition import partition_plan as _partition_plan_radix

# Arm of the partition planner that `core.primitives` resolves impl=None
# through. Unset: by device. Read and validated per call, so an unknown value
# raises instead of silently running another arm.
PARTITION_PLAN_ENV = "REPRO_PARTITION_PLAN_IMPL"


def partition_plan_impl() -> str | None:
    env = os.environ.get(PARTITION_PLAN_ENV)
    if env is not None and env not in ("torch", "cuda"):
        raise ValueError(f"{PARTITION_PLAN_ENV}={env!r} is not a recognized value; "
                         "allowed: torch/cuda")
    return env


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# partition planning
# ---------------------------------------------------------------------------
def partition_plan(digits: torch.Tensor, num_partitions: int, *, carry=(),
                   impl: str | None = None):
    """Stable-partition plan: (perm, carried, offsets, sizes), layout tensors
    int32.

    impl='cuda': the sort-free rank pipeline (per pass: histogram kernel ->
    tile/digit exclusive prefix -> rank kernel, LSD-composed past 8 bits).
    impl='torch': one stable sort of the digits. Both arms return the same
    tensors: the stable partition permutation is unique."""
    impl = resolve_impl(impl, digits)
    if impl == "cuda":
        return _partition_plan_radix(digits, num_partitions, carry=carry)
    return _partition_plan_torch(digits, num_partitions, carry)


def _partition_plan_torch(digits, num_partitions, carry):
    digits = digits.to(torch.int32)
    perm = torch.sort(digits, stable=True).indices.to(torch.int32)
    carried = tuple(c[perm] for c in carry)
    sizes = torch.bincount(digits, minlength=num_partitions)[:num_partitions].to(torch.int32)
    offsets = torch.cumsum(sizes, 0, dtype=torch.int32) - sizes
    return perm, carried, offsets, sizes


def apply_partition(dest: torch.Tensor, *arrays: torch.Tensor):
    """Materialize a partition from scatter-form destinations: invert dest
    and gather each array through the inverse."""
    n = dest.shape[0]
    inv = torch.zeros(n, dtype=torch.int32, device=dest.device)
    inv[dest.clamp(0, max(n - 1, 0))] = torch.arange(n, dtype=torch.int32, device=dest.device)
    return tuple(a[inv] for a in arrays)


# ---------------------------------------------------------------------------
# hash probe
# ---------------------------------------------------------------------------
def hash_probe(bkeys: torch.Tensor, off_r: torch.Tensor, probe_keys_part: torch.Tensor,
               probe_off: torch.Tensor, probe_sz: torch.Tensor, impl: str | None = None):
    """Co-partition PK-FK probe over a partitioned probe side. Returns
    (vid_r, matched) aligned with probe_keys_part order; vid_r is -1 where
    nothing matched. impl='torch' is the chunked row-by-row compare
    (`ref.probe_pk_fk`); impl='cuda' lays the rows out in sub-blocks, runs
    the kernel and scatters its results back."""
    impl = resolve_impl(impl, probe_keys_part)
    if impl == "torch":
        vid, hit = ref.probe_pk_fk(bkeys, off_r, probe_keys_part, probe_off)
        return vid, hit.bool()
    P, cap_r = bkeys.shape
    n = probe_keys_part.shape[0]
    cap_s = cap_r
    max_blocks = ceil_div(n, cap_s) + P
    pk, part, src_idx = layout_probe_blocks(probe_keys_part, probe_off, probe_sz, cap_s,
                                            max_blocks)
    vid, hit = _hash_probe_kernel(bkeys.contiguous(), off_r.contiguous(), pk, part)
    # scatter the sub-block results back to partitioned probe order; pad
    # slots all land on the extra row n, which is cut off
    dst = torch.where(src_idx >= 0, src_idx, n).reshape(-1)
    vid_out = torch.full((n + 1,), -1, dtype=torch.int32, device=vid.device)
    vid_out[dst] = vid.reshape(-1)
    hit_out = torch.zeros((n + 1,), dtype=torch.int32, device=vid.device)
    hit_out[dst] = hit.reshape(-1)
    return vid_out[:n], hit_out[:n].bool()


# ---------------------------------------------------------------------------
# clustered gather
# ---------------------------------------------------------------------------
def clustered_gather(src: torch.Tensor, idx: torch.Tensor, impl: str | None = None):
    """GATHER: out[i] = src[clip(idx[i])] where idx[i] >= 0, else 0. The
    kernel is right for any index, so no span check picks the arm."""
    impl = resolve_impl(impl, src, idx)
    if impl == "torch":
        return ref.clustered_gather(src, idx)
    return _gather.clustered_gather(src.contiguous(), idx.to(torch.int32).contiguous())
