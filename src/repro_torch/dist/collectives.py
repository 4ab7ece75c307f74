"""Compressed data-parallel gradient collectives (DESIGN.md §6).

int8 uniform quantization with error feedback (EF-SGD / 1-bit-Adam family):
each rank quantizes (grad + carried error) to int8 + one float32 scale per
tensor, all-reduces the dequantized value over the DP axes, and carries the
local quantization residual into the next step. EF keeps the *accumulated*
error bounded, so SGD converges to the true optimum where plain quantized
SGD stalls at a quantization-noise floor (tests/test_torch_distributed.py).

Wire cost: 1 byte/param + 4 bytes/tensor vs 4 bytes/param — the 4x DP
bandwidth knob for the multi-pod mesh, where the ('pod','data') all-reduce
crosses the slow inter-pod links (roofline collective term).

The reduction is `torch.distributed.all_reduce` over the process group of
each named mesh axis (`DeviceMesh.get_group`), one axis after another.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.params import leaves, map_leaves
from .sharding import _mesh_axis_size


class EFState(NamedTuple):
    """Per-rank error-feedback residuals, one float32 leaf per gradient leaf."""

    error: Any


def _tensors(tree) -> list:
    return leaves(tree, torch.is_tensor)


def _rebuild(tree, tensors):
    it = iter(tensors)
    return map_leaves(lambda _: next(it), tree, is_leaf=torch.is_tensor)


def init_ef_state(grads) -> EFState:
    return EFState(error=map_leaves(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads,
        is_leaf=torch.is_tensor))


def quantize_int8(x):
    """Symmetric uniform int8 quantization. Returns (q int8, scale float32
    0-d) with x ~= q * scale and |x - q*scale| <= scale/2 (round to nearest,
    ties to even, as the JAX package's)."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def ef_compress_decompress(grads, ef: EFState):
    """One local compression round trip with error feedback: quantize
    (grad + error), return the dequantized gradient and the new residual.
    This is the per-rank half of compressed_psum_dp, usable on one rank
    (tests) or composed with any reduction."""
    corrected = [g.float() + e for g, e in zip(_tensors(grads), _tensors(ef.error))]
    decoded = [dequantize_int8(*quantize_int8(c)) for c in corrected]
    new_err = [c - d for c, d in zip(corrected, decoded)]
    return _rebuild(grads, decoded), EFState(error=_rebuild(ef.error, new_err))


def compressed_psum_dp(grads, ef: EFState, mesh, *, axis="data"):
    """Mean-all-reduce `grads` over mesh `axis` with int8 EF compression.

    `axis` is one mesh axis name or a tuple of them — the multi-pod DP
    reduction is axis=('pod', 'data'). Axes absent from the mesh (or of
    size 1) are dropped, so one call site serves every mesh layout.

    Returns (mean_grads float32, new EFState). The inputs are each rank's
    own plain tensors (on a DP mesh, the rank's local gradient); on
    replicated input the result reproduces the input to within one int8
    quantization step, since every rank quantizes identically and the mean
    of identical dequantized values is the dequantized value itself. With
    no axis left to reduce over, the result is `ef_compress_decompress`'s,
    bit for bit."""
    import torch.distributed as dist

    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    names = tuple(a for a in names if _mesh_axis_size(mesh, a) > 1)
    n = _mesh_axis_size(mesh, names)
    dec, new_ef = ef_compress_decompress(grads, ef)
    if not names:
        return dec, new_ef
    out = []
    for d in _tensors(dec):
        for a in names:
            dist.all_reduce(d, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
        out.append(d / n)
    return _rebuild(dec, out), new_ef
