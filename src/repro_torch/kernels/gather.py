"""Clustered GATHER (GFTR materialization).

For a gather map that is clustered, as GFTR's tuple IDs are, neighbouring
outputs read neighbouring source rows. The kernel copies 4- or 8-byte
elements, eight outputs a thread; a warp stages the source window of its 256
outputs in shared memory when it is at most 256 rows wide, and reads device
memory directly when it is wider, so it needs no span check: it is right for
any index.
"""
from __future__ import annotations

import torch

from . import _build, ref
from ._build import I32, I64, PTR
from .common import Launch, ceil_div, register


@register("clustered_gather", rows="n",
          entries={"clustered_gather": (PTR, PTR, I64, I64, I32, PTR, PTR, I32)},
          config=lambda a: (PTR(a.get("idx_addr", 0)), I64(a["n"]), I32(a["elem_bytes"]),
                            PTR(a.get("out_addr", 0))),
          instances=("clustered_gather<4, false>", "clustered_gather<4, true>",
                     "clustered_gather<8, false>", "clustered_gather<8, true>"),
          static_smem={f"clustered_gather<{eb}, {v}>": 8 * 256 * eb
                       for eb in (4, 8) for v in ("false", "true")})
def CLUSTERED_GATHER(a, sms, per_sm):
    # clustered_gather.cu, config: 256 threads, 8 outputs a lane a step;
    # vector index loads where idx + head lies on a (4 P)-byte boundary. No
    # source row: the wrapper writes zeros and launches nothing.
    if a["n_src"] == 0:
        return None
    n, eb = a["n"], a["elem_bytes"]
    head = min((16 - a.get("out_addr", 0) % 16) % 16 // eb, n)
    vec = (a.get("idx_addr", 0) + 4 * head) % (4 * (16 // eb)) == 0
    inst = CLUSTERED_GATHER.instances[2 * (eb == 8) + int(vec)]
    fill = sms * per_sm(inst, 256, 0)
    need = max(ceil_div((n - head) // 256 * 32, 256), 1)
    return Launch("clustered_gather", inst, 256, 0, (min(need, fill), 1, 1))


def clustered_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[clip(idx[i], 0, n_src - 1)] where idx[i] >= 0, else 0.
    src is 1-D with 4- or 8-byte elements; idx is int32."""
    if not src.is_cuda:
        return ref.clustered_gather(src, idx)
    if src.dim() != 1 or src.element_size() not in (4, 8) or not src.is_contiguous():
        raise TypeError(f"src must be a contiguous 1-D tensor of 4- or 8-byte elements, "
                        f"got {src.dtype} {tuple(src.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous() \
            or idx.device != src.device:
        raise TypeError(f"idx must be a contiguous 1-D int32 tensor on {src.device}, got "
                        f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
    out = torch.empty(idx.shape[0], dtype=src.dtype, device=src.device)
    if idx.shape[0] == 0:
        return out
    if src.shape[0] == 0:  # no row to read: every index is out of range
        return out.zero_()
    _build.launch("clustered_gather", "clustered_gather", src.data_ptr(), idx.data_ptr(),
                  src.shape[0], idx.shape[0], src.element_size(), out.data_ptr(), on=src)
    return out
