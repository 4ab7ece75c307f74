"""Co-partition hash probe (PHJ match finding) and the group-join's fused
probe + aggregate.

`hash_probe` reads the partitioned build and probe columns directly, by the
partitions' offsets and sizes: a group of threads stages a partition's
build keys in a shared-memory hash table and streams its probe rows past it.
`probe_agg` reads probe rows laid out partition-major in capS-wide
sub-blocks, each of which belongs to exactly one partition
(`layout_probe_blocks`, the paper's probe-side sub-partitioning), against
each partition's padded build block (capR keys), and folds the matched rows
of a sub-block into one partial per distinct group key instead of writing a
match per row.
"""
from __future__ import annotations

import torch

from . import _build, ref
from ._build import I32, I64, PTR
from .common import (KEY_SENTINEL, SMEM_DEFAULT_PER_BLOCK, SMEM_PER_BLOCK, Kernel, Launch,
                     ceil_div, register)

# the widest build block the probe kernel's table takes (csrc/hash_probe.cu)
MAX_BUILD_BLOCK = 12288


@register("hash_probe", rows="n_probe",
          entries={"hash_probe": (PTR, PTR, PTR, PTR, PTR, PTR, I32, I64, I32, PTR, PTR, PTR, I32)},
          config=lambda a: (I32(a["num_parts"]), I32(a["cap"])),
          instances=("hash_probe<32>", "hash_probe<256>"))
def HASH_PROBE(a, sms, per_sm):
    # hash_probe.cu, group_config: a warp a partition (8 tables of 2^9
    # entries) up to 256 build keys, else the block (one of 2^14)
    parts, cap = a["num_parts"], a["cap"]
    wide = cap > 256
    groups, bits = (1, 14) if wide else (8, 9)
    inst = HASH_PROBE.instances[int(wide)]
    smem = groups * (2 << bits) * 4
    fill = sms * per_sm(inst, 256, smem)
    return Launch("hash_probe", inst, 256, smem, (min(ceil_div(parts, groups), fill), 1, 1),
                  opt_in=smem)


def hash_probe(build_keys: torch.Tensor, off_r: torch.Tensor, sz_r: torch.Tensor,
               probe_keys: torch.Tensor, probe_off: torch.Tensor, probe_sz: torch.Tensor,
               build_block: int):
    """(vid (n,) int32, hit (n,) bool) for the partitioned probe keys: the
    position off_r[p] + s of the first of the first min(sz_r[p],
    build_block) build rows of the row's partition p whose key equals it,
    or -1 and False. KEY_SENTINEL keys never match; rows in no partition
    (past probe_off[P - 1] + probe_sz[P - 1]) miss. Partitions lie in row
    order and do not overlap, as a partition plan leaves them. All tensors
    int32; the plain version (`ref.hash_probe`) for CPU tensors."""
    if not probe_keys.is_cuda:
        return ref.hash_probe(build_keys, off_r, sz_r, probe_keys, probe_off, probe_sz,
                              build_block)
    dev = probe_keys.device
    tensors = (("build_keys", build_keys), ("off_r", off_r), ("sz_r", sz_r),
               ("probe_keys", probe_keys), ("probe_off", probe_off), ("probe_sz", probe_sz))
    for name, t in tensors:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() or t.device != dev:
            raise TypeError(f"{name} must be a contiguous 1-D int32 tensor on {dev}, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    P = off_r.shape[0]
    if P < 1 or any(t.shape[0] != P for t in (sz_r, probe_off, probe_sz)):
        raise ValueError(f"off_r, sz_r, probe_off and probe_sz must have one entry per "
                         f"partition (at least one), got {off_r.shape[0]}, {sz_r.shape[0]}, "
                         f"{probe_off.shape[0]} and {probe_sz.shape[0]}")
    if not 1 <= build_block <= MAX_BUILD_BLOCK:
        raise ValueError(f"build blocks of 1 to {MAX_BUILD_BLOCK} keys fit the kernel's table, "
                         f"got {build_block}")
    n = probe_keys.shape[0]
    vid = torch.empty(n, dtype=torch.int32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return vid, hit
    _build.launch("hash_probe", "hash_probe", build_keys.data_ptr(), off_r.data_ptr(),
                  sz_r.data_ptr(), probe_keys.data_ptr(), probe_off.data_ptr(),
                  probe_sz.data_ptr(), P, n, build_block, vid.data_ptr(), hit.data_ptr(),
                  on=probe_keys)
    return vid, hit


# The kernel runs one thread per probe row. Its shared memory holds two hash
# tables (build keys and group keys, each at least twice its rows, rounded
# up to a power of two), a lane word per (warp, slot), a chunk word per
# slot, each row's value of each output column and its successor in its
# slot, and two copies of a sub-block's probe values and its build block's
# keys and values.
_MAX_ROWS = 1024


def _probe_agg_smem(cap_r: int, cap_s: int, key_bytes: int, cb: int, cp: int, c: int) -> int:
    """Bytes of shared memory the kernel asks for (csrc/probe_agg.cu
    smem_bytes)."""
    def words(n):  # int32 words, rounded up to 16 bytes
        return ceil_div(n, 4) * 4

    hb, hg = 1 << max(1, (2 * cap_r - 1).bit_length()), 1 << max(1, (2 * cap_s - 1).bit_length())
    tables = words(hg * key_bytes // 4 + 2 * hb + hg + ceil_div(cap_s, 32) * cap_s + cap_s
                   + c * cap_s + cap_s)
    half = words(cp * cap_s) + words(cap_r) + words(cb * cap_r)
    return 4 * (tables + 2 * half)


@register("probe_agg", rows="num_blocks",
          entries={"probe_agg": (PTR, PTR, PTR, PTR, PTR, PTR, PTR, I64, I32, I32, I32, I32, I32, I32,
                                 I32, PTR, PTR, PTR, PTR, I32)},
          config=lambda a: (I64(a["num_blocks"]), I32(a["cap_r"]), I32(a["cap_s"]), I32(a["cb"]),
                            I32(a["cp"]), I32(a["c"]), I32(a["key_bytes"])),
          instances=("probe_agg<4, 256, 8>", "probe_agg<4, 1024, 1>", "probe_agg<8, 256, 6>",
                     "probe_agg<8, 1024, 1>"))
def PROBE_AGG(a, sms, per_sm):
    # probe_agg.cu, config: a thread a row (whole warps), the tables and the
    # double buffer of smem_bytes
    cap_s, kb = a["cap_s"], a["key_bytes"]
    inst = PROBE_AGG.instances[2 * (kb == 8) + int(cap_s > 256)]
    threads = ceil_div(cap_s, 32) * 32
    smem = _probe_agg_smem(a["cap_r"], cap_s, kb, a["cb"], a["cp"], a["c"])
    fill = sms * per_sm(inst, threads, smem)
    return Launch("probe_agg", inst, threads, smem, (min(a["num_blocks"], fill), 1, 1),
                  opt_in=smem if smem > SMEM_DEFAULT_PER_BLOCK else 0)


def probe_agg(bkeys: torch.Tensor, bvals: torch.Tensor, probe_blocks: torch.Tensor,
              gk_blocks: torch.Tensor, pv_blocks: torch.Tensor, block_part: torch.Tensor,
              col_sides):
    """Fused probe + tile-local group partials, one per probe sub-block:
    (pk (B, capS) of gk's type, ps (B, C, capS) float32, pc (B, capS) int32).
    Slot s of sub-block b holds the group key of its row s, the sums of the
    C aggregate columns and the count over the matched rows whose first row
    with the same group key is s; KEY_SENTINEL and zeros where no row maps.

    bkeys (P, capR) int32, bvals (P, Cb, capR) float32, probe_blocks
    (B, capS) int32, gk_blocks (B, capS) int32 or int64, pv_blocks
    (B, Cp, capS) float32, block_part (B,) int32. col_sides[c] is
    ("probe", j) for pv_blocks[:, j] or ("build", j) for the matched row's
    bvals[:, j]."""
    B, cap_s = probe_blocks.shape
    P, cap_r = bkeys.shape
    if not probe_blocks.is_cuda:
        return ref.probe_agg_blocks(bkeys, bvals, probe_blocks, gk_blocks, pv_blocks,
                                    block_part, col_sides)
    dev = probe_blocks.device
    for name, t, dtypes in (("bkeys", bkeys, (torch.int32,)),
                            ("bvals", bvals, (torch.float32,)),
                            ("probe_blocks", probe_blocks, (torch.int32,)),
                            ("gk_blocks", gk_blocks, (torch.int32, torch.int64)),
                            ("pv_blocks", pv_blocks, (torch.float32,)),
                            ("block_part", block_part, (torch.int32,))):
        if t.dtype not in dtypes or not t.is_contiguous() or t.device != dev:
            raise TypeError(f"{name} must be a contiguous {'/'.join(map(str, dtypes))} "
                            f"tensor on {dev}, got {t.dtype} on {t.device}")
    Cb, Cp, C = bvals.shape[1], pv_blocks.shape[1], len(col_sides)
    if (bvals.shape != (P, Cb, cap_r) or gk_blocks.shape != (B, cap_s)
            or pv_blocks.shape != (B, Cp, cap_s) or block_part.shape != (B,)):
        raise ValueError(f"shapes do not agree: bkeys {tuple(bkeys.shape)}, bvals "
                         f"{tuple(bvals.shape)}, probe_blocks {tuple(probe_blocks.shape)}, "
                         f"gk_blocks {tuple(gk_blocks.shape)}, pv_blocks "
                         f"{tuple(pv_blocks.shape)}, block_part {tuple(block_part.shape)}")
    src = []
    for side, j in col_sides:
        if side not in ("probe", "build") or not 0 <= j < (Cp if side == "probe" else Cb):
            raise ValueError(f"column source {(side, j)} is not in the {Cp} probe and "
                             f"{Cb} build value columns")
        src.append(j if side == "probe" else -j - 1)
    if cap_r < 1 or cap_s > _MAX_ROWS:
        raise ValueError(f"the kernel takes sub-blocks of at most {_MAX_ROWS} rows and build "
                         f"blocks of at least one key, got {cap_s} and {cap_r}")
    smem = _probe_agg_smem(cap_r, cap_s, gk_blocks.element_size(), Cb, Cp, C)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"a sub-block of {cap_s} rows against {cap_r} build keys with {Cb} "
                         f"build and {Cp} probe value columns and {C} output columns needs "
                         f"{smem} bytes of shared memory")
    pk = torch.empty((B, cap_s), dtype=gk_blocks.dtype, device=dev)
    ps = torch.empty((B, C, cap_s), dtype=torch.float32, device=dev)
    pc = torch.empty((B, cap_s), dtype=torch.int32, device=dev)
    if B == 0 or cap_s == 0:
        return pk, ps, pc
    col_src = torch.tensor(src, dtype=torch.int32).to(dev)
    _build.launch("probe_agg", "probe_agg", bkeys.data_ptr(), bvals.data_ptr(),
                  probe_blocks.data_ptr(), gk_blocks.data_ptr(), pv_blocks.data_ptr(),
                  block_part.data_ptr(), col_src.data_ptr(), B, P, cap_r, cap_s, Cb, Cp, C,
                  gk_blocks.element_size(), pk.data_ptr(), ps.data_ptr(), pc.data_ptr(), on=pk)
    return pk, ps, pc


def layout_probe_blocks(keys_part: torch.Tensor, off: torch.Tensor, sz: torch.Tensor,
                        cap_s: int, max_blocks: int):
    """Decompose contiguous partitions into capS-aligned sub-blocks. Static
    worst case: n / capS + P blocks.

    Returns (probe_blocks (B, capS), block_part (B,), src_idx (B, capS)),
    int32, where src_idx maps each slot back to its position in keys_part
    (-1 = padding, whose key is KEY_SENTINEL)."""
    P = off.shape[0]
    n = keys_part.shape[0]
    dev = keys_part.device
    blocks_per = (sz + cap_s - 1) // cap_s
    boff = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(blocks_per, 0, dtype=torch.int32)])
    b = torch.arange(max_blocks, dtype=torch.int32, device=dev)
    part = (torch.searchsorted(boff, b, right=True, out_int32=True) - 1).clamp(0, P - 1)
    sub = b - boff[part]
    valid_block = b < boff[-1]
    j = torch.arange(cap_s, dtype=torch.int32, device=dev)[None, :]
    rel = sub[:, None] * cap_s + j
    in_part = rel < sz[part][:, None]
    src_idx = torch.where(valid_block[:, None] & in_part, off[part][:, None] + rel, -1)
    pk = torch.where(src_idx >= 0, keys_part[src_idx.clamp(0, max(n - 1, 0))], KEY_SENTINEL)
    return pk, part, src_idx
