"""Dispatch between the hand-written kernels and their plain arms.

The partition digits, the partition plan, the hash probe, the gather, the
merge lower bound and the histogram take `impl` in {"torch", "cuda"} or
None. None resolves by the tensor's device: a CUDA tensor gets the kernel,
a CPU tensor the plain arm; "cuda" on a CPU tensor raises
(`common.resolve_impl`). The group-join's probe-aggregate and the
sorted group sums have one arm, the kernel wrapper, which runs the
kernel's plain version for CPU tensors. Whatever a kernel arm raises (a
wrapper's rejection of its inputs, a failed build or launch, an error the
card reports) reaches the caller as `KernelError`, apart from running out
of memory: no arm catches it and carries on, and no caller can mistake a
broken kernel for a condition to re-plan around.
"""
from __future__ import annotations

import contextlib
import os

import torch

from ..obs import trace as _trace
from . import digits as _digits
from . import gather as _gather
from . import histogram as _histogram
from . import merge_join as _merge_join
from . import ref
from . import segsum as _segsum
from ._build import KernelError
from .common import KERNELS, KEY_SENTINEL, LAUNCHES, ceil_div, kernel_call, resolve_impl
from .hash_probe import hash_probe as _hash_probe_kernel
from .hash_probe import layout_probe_blocks
from .hash_probe import probe_agg as _probe_agg_kernel
from .radix_partition import partition_plan as _partition_plan_radix

# Arm of the partition planner that `core.primitives` resolves impl=None
# through, and of the join's partition digits that feed it
# (`core.hash_join._digits`). Unset: by device. Read and validated per call,
# so an unknown value raises instead of silently running another arm.
PARTITION_PLAN_ENV = "REPRO_PARTITION_PLAN_IMPL"


def partition_plan_impl() -> str | None:
    env = os.environ.get(PARTITION_PLAN_ENV)
    if env is not None and env not in ("torch", "cuda"):
        raise ValueError(f"{PARTITION_PLAN_ENV}={env!r} is not a recognized value; "
                         "allowed: torch/cuda")
    return env


@contextlib.contextmanager
def _kernel_arm(name: str, on: bool = True):
    """Around a kernel arm (where `on`): any error but KernelError and
    running out of memory, which the engine answers with smaller morsels,
    becomes a KernelError naming the kernel."""
    if not on:
        yield
        return
    try:
        yield
    except (KernelError, torch.cuda.OutOfMemoryError):
        raise
    except Exception as e:  # noqa: BLE001 - every other failure is the kernel's
        raise KernelError(f"{name}: {type(e).__name__}: {e}") from e


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------
def histogram(digits: torch.Tensor, num_bins: int, impl: str | None = None) -> torch.Tensor:
    """(num_bins,) int32 counts of int32 digits; digits < 0 or >= num_bins
    count nowhere. impl='cuda': the histogram kernel; 'torch': its plain
    version (a bincount)."""
    with kernel_call("histogram"):
        if resolve_impl(impl, digits) == "cuda":
            with _kernel_arm("histogram"):
                return _histogram.histogram(digits, num_bins)
        return ref.histogram(digits, num_bins)


# ---------------------------------------------------------------------------
# partition digits
# ---------------------------------------------------------------------------
def partition_digits(keys: torch.Tensor, p_bits: int, hash_keys: bool = True,
                     impl: str | None = None) -> torch.Tensor:
    """Partition digit per row, int32 in [0, 2^p_bits]: 2^p_bits for
    KEY_SENTINEL rows, else the low p_bits of hash32 of the key (of its low
    32 bits where not hash_keys). Keys that are not integers raise
    TypeError and a p_bits past 30 ValueError, on either arm.
    impl='cuda': one launch of the partition_digits kernel; 'torch': its
    plain version (hash32's uint32 arithmetic in int64)."""
    _digits.check(keys, p_bits)
    with kernel_call("partition_digits"):
        if resolve_impl(impl, keys) == "cuda":
            with _kernel_arm("partition_digits"):
                return _digits.partition_digits(keys, p_bits, hash_keys)
        return ref.partition_digits(keys, p_bits, hash_keys)


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
    with kernel_call("partition_plan"):
        if impl == "cuda":
            with _kernel_arm("partition_plan"):
                return _partition_plan_radix(digits, num_partitions, carry=carry)
        return _partition_plan_torch(digits, num_partitions, carry)


def _partition_plan_torch(digits, num_partitions, carry):
    digits = digits.to(torch.int32)
    perm = torch.sort(digits, stable=True).indices.to(torch.int32)
    carried = tuple(c[perm] for c in carry)
    # a count of static size (bincount's output size depends on the data,
    # which a trace without values cannot know); digits lie in
    # [0, num_partitions), and integer counts add exactly in any order
    sizes = torch.zeros(num_partitions, dtype=torch.int32, device=digits.device).index_add_(
        0, digits.long(), torch.ones_like(digits))
    offsets = torch.cumsum(sizes, 0, dtype=torch.int32) - sizes
    return perm, carried, offsets, sizes


def sort_plan(keys: torch.Tensor):
    """Stable sort plan: (sorted_keys, perm int32), one stable torch.sort
    (the counterpart of the reference's 'xla' arm). The sort-free rank-pass
    plan of int32 keys is `radix_partition.sort_plan_radix`; it gives the
    same tensors."""
    sk, perm = torch.sort(keys, stable=True)
    return sk, perm.to(torch.int32)


def apply_partition(dest: torch.Tensor, *arrays: torch.Tensor):
    """Materialize a partition from scatter-form destinations: invert dest
    and gather each array through the inverse."""
    n = dest.shape[0]
    inv = torch.zeros(n, dtype=torch.int32, device=dest.device)
    inv[dest.clamp(0, max(n - 1, 0))] = torch.arange(n, dtype=torch.int32, device=dest.device)
    return tuple(a[inv] for a in arrays)


# ---------------------------------------------------------------------------
# merge lower bound
# ---------------------------------------------------------------------------
def merge_lower_bound(build_sorted: torch.Tensor, probe_sorted: torch.Tensor,
                      impl: str | None = None) -> torch.Tensor:
    """Lower bound of each sorted probe key in the sorted build keys, int32
    in [0, n_build]. impl='cuda': the lower_bound kernel, right for any span
    (no span check, no fallback); 'torch': its plain version (searchsorted)."""
    with kernel_call("lower_bound"):
        if resolve_impl(impl, probe_sorted, build_sorted) == "cuda":
            with _kernel_arm("lower_bound"):
                return _merge_join.lower_bound(build_sorted, probe_sorted)
        return ref.lower_bound(build_sorted, probe_sorted)


# ---------------------------------------------------------------------------
# hash probe
# ---------------------------------------------------------------------------
def hash_probe(build_keys_part: torch.Tensor, off_r: torch.Tensor, sz_r: torch.Tensor,
               probe_keys_part: torch.Tensor, probe_off: torch.Tensor, probe_sz: torch.Tensor,
               build_block: int, impl: str | None = None):
    """Co-partition PK-FK probe over the partitioned build and probe
    columns. Returns (vid_r int32, matched bool) in partitioned probe order:
    vid_r is the position in build_keys_part of the first of the first
    min(sz_r[p], build_block) build rows of the row's partition with an
    equal key, or -1. It answers to the reference's `ops.hash_probe` with
    bkeys = `build_blocks(build_keys_part, off_r, sz_r, build_block)`.
    impl='cuda': one launch of the probe kernel, which reads the columns
    directly; 'torch': its plain version (`ref.hash_probe`)."""
    impl = resolve_impl(impl, probe_keys_part)
    args = (build_keys_part, off_r, sz_r, probe_keys_part, probe_off, probe_sz, build_block)
    if _trace.on():
        # the rows after the last partition's end, which the kernel's whole
        # grid answers: a 0-d tensor, read after the span closes
        n = probe_keys_part.shape[0]
        _trace.annotate(rows_outside=n - (probe_off[-1] + probe_sz[-1]).clamp(0, n))
    with kernel_call("hash_probe"):
        if impl == "torch":
            return ref.hash_probe(*args)
        with _kernel_arm("hash_probe"):
            return _hash_probe_kernel(*(a.contiguous() for a in args[:-1]), build_block)


# ---------------------------------------------------------------------------
# clustered gather
# ---------------------------------------------------------------------------
def clustered_gather(src: torch.Tensor, idx: torch.Tensor, impl: str | None = None):
    """GATHER: out[i] = src[clip(idx[i])] where idx[i] >= 0, else 0. The
    kernel is right for any index, so no span check picks the arm."""
    impl = resolve_impl(impl, src, idx)
    with kernel_call("clustered_gather"):
        if impl == "torch":
            return ref.clustered_gather(src, idx)
        with _kernel_arm("clustered_gather"):
            return _gather.clustered_gather(src.contiguous(), idx.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# reductions over runs of a key-sorted column
# ---------------------------------------------------------------------------
def sorted_runs(sk: torch.Tensor, num_groups: int):
    """Runs of equal valid keys in a key-sorted column: (valid, rid, starts,
    n_found). rid is each row's run id (non-decreasing; -1 before the first
    run); run r < num_groups spans rows [starts[r], starts[r + 1]), where
    rows past its last key can only be KEY_SENTINEL rows (masked by valid);
    runs past the last one are empty. n_found (0-d int32) counts all runs."""
    valid = sk != KEY_SENTINEL
    head = torch.cat([valid[:1], (sk[1:] != sk[:-1]) & valid[1:]])
    rid = torch.cumsum(head, 0, dtype=torch.int32) - 1
    n_found = rid[-1] + 1
    starts = torch.searchsorted(
        rid, torch.arange(num_groups + 1, dtype=torch.int32, device=sk.device), out_int32=True)
    return valid, rid, starts, n_found


def run_keys(sk: torch.Tensor, starts: torch.Tensor, n_found: torch.Tensor) -> torch.Tensor:
    """The key of each run of `sorted_runs`, KEY_SENTINEL past the last."""
    g = starts.shape[0] - 1
    present = torch.arange(g, dtype=torch.int32, device=sk.device) < n_found
    return torch.where(present, sk[starts[:-1].clamp(max=sk.shape[0] - 1)], KEY_SENTINEL)


class RunSums:
    """Sums over the runs [starts[r], starts[r + 1]) of a key-sorted column,
    in the column's dtype: `RunSums(starts)(vals)`. One instance serves every
    column summed over the same runs.

    Integers: differences of a prefix sum, exact under wrap-around. Floats:
    a segmented inclusive scan that doubles its stride each step (one step
    per bit of the longest run), read at each run's last row. Each result
    depends only on its run's rows, added in a fixed tree order, so the sums
    are the same on every run. A float scatter-add is not; a difference of a
    global prefix sum loses the digits of short runs behind a large prefix;
    a segment reduction (`torch.segment_reduce`) spends a thread block on
    each run, which took about 22 ms a column for 15M short runs on an H100
    (chip_smoke.py's profile of the group-join). The scan covers only the
    rows inside the runs (sentinel keys sort first). Its geometry (those
    rows, the longest run, each row's run start) costs one host sync; it is
    computed at the first float column and shared by the rest."""

    def __init__(self, starts: torch.Tensor):
        self.starts = starts
        self._geometry = None

    def _scan_geometry(self):
        if self._geometry is None:
            starts = self.starts
            lengths = torch.diff(starts)
            lo, hi, longest = (torch.stack([starts[0], starts[-1], lengths.max()]).tolist()
                               if lengths.shape[0] else (0, 0, 0))
            rel = starts - lo
            pos = torch.arange(hi - lo, dtype=torch.int32, device=starts.device)
            # each row's run is the number of runs that end at or before it
            run_start = rel[torch.searchsorted(rel[1:], pos, right=True, out_int32=True)]
            self._geometry = (lo, hi, longest, pos, run_start, lengths > 0,
                              (rel[1:] - 1).clamp(min=0))
        return self._geometry

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        starts = self.starts
        if not vals.dtype.is_floating_point:
            ecs = torch.cat([vals.new_zeros(1), torch.cumsum(vals, 0, dtype=vals.dtype)])
            return ecs[starts[1:]] - ecs[starts[:-1]]
        lo, hi, longest, pos, run_start, nonempty, last = self._scan_geometry()
        if hi == lo:
            return vals.new_zeros(starts.shape[0] - 1)
        x = vals[lo:hi].clone()
        d = 1
        while d < longest:
            x[d:] += torch.where(pos[d:] - d >= run_start[d:], x[:-d], 0.0)
            d *= 2
        return torch.where(nonempty, x[last], 0.0)


# ---------------------------------------------------------------------------
# fused probe + accumulate (group-join)
# ---------------------------------------------------------------------------
def _combine_group_partials(pk, ps_cols, pc, num_groups: int, key_dtype):
    """Combine (key, sums..., count) partials into the dense accumulator:
    (keys (G,), sums (C, G) float32, counts (G,) int32, n_found), groups
    in key order. One stable sort by key carries every column; each group's
    sums and count are taken over its run of partials (`RunSums`, whose
    geometry all the sum columns share)."""
    order = torch.sort(pk, stable=True).indices
    sk = pk[order]
    valid, _, starts, n_found = sorted_runs(sk, num_groups)
    run_sums = RunSums(starts)
    keys_o = run_keys(sk, starts, n_found).to(key_dtype)
    if ps_cols:
        sums_o = torch.stack([run_sums(torch.where(valid, s[order], 0.0)) for s in ps_cols])
    else:
        sums_o = torch.zeros((0, num_groups), dtype=torch.float32, device=pk.device)
    counts_o = run_sums(torch.where(valid, pc[order], 0).to(torch.int32))
    return keys_o, sums_o, counts_o, torch.clamp(n_found, max=num_groups)


def groupjoin_probe_agg(bkeys: torch.Tensor, bvals: torch.Tensor | None,
                        probe_keys_part: torch.Tensor, gk_part: torch.Tensor,
                        pv_part: torch.Tensor | None, probe_off: torch.Tensor,
                        probe_sz: torch.Tensor, num_groups: int, *, col_sides,
                        impl: str | None = None):
    """Co-partition pk_fk probe fused with grouped accumulation. bkeys
    (P, capR) build key blocks, bvals (P, Cb, capR) build value blocks or
    None, the partitioned probe join keys and group keys, pv_part (Cp, n)
    probe value columns or None, the probe partitions' offsets and sizes;
    col_sides[c] is ("probe" | "build", j) per sum column. Returns
    (group_keys (G,), sums (C, G) float32, counts (G,) int32, valid_count).

    The probe side is laid out in capS-wide sub-blocks (static worst case
    n / capS + P), the probe_agg kernel reduces each to per-slot partials
    (its plain version does for CPU tensors), and one combine gives the
    groups; the joined rows are never written. impl is None or 'cuda',
    which raises for CPU tensors; the group-join's plain arm is
    `phj_groupjoin(probe_impl='torch')`."""
    if impl not in (None, "cuda"):
        raise ValueError(f"unknown impl {impl!r}; allowed: cuda (CPU tensors take the "
                         "kernel's plain version)")
    resolve_impl(impl, probe_keys_part)
    with _kernel_arm("probe_agg", probe_keys_part.is_cuda):
        P, cap_s = bkeys.shape
        n = probe_keys_part.shape[0]
        dev = probe_keys_part.device
        if bvals is None:
            bvals = torch.zeros((P, 0, cap_s), dtype=torch.float32, device=dev)
        if pv_part is None:
            pv_part = torch.zeros((0, n), dtype=torch.float32, device=dev)
        pk, part, src_idx = layout_probe_blocks(probe_keys_part, probe_off, probe_sz, cap_s,
                                                ceil_div(n, cap_s) + P)
        pad = src_idx >= 0
        safe = src_idx.clamp(0, max(n - 1, 0))
        gkb = torch.where(pad, gk_part[safe], KEY_SENTINEL)
        # (B, Cp, capS): every probe value column laid out with the same block map
        pvb = torch.where(pad[:, None, :], pv_part.to(torch.float32)[:, safe].permute(1, 0, 2),
                          0.0).contiguous()
        del safe
        with kernel_call("probe_agg"):
            pkeys, psums, pcounts = _probe_agg_kernel(bkeys.contiguous(),
                                                      bvals.to(torch.float32).contiguous(), pk,
                                                      gkb, pvb, part, col_sides)
        del pk, part, src_idx, gkb, pvb
        return _combine_group_partials(pkeys.reshape(-1),
                                       [psums[:, c].reshape(-1) for c in range(len(col_sides))],
                                       pcounts.reshape(-1), num_groups, gk_part.dtype)


# ---------------------------------------------------------------------------
# grouped aggregation over sorted keys
# ---------------------------------------------------------------------------
def groupby_sorted_sum(sorted_keys: torch.Tensor, values: torch.Tensor, num_groups: int):
    """Group sums over key-sorted rows: per-tile partials over tiles of
    segsum.TILE rows (the segsum_partials kernel; its plain version for CPU
    tensors), then a sum over each run of equal partial keys. The partials
    come compact and in key order, so the runs are found without a sort.
    Returns (group_keys (G,), float32 sums (G,), valid_count).

    The reference re-sorts its partials (slot layout, sentinel slots among
    them), so it also sums unsorted rows by key; here unsorted keys raise
    ValueError (`segsum_partials`), a KernelError on the card."""
    with _kernel_arm("segsum_partials", sorted_keys.is_cuda), kernel_call("segsum_partials"):
        pk, ps, _ = _segsum.segsum_partials(sorted_keys.contiguous(),
                                            values.to(torch.float32).contiguous())
    if pk.shape[0] == 0:
        return (torch.full((num_groups,), KEY_SENTINEL, dtype=pk.dtype, device=pk.device),
                torch.zeros(num_groups, dtype=torch.float32, device=pk.device),
                torch.zeros((), dtype=torch.int32, device=pk.device))
    _, _, starts, n_found = sorted_runs(pk, num_groups)  # every partial key is valid
    sums = RunSums(starts)(ps)
    return run_keys(pk, starts, n_found), sums, torch.clamp(n_found, max=num_groups)
