"""Sort-merge join: SMJ-UM (GFUR pattern, §3.1) and SMJ-OM (GFTR, §4.2).

Phases (paper §2.2):
  transformation  - sort (key, tuple ID) pairs, one sort plan per relation
  match finding   - lower bounds of the sorted probe keys in the sorted
                    build keys: one sweep for pk_fk (the lower_bound kernel
                    on the card), lower and upper bounds and an expansion for
                    m:n (the paper's single and double Merge Path, §3.1)
  materialization - GATHER of payload columns. GFUR gathers from the
                    original relations through the sort permutations
                    (unclustered); GFTR gathers from the sorted relations
                    with monotone virtual IDs (clustered), Algorithm 1.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..kernels import ref as kref
from . import primitives as prim
from .phases import phase
from .table import KEY_SENTINEL, Table, nonempty

MODES = ("pk_fk", "mn")


# ---------------------------------------------------------------------------
# Match finding over sorted key columns
# ---------------------------------------------------------------------------
def merge_find_pk_fk(kr_sorted: torch.Tensor, ks_sorted: torch.Tensor,
                     impl: str | None = None):
    """PK-FK merge: one lower-bound sweep (`ops.merge_lower_bound`; impl
    None takes the kernel for CUDA tensors). Returns (vid_r, matched): for
    each sorted probe row, the position of its match in the sorted build
    keys (a virtual ID) and whether it matched. Both are monotone in the
    probe row, so the IDs stay clustered, as GFTR needs (§4.1)."""
    n_r = kr_sorted.shape[0]
    lb = kops.merge_lower_bound(kr_sorted, ks_sorted, impl)
    lb_c = lb.clamp(max=n_r - 1)
    matched = (kr_sorted[lb_c] == ks_sorted) & (lb < n_r) & (ks_sorted != KEY_SENTINEL)
    return lb_c, matched


def merge_find_mn(kr_sorted: torch.Tensor, ks_sorted: torch.Tensor, capacity: int):
    """General m:n merge: lower and upper bounds of each probe key (binary
    searches, as in the reference, which runs no kernel here), then an
    expansion into `capacity` output rows. Returns (vid_r, vid_s, valid,
    total)."""
    lb = kref.lower_bound(kr_sorted, ks_sorted)
    ub = kref.upper_bound(kr_sorted, ks_sorted)
    counts = torch.where(ks_sorted == KEY_SENTINEL, 0, ub - lb)
    row, rank, valid, total = prim.expand_offsets(counts, capacity)
    return lb[row] + rank, row, valid, total


def _find(kr, ks, mode, out_size, find_impl, phases):
    """Match finding and compaction on sorted keys: (keys_o, vid_r, vid_s,
    valid, count) of `out_size` rows, with clustered virtual IDs."""
    dev = ks.device
    if mode == "pk_fk":
        with phase(phases, "find", dev):
            vid_r, matched = merge_find_pk_fk(kr, ks, find_impl)
        with phase(phases, "compact", dev):
            vid_s = torch.arange(ks.shape[0], dtype=torch.int32, device=dev)
            (keys_o, vr_o, vs_o), count = prim.compact(matched, [ks, vid_r, vid_s], out_size,
                                                       fill=KEY_SENTINEL)
            valid = torch.arange(out_size, dtype=torch.int32, device=dev) < count
        return keys_o, vr_o, vs_o, valid, count
    with phase(phases, "find", dev):
        vid_r, vid_s, valid, total = merge_find_mn(kr, ks, out_size)
    with phase(phases, "compact", dev):
        keys_o = torch.where(valid, ks[vid_s], KEY_SENTINEL)
    return keys_o, vid_r, vid_s, valid, torch.clamp(total, max=out_size)


# ---------------------------------------------------------------------------
# The join
# ---------------------------------------------------------------------------
def smj_join(
    R: Table,
    S: Table,
    *,
    key: str = "k",
    pattern: str = "gftr",  # "gftr" (SMJ-OM) | "gfur" (SMJ-UM)
    out_size: int | None = None,
    mode: str = "pk_fk",  # "pk_fk" | "mn"
    find_impl: str | None = None,  # "torch" | "cuda" | None (by device)
    phases: dict | None = None,
):
    """End-to-end sort-merge join. Returns (Table, valid_count), with
    valid_count a 0-d int32 tensor.

    Output columns: key + R payloads + S payloads; rows >= valid_count are
    padding (key == KEY_SENTINEL, payloads 0). out_size defaults to |S| for
    pk_fk and 2|S| for m:n. find_impl picks the pk_fk lower-bound arm
    (m:n takes searchsorted bounds either way). `phases`, when given,
    receives the wall seconds of each phase (transform, find, compact,
    gathers), measured with a device synchronisation at each phase edge."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; allowed: {'/'.join(MODES)}")
    if pattern not in ("gftr", "gfur"):
        raise ValueError(f"unknown pattern {pattern!r}")
    if out_size is None:
        out_size = S.num_rows if mode == "pk_fk" else 2 * S.num_rows
    R = nonempty(R, key)
    S = nonempty(S, key)
    dev = S.device
    r_pay = [n for n in R.column_names if n != key]
    s_pay = [n for n in S.column_names if n != key]

    with phase(phases, "transform", dev):
        if pattern == "gfur":
            # the narrow transform: (key, physical ID) pairs only
            kr, pid_r = prim.sort_pairs(R[key], torch.arange(R.num_rows, dtype=torch.int32,
                                                             device=dev))
            ks, pid_s = prim.sort_pairs(S[key], torch.arange(S.num_rows, dtype=torch.int32,
                                                             device=dev))
        else:
            # one sort plan per relation; every payload column is then
            # transformed with one gather, lazily (Algorithm 1)
            kr, perm_r = prim.plan_sort_permutation(R[key])
            ks, perm_s = prim.plan_sort_permutation(S[key])
    keys_o, vid_r, vid_s, valid, count = _find(kr, ks, mode, out_size, find_impl, phases)

    with phase(phases, "gathers", dev):
        cols = {key: keys_o}
        if pattern == "gfur":
            # virtual IDs -> physical IDs of the untransformed relations: the
            # permutation makes them unclustered, GFUR's flaw (§3.3)
            id_r = torch.where(valid, pid_r[vid_r.clamp(0, R.num_rows - 1)], -1)
            id_s = torch.where(valid, pid_s[vid_s.clamp(0, S.num_rows - 1)], -1)
            for n in r_pay:
                cols[n] = prim.gather(R[n], id_r, fill=0)
            for n in s_pay:
                cols[n] = prim.gather(S[n], id_s, fill=0)
        else:
            id_r = torch.where(valid, vid_r, -1)
            id_s = torch.where(valid, vid_s, -1)
            for n in r_pay:
                cols[n] = prim.gather(prim.apply_permutation(perm_r, R[n]), id_r, fill=0)
            for n in s_pay:
                cols[n] = prim.gather(prim.apply_permutation(perm_s, S[n]), id_s, fill=0)
    return Table(cols), count
