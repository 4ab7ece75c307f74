"""Non-partitioned hash join (the cuDF-style baseline, paper Fig. 1/8).

One global open-addressing table: the build inserts R's keys directly and
the probe streams S's keys against it, with random device-memory accesses
on both sides, which is why the paper's partitioned joins beat it.

Insertion without atomic slot claims: each linear-probing round scatters
each free slot's candidate ranks with an integer max (`scatter_reduce_`
"amax", which commutes, so the winner is the same on every run) and the
losers retry in the next round. Rows that want no slot this round scatter
_EMPTY, the least value, into their own probe slot, which leaves it as it
is; a shared dummy slot would serialize all their atomics on one address
(171 ms of a 0.31 s build and probe of J2 on an H100, chip_smoke.py's NPHJ
profile). With load factor <= 1/4 and 16 rounds no
insertion fails for the workloads run here; `build_table` returns the count
of rows that did.
"""
from __future__ import annotations

import torch

from . import primitives as prim
from .hash_join import hash32
from .table import KEY_SENTINEL, Table, nonempty

_EMPTY = -1


def build_table(keys: torch.Tensor, table_size: int, max_rounds: int = 16):
    """Insert unique keys into an open-addressing table of table_size (a
    power of two) slots. Returns (slot_keys, slot_vids int32, failed), with
    failed a 0-d count of the keys that found no slot in max_rounds."""
    n = keys.shape[0]
    dev = keys.device
    mask = table_size - 1
    h = (hash32(keys) & mask).to(torch.int32)
    rank = torch.arange(n, dtype=torch.int32, device=dev)
    slot_rank = torch.full((table_size,), _EMPTY, dtype=torch.int32, device=dev)
    inserted = torch.zeros(n, dtype=torch.bool, device=dev)
    slot_of = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for a in range(max_rounds):
        idx = ((h + a) & mask).long()
        want = ~inserted & (slot_rank[idx] == _EMPTY)
        slot_rank.scatter_reduce_(0, idx, torch.where(want, rank, _EMPTY), "amax")
        won = want & (slot_rank[idx] == rank)
        slot_of = torch.where(won, idx.to(torch.int32), slot_of)
        inserted |= won
    # each inserted row owns its slot; the rest write a spare slot past the
    # table, which is cut off
    safe = torch.where(inserted, slot_of, table_size).long()
    slot_keys = torch.full((table_size + 1,), KEY_SENTINEL, dtype=keys.dtype, device=dev)
    slot_vids = torch.full((table_size + 1,), -1, dtype=torch.int32, device=dev)
    slot_keys[safe] = keys
    slot_vids[safe] = rank
    return slot_keys[:table_size], slot_vids[:table_size], (~inserted).sum()


def probe_table(slot_keys: torch.Tensor, slot_vids: torch.Tensor, probe_keys: torch.Tensor,
                max_rounds: int = 16):
    """Probe with unique build keys: (vid_r int32, matched) per probe row. A
    chain ends at its first empty slot."""
    mask = slot_keys.shape[0] - 1
    h = (hash32(probe_keys) & mask).to(torch.int32)
    found = torch.full(probe_keys.shape, -1, dtype=torch.int32, device=probe_keys.device)
    done = probe_keys == KEY_SENTINEL
    for a in range(max_rounds):
        idx = ((h + a) & mask).long()
        sk = slot_keys[idx]
        hit = ~done & (sk == probe_keys)
        found = torch.where(hit, slot_vids[idx], found)
        done = done | hit | (sk == KEY_SENTINEL)
    return found, found >= 0


def nphj_join(
    R: Table,
    S: Table,
    *,
    key: str = "k",
    out_size: int | None = None,
    load_factor: float = 0.25,
    max_rounds: int = 16,
    stats: dict | None = None,
):
    """cuDF-style non-partitioned hash join (pk_fk). Returns (Table,
    valid_count). The probe side streams in order (clustered); the build
    side is gathered through hash-permuted IDs (unclustered). `stats`, when
    given, receives the table's `table_size` and `failed`, the 0-d count of
    build keys that found no slot (their probe rows then miss)."""
    if out_size is None:
        out_size = S.num_rows
    R = nonempty(R, key)
    S = nonempty(S, key)
    dev = S.device
    table_size = 1 << max(3, (int(R.num_rows / load_factor) - 1).bit_length())
    slot_keys, slot_vids, failed = build_table(R[key], table_size, max_rounds)
    if stats is not None:
        stats.update(table_size=table_size, failed=failed)
    vid_r, matched = probe_table(slot_keys, slot_vids, S[key], max_rounds)
    vid_s = torch.arange(S.num_rows, dtype=torch.int32, device=dev)
    (keys_o, vr, vs), count = prim.compact(matched, [S[key], vid_r, vid_s], out_size,
                                           fill=KEY_SENTINEL)
    valid = torch.arange(out_size, dtype=torch.int32, device=dev) < count
    cols = {key: keys_o}
    for n in R.column_names:
        if n != key:
            cols[n] = prim.gather(R[n], torch.where(valid, vr, -1), fill=0)
    for n in S.column_names:
        if n != key:
            cols[n] = prim.gather(S[n], torch.where(valid, vs, -1), fill=0)
    return Table(cols), count
