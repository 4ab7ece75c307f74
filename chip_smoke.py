#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the hand-written kernels
   (one nvcc per source, in parallel) and prints the build time.
2. Generates the TPC-H Q18 extract J2 at scale 1 (R = orders, 15,000,000
   rows, int32 key and three int64 payloads; S = lineitem, 60,000,000 rows,
   int32 key and one int64 payload; seed 0) and puts it on the card.
3. Drives the port's main path: join(R, S, algorithm="phj", pattern="gftr")
   followed by group_aggregate(T, key="k", strategy="partition") with 15M
   groups, with every kernel launch counter set to 0 just before the run and
   read just after it. Prints the wall time of each phase and the peak device
   memory, then profiles one more warm query (device time by kernel, and the
   device's idle share).
4. Checks the result: (a) the same query with every arm forced to plain
   PyTorch on the card gives the same tables row for row; (b) a numpy
   reference in int64 gives the same per-key row counts, sums of s1 and
   maxima of r1, for the join and the group-by; (c) every kernel of the path
   was launched.
5. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the J2 query gives it (they must be exactly equal), and times the
   kernel, the plain version and the one PyTorch library call that computes
   the same function where there is one (median of CUDA-event timings),
   beside the least time the card could take.

Prints one JSON line {"kernels": [...]} before the last line, and as the last
line {"ok": true, "device": {...}}. Exits non-zero, before printing either,
when there is no CUDA device, when the repository's `src/repro_torch` is not
beside this file, or when any phase fails.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# H100 SXM int32 compares: the 67 TFLOP/s float32 peak counts an FMA as two
# operations on 128 lanes per SM; int32 runs on 64 lanes per SM, one
# operation each, so a quarter of it
INT32_OPS_PER_S = 67e12 / 4
N_GROUPS = 15_000_000
AGGS = {"s1": "sum", "r1": "max", "r2": "count"}
# the partition plan runs 3 passes per join side (2^18 + 1 partitions) and
# 2 for the group-by (2^16 + 1, top partition as a tail class); one probe;
# one gather per payload column
EXPECTED_LAUNCHES = {"block_histograms": 8, "partition_ranks": 8, "hash_probe": 1,
                     "clustered_gather": 4}
KERNEL_SOURCES = {
    "block_histograms": ("src/repro_torch/csrc/block_histograms.cu",
                         "src/repro/kernels/radix_partition.py:49"),
    "partition_ranks": ("src/repro_torch/csrc/partition_ranks.cu",
                        "src/repro/kernels/radix_partition.py:79"),
    "hash_probe": ("src/repro_torch/csrc/hash_probe.cu", "src/repro/kernels/hash_probe.py:43"),
    "clustered_gather": ("src/repro_torch/csrc/clustered_gather.cu",
                         "src/repro/kernels/gather.py:40"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not bool(cond):
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# numpy reference
# ---------------------------------------------------------------------------
def per_key(keys: np.ndarray, n_keys: int, sum_col: np.ndarray, max_col: np.ndarray):
    """(rows, int64 sum of sum_col, max of max_col) per key in [0, n_keys),
    by a stable sort and int64 segment reductions; empty keys give 0, 0 and
    the int64 minimum."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]]) if ks.size else np.array([], int)
    uk = ks[starts]
    rows = np.zeros(n_keys, np.int64)
    sums = np.zeros(n_keys, np.int64)
    maxs = np.full(n_keys, np.iinfo(np.int64).min, np.int64)
    rows[uk] = np.diff(np.r_[starts, ks.size])
    sums[uk] = np.add.reduceat(sum_col[order].astype(np.int64), starts)
    maxs[uk] = np.maximum.reduceat(max_col[order].astype(np.int64), starts)
    return rows, sums, maxs


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (group_aggregate, join, phj_overflowed, table_from_numpy,
                                  table_to_numpy)
    from repro_torch.core import groupby as gb
    from repro_torch.core import hash_join as hj
    from repro_torch.core import primitives as prim
    from repro_torch.data.relgen import generate_tpc
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import gather as kgather
    from repro_torch.kernels import hash_probe as kprobe
    from repro_torch.kernels import radix_partition as krp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(smi[0] if smi else "nvidia-smi printed nothing")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s for {len(_build.SOURCES)} kernels "
        f"({' '.join(_build.NVCC_FLAGS)}) into {_build.BUILD_DIR.relative_to(ROOT)}")

    # -- 2. data ------------------------------------------------------------
    t0 = time.perf_counter()
    Rn, Sn, mode = generate_tpc("J2", scale=1, payload_bytes=8, seed=0)
    check(mode == "pk_fk", f"J2 mode {mode}")
    n_r, n_s = Rn["k"].shape[0], Sn["k"].shape[0]
    R, S = table_from_numpy(Rn), table_from_numpy(Sn)
    dev = R.device
    torch.cuda.synchronize()
    log(f"data: R {n_r} rows {R!r}, S {n_s} rows {S!r}; "
        f"{(R.nbytes() + S.nbytes()) / 1e9:.3f} GB on the card, "
        f"{time.perf_counter() - t0:.3f} s")
    over, p_bits = phj_overflowed(R)
    check(not over, "a build partition overflows its 256-row block")
    log(f"phj_overflowed: False at {p_bits} partition bits")

    def query(phases=None, **arms):
        T, cnt = join(R, S, algorithm="phj", pattern="gftr", phases=phases, **arms)
        if phases is not None:
            torch.cuda.synchronize()
            t = time.perf_counter()
        G, gcnt = group_aggregate(T, key="k", aggs=AGGS, num_groups=N_GROUPS,
                                  strategy="partition")
        if phases is not None:
            torch.cuda.synchronize()
            phases["group-by"] = time.perf_counter() - t
        return T, cnt, G, gcnt

    # -- 3. the main path ---------------------------------------------------
    (T, cnt, G, gcnt), cold_s = timed(torch, query)
    del T, G
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    phases = {}
    (T, cnt, G, gcnt), warm_s = timed(torch, lambda: query(phases))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(json.dumps({"j2_query": {"cold_s": cold_s, "warm_s": warm_s, "phases_s": phases,
                                 "peak_device_bytes": peak, "join_rows": int(cnt),
                                 "groups": int(gcnt), "launches": launches}}))
    for name, want in EXPECTED_LAUNCHES.items():
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
        check(launches[name] == want, f"kernel {name}: {launches[name]} launches, "
              f"expected {want}")
    check(int(cnt) == n_s, f"join rows {int(cnt)} != {n_s} (match ratio 1.0)")

    # -- where the time of a warm query goes --------------------------------
    walls = sorted(timed(torch, query)[1] for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_wall = timed(torch, query)
    averages = prof.key_averages()
    kernel_us = {e.key[:90]: e.self_device_time_total for e in averages
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    host_us = {e.key[:60]: e.self_cpu_time_total for e in averages
               if e.device_type == DeviceType.CPU}
    busy_s = sum(kernel_us.values()) / 1e6

    def top(us):
        return {k: v / 1e3 for k, v in sorted(us.items(), key=lambda kv: -kv[1])[:15]}

    log(json.dumps({"j2_profile": {
        "query_s_median_of_3": walls[1], "profiled_wall_s": prof_wall,
        "device_busy_s": busy_s if busy_s else "not measured",
        "device_idle_share": 1 - busy_s / prof_wall if busy_s else "not measured",
        "top_kernels_ms": top(kernel_us), "top_host_ops_self_ms": top(host_us)}}))

    # -- 4a. every arm forced to plain PyTorch, on the card -----------------
    os.environ[ops.PARTITION_PLAN_ENV] = "torch"
    try:
        ops.reset_launch_counts()
        (T0, cnt0, G0, gcnt0), torch_s = timed(
            torch, lambda: query(probe_impl="torch", gather_impl="torch"))
        check(sum(ops.launch_counts().values()) == 0, "the plain arms launched a kernel")
    finally:
        del os.environ[ops.PARTITION_PLAN_ENV]
    check(int(cnt0) == int(cnt) and int(gcnt0) == int(gcnt), "valid counts differ")
    for a, b, what in ((T, T0, "join"), (G, G0, "group-by")):
        check(a.column_names == b.column_names, f"{what} columns differ")
        for name in a.column_names:
            check(torch.equal(a[name], b[name]), f"{what} column {name} differs from the "
                  "all-torch run")
    log(f"(a) all-torch arms on the card: join and group-by equal row for row "
        f"({torch_s:.3f} s)")
    del T0, G0

    # -- 4b. numpy reference ------------------------------------------------
    t0 = time.perf_counter()
    r1_of_key = np.full(n_r, np.iinfo(np.int64).min, np.int64)
    r1_of_key[Rn["k"]] = Rn["r1"]
    rows_ref, s1_ref, _ = per_key(Sn["k"], n_r, Sn["s1"], Sn["s1"])
    present = rows_ref > 0
    r1_ref = np.where(present, r1_of_key, np.iinfo(np.int64).min)
    Th = table_to_numpy(T.head(int(cnt)))
    check(Th["k"].min() >= 0 and Th["k"].max() < n_r, "join keys out of range")
    rows_t, s1_t, r1_t = per_key(Th["k"], n_r, Th["s1"], Th["r1"])
    check(np.array_equal(rows_t, rows_ref), "join: rows per key differ from numpy")
    check(np.array_equal(s1_t, s1_ref), "join: sum of s1 per key differs from numpy")
    check(np.array_equal(r1_t, r1_ref), "join: max of r1 per key differs from numpy")
    for c in ("r2", "r3"):
        want = np.empty(n_r, Rn[c].dtype)
        want[Rn["k"]] = Rn[c]
        check(np.array_equal(Th[c], want[Th["k"]]), f"join: {c} is not its key's payload")
    del Th
    Gh = table_to_numpy(G.head(int(gcnt)))
    check(int(gcnt) == int(present.sum()), f"groups {int(gcnt)} != {int(present.sum())}")
    order = np.argsort(Gh["k"], kind="stable")
    gk = Gh["k"][order]
    check(np.array_equal(gk, np.flatnonzero(present)), "group-by keys differ from numpy")
    check(np.array_equal(Gh["r2_count"][order], rows_ref[gk]), "group-by: counts differ")
    check(np.array_equal(Gh["s1_sum"][order], s1_ref[gk]), "group-by: sums of s1 differ")
    check(np.array_equal(Gh["r1_max"][order], r1_ref[gk]), "group-by: max of r1 differs")
    check(Gh["s1_sum"].dtype == np.int64 and Gh["r1_max"].dtype == np.int64,
          "aggregates lost the int64 payload type")
    del Gh
    log(f"(b) numpy int64 reference: join and group-by agree per key "
        f"({time.perf_counter() - t0:.3f} s)")
    log(f"(c) launches on the main path: {json.dumps(launches)}")
    tk = T["k"]
    del T, G

    # -- 5. each kernel against its plain version, at J2's shapes ------------
    results = []

    def record(name, kernel_out, plain_out, kernel_fn, plain_fn, library_fn, nbytes, nops=0):
        for k, p in zip(kernel_out, plain_out):
            check(k.shape == p.shape and k.dtype == p.dtype, f"{name}: shape/dtype differ")
            check(torch.equal(k, p), f"{name}: kernel differs from its plain version")
        err = max(float((k.double() - p.double()).abs().max()) if k.numel() else 0.0
                  for k, p in zip(kernel_out, plain_out))
        bound_b, bound_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
        row = {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
               "replaces": KERNEL_SOURCES[name][1], "launches": launches[name],
               "max_abs_err": err, "ms": cuda_ms(torch, kernel_fn),
               "plain_ms": cuda_ms(torch, plain_fn, reps=5),
               "bound_ms": max(bound_b, bound_o),
               "bound_by": "bytes" if bound_b >= bound_o else "operations",
               "library_ms": cuda_ms(torch, library_fn) if library_fn else None}
        results.append(row)
        log(f"kernel {name}: exact; {json.dumps(row)} bytes={nbytes} ops={nops}")

    # the first plan pass of the probe side: 60M digits, 256 bins
    dig_s = hj._digits(S["k"], p_bits, True)
    pd = (dig_s & 255).contiguous()
    nb, tile = 256, krp.TILE
    n_tiles = -(-n_s // tile)
    hist = krp.block_histograms(pd, nb)
    flat = torch.arange(n_s, device=dev) // tile * nb + pd
    record("block_histograms", [hist], [ref.block_histograms(pd, nb, tile)],
           lambda: krp.block_histograms(pd, nb), lambda: ref.block_histograms(pd, nb, tile),
           lambda: torch.bincount(flat, minlength=n_tiles * nb), 4 * n_s + 4 * n_tiles * nb)
    del flat
    base, _, _ = krp.tile_base(hist)
    record("partition_ranks", [krp.rank_with_base(pd, base, nb)],
           [ref.partition_ranks(pd, nb)], lambda: krp.rank_with_base(pd, base, nb),
           lambda: ref.partition_ranks(pd, nb), lambda: torch.sort(pd, stable=True),
           4 * n_s + base.numel() * 4 + 4 * n_s)
    del hist, base, pd

    # the group-by's first pass over the join output: 2^16 + 1 partitions,
    # ranked as 256 bit bins plus the sentinel partition as a tail class
    gbits, _ = gb._partition_layout(tk.shape[0], gb.PARTITION_ROW_BLOCK, None)
    gdig = gb._partition_digits(tk, gbits)
    gd = torch.where(gdig == 1 << gbits, 256, gdig & 255).contiguous()
    gh = krp.block_histograms(gd, 257)
    check(torch.equal(gh, ref.block_histograms(gd, 257, tile)), "257-bin histograms differ")
    check(torch.equal(krp.rank_with_base(gd, krp.tile_base(gh)[0], 257),
                      ref.partition_ranks(gd, 257)), "257-bin ranks differ")
    log("kernels block_histograms and partition_ranks at the group-by's 257 bins: exact")
    del tk, gdig, gd, gh

    # the probe and the gathers, on the join's own layout
    P = 1 << p_bits
    dig_r = hj._digits(R["k"], p_bits, True)
    perm_r, off_r, sz_r = prim.plan_partition_permutation(dig_r, P + 1)
    perm_s, off_s, sz_s = prim.plan_partition_permutation(dig_s, P + 1)
    kr, ks = R["k"][perm_r], S["k"][perm_s]
    bkeys, _, _ = hj.build_blocks(kr, off_r[:P], sz_r[:P], hj.BUILD_BLOCK)
    cap = hj.BUILD_BLOCK
    pk, part, _ = kprobe.layout_probe_blocks(ks, off_s[:P], sz_s[:P], cap, -(-n_s // cap) + P)
    offp = off_r[:P].contiguous()
    vid, hit = kprobe.hash_probe(bkeys, offp, pk, part)
    B = pk.shape[0]

    def probe_plain():
        v, h = ref.hash_probe_blocks(bkeys, offp, pk.reshape(-1), part.repeat_interleave(cap))
        return v.reshape(B, cap), h.reshape(B, cap)

    # compares the data needs: up to the first hit, the whole block on a miss.
    # Bytes the data needs: each probe key read and its vid and hit written
    # once, each build key and partition offset read once. The padded layout
    # the kernel is given moves more: every slot of every sub-block and of
    # every build block.
    slot = vid - offp[part][:, None]
    nops = int(torch.where(hit.bool(), slot + 1, torch.where(pk != -1, cap, 0)).sum())
    padded_bytes = 4 * (bkeys.numel() + P + pk.numel() + B + 2 * vid.numel())
    log(f"hash_probe padded layout: {B} sub-blocks of {cap} slots, "
        f"{int((pk != -1).sum())} probe keys; padded bytes={padded_bytes} "
        f"bound {padded_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms")
    record("hash_probe", [vid, hit], list(probe_plain()),
           lambda: kprobe.hash_probe(bkeys, offp, pk, part), probe_plain, None,
           4 * (3 * n_s + n_r + P), nops)
    check(int(hit.sum()) == n_s, "the probe missed rows of a match-ratio-1 join")
    del pk, part, vid, hit, slot

    vid_r, matched = ops.hash_probe(bkeys, off_r[:P], ks, off_s[:P], sz_s[:P], "cuda")
    (_, vr), c = prim.compact(matched, [ks, vid_r], n_s, fill=-1)
    id_r = torch.where(torch.arange(n_s, device=dev) < c, vr, -1)
    src = R["r1"][perm_r]
    idx_long = id_r.clamp(min=0).long()  # all valid here, so take computes the same
    record("clustered_gather", [kgather.clustered_gather(src, id_r)],
           [ref.clustered_gather(src, id_r)], lambda: kgather.clustered_gather(src, id_r),
           lambda: ref.clustered_gather(src, id_r), lambda: torch.take(src, idx_long),
           src.numel() * 8 + id_r.numel() * 4 + id_r.numel() * 8)

    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
