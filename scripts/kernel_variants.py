#!/usr/bin/env python3
"""Times design variants of the port's probe, per-tile histogram and
segmented-sum kernels against the kept sources, on one NVIDIA GPU, at J2's
shapes.

    python3 scripts/kernel_variants.py [--rounds 21] [--kernel segsum_partials]

Each variant is the kept source (`src/repro_torch/csrc/hash_probe.cu`,
`block_histograms.cu` or `segsum_partials.cu`) with one named text edit
(`VARIANTS`), written to
`build/kernel_variants/`, built with the port's nvcc flags and loaded with
ctypes beside the kept kernel. Variants that change the output say so
(`exact=False`): they take a part of the kernel away to show what that part
costs. The script makes J2's partitioned key columns (TPC-H Q18 at scale 1,
seed 0: 15M build and 60M probe keys, 2^18 partitions) and the digits of
the probe side's plan passes (256, 257 and 8 bins), and the sort_pallas
group-by's s1 pass (the probe side's 60M keys sorted, their s1 as float32,
and the same rows with every key equal: the serial-add worst case), then
times every variant of a kernel once a round, in an order that turns each
round, and prints each one's median milliseconds, its minimum and the min,
median and max of its per-round ratio to the kept kernel. It also times a
`copy_` of the 60M digits and of the sorted keys and values, the card's
copy rate on the same bytes. Prints the card's name and power limit first.
Exits non-zero without a CUDA device.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "kernel_variants"

_PROBE_LOOKUP = """        if (key != KEY_SENTINEL) {
          unsigned long long x = e[u];"""
_PROBE_STORES = """        vid[j] = slot >= 0 ? cur.build_off + slot : -1;
        hit[j] = slot >= 0;
"""
_PROBE_BUILD = """    for (int i = r; i <= static_cast<int>(mask); i += GROUP) table[i] = EMPTY;
    group_sync<GROUP>();
    for (int s = r; s < m; s += GROUP) {"""
_PROBE_NO_TABLE = [
    (_PROBE_BUILD, "    for (int s = r; s < 0; s += GROUP) {"),
    ("        e[u] = table[h[u]];", "        e[u] = EMPTY;"),
    (_PROBE_LOOKUP, """        if (key != KEY_SENTINEL) slot = key;
        if (false) {
          unsigned long long x = e[u];"""),
]
_PROBE_RUNS = [("""  const long long stride = static_cast<long long>(gridDim.x) * GROUPS;
  long long p = static_cast<long long>(blockIdx.x) * GROUPS + g;
  if (p >= num_parts) return;  // the whole group leaves: no sync is left waiting
  Part cur = load_part(p, off_r, sz_r, off_s, sz_s, num_parts, n_probe, cap);
  for (; p < num_parts; p += stride) {
    const long long pn = p + stride;""",
                """  const long long groups = static_cast<long long>(gridDim.x) * GROUPS;
  const long long run = (num_parts + groups - 1) / groups;
  long long p = (static_cast<long long>(blockIdx.x) * GROUPS + g) * run;
  const long long p_end = min(p + run, static_cast<long long>(num_parts));
  if (p >= p_end) return;
  Part cur = load_part(p, off_r, sz_r, off_s, sz_s, num_parts, n_probe, cap);
  for (; p < p_end; ++p) {
    const long long pn = p + 1 < p_end ? p + 1 : num_parts;""")]

# name -> (kernel, exact, [(old, new), ...]); every old text must occur once
VARIANTS = {
    "hash_probe": ("hash_probe", True, []),
    "hash_probe 8 rows a thread": ("hash_probe", True, [
        ("constexpr int UNROLL = 4;", "constexpr int UNROLL = 8;")]),
    "hash_probe tables of 4m entries": ("hash_probe", True, [
        ("constexpr int WARP_TABLE_BITS = 9;", "constexpr int WARP_TABLE_BITS = 10;"),
        ("while ((1 << bits) < 2 * m && bits < table_bits)",
         "while ((1 << bits) < 4 * m && bits < table_bits)")]),
    "hash_probe runs of neighbouring partitions": ("hash_probe", True, _PROBE_RUNS),
    "hash_probe streaming loads and stores": ("hash_probe", True, [
        ("vid[j] = slot >= 0 ? cur.build_off + slot : -1;",
         "__stcs(vid + j, slot >= 0 ? cur.build_off + slot : -1);"),
        ("? probe[j] : KEY_SENTINEL", "? __ldcs(probe + j) : KEY_SENTINEL")]),
    "walk only (no table)": ("hash_probe", False, _PROBE_NO_TABLE),
    "walk only, no hit stores": ("hash_probe", False, _PROBE_NO_TABLE + [
        ("        hit[j] = slot >= 0;\n", "")]),
    "walk only, no vid stores": ("hash_probe", False, _PROBE_NO_TABLE + [
        ("        vid[j] = slot >= 0 ? cur.build_off + slot : -1;\n", "")]),
    "walk only, loads only": ("hash_probe", False, _PROBE_NO_TABLE + [
        (_PROBE_STORES, "        if (slot == 123456789) hit[j] = 1;\n")]),
    "walk only, 8 rows a thread": ("hash_probe", False, _PROBE_NO_TABLE + [
        ("constexpr int UNROLL = 4;", "constexpr int UNROLL = 8;")]),
    "block_histograms": ("block_histograms", True, []),
    "block_histograms next tile in flight": ("block_histograms", True, [
        ("  for (; t < num_tiles; t += stride) {\n",
         "  int4 nxt[VECS];\n  if (VEC && t < full) load_tile(nxt, d4, t, lane);\n"
         "  for (; t < num_tiles; t += stride) {\n"),
        ("      int4 cur[VECS];\n      load_tile(cur, d4, t, lane);\n",
         "      int4 cur[VECS];\n#pragma unroll\n"
         "      for (int i = 0; i < VECS; ++i) cur[i] = nxt[i];\n"
         "      if (t + stride < full) load_tile(nxt, d4, t + stride, lane);\n")]),
    "block_histograms 3 blocks an SM": ("block_histograms", True, [
        ("__launch_bounds__(WARPS * 32) block_histograms_kernel(",
         "__launch_bounds__(WARPS * 32, 3) block_histograms_kernel(")]),
    "segsum_partials": ("segsum_partials", True, []),
    "segsum_partials chunks of 512 rows": ("segsum_partials", True, [
        ("constexpr int ROW_WARPS = 2;", "constexpr int ROW_WARPS = 1;"),
        ("constexpr int BLOCKS_PER_SM = 5;", "constexpr int BLOCKS_PER_SM = 10;")]),
    "segsum_partials chunks of 2048 rows": ("segsum_partials", True, [
        ("constexpr int ROW_WARPS = 2;", "constexpr int ROW_WARPS = 4;"),
        ("constexpr int BLOCKS_PER_SM = 5;", "constexpr int BLOCKS_PER_SM = 2;")]),
    "segsum_partials a warp per tile": ("segsum_partials", True, [
        ("constexpr int ROW_WARPS = 2;", "constexpr int ROW_WARPS = 1;"),
        ("constexpr int ITEMS = 16;", "constexpr int ITEMS = 8;"),
        ("constexpr int BLOCKS_PER_SM = 5;", "constexpr int BLOCKS_PER_SM = 16;")]),
    "segsum_partials 8 rows a thread": ("segsum_partials", True, [
        ("constexpr int ROW_WARPS = 2;", "constexpr int ROW_WARPS = 4;"),
        ("constexpr int ITEMS = 16;", "constexpr int ITEMS = 8;")]),
    "segsum_partials one stage": ("segsum_partials", True, [
        ("constexpr int STAGES = 2;", "constexpr int STAGES = 1;"),
        ("constexpr int BLOCKS_PER_SM = 5;", "constexpr int BLOCKS_PER_SM = 7;")]),
    "segsum_partials three stages": ("segsum_partials", True, [
        ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),
        ("constexpr int BLOCKS_PER_SM = 5;", "constexpr int BLOCKS_PER_SM = 4;")]),
    "segsum_partials look-back of 128 chunks a trip": ("segsum_partials", True, [
        ("constexpr int LOOKBACK = 1;", "constexpr int LOOKBACK = 4;")]),
    "segsum_partials look-back words packed": ("segsum_partials", True, [
        ("constexpr int STATUS_STRIDE = 16;", "constexpr int STATUS_STRIDE = 1;")]),
    "segsum_partials edges and counts only": ("segsum_partials", False, [
        ("if (i >= STAGES && s_slot_chunk[slot] >= 0) {", "if (false) {"),
        ("s_slot_chunk[slot] = live ? cur : -1;", "s_slot_chunk[slot] = -1;"),
        ("    if (live) {\n      // Each run's partial",
         "    if (false) {\n      // Each run's partial")]),
    "segsum_partials no write-out": ("segsum_partials", False, [
        ("if (i >= STAGES && s_slot_chunk[slot] >= 0) {", "if (false) {"),
        ("s_slot_chunk[slot] = live ? cur : -1;", "s_slot_chunk[slot] = -1;")]),
    "segsum_partials loads only": ("segsum_partials", False, [
        ("const int rows = live ? chunk_rows_of(cur, chunk_rows, n) : 0;", "const int rows = 0;"),
        ("if (i >= STAGES && s_slot_chunk[slot] >= 0) {", "if (false) {"),
        ("s_slot_chunk[slot] = live ? cur : -1;", "s_slot_chunk[slot] = -1;"),
        ("    if (live) {\n      // Each run's partial",
         "    if (false) {\n      // Each run's partial")]),
    "segsum_partials no look-back (slot offsets)": ("segsum_partials", False, [
        ("const unsigned long long before = look_back(status, c, unsorted);",
         "unsorted = false;\n        const unsigned long long before = c * chunk_rows;")]),
    "segsum_partials no float sums": ("segsum_partials", False, [
        ("        acc += v[j];", "        acc = 0.f;"),
        ("carry = (j == 0 ? up : carry) + v[j];", "carry = up;"),
        ("if (j < first) c += v[j];", "if (j < first) c = 0.f;"),
        ("++i) walk += sv[sp<float>(i)];", "++i) {\n          }")]),
}


def fail(msg):
    print(f"kernel_variants: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def build(names, nvcc_flags):
    """Write and compile every variant, one nvcc each, all at once; returns
    {name: library path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    jobs = {}
    for i, name in enumerate(names):
        kernel, _, edits = VARIANTS[name]
        src = (csrc / f"{kernel}.cu").read_text()
        for old, new in edits:
            if src.count(old) != 1:
                fail(f"{name}: the edit does not find its text once: {old[:60]!r}")
            src = src.replace(old, new)
        cu, so = OUT / f"v{i}_{kernel}.cu", OUT / f"v{i}_{kernel}.so"
        cu.write_text(src)
        cmd = ["/usr/local/cuda/bin/nvcc", *nvcc_flags, "-Xptxas", "-v", "-I", str(csrc),
               "-o", str(so), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc failed for {name}:\n{log}")
        regs = sorted({line.split(":", 1)[1].strip() for line in log.splitlines()
                       if "registers" in line})
        print(f"built {name!r}: {regs}", flush=True)
        libs[name] = so
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=21)
    ap.add_argument("--kernel", choices=sorted({v[0] for v in VARIANTS.values()}),
                    help="time only this kernel's variants")
    args = ap.parse_args()
    kernels = {args.kernel} if args.kernel else {v[0] for v in VARIANTS.values()}
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the variants run on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import hash_join as hj
    from repro_torch.core import primitives as prim
    from repro_torch.core import table_from_numpy
    from repro_torch.data.relgen import generate_tpc
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import radix_partition as krp
    from repro_torch.kernels import segsum as kseg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    paths = build([k for k, v in VARIANTS.items() if v[0] in kernels], _build.NVCC_FLAGS)

    def load(name):
        """The variant's library, with the argument and result types of its
        entry points set."""
        lib = ctypes.CDLL(str(paths[name]))
        for fn, argtypes in _build.SIGNATURES[VARIANTS[name][0]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _build.RESTYPES.get(fn, ctypes.c_int)
        return lib

    Rn, Sn, _ = generate_tpc("J2", scale=1, payload_bytes=8, seed=0)
    R, S = table_from_numpy({"k": Rn["k"]}), table_from_numpy({"k": Sn["k"], "s1": Sn["s1"]})
    p_bits = hj.choose_partition_bits(R.num_rows, hj.BUILD_BLOCK)
    P, cap = 1 << p_bits, hj.BUILD_BLOCK
    dig_r, dig_s = hj._digits(R["k"], p_bits, True), hj._digits(S["k"], p_bits, True)
    perm_r, off_r, sz_r = prim.plan_partition_permutation(dig_r, P + 1)
    perm_s, off_s, sz_s = prim.plan_partition_permutation(dig_s, P + 1)
    cols = [t.contiguous() for t in (R["k"][perm_r], off_r[:P], sz_r[:P], S["k"][perm_s],
                                     off_s[:P], sz_s[:P])]
    n = cols[3].shape[0]
    launch = _build.launch_on(cols[3])

    def event_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def rounds(fns, title):
        for fn in fns.values():
            for _ in range(3):
                fn()
        names = list(fns)
        t = {k: [] for k in names}
        for i in range(args.rounds):
            order = names[i % len(names):] + names[:i % len(names)]
            for k in order[::-1] if i % 2 else order:
                t[k].append(event_ms(fns[k]))
        base = np.array(t[names[0]])
        print(title, flush=True)
        for k in names:
            a = np.array(t[k])
            ratio = a / base
            print(f"  {k}: median {np.median(a):.4f} ms, min {a.min():.4f}; ratio to "
                  f"{names[0]!r} {ratio.min():.3f}-{ratio.max():.3f}, median "
                  f"{np.median(ratio):.3f}", flush=True)

    if "hash_probe" in kernels:
        want = ref.hash_probe(*cols, cap)
        fns = {}
        for name, (kernel, exact, _) in VARIANTS.items():
            if kernel != "hash_probe":
                continue
            fn = load(name).hash_probe
            vid = torch.empty(n, dtype=torch.int32, device=cols[3].device)
            hit = torch.empty(n, dtype=torch.bool, device=cols[3].device)

            def call(fn=fn, vid=vid, hit=hit, name=name):
                err = fn(*(c.data_ptr() for c in cols), P, n, cap, vid.data_ptr(), hit.data_ptr(),
                         *launch)
                if err:
                    fail(f"{name}: launch error {err}")
            call()
            torch.cuda.synchronize()
            if exact and not (torch.equal(vid, want[0]) and torch.equal(hit, want[1])):
                fail(f"{name} differs from the plain version")
            fns[name] = call
        rounds(fns, f"hash_probe at J2: {n} probe rows, {int(cols[0].shape[0])} build rows, "
                    f"{P} partitions")

    if "block_histograms" in kernels:
        pd = (dig_s & 255).contiguous()
        gd = torch.where(dig_s == P, 256, dig_s & 255).contiguous()
        nd = ((dig_s >> 16) & 7).int().contiguous()
        for d, bins in ((pd, 256), (gd, 257), (nd, 8)):
            want = ref.block_histograms(d, bins, krp.TILE)
            fns = {}
            for name, (kernel, exact, _) in VARIANTS.items():
                if kernel != "block_histograms":
                    continue
                fn = load(name).block_histograms
                out = torch.empty_like(want)

                def call(fn=fn, out=out, d=d, bins=bins, name=name):
                    err = fn(d.data_ptr(), d.shape[0], bins, krp.TILE, out.data_ptr(), *launch)
                    if err:
                        fail(f"{name}: launch error {err}")
                call()
                torch.cuda.synchronize()
                if exact and not torch.equal(out, want):
                    fail(f"{name} differs from the plain version at {bins} bins")
                fns[name] = call
            rounds(fns, f"block_histograms on S's {d.shape[0]} digits, {bins} bins")
        dst = torch.empty_like(pd)
        rounds({"copy_": lambda: dst.copy_(pd)}, "copy_ of the 60M digits (read and write)")

    if "segsum_partials" in kernels:
        # the sort_pallas group-by's s1 pass: the join output's keys sorted (the
        # probe side's keys, at match ratio 1) and s1 as float32
        sk, order = torch.sort(S["k"], stable=True)
        sv = S["s1"][order].to(torch.float32)
        del order
        for what, keys in (("J2's sorted keys", sk), ("every key equal", torch.full_like(sk, 7))):
            want = ref.segsum_partials(keys, sv, kseg.TILE)
            live = want[0].shape[0]
            fns = {}
            for name, (kernel, exact, _) in VARIANTS.items():
                if kernel != "segsum_partials":
                    continue
                lib = load(name)
                fn = lib.segsum_partials
                out = (torch.empty(n, dtype=keys.dtype, device=keys.device),
                       torch.empty(n, dtype=torch.float32, device=keys.device),
                       torch.empty(n, dtype=torch.int32, device=keys.device),
                       torch.empty(lib.segsum_partials_state_words(n, kseg.TILE),
                                   dtype=torch.int64, device=keys.device))

                def call(fn=fn, out=out, keys=keys, name=name):
                    err = fn(keys.data_ptr(), sv.data_ptr(), n, kseg.TILE, keys.element_size(),
                             *(o.data_ptr() for o in out), *launch)
                    if err:
                        fail(f"{name}: launch error {err}")
                call()
                torch.cuda.synchronize()
                got = [o[:live] for o in out[:3]]
                if exact and (int(out[3][1]) != live
                              or not all(torch.equal(g, w) for g, w in zip(got, want))):
                    fail(f"{name} differs from the plain version on {what}")
                fns[name] = call
            rounds(fns, f"segsum_partials on {what}: {n} rows, {live} live partials")
        dk, dv = torch.empty_like(sk), torch.empty_like(sv)
        rounds({"copy_": lambda: (dk.copy_(sk), dv.copy_(sv))},
               "copy_ of the sorted keys and values (read and write)")


if __name__ == "__main__":
    main()
