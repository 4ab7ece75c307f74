"""Launch-configuration lint for the port's hand-written Hopper kernels (the
records that `kernels.common.register` holds): the port's counterpart of
the JAX package's `analysis/kernel_lint.py`.

The reference judges each `pallas_call` from its traced jaxpr. Here every
kernel is CUDA C++ whose host code (`csrc/<name>.cu`) decides its launch, so
the lint holds three checks, the Hopper form of the reference's three:

  * Fit (the reference's VMEM fit). Each kernel's record, beside its
    wrapper, declares its launch (`Kernel.declare`, called by `declare`) as
    a function of the call's shape, the card's multiprocessors and `per_sm`,
    the blocks of the instance one of them holds: the instance, threads a
    block, dynamic shared memory and grid, read off the host code.
    `lint_launch` holds one declared launch against the H100's limits
    (`LIMITS`): threads a block, shared memory a block (static plus dynamic;
    past 48 KB only where the launch raises the kernel's limit) and a
    multiprocessor, the grid's dimensions, an empty grid. On the card the
    lint also reads the compiled kernels: each library's
    `<name>_launch_config` is the host helper its launch calls, and must
    equal the declaration at every registered shape; `<name>_func_attributes`
    gives each instance's registers, spills and static shared memory, held
    against the block's threads and the multiprocessor's registers. A spill
    is a violation unless `DECLARED_SPILLS` names the instance, its bytes and
    the timing that shows the spilling build the faster one. Every failure
    here is a `VmemBudgetViolation`.
  * The determinism rule (the reference's grid-output aliasing). Output
    slots come from prefix-sum ranks, never from atomic claims (DESIGN.md
    §10). `lint_source` reads a source as text: every atomic must be one
    `ALLOWED_ATOMICS` names, with the reason its result does not depend on
    the order of the atomics; an atomic whose returned value is used as an
    index (a slot claim) and `atomicExch`, `atomicInc`, `atomicDec` and
    `atomicSub` trip a `GridAliasViolation` unless declared. `histogram`
    declares its accumulation of per-block counts into its one output, as
    `histogram_pallas` declares `allow_output_revisit`; the report counts
    such declared output atomics (`output_atomics`, the counterpart of
    `aliased_output_blocks`).
  * Scatter discipline. No `atomicAdd` on a `float`, `double`, `__half` or
    `__nv_bfloat16` target (`FloatScatterViolation`).

`lint_pallas_eqn` and `lint_fn` traced jaxprs and have no counterpart:
`lint_launch` judges one declared launch and `lint_source` one source.
`lint_production_kernels()` runs all three over every kernel instance at
every registered shape (`SHAPES`) and over every source; given a CUDA
device it adds the C side's configurations and the attributes. The source
checks and the declarations need no card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import re
from pathlib import Path

from ..kernels import _build
from ..kernels import hash_probe as _kprobe
from ..kernels import histogram as _histogram
from ..kernels import radix_partition as _radix
from ..kernels.common import KERNELS, Launch, ceil_div
from .contracts import FloatScatterViolation, GridAliasViolation, VmemBudgetViolation

CSRC = Path(__file__).resolve().parent.parent / "csrc"

# The H100 (compute capability 9.0): CUDA C++ Programming Guide, "Technical
# Specifications per Compute Capability".
LIMITS = {
    "threads_per_block": 1024,
    "smem_per_block": 232_448,          # 227 KB a block, after opting in
    "smem_default_per_block": 48 * 1024,  # without cudaFuncSetAttribute
    "smem_per_sm": 233_472,
    "smem_reserved_per_block": 1024,    # the system's share of each block's
    "regs_per_sm": 65_536,
    "reg_alloc_per_warp": 256,          # registers are given out per warp in 256s
    "threads_per_sm": 2048,
    "blocks_per_sm": 32,
    "grid": (2**31 - 1, 65_535, 65_535),
}
# H100 SXM's multiprocessors: the declarations' default card
SMS = 132

# each registered kernel's instances (`<name>_instance_name(i)` on the card
# must agree)
INSTANCES = {k: r.instances for k, r in KERNELS.items()}


@dataclasses.dataclass(frozen=True)
class DeclaredSpill:
    """A kernel instance allowed to spill: at most `bytes` a thread of local
    memory (`localSizeBytes`), and the timing that shows the spilling build
    faster than one that spills nothing."""
    instance: str
    bytes: int
    reason: str


DECLARED_SPILLS = (
    DeclaredSpill("probe_agg<4, 256, 8>", 8,
                  "`__launch_bounds__(256, 8)` caps a thread at 32 registers so that eight "
                  "blocks share an SM; scripts/kernel_variants.py --kernel probe_agg times it "
                  "against six blocks an SM (40 registers, no spill) at J2's padded layout "
                  "with int32 group keys on an H100 80GB HBM3 at 700 W: median 2.2381 "
                  "against 2.3206 ms, six blocks 1.025-1.051x of eight in every round. (With "
                  "int64 keys eight blocks spill 24 bytes and ran 1.13x of six, so "
                  "probe_agg<8, 256, 6> runs six.)"),
)

# The C side's `LaunchConfig` (`put_config`) and attributes
# (`instance_attributes`), as `<name>_launch_config` and
# `<name>_func_attributes` write them.
CONFIG = ("instance", "threads", "smem", "grid", "sms", "per_sm")
ATTRIBUTES = ("registers", "spill_bytes", "static_smem", "max_threads_per_block",
              "max_dynamic_smem", "instances")


@dataclasses.dataclass
class KernelLintReport:
    """One kernel instance at one shape (or one source), judged."""
    name: str
    grid: tuple
    kernel: str = ""
    instance: str = ""
    shape: str = ""
    threads: int = 0
    dynamic_smem: int = 0
    static_smem: int = 0
    opt_in: int = 0
    launched: bool = True
    # on the card: the compiled instance's attributes and the C side's
    # configuration
    registers: int | None = None
    spill_bytes: int | None = None
    declared_spill_bytes: int = 0
    max_threads_per_block: int | None = None
    c_config: dict | None = None
    # the source checks: atomics found, declared output atomics (the
    # counterpart of `aliased_output_blocks`), float atomicAdds
    atomics: int = 0
    output_atomics: int = 0
    float_atomic_adds: int = 0
    violations: list = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["violations"] = [f"{type(v).__name__}: {v}" for v in self.violations]
        d["grid"] = list(self.grid)
        return d


# ---------------------------------------------------------------------------
# fit: the declared launches against the card's limits
# ---------------------------------------------------------------------------
def occupancy(threads: int, smem: int, registers: int | None = None) -> int:
    """Blocks of a kernel one H100 multiprocessor holds at `threads` threads
    and `smem` bytes of shared memory a block (static plus dynamic): the
    least of the block, warp, shared-memory and (when known) register
    limits. The CPU's stand-in for `cudaOccupancyMaxActiveBlocksPerMultiprocessor`."""
    warps = math.ceil(threads / 32)
    by = [LIMITS["blocks_per_sm"], LIMITS["threads_per_sm"] // 32 // warps,
          LIMITS["smem_per_sm"] // (smem + LIMITS["smem_reserved_per_block"])]
    if registers:
        per_warp = math.ceil(registers * 32 / LIMITS["reg_alloc_per_warp"]) * \
            LIMITS["reg_alloc_per_warp"]
        by.append(LIMITS["regs_per_sm"] // per_warp // warps)
    return max(0, min(by))


def static_smem(instance: str) -> int:
    """Bytes of the `__shared__` arrays of a kernel instance, as its record
    declares them; the card's `sharedSizeBytes` replaces it there."""
    return next((r.static_smem.get(instance, 0) for r in KERNELS.values()
                 if instance in r.instances), 0)


def _estimate_per_sm(instance: str, threads: int, smem: int) -> int:
    return occupancy(threads, smem + static_smem(instance))


def declare(kernel: str, args: dict, sms: int = SMS, per_sm=_estimate_per_sm) -> Launch | None:
    """The launch a call of `kernel` with `args` makes on a card of `sms`
    multiprocessors; `per_sm(instance, threads, smem)` gives the blocks of
    the instance one multiprocessor holds (default: `occupancy` with no
    registers). None where the wrapper launches nothing."""
    record = KERNELS[kernel]
    if args[record.rows] == 0:
        return None
    return record.declare(args, sms, per_sm)


def lint_launch(launch: Launch, *, name: str | None = None, shape: str = "",
                attributes: dict | None = None, c_config: dict | None = None,
                spills=DECLARED_SPILLS) -> KernelLintReport:
    """One declared launch against the H100's limits; with the compiled
    instance's `attributes` (card), its registers, static shared memory and
    spills (past what `spills` declares for it) too, and with the C side's
    `c_config`, their equality."""
    L = LIMITS
    tag = name or launch.instance
    static = (attributes or {}).get("static_smem", static_smem(launch.instance))
    v = []
    if not 1 <= launch.threads <= L["threads_per_block"]:
        v.append(VmemBudgetViolation(
            f"{tag}: a block of {launch.threads} threads; a block takes 1 to "
            f"{L['threads_per_block']}"))
    total = static + launch.smem
    if total > L["smem_per_block"]:
        v.append(VmemBudgetViolation(
            f"{tag}: {launch.smem} bytes of dynamic and {static} of static shared memory "
            f"({total}) over the {L['smem_per_block']} a block may opt in to"))
    limit = launch.opt_in or L["smem_default_per_block"] - static
    if launch.smem > limit:
        v.append(VmemBudgetViolation(
            f"{tag}: asks {launch.smem} bytes of dynamic shared memory where the launch "
            f"leaves the kernel's limit at {limit} (raise it with cudaFuncSetAttribute)"))
    for axis, (g, top) in enumerate(zip(launch.grid, L["grid"])):
        if not 1 <= g <= top:
            v.append(VmemBudgetViolation(
                f"{tag}: grid dimension {'xyz'[axis]} = {g}; it takes 1 to {top}"))
    rep = KernelLintReport(
        name=tag, grid=tuple(launch.grid), kernel=launch.kernel, instance=launch.instance,
        shape=shape, threads=launch.threads, dynamic_smem=launch.smem, static_smem=static,
        opt_in=launch.opt_in, c_config=c_config, violations=v)
    if attributes is not None:
        regs, top = attributes["registers"], attributes["max_threads_per_block"]
        rep.registers, rep.spill_bytes, rep.max_threads_per_block = \
            regs, attributes["spill_bytes"], top
        if launch.threads > top:
            v.append(VmemBudgetViolation(
                f"{tag}: a block of {launch.threads} threads over the {top} the compiled "
                f"instance takes ({regs} registers a thread)"))
        per_warp = math.ceil(regs * 32 / L["reg_alloc_per_warp"]) * L["reg_alloc_per_warp"]
        if per_warp * math.ceil(launch.threads / 32) > L["regs_per_sm"]:
            v.append(VmemBudgetViolation(
                f"{tag}: {regs} registers a thread x {launch.threads} threads over the "
                f"{L['regs_per_sm']} of a multiprocessor"))
        declared = next((d.bytes for d in spills if d.instance == launch.instance), 0)
        rep.declared_spill_bytes = declared
        if attributes["spill_bytes"] > declared:
            v.append(VmemBudgetViolation(
                f"{tag}: spills {attributes['spill_bytes']} bytes a thread to local memory"
                + (f", past the {declared} declared" if declared else
                   " (undeclared: DECLARED_SPILLS names a spill the timing shows pays)")))
    if c_config is not None:
        mine = {"instance": launch.instance, "threads": launch.threads, "smem": launch.smem,
                "grid": launch.grid[0]}
        theirs = {k: c_config[k] for k in mine}
        if mine != theirs:
            v.append(VmemBudgetViolation(
                f"{tag}: the declared launch {mine} differs from the C side's {theirs} "
                f"(threads, shared memory, grid)"))
    return rep


# ---------------------------------------------------------------------------
# the registered shapes: J2's, the LM paths', the pipeline's, and the edges
# ---------------------------------------------------------------------------
J2_R, J2_S, J2_P = 15_000_000, 60_000_000, 1 << 18
PIPE_U, PIPE_I, PIPE_F = 4_194_304, 1_048_576, 4_096


def _shapes():
    s = {}

    def add(kernel, label, **args):
        s.setdefault(kernel, []).append((label, args))

    for k in ("block_histograms", "partition_ranks"):
        add(k, "J2: S's first plan pass, 256 bins", n=J2_S, num_bins=256)
        add(k, "J2: the group-by's first pass, 257 bins", n=J2_S, num_bins=257)
        add(k, "J2: the join plan's last pass, 8 bins", n=J2_S, num_bins=8)
        for n in (4, 32):
            add(k, f"MoE routing: {n} digits, 60 bins", n=n, num_bins=60)
            add(k, f"MoE routing: {n} digits, 64 bins (60 experts in one 6-bit pass)",
                n=n, num_bins=64)
        add(k, "MoE train: 8,192 digits, 60 bins", n=8192, num_bins=60)
        add(k, "MoE train: 8,192 digits, 64 bins", n=8192, num_bins=64)
        add(k, "pipeline: U's plan (2^16 + 1), 4,194,304 digits, 257 bins", n=PIPE_U,
            num_bins=257)
        add(k, "pipeline: I's plan (2^14 + 1), 1,048,576 digits, 257 bins", n=PIPE_I,
            num_bins=257)
        add(k, "pipeline: I's plan's second pass, 65 bins", n=PIPE_I, num_bins=65)
        add(k, "pipeline: the fact side, 4,096 digits, 257 bins", n=PIPE_F, num_bins=257)
        add(k, "edge: 0 rows", n=0, num_bins=256)
        add(k, "edge: 1 row", n=1, num_bins=256)
        add(k, "edge: the most bins a pass takes, 1,024", n=J2_S, num_bins=_radix.MAX_BINS)
    add("partition_ranks", "edge: 204 bins (49,088 B, under the 48 KB opt-in)", n=J2_S,
        num_bins=204)
    add("partition_ranks", "edge: 205 bins (49,408 B, over the 48 KB opt-in)", n=J2_S,
        num_bins=205)
    add("block_histograms", "edge: digits off a 16-byte boundary", n=J2_S, num_bins=256, addr=4)
    add("block_histograms", "edge: tiles of 256 digits", n=J2_S, num_bins=256, tile=256)

    add("hash_probe", "J2: 60M probe rows, 2^18 partitions, blocks of 256", n_probe=J2_S,
        num_parts=J2_P, cap=256)
    add("hash_probe", "pipeline: 4,096 rows against U, 2^16 partitions", n_probe=PIPE_F,
        num_parts=1 << 16, cap=256)
    add("hash_probe", "pipeline: 4,096 rows against I, 2^14 partitions", n_probe=PIPE_F,
        num_parts=1 << 14, cap=256)
    add("hash_probe", "edge: blocks of 257 keys (the block's table)", n_probe=J2_S,
        num_parts=J2_P, cap=257)
    add("hash_probe", "edge: the widest block, 12,288 keys", n_probe=J2_S, num_parts=1 << 12,
        cap=_kprobe.MAX_BUILD_BLOCK)
    add("hash_probe", "edge: 0 rows", n_probe=0, num_parts=1, cap=256)
    add("hash_probe", "edge: 1 row, 1 partition", n_probe=1, num_parts=1, cap=256)

    add("clustered_gather", "J2: r1 through id_r, 60M of 15M int64", n=J2_S, n_src=J2_R,
        elem_bytes=8)
    add("clustered_gather", "pipeline: 4,096 rows of U's 4,194,304 float32", n=PIPE_F,
        n_src=PIPE_U, elem_bytes=4)
    for eb in (4, 8):
        add("clustered_gather", f"edge: {eb}-byte elements, indices off their vector boundary",
            n=J2_S, n_src=J2_R, elem_bytes=eb, idx_addr=4)
        add("clustered_gather", f"edge: {eb}-byte elements, output off a 16-byte boundary",
            n=J2_S, n_src=J2_R, elem_bytes=eb, out_addr=eb)
    add("clustered_gather", "edge: 0 rows", n=0, n_src=J2_R, elem_bytes=8)
    add("clustered_gather", "edge: 1 row", n=1, n_src=J2_R, elem_bytes=8)
    add("clustered_gather", "edge: no source row (zeros, no launch)", n=J2_S, n_src=0,
        elem_bytes=8)

    j2_blocks = ceil_div(J2_S, 256) + J2_P
    gj = dict(cap_r=256, cap_s=256, cb=1, cp=1, c=2)
    add("probe_agg", "J2: the group-join's padded layout, int32 group keys",
        num_blocks=j2_blocks, key_bytes=4, **gj)
    add("probe_agg", "edge: int64 group keys", num_blocks=j2_blocks, key_bytes=8, **gj)
    for kb in (4, 8):
        add("probe_agg", f"edge: sub-blocks of 1,024 rows against 1,024 keys, {kb}-byte "
            "group keys, 3 columns (past the 48 KB opt-in)", num_blocks=j2_blocks, cap_r=1024,
            cap_s=1024, cb=2, cp=1, c=3, key_bytes=kb)
    add("probe_agg", "edge: 0 sub-blocks", num_blocks=0, key_bytes=4, **gj)
    add("probe_agg", "edge: 1 sub-block of 1 row", num_blocks=1, cap_r=1, cap_s=1, cb=0, cp=0,
        c=0, key_bytes=4)

    add("segsum_partials", "J2: sort_pallas' s1 pass, 60M int32 keys", n=J2_S, key_bytes=4)
    add("segsum_partials", "edge: int64 keys", n=J2_S, key_bytes=8)
    add("segsum_partials", "edge: tiles of 1,024 rows", n=J2_S, key_bytes=4, tile=1024)
    add("segsum_partials", "edge: tiles of 1 row", n=J2_S, key_bytes=4, tile=1)
    add("segsum_partials", "edge: 0 rows", n=0, key_bytes=4)
    add("segsum_partials", "edge: 1 row", n=1, key_bytes=4)

    add("lower_bound", "J2: S's 60M sorted keys over R's", n_probe=J2_S, key_bytes=4)
    add("lower_bound", "J2: 100,000 sorted keys over R's (wide spans)", n_probe=100_000,
        key_bytes=4)
    add("lower_bound", "J2: S's keys over R's as int64", n_probe=J2_S, key_bytes=8)
    for kb in (4, 8):
        for n, per in ((540_672, 8), (540_671, 4), (270_335, 2), (135_167, 1)):
            add("lower_bound", f"edge: {n:,} {kb}-byte keys (tiles of {256 * per})",
                n_probe=n, key_bytes=kb)
    add("lower_bound", "edge: 0 rows", n_probe=0, key_bytes=4)
    add("lower_bound", "edge: 1 row", n_probe=1, key_bytes=4)

    add("histogram", "J2: S's first-pass digits, 256 bins", n=J2_S, num_bins=256)
    add("histogram", "J2: the join's full fan-out, 2^18 + 1 bins", n=J2_S, num_bins=J2_P + 1)
    add("histogram", "edge: the largest fan-out a plan asks, 2^20 + 1 bins", n=J2_S,
        num_bins=(1 << 20) + 1)
    add("histogram", f"edge: {_histogram.SMEM_BINS} bins (48 KB of counts)", n=J2_S,
        num_bins=_histogram.SMEM_BINS)
    add("histogram", f"edge: {_histogram.SMEM_BINS + 1} bins (device-memory counts)", n=J2_S,
        num_bins=_histogram.SMEM_BINS + 1)
    add("histogram", "edge: 1 bin", n=J2_S, num_bins=1)
    add("histogram", "edge: digits off a 16-byte boundary", n=J2_S, num_bins=256, addr=4)
    add("histogram", "edge: 0 rows", n=0, num_bins=256)
    add("histogram", "edge: 1 row", n=1, num_bins=256)

    add("partition_digits", "J2: S's 60M int32 join keys", n=J2_S, key_bytes=4)
    add("partition_digits", "served: a probe side's 2^26 int32 keys", n=1 << 26, key_bytes=4)
    add("partition_digits", "pipeline: U's 4,194,304 int32 keys", n=PIPE_U, key_bytes=4)
    add("partition_digits", "edge: int64 keys", n=J2_S, key_bytes=8)
    for kb in (4, 8):
        add("partition_digits", f"edge: {kb}-byte keys off a 16-byte boundary (row by row)",
            n=J2_S, key_bytes=kb, keys_addr=kb)
        add("partition_digits", f"edge: {kb}-byte keys and digits off a 16-byte boundary, "
            "on one after a head of 3", n=J2_S, key_bytes=kb, keys_addr=kb, out_addr=4)
    add("partition_digits", "edge: 3 rows (no whole vector)", n=3, key_bytes=4)
    add("partition_digits", "edge: 0 rows", n=0, key_bytes=4)
    add("partition_digits", "edge: 1 row", n=1, key_bytes=4)

    add("pass_scatter", "J2: S's plan passes, 60M rows", n=J2_S)
    add("pass_scatter", "served: a probe side's plan passes, 2^26 rows", n=1 << 26)
    add("pass_scatter", "MoE routing: 32 digits", n=32)
    add("pass_scatter", "MoE train: 8,192 digits", n=8192)
    add("pass_scatter", "pipeline: U's plan, 4,194,304 rows", n=PIPE_U)
    add("pass_scatter", "edge: 3 rows (no whole group)", n=3)
    add("pass_scatter", "edge: keys off a 16-byte boundary", n=J2_S, dig_addr=4)
    add("pass_scatter", "edge: 0 rows", n=0)
    add("pass_scatter", "edge: 1 row", n=1)
    return s


SHAPES = _shapes()


# ---------------------------------------------------------------------------
# the card: the C side's configurations and the compiled instances
# ---------------------------------------------------------------------------
def c_launch_config(kernel: str, args: dict, device: int = 0) -> dict:
    """What the launch of `kernel` with `args` would use, from the C side
    (its launch's own host helper); raises KernelError where it refuses."""
    out = (ctypes.c_longlong * len(CONFIG))()
    _build.checked(kernel, f"{kernel}_launch_config", *KERNELS[kernel].config(args),
                   ctypes.c_int(device), out)
    c = dict(zip(CONFIG, out))
    c["instance"] = KERNELS[kernel].instances[c["instance"]]
    return c


def func_attributes(kernel: str, device: int = 0) -> dict:
    """{instance: attributes} of every compiled instance of `kernel`
    (cudaFuncGetAttributes); raises where the library's table differs from
    record's instances."""
    instances = KERNELS[kernel].instances
    attrs = {}
    for i, inst in enumerate(instances):
        out = (ctypes.c_longlong * len(ATTRIBUTES))()
        _build.checked(kernel, f"{kernel}_func_attributes", i, device, out)
        got = _build.call(kernel, f"{kernel}_instance_name", i).decode()
        a = dict(zip(ATTRIBUTES, out))
        if got != inst or a["instances"] != len(instances):
            raise VmemBudgetViolation(
                f"{kernel}: the library's instance {i} is {got!r} of {a['instances']}; the "
                f"lint declares {inst!r} of {len(instances)}")
        attrs[inst] = a
    return attrs


# ---------------------------------------------------------------------------
# the determinism rule and scatter discipline: the sources as text
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AllowedAtomic:
    """An atomic the sources may use: its file, operation and target (the
    first argument, spaces removed), and why the result does not depend on
    the order in which the atomics land. `output`: it adds into (or places)
    a kernel output across blocks, the counterpart of
    `allow_output_revisit`. `index_use`: why its returned value may be used
    as an index; empty where it must not be."""
    source: str
    op: str
    target: str
    reason: str
    output: bool = False
    index_use: str = ""


_COUNTS = "integer counts commute: the bin's total is the same in any order"
_FIRST_WINS = ("the first-wins insert: the CAS only tells an empty slot from a taken one, "
               "and a key held twice keeps the least value by atomicMin, in any order")
_LEAST_DEST = "a bin's least destination in the chunk: a minimum commutes"
ALLOWED_ATOMICS = (
    AllowedAtomic("block_histograms.cu", "atomicAdd", "&hist[d]", _COUNTS),
    AllowedAtomic("histogram.cu", "atomicAdd", "&hist[d]", _COUNTS),
    AllowedAtomic("histogram.cu", "atomicAdd", "&out[b]",
                  "each block adds its integer counts into the one output: the sum is the "
                  "same in any order (declared accumulation)", output=True),
    AllowedAtomic("partition_ranks.cu", "atomicOr", "w+d",
                  "each lane sets its own bit of its digit's peer word: bits commute"),
    AllowedAtomic("hash_probe.cu", "atomicCAS", "&table[h]", _FIRST_WINS),
    AllowedAtomic("hash_probe.cu", "atomicMin", "&table[h]", _FIRST_WINS),
    AllowedAtomic("probe_agg.cu", "atomicCAS", "a", _FIRST_WINS),
    AllowedAtomic("probe_agg.cu", "atomicCAS", "reinterpret_cast<unsignedlonglong*>(a)",
                  _FIRST_WINS),
    AllowedAtomic("probe_agg.cu", "atomicMin", "&bidx[insert(bkey,hb_bits,k)]",
                  "the lowest build slot of a key: a minimum commutes"),
    AllowedAtomic("probe_agg.cu", "atomicMin", "&grep[gpos]",
                  "the lowest row of a group key: a minimum commutes"),
    AllowedAtomic("probe_agg.cu", "atomicOr", "&lanes[chunk*cap_s+slot]",
                  "each row sets its lane's bit in its slot's word: bits commute"),
    AllowedAtomic("probe_agg.cu", "atomicOr", "&chunk_words[slot]",
                  "each row sets its chunk's bit in its slot's word: bits commute"),
    AllowedAtomic("pass_scatter.cu", "atomicAdd", "&cnt[b]", _COUNTS),
    AllowedAtomic("pass_scatter.cu", "atomicAdd", "&cnt[b0]", _COUNTS),
    AllowedAtomic("pass_scatter.cu", "atomicMin", "&lo[b]", _LEAST_DEST),
    AllowedAtomic("pass_scatter.cu", "atomicMin", "&lo[b0]", _LEAST_DEST),
    AllowedAtomic("lower_bound.cu", "atomicMax", "&tile_hi",
                  "a tile's largest bound: a maximum commutes"),
    AllowedAtomic("segsum_partials.cu", "atomicAdd", "state",
                  "the chunk ticket hands out chunks in order; where a chunk's partials land "
                  "comes from the look-back's integer prefix, whichever block takes it",
                  index_use="a work ticket: the chunk a block takes next, never a row's slot"),
)

# operations whose result depends on the order they land in
ORDERED_OPS = ("atomicExch", "atomicInc", "atomicDec", "atomicSub")
FLOAT_TYPES = ("float", "double", "__half", "half", "__nv_bfloat16", "nv_bfloat16",
               "__half2", "__nv_bfloat162", "float2", "float4")

_ATOMIC = re.compile(r"\b(atomic[A-Z][A-Za-z]*)(?:_block|_system)?\s*\(")
_KEYWORDS = {"if", "for", "while", "switch", "return", "sizeof", "else"}


def _strip_comments(text: str) -> str:
    """The source with comments and string literals blanked, line breaks
    kept (so positions keep their line numbers)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\])*"', blank, text, flags=re.S)


def _call_args(text: str, open_paren: int) -> tuple[list[str], int]:
    """The top-level arguments of the call whose '(' is at open_paren, and
    the position after its ')'."""
    depth, args, start = 0, [], open_paren + 1
    for i in range(open_paren, len(text)):
        ch = text[i]
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
            if depth == 0:
                args.append(text[start:i])
                return [a.strip() for a in args], i + 1
        elif ch == "," and depth == 1:
            args.append(text[start:i])
            start = i + 1
    return [a.strip() for a in args], len(text)


def _statement_start(text: str, pos: int) -> int:
    return max(text.rfind(c, 0, pos) for c in ";{}") + 1


def _assigned_name(prefix: str) -> str | None:
    """The variable a statement prefix assigns to ('x =', 'T x =', 'x +='),
    or None."""
    m = re.search(r"([A-Za-z_]\w*)\s*(?:\[[^\]]*\])?\s*(?:[-+*/|&^]|<<|>>)?=(?!=)", prefix)
    if m and prefix[m.end() - 2:m.end()] not in ("==", "<=", ">=", "!="):
        return m.group(1)
    return None


def _enclosing_function(text: str, pos: int) -> str | None:
    """The name of the function whose body holds pos (the nearest header
    'name(...) {' before it), or None."""
    best = None
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*\(([^;{}]*?)\)\s*(?:const\s*)?\{", text[:pos]):
        if m.group(1) not in _KEYWORDS:
            best = m
    return best.group(1) if best else None


def _subscripted(text: str, names: set) -> bool:
    """Whether any of `names` appears inside a subscript [ ... ]."""
    for m in re.finditer(r"\[([^\[\]]*)\]", text):
        if set(re.findall(r"[A-Za-z_]\w*", m.group(1))) & names:
            return True
    return False


def _tainted(text: str, seeds: set) -> set:
    """`seeds` and every variable assigned from an expression that reads one
    of them, to a fixed point."""
    names = set(seeds)
    while True:
        grown = set(names)
        for stmt in re.split(r"[;{}]", text):
            lhs = _assigned_name(stmt)
            if lhs is None:
                continue
            rhs = stmt[stmt.index("=", stmt.index(lhs) + len(lhs)) + 1:]
            if set(re.findall(r"[A-Za-z_]\w*", rhs)) & names:
                grown.add(lhs)
        if grown == names:
            return names
        names = grown


def _is_float_target(text: str, target: str) -> bool:
    """Whether an atomic's target points at a floating type: a cast to one
    in the target itself, or its base variable declared with one."""
    types = "|".join(map(re.escape, FLOAT_TYPES))
    if re.search(rf"\b(?:{types})\s*\*", target):
        return True
    base = re.search(r"[A-Za-z_]\w*", re.sub(r"\w+_cast<[^>]*>", "", target))
    if not base:
        return False
    name = re.escape(base.group(0))
    decl = rf"\b(?:{types})\b[\w\s\*&]*?(?:__restrict__\s*)?\*?\s*{name}\s*[\[,;)=]"
    return re.search(decl, text) is not None


def lint_source(text: str, name: str, *, allowed=ALLOWED_ATOMICS) -> KernelLintReport:
    """The determinism rule and scatter discipline over one CUDA source
    (`text`, named `name` as `allowed` names its file)."""
    code = _strip_comments(text)
    entries = [a for a in allowed if a.source == name]
    sites = []
    aliases = {}  # helper function -> the atomic site it returns
    for m in _ATOMIC.finditer(code):
        args, end = _call_args(code, code.index("(", m.start()))
        target = re.sub(r"\s+", "", args[0] if args else "")
        stmt = code[_statement_start(code, m.start()):m.start()]
        site = {"op": m.group(1), "target": target, "line": code.count("\n", 0, m.start()) + 1,
                "pos": m.start(), "end": end, "prefix": stmt}
        sites.append(site)
        if re.search(r"\breturn\b", stmt):
            fn = _enclosing_function(code, m.start())
            if fn:
                aliases[fn] = site
    v = []
    output = floats = 0
    for site in sites:
        where = f"{name}:{site['line']} {site['op']}({site['target']})"
        entry = next((a for a in entries if a.op == site["op"] and a.target == site["target"]),
                     None)
        if entry is None:
            v.append(GridAliasViolation(
                f"{where}: an atomic the determinism rule does not declare; output slots come "
                f"from prefix-sum ranks (DESIGN.md §10), and an atomic must state why its "
                f"result does not depend on the order the atomics land in"))
        elif entry.output:
            output += 1
        if site["op"] in ORDERED_OPS and entry is None:
            v.append(GridAliasViolation(
                f"{where}: {site['op']} gives a result that depends on the order the "
                f"atomics land in"))
        if site["op"] == "atomicAdd" and _is_float_target(code, site["target"]):
            floats += 1
            v.append(FloatScatterViolation(
                f"{where}: a float atomicAdd accumulates in the order the atomics land; "
                f"sum runs in row order instead (DESIGN.md §2)"))
        if _index_use(code, site, aliases) and not (entry and entry.index_use):
            v.append(GridAliasViolation(
                f"{where}: its returned value is used as an index: a slot claimed by an "
                f"atomic lands where the scheduler puts it; take it from a prefix-sum rank"))
    return KernelLintReport(name=f"{name} (source)", grid=(), kernel=Path(name).stem,
                            instance="source", launched=False, atomics=len(sites),
                            output_atomics=output, float_atomic_adds=floats, violations=v)


def _index_use(code: str, site: dict, aliases: dict) -> bool:
    """Whether the atomic's returned value reaches a subscript: the call
    inside one, or a variable assigned from it (or from a helper that
    returns it), or from those, read inside one."""
    prefix = site["prefix"]
    if prefix.count("[") > prefix.count("]"):
        return True
    seeds = set()
    lhs = _assigned_name(prefix)
    if lhs and not re.search(r"\breturn\b", prefix):
        seeds.add(lhs)
    for fn, s in aliases.items():
        if s is site:
            for call in re.finditer(rf"\b{re.escape(fn)}\s*\(", code):
                before = code[_statement_start(code, call.start()):call.start()]
                if before.count("[") > before.count("]"):
                    return True
                if re.search(r"\)\s*\{", code[call.start():call.start() + 400].split(";")[0]):
                    continue  # the helper's own definition
                name = _assigned_name(before)
                if name:
                    seeds.add(name)
    return bool(seeds) and _subscripted(code[site["end"]:], _tainted(code, seeds))


def source_files(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


# ---------------------------------------------------------------------------
# the production sweep
# ---------------------------------------------------------------------------
def enforce(reports: list[KernelLintReport]) -> None:
    for rep in reports:
        if rep.violations:
            raise rep.violations[0]


def production_kernel_specs():
    """(kernel, shape label, args) for every registered shape of every
    kernel: J2's shapes, the MoE routing and train shapes, the pipeline's,
    and the edges (0 and 1 rows, each side of the 48 KB opt-in and of
    `histogram`'s SMEM_BINS, the largest fan-out a plan asks, every
    instance a launch can pick)."""
    return [(k, label, args) for k, shapes in SHAPES.items() for label, args in shapes]


def lint_production_kernels(device=None) -> list[KernelLintReport]:
    """Every kernel instance at every registered shape, and every source.
    With a CUDA `device`, also the C side's configuration at each shape
    (the declaration is evaluated with its sms and per_sm) and each compiled
    instance's attributes."""
    on_card = device is not None and str(device).startswith("cuda")
    ordinal = 0
    attrs = {}
    if on_card:
        import torch

        dev = torch.device(device)
        ordinal = dev.index if dev.index is not None else torch.cuda.current_device()
        for k in KERNELS:
            attrs.update(func_attributes(k, ordinal))
    reports = []
    for kernel, label, args in production_kernel_specs():
        c_cfg = None
        launch = declare(kernel, args)
        if launch is None:
            reports.append(KernelLintReport(name=f"{kernel} @ {label}", grid=(0, 1, 1),
                                            kernel=kernel, instance="none", shape=label,
                                            launched=False))
            continue
        if on_card:
            c_cfg = c_launch_config(kernel, args, ordinal)
            launch = declare(kernel, args, c_cfg["sms"], lambda *_: c_cfg["per_sm"])
        reports.append(lint_launch(launch, name=f"{launch.instance} @ {label}", shape=label,
                                   attributes=attrs.get(launch.instance), c_config=c_cfg))
    for path in source_files():
        reports.append(lint_source(path.read_text(), path.name))
    return reports


def instance_table(reports: list[KernelLintReport]) -> list[dict]:
    """One row per kernel instance: threads, dynamic shared memory at J2's
    shape (else at the instance's first registered shape, named), and on
    the card registers, spills and static shared memory."""
    rows = {}
    for r in reports:
        if not r.launched:
            continue
        row = rows.get(r.instance)
        if row is None or (not row["shape"].startswith("J2") and r.shape.startswith("J2")):
            rows[r.instance] = {"instance": r.instance, "threads": r.threads,
                                "dynamic_smem": r.dynamic_smem, "shape": r.shape,
                                "registers": r.registers, "spill_bytes": r.spill_bytes,
                                "declared_spill_bytes": r.declared_spill_bytes,
                                "static_smem": r.static_smem}
    order = [i for k in SHAPES for i in KERNELS[k].instances]
    return [rows[i] for i in order if i in rows]
