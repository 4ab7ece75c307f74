"""The launch-configuration lint of the port's Hopper kernels
(`repro_torch.analysis.kernel_lint`), on the CPU: the counterparts of
tests/test_analysis.py's three kernel-lint tests, held to those tests'
assertions (the JAX package's own fail on this container:
`BlockMapping.array_shape_dtype`), the scatter discipline, the declared
launches at J2's shapes against rows computed by hand, and the analysis
CLI's kernels section. What only the card can show (the C side's
configurations, registers, spills) is in tests/test_torch_cuda.py."""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.analysis import __main__ as analysis_cli  # noqa: E402
from repro_torch.analysis import kernel_lint as kl  # noqa: E402
from repro_torch.analysis.contracts import (FloatScatterViolation,  # noqa: E402
                                            GridAliasViolation, VmemBudgetViolation)

# a kernel that claims output slots with an atomic: where a row lands
# depends on the order the atomics land in
SLOT_CLAIM = """
__global__ void compact(const int* __restrict__ in, int n, int* __restrict__ out,
                        int* __restrict__ cursor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && in[i] > 0) {
    const int pos = atomicAdd(cursor, 1);  // claim a slot
    out[pos] = in[i];
  }
}
"""


@pytest.mark.parametrize("launch", [
    kl.Launch("big", "big", threads=256, smem=kl.LIMITS["smem_per_block"] + 1, grid=(4, 1, 1),
              opt_in=kl.LIMITS["smem_per_block"] + 1),
    kl.Launch("wide", "wide", threads=1025, smem=0, grid=(4, 1, 1)),
    kl.Launch("unraised", "unraised", threads=256, smem=64 * 1024, grid=(4, 1, 1)),
    kl.Launch("empty", "empty", threads=256, smem=0, grid=(0, 1, 1)),
], ids=["over-227KB", "over-1024-threads", "past-48KB-unraised", "empty-grid"])
def test_over_smem_or_threads_launch_trips_lint(launch):
    """test_over_vmem_block_spec_trips_lint's counterpart: a launch the card
    cannot take is a VmemBudgetViolation in its report, and enforce raises it."""
    reports = [kl.lint_launch(launch)]
    assert any(isinstance(v, VmemBudgetViolation) for r in reports for v in r.violations)
    with pytest.raises(VmemBudgetViolation):
        kl.enforce(reports)


def test_violation_messages_speak_of_shared_memory_and_threads():
    rep = kl.lint_launch(kl.Launch("k", "k", threads=2048, smem=300_000, grid=(1, 1, 1),
                                   opt_in=300_000))
    text = " ".join(map(str, rep.violations))
    assert "shared memory" in text and "threads" in text and "VMEM" not in text


def test_card_attributes_add_register_and_spill_checks():
    launch = kl.declare("probe_agg", dict(num_blocks=100, cap_r=256, cap_s=1024, cb=1, cp=1, c=2,
                                          key_bytes=4))
    ok = {"registers": 64, "spill_bytes": 0, "static_smem": 0, "max_threads_per_block": 1024}
    assert not kl.lint_launch(launch, attributes=ok).violations
    for bad in ({"registers": 72}, {"spill_bytes": 8}, {"max_threads_per_block": 512}):
        rep = kl.lint_launch(launch, attributes=ok | bad)
        assert [type(v) for v in rep.violations] == [VmemBudgetViolation], bad
    other = {"instance": launch.instance, "threads": launch.threads, "smem": launch.smem,
             "grid": launch.grid[0] + 1}
    assert kl.lint_launch(launch, c_config=other).violations


def test_spill_trips_lint_unless_declared():
    """A spill is a violation unless DECLARED_SPILLS names the instance, and
    a spill past the declared bytes is one all the same."""
    launch = kl.declare("probe_agg", dict(num_blocks=100, cap_r=256, cap_s=256, cb=1, cp=1, c=2,
                                          key_bytes=4))
    assert launch.instance == "probe_agg<4, 256, 8>"
    attrs = {"registers": 32, "static_smem": 0, "max_threads_per_block": 256}
    declared = kl.lint_launch(launch, attributes=attrs | {"spill_bytes": 8})
    assert not declared.violations and declared.declared_spill_bytes == 8
    for spill_bytes, spills in ((16, kl.DECLARED_SPILLS), (8, ())):
        rep = kl.lint_launch(launch, attributes=attrs | {"spill_bytes": spill_bytes},
                             spills=spills)
        assert [type(v) for v in rep.violations] == [VmemBudgetViolation], spill_bytes
        assert "spills" in str(rep.violations[0])
    # each declaration names an instance a launch can pick, and its timing
    instances = {i for k in kl.KERNELS for i in kl.INSTANCES[k]}
    for d in kl.DECLARED_SPILLS:
        assert d.instance in instances and d.bytes > 0
        assert "scripts/kernel_variants.py" in d.reason and " ms" in d.reason


def test_atomic_slot_claim_trips_lint_unless_declared():
    """test_aliased_grid_output_trips_lint_unless_declared's counterpart."""
    rep = kl.lint_source(SLOT_CLAIM, "compact.cu", allowed=())
    assert any(isinstance(v, GridAliasViolation) for v in rep.violations)
    with pytest.raises(GridAliasViolation):
        kl.enforce([rep])
    # the same kernel with its claim declared is a stated contract
    claim = kl.AllowedAtomic("compact.cu", "atomicAdd", "cursor", "a stated slot claim",
                             output=True, index_use="declared: the claimed slot")
    declared = kl.lint_source(SLOT_CLAIM, "compact.cu", allowed=(claim,))
    assert not declared.violations
    assert declared.output_atomics == 1


def test_registered_but_index_used_atomic_still_trips():
    """Declaring an atomic as commuting does not let its result pick a slot."""
    commuting = kl.AllowedAtomic("compact.cu", "atomicAdd", "cursor", "counts commute")
    rep = kl.lint_source(SLOT_CLAIM, "compact.cu", allowed=(commuting,))
    assert [type(v) for v in rep.violations] == [GridAliasViolation]
    nested = "__global__ void k(int* c, int* out) { out[atomicAdd(c, 1)] = 7; }"
    rep = kl.lint_source(nested, "nested.cu", allowed=(
        kl.AllowedAtomic("nested.cu", "atomicAdd", "c", "counts commute"),))
    assert [type(v) for v in rep.violations] == [GridAliasViolation]


@pytest.mark.parametrize("op", ["atomicExch", "atomicInc", "atomicDec", "atomicSub"])
def test_order_dependent_atomics_trip_unless_declared(op):
    src = f"__global__ void k(unsigned* a, unsigned v) {{ {op}(a, v); }}"
    rep = kl.lint_source(src, "ordered.cu", allowed=())
    assert len(rep.violations) == 2 and all(isinstance(v, GridAliasViolation)
                                            for v in rep.violations)
    declared = kl.lint_source(src, "ordered.cu", allowed=(
        kl.AllowedAtomic("ordered.cu", op, "a", "a stated order dependence"),))
    assert not declared.violations


@pytest.mark.parametrize("ctype", ["float", "double", "__half", "__nv_bfloat16"])
def test_float_atomic_add_trips_scatter_discipline(ctype):
    src = f"""
__global__ void scatter(const int* __restrict__ idx, const {ctype}* __restrict__ v, int n,
                        {ctype}* __restrict__ out) {{
  const int i = threadIdx.x;
  if (i < n) atomicAdd(&out[idx[i]], v[i]);
}}
"""
    allowed = (kl.AllowedAtomic("scatter.cu", "atomicAdd", "&out[idx[i]]", "declared"),)
    rep = kl.lint_source(src, "scatter.cu", allowed=allowed)
    assert rep.float_atomic_adds == 1
    assert [type(v) for v in rep.violations] == [FloatScatterViolation]
    cast = "__global__ void k(void* p) { atomicAdd(reinterpret_cast<float*>(p), 1.f); }"
    rep = kl.lint_source(cast, "cast.cu", allowed=(
        kl.AllowedAtomic("cast.cu", "atomicAdd", "reinterpret_cast<float*>(p)", "declared"),))
    assert [type(v) for v in rep.violations] == [FloatScatterViolation]


def test_comments_are_not_atomics():
    src = "// atomicExch(a, 1) in a comment\n/* atomicAdd(&f, 1.f) */\n__global__ void k() {}\n"
    rep = kl.lint_source(src, "quiet.cu", allowed=())
    assert rep.atomics == 0 and not rep.violations


def test_production_kernels_lint_clean():
    """test_production_kernels_lint_clean's counterpart: every registered
    shape of all nine kernels, every instance a launch can pick, every
    source; no violation, and histogram's declared accumulation counts."""
    reports = kl.lint_production_kernels()
    assert reports, "registry must cover the production kernels"
    for rep in reports:
        assert not rep.violations, (rep.name, rep.violations)
        assert rep.dynamic_smem + rep.static_smem <= kl.LIMITS["smem_per_block"]
    launched = [r for r in reports if r.launched]
    assert {r.kernel for r in launched} == set(kl.KERNELS) and len(kl.KERNELS) == 9
    assert {r.instance for r in launched} == {i for k in kl.KERNELS for i in kl.INSTANCES[k]}
    sources = {r.kernel: r for r in reports if r.instance == "source"}
    assert set(kl.KERNELS) <= set(sources)
    # histogram's accumulation into its one output is exercised AND declared
    hist = sources["histogram"]
    assert hist.output_atomics >= 1
    assert sum(r.output_atomics for r in sources.values()) == hist.output_atomics
    assert all(r.float_atomic_adds == 0 for r in sources.values())


def test_every_registered_atomic_is_in_the_sources():
    """No stale entry: each allowed atomic names a site that exists."""
    import re

    for a in kl.ALLOWED_ATOMICS:
        code = kl._strip_comments((kl.CSRC / a.source).read_text())
        targets = set()
        for m in re.finditer(rf"\b{a.op}\s*\(", code):
            args, _ = kl._call_args(code, m.end() - 1)
            targets.add(re.sub(r"\s+", "", args[0]))
        assert a.target in targets, a


def test_registered_shapes_cover_the_paths_and_edges():
    labels = {k: [label for label, _ in kl.SHAPES[k]] for k in kl.KERNELS}
    for k in kl.KERNELS:
        assert any(label.startswith("J2") for label in labels[k]), k
        assert any("0 rows" in label or "0 sub-blocks" in label for label in labels[k]), k
        assert any("1 row" in label for label in labels[k]), k
    for k in ("block_histograms", "partition_ranks"):
        assert any(label.startswith("MoE routing") for label in labels[k])
        assert any(label.startswith("MoE train") for label in labels[k])
        assert any(label.startswith("pipeline") for label in labels[k])
    sizes = [kl.declare("partition_ranks", a).smem for _, a in kl.SHAPES["partition_ranks"]
             if a["n"]]
    assert min(sizes) <= kl.LIMITS["smem_default_per_block"] < max(sizes)
    pers = {kl.declare("lower_bound", a).instance for _, a in kl.SHAPES["lower_bound"]
            if a["n_probe"]}
    assert pers == set(kl.INSTANCES["lower_bound"])


def test_declared_launches_at_j2_equal_hand_computed_rows():
    """J2 (15M x 60M, 2^18 partitions) on 132 SMs holding 3 blocks each:
    (instance, threads, dynamic shared memory, grid), worked out by hand
    from each .cu's host code."""
    n, fill = 60_000_000, 132 * 3
    tiles = -(-n // 1024)  # 58,594 tiles of 1,024 digits
    rows = {
        # 8 warps, 8 x 256 int32 counts; a block per 8 tiles: 7,325
        "block_histograms": (dict(n=n, num_bins=256),
                             ("block_histograms<true>", 256, 8 * 256 * 4, fill)),
        # 4 warps x 4 x (5 x 256 + 2 x 1,024) words; a block per 4 tiles
        "partition_ranks": (dict(n=n, num_bins=256),
                            ("partition_ranks", 128, 4 * 4 * (5 * 256 + 2 * 1024), fill)),
        # 8 warp tables of 2^9 8-byte entries; a block per 8 partitions
        "hash_probe": (dict(n_probe=n, num_parts=1 << 18, cap=256),
                       ("hash_probe<32>", 256, 8 * 512 * 8, fill)),
        # 8-byte rows, aligned: 234,375 warp steps, 29,297 blocks wanted
        "clustered_gather": (dict(n=n, n_src=15_000_000, elem_bytes=8),
                             ("clustered_gather<8, true>", 256, 0, fill)),
        # tables 512 + 2 x 512 + 512 + 8 x 256 + 3 x 256 + 2 x 256 words,
        # two halves of 3 x 256 words
        "probe_agg": (dict(num_blocks=-(-n // 256) + (1 << 18), cap_r=256, cap_s=256, cb=1,
                           cp=1, c=2, key_bytes=4),
                      ("probe_agg<4, 256, 8>", 256, 4 * (5120 + 2 * 768), fill)),
        # 4 buffers of 1,056 int32 keys and 6 of 1,056 floats
        "segsum_partials": (dict(n=n, key_bytes=4),
                            ("segsum_partials<4>", 96, 10 * 1056 * 4, fill)),
        # tiles of 2,048 keys: a 32 KB ring and two tiles
        "lower_bound": (dict(n_probe=n, key_bytes=4),
                        ("lower_bound<4, 8>", 256, 32 * 1024 + 2 * 2048 * 4, fill)),
        # 256 counts in shared memory; 15M vectors want 58,594 blocks, 8 an SM
        "histogram": (dict(n=n, num_bins=256), ("histogram<true>", 256, 1024, 132 * 8)),
        # chunks of 8,192 rows staged as 3 x 8,192 words, 3 x 260 counts,
        # least destinations and offsets, 32 warp sums and a flag; 7,325 chunks
        "pass_scatter": (dict(n=n), ("pass_scatter<true>", 1024, (3 * 8192 + 813) * 4, fill)),
    }
    assert tiles == 58_594
    for kernel, (args, want) in rows.items():
        got = kl.declare(kernel, args, 132, lambda *_: 3)
        assert (got.instance, got.threads, got.smem, got.grid) == want[:3] + ((want[3], 1, 1),), \
            kernel
    # a short column: the grid is the work's, not the card's
    assert kl.declare("block_histograms", dict(n=32, num_bins=60)).grid == (1, 1, 1)
    assert kl.declare("lower_bound", dict(n_probe=100_000, key_bytes=4), 132,
                      lambda *_: 3).grid == (391, 1, 1)
    assert kl.declare("histogram", dict(n=0, num_bins=256)) is None


def test_occupancy_estimate_follows_the_limits():
    assert kl.occupancy(256, 0) == 8  # 64 warps an SM
    assert kl.occupancy(96, 42_240) == 5  # 233,472 B / (42,240 + 1,024)
    assert kl.occupancy(1024, 0, registers=64) == 1
    assert kl.occupancy(256, 0, registers=32) == 8


def test_analysis_cli_writes_a_kernels_section(tmp_path, capsys):
    out = tmp_path / "ANALYSIS.json"
    assert analysis_cli.main(["--device", "cpu", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    kernels = rep["kernels"]
    assert len(kernels) == len(kl.production_kernel_specs()) + len(kl.source_files())
    assert all(not k["violations"] for k in kernels.values())
    assert rep["summary"]["violations"] == 0 and rep["operators"] and rep["engine"]
    hist = kernels["histogram.cu (source)"]
    assert hist["output_atomics"] == 1 and hist["registers"] is None
    assert "== kernels ==" in capsys.readouterr().out
