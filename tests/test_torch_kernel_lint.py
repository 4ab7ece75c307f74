"""The launch-configuration lint of the port's Hopper kernels
(`repro_torch.analysis.kernel_lint`), on the CPU: the counterparts of
tests/test_analysis.py's three kernel-lint tests, held to those tests'
assertions (the JAX package's own fail on this container:
`BlockMapping.array_shape_dtype`), the scatter discipline, the declared
launches at J2's shapes against rows computed by hand, the analysis CLI's
kernels section, and the kernels' records (`kernels.common.register`),
which the build, the launch counter and the lint read. What only the card
can show (the C side's
configurations, registers, spills) is in tests/test_torch_cuda.py."""
import ctypes
import json
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.analysis import __main__ as analysis_cli  # noqa: E402
from repro_torch.analysis import kernel_lint as kl  # noqa: E402
from repro_torch.analysis.contracts import (FloatScatterViolation,  # noqa: E402
                                            GridAliasViolation, VmemBudgetViolation)
from repro_torch.kernels import _build, common, ops  # noqa: E402

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
    shape of all ten kernels, every instance a launch can pick, every
    source; no violation, and histogram's declared accumulation counts."""
    reports = kl.lint_production_kernels()
    assert reports, "registry must cover the production kernels"
    for rep in reports:
        assert not rep.violations, (rep.name, rep.violations)
        assert rep.dynamic_smem + rep.static_smem <= kl.LIMITS["smem_per_block"]
    launched = [r for r in reports if r.launched]
    assert {r.kernel for r in launched} == set(kl.KERNELS) and len(kl.KERNELS) == 10
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
        # int32 keys, aligned: 16 rows a thread, a block for every 4,096 rows
        "partition_digits": (dict(n=n, key_bytes=4),
                             ("partition_digits<4, true>", 256, 0, 14_649)),
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


@pytest.fixture
def throwaway():
    """A kernel declared for one test and removed after it."""
    def declare(a, sms, per_sm):
        inst = rec.instances[int(a["n"] > 1024)]
        fill = sms * per_sm(inst, 128, 50_000)
        return kl.Launch("throwaway", inst, 128, 50_000, (min(a["n"], fill), 1, 1),
                         opt_in=50_000)

    rec = common.register("throwaway", rows="n",
                          entries={"throwaway": (_build.PTR, _build.I64, _build.PTR, _build.I32)},
                          config=lambda a: (_build.I64(a["n"]),),
                          instances=("throwaway<small>", "throwaway<large>"),
                          static_smem={"throwaway<large>": 20_000})(declare)
    try:
        yield rec
    finally:
        del common.KERNELS["throwaway"], common.LAUNCHES["throwaway"]


def test_a_record_reaches_the_build_the_launch_counter_and_the_lint(throwaway):
    assert common.KERNELS["throwaway"] is throwaway and throwaway.declare is not None
    assert ops.launch_counts()["throwaway"] == 0
    with pytest.raises(ValueError, match="declared twice"):
        common.register("throwaway", rows="n", entries={}, config=tuple, instances=())(print)
    # the build types the library's entry points from the record
    entries = ("throwaway", "throwaway_func_attributes", "throwaway_instance_name",
               "kernel_error_string")
    lib = _build.bind(types.SimpleNamespace(**{fn: types.SimpleNamespace() for fn in entries}),
                      "throwaway")
    assert lib.throwaway.argtypes == (_build.PTR, _build.I64, _build.PTR, _build.I32)
    assert lib.throwaway.restype is ctypes.c_int
    assert lib.throwaway_func_attributes.argtypes == (_build.I32, _build.I32, _build.PTR)
    assert lib.throwaway_instance_name.restype is ctypes.c_char_p
    # the lint declares its launches, with its static shared memory
    assert kl.declare("throwaway", {"n": 0}) is None
    small, large = (kl.declare("throwaway", {"n": n}) for n in (100, 10_000))
    assert (small.instance, small.grid, large.instance) == \
        ("throwaway<small>", (100, 1, 1), "throwaway<large>")
    assert kl.static_smem("throwaway<large>") == 20_000 and kl.static_smem("throwaway<small>") == 0
    # 233,472 B an SM hold 3 blocks of 70,000 B (static and dynamic), 4 of 50,000
    assert large.grid == (kl.SMS * 3, 1, 1) and kl.occupancy(128, 50_000) == 4
    assert not kl.lint_launch(large).violations


@pytest.mark.parametrize("err", [0, 1, 700])
def test_launch_counts_only_what_returns_no_error(throwaway, monkeypatch, err):
    """`_build.launch` on a stub library: a zero error code counts one
    launch; any other raises KernelError naming the kernel and counts
    nothing. The stream and the card follow the call's own arguments."""
    calls = []

    def entry(*args):
        calls.append(args)
        return err

    lib = types.SimpleNamespace(throwaway=entry, kernel_error_string=lambda e: b"stub failure")
    monkeypatch.setitem(_build._libs, "throwaway", lib)
    monkeypatch.setattr(_build, "launch_on", lambda t: ("stream", "card"))
    if err:
        with pytest.raises(_build.KernelError, match=f"throwaway.*error {err} .stub failure"):
            _build.launch("throwaway", "throwaway", 1, 2, on=None)
    else:
        _build.launch("throwaway", "throwaway", 1, 2, on=None)
    assert calls == [(1, 2, "stream", "card")]
    assert common.LAUNCHES["throwaway"] == (0 if err else 1)


def test_every_source_has_one_record_and_every_record_its_shapes():
    """Each csrc/*.cu (the shared header aside) is one registered kernel,
    each kernel has its source and registered shapes, each shape names the
    record's rows argument, and each record's launch entry is its name."""
    sources = sorted(p.stem for p in kl.CSRC.glob("*.cu"))
    assert sources == sorted(common.KERNELS) == sorted(kl.SHAPES)
    assert [p.name for p in kl.CSRC.iterdir() if p.suffix != ".cu"] == ["common.cuh"]
    for name, rec in common.KERNELS.items():
        assert rec.name == name and name in rec.entries and rec.instances
        assert all(rec.rows in args for _, args in kl.SHAPES[name]), name
        assert set(rec.static_smem) <= set(rec.instances), name
