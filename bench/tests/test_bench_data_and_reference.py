"""The generator's determinism and recipe, the byte formulas, and the plain
references against the port's plain arms (its kernels' plain versions run
for CPU tensors) at a tiny size."""
import numpy as np
import pytest
import torch

from bench import check, datagen, loop, refops, roofline

from .conftest import tiny_parts

CONFIG_CELLS = ["q18-sf10.embedded", "star4-sf10.served4"]


def digest(tables):
    return {(t, c): v.clone() for t, cols in tables.items() for c, v in cols.items()}


@pytest.mark.parametrize("cell", CONFIG_CELLS)
def test_generator_is_a_function_of_the_seed(cell):
    cfg = tiny_parts(cell)["config"]
    a, b = digest(datagen.make_tables(cfg, 2**31 + 3, "cpu")), \
        digest(datagen.make_tables(cfg, 2**31 + 3, "cpu"))
    c = digest(datagen.make_tables(cfg, 5, "cpu"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)


def test_generator_recipe():
    cfg = tiny_parts("q18-sf10.embedded")["config"]
    t = datagen.make_tables(cfg, 123, "cpu")
    n = cfg["tables"]["orders"]["rows"]
    assert torch.equal(torch.sort(t["orders"]["k"]).values, torch.arange(n, dtype=torch.int32))
    li = t["lineitem"]["k"]
    assert li.dtype == torch.int32 and int(li.min()) >= 0 and int(li.max()) < n
    assert t["orders"]["r2"].dtype == torch.int64
    # the payload formula of the port's generator, in numpy
    from repro_torch.data.relgen import _payload

    for col, j in (("r1", 0), ("r3", 2)):
        want = _payload(t["orders"]["k"].numpy(), j, np.int64)
        assert np.array_equal(t["orders"][col].numpy(), want)
    assert np.array_equal(t["lineitem"]["s1"].numpy(),
                          _payload(li.numpy(), 100, np.int64))


def test_payload_refuses_a_wrapping_product():
    with pytest.raises(ValueError):
        datagen.payload(torch.tensor([2**40]), 0, torch.int64)


def test_byte_bounds_match_the_kernel_table():
    # PERF.md's kernel table at J2's shapes: 60M digits in 256 bins; r1 (15M
    # int64) through a 60M-row map
    ms = lambda b: round(roofline.bound_s(b) * 1e3, 3)  # noqa: E731
    assert ms(roofline.block_histograms_bytes(60_000_000, 256)) == 0.090
    assert ms(roofline.partition_ranks_bytes(60_000_000, 256)) == 0.161
    assert ms(roofline.clustered_gather_bytes(15_000_000, 60_000_000, 8)) == 0.251
    tables = {"t": {"a": torch.zeros(10, dtype=torch.int64), "b": torch.zeros(10)}}
    assert roofline.compulsory_bytes(tables, [("t", "a")], 7) == 87


def program_answer(parts, tables):
    from repro_torch.core.table import Table
    from repro_torch.engine import Catalog, executor, optimize, scan

    prog = {n: Table(dict(c)) for n, c in tables.items()}
    plan = optimize(parts["query"].plan(scan), Catalog(prog), measure_profile=False)
    with loop.keep_output(loop.group_node(plan.root)) as kept:
        answer = loop.fetch(executor.run(plan, prog))
    return answer, kept[-1]


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
@pytest.mark.parametrize("cell", CONFIG_CELLS)
def test_reference_agrees_with_the_ports_plain_arms(cell, seed):
    parts = tiny_parts(cell)
    q = parts["query"]
    tables = datagen.make_tables(parts["config"], seed, "cpu")
    ref = q.reference(tables)
    answer, groups = program_answer(parts, tables)
    numbers, right = q.judge([answer], groups, ref)
    assert right == [True] and check.within_limits(numbers, q.LIMITS), numbers


@pytest.mark.parametrize("cell", CONFIG_CELLS)
def test_a_narrower_sum_is_a_wrong_answer(cell):
    parts = tiny_parts(cell)
    q = parts["query"]
    tables = datagen.make_tables(parts["config"], 9, "cpu")
    ref = q.reference(tables)
    narrow_ref = q.reference(tables, torch.int32)
    narrow = refops.top_rows(narrow_ref, q.ORDER, q.LIMIT)
    narrow = {c: v.numpy() for c, v in narrow.items()}
    assert check.rows_wrong(narrow, ref, q.KEY, q.ORDER, q.LIMIT) > 0
    assert check.groups_wrong({c: v.numpy() for c, v in narrow_ref.items()}, ref, q.KEY) > 0


def test_rows_wrong_counts_each_fault():
    ref = {"k": torch.tensor([1, 2, 3, 4]), "s": torch.tensor([10, 40, 30, 40])}
    good = {"k": np.array([4, 2, 3]), "s": np.array([40, 40, 30])}
    assert check.rows_wrong(good, ref, "k", "s", 3) == 0
    tie = {"k": np.array([2, 4, 3]), "s": np.array([40, 40, 30])}
    assert check.rows_wrong(tie, ref, "k", "s", 3) == 0
    assert check.rows_wrong({"k": np.array([4, 2]), "s": np.array([40, 40])},
                            ref, "k", "s", 3) == 1
    assert check.rows_wrong({"k": np.array([4, 4, 3]), "s": np.array([40, 40, 30])},
                            ref, "k", "s", 3) == 1
    assert check.rows_wrong({"k": np.array([4, 2, 1]), "s": np.array([40, 40, 10])},
                            ref, "k", "s", 3) == 1
    assert check.rows_wrong({"k": np.array([4, 2, 3]), "s": np.array([40, 41, 30])},
                            ref, "k", "s", 3) == 1
    assert check.rows_wrong({"k": np.array([4, 2, 3])}, ref, "k", "s", 3) == 3
    groups = {c: v.numpy() for c, v in ref.items()}
    numbers, right = check.judge_exact([good, None, tie], groups, ref, "k", "s", 3)
    assert numbers == {"answers_missing": 1, "answers_wrong": 0, "rows_wrong_max": 0,
                       "groups_wrong": 0}
    assert right == [True, False, True]
    assert check.within_limits(numbers, {"answers_wrong": 0, "groups_wrong": 0})
    assert not check.within_limits(numbers, check.EXACT_LIMITS)
    assert not check.within_limits({}, {"groups_wrong": 0})


def test_groups_wrong_counts_each_fault():
    ref = {"k": torch.tensor([1, 2, 3, 4]), "s": torch.tensor([10, 40, 30, 40])}
    g = lambda k, s: {"k": np.array(k), "s": np.array(s)}  # noqa: E731
    assert check.groups_wrong(g([3, 1, 4, 2], [30, 10, 40, 40]), ref, "k") == 0
    assert check.groups_wrong(g([1, 2, 3], [10, 40, 30]), ref, "k") == 1  # one missing
    assert check.groups_wrong(g([1, 2, 3, 4, 5], [10, 40, 30, 40, 0]), ref, "k") == 1
    assert check.groups_wrong(g([1, 2, 3, 4], [10, 40, 31, 40]), ref, "k") == 2
    assert check.groups_wrong(g([1, 2, 3, 4, 4], [10, 40, 30, 40, 40]), ref, "k") == 1
    assert check.groups_wrong(None, ref, "k") == 4
    assert check.groups_wrong({"k": np.array([1, 2])}, ref, "k") == 6


def test_launch_bytes_are_captured_as_a_metric_file_declares(monkeypatch):
    import sys
    import types

    from repro_torch.kernels.common import LAUNCHES

    mod = types.ModuleType("fake_kernels")

    def kernel(x):
        if x.is_cuda or x.numel() > 2:  # stands in for a launch
            LAUNCHES["fake"] += 1
        return x

    mod.kernel = kernel
    monkeypatch.setitem(sys.modules, "fake_kernels", mod)
    monkeypatch.setitem(LAUNCHES, "fake", 0)
    with roofline.capture_launch_bytes(
            {"fake": ("fake_kernels", "kernel", lambda x: x.numel() * 8)}) as rec:
        mod.kernel(torch.zeros(5))
        mod.kernel(torch.zeros(1))  # launches nothing
        mod.kernel(torch.zeros(3))
    assert rec == {"fake": [40, 24]} and mod.kernel is kernel
    with pytest.raises(AttributeError):  # a wrapper renamed fails the run
        with roofline.capture_launch_bytes({"fake": ("fake_kernels", "gone", len)}):
            pass
    with pytest.raises(KeyError):  # so does a kernel the program does not count
        with roofline.capture_launch_bytes({"unknown": ("fake_kernels", "kernel", len)}):
            pass
    assert mod.kernel is kernel


def test_roofline_metrics_capture_the_partition_and_gather_wrappers():
    from bench import registry

    caps = {k: v[:2] for name in ("kernels.partition_roofline", "kernels.gather_roofline")
            for k, v in registry.load_metric(name).CAPTURE.items()}
    assert caps == {
        "block_histograms": ("repro_torch.kernels.radix_partition", "block_histograms"),
        "partition_ranks": ("repro_torch.kernels.radix_partition", "rank_with_base"),
        "clustered_gather": ("repro_torch.kernels.gather", "clustered_gather")}


# device operation names as the profiler gives them on the card (abridged)
INDEX_NAMES = [
    "void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<"
    "at::native::index_kernel_impl<at::native::OpaqueType<4> >(at::TensorIteratorBase&)",
    "void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<"
    "at::native::index_put_kernel_impl<at::native::OpaqueType<4> >(at::TensorIterator&)",
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::"
    "_cuda_scatter_gather_internal_kernel<true, long, long>::operator()<at::native::"
    "ReduceMaximum>(at::TensorIterator&, long, long, long, at::native::ReduceMaximum)",
    "void at::native::(anonymous namespace)::indexSelectLargeIndex<long, unsigned int, 2, 2, -2,"
    " true>(at::cuda::detail::TensorInfo<long, unsigned int>)",
    "void at::native::(anonymous namespace)::indexFuncLargeIndex<long, long, unsigned int, 1, 1,"
    " -2, true>(at::cuda::detail::TensorInfo<long, unsigned int>)",
]
OTHER_NAMES = [
    "void (anonymous namespace)::elementwise_kernel_with_index<int, at::native::arange_cuda_out("
    "c10::Scalar const&, c10::Scalar const&, c10::Scalar const&, at::Tensor&)",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::native::"
    "(anonymous namespace)::OpaqueType<4u>, unsigned int, 1, 128, 1, 16, 4>(char*, "
    "at::native::(anonymous namespace)::CatArrInputTensorMetadata)",
    "void clustered_gather_kernel<unsigned int, true>(unsigned int const*, int const*, long long,"
    " long long, int, unsigned int*)",
    "hash_probe_kernel<32>",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::"
    "TensorIteratorBase&)",
]


def test_index_kernels_are_named_one_by_one():
    from bench import registry

    metric = registry.load_metric("prim.index_ms")
    assert [metric.aten_index(n) for n in INDEX_NAMES] == [True] * len(INDEX_NAMES)
    assert [metric.aten_index(n) for n in OTHER_NAMES] == [False] * len(OTHER_NAMES)
