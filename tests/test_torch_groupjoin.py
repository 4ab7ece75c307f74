"""Parity of the port's fused group-join and sort-based group-bys with the JAX
package, on the CPU.

One numpy dict per case, made from a seed, feeds `repro.core.Table` and
`repro_torch.core.table_from_numpy(..., device="cpu")`. Keys, counts, valid
counts and integer aggregates must be equal; float32 sums and means agree to
SUM_TOL (the packages sum in another order: JAX scatters or multiplies
one-hot matrices, the port sums each run on its own). The kernel arm of the
group-join runs here with the probe_agg kernel's plain version in place of
the kernel (`fused_on_cpu`); tests/test_torch_cuda.py runs it on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import groupjoin as tgj  # noqa: E402
from repro_torch.data import relgen as trel  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# float32 sums of a few dozen values of magnitude < 2^31 (or N(0, 1)) in
# another order: a few ulp of the sum
SUM_TOL = dict(rtol=1e-5, atol=1e-3)
J2_SCALE = 1 / 4096  # 3,662 x 14,648 rows


def _jt(d):
    return J.Table({k: jnp.asarray(v) for k, v in d.items()})


def _tt(d):
    return T.table_from_numpy(d, device="cpu")


def _assert_close_tables(jt, jc, tt, tc):
    """Same columns, types and valid count; keys and integers equal, float
    columns to SUM_TOL."""
    assert int(jc) == int(tc)
    assert jt.column_names == tt.column_names
    for name in jt.column_names:
        a, b = np.asarray(jt[name]), tt[name].numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, err_msg=name, **SUM_TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Let probe_impl='cuda' run on CPU tensors: the arm's layout, combine
    and output assembly run as on the card, with the probe_agg kernel's
    plain version standing in for the kernel."""
    def resolve(impl, *tensors):
        return impl or "torch"

    monkeypatch.setattr(tgj, "resolve_impl", resolve)


# ---------------------------------------------------------------------------
# sort-based group-bys
# ---------------------------------------------------------------------------
def _groupby_input(seed, n=6000, domain=700):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, domain, n).astype(np.int32)
    k[::13] = -1  # sentinel padding rows are dropped
    return {"k": k,
            "vi": rng.integers(1 << 28, 1 << 30, n).astype(np.int32),  # sums wrap int32
            "vf": rng.normal(size=n).astype(np.float32),
            "vi2": rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32),
            "vf2": rng.normal(size=n).astype(np.float32),
            "vm": rng.normal(size=n).astype(np.float32),
            "vc": np.zeros(n, np.int32)}


@pytest.mark.parametrize("num_groups", [800, 300])
def test_groupby_sort_matches_jax(num_groups):
    """Every op, int32 sums wrapping, sentinel rows, and a capacity below the
    group count (the overflow groups are dropped alike)."""
    d = _groupby_input(num_groups)
    aggs = {"vi": "sum", "vf": "sum", "vi2": "max", "vf2": "min", "vm": "mean", "vc": "count"}
    jg, jc = J.group_aggregate(_jt(d), key="k", aggs=aggs, num_groups=num_groups,
                               strategy="sort")
    tg, tc = T.group_aggregate(_tt(d), key="k", aggs=aggs, num_groups=num_groups)  # default
    _assert_close_tables(jg, jc, tg, tc)


def test_groupby_sort_int64_sums_exact_and_empty_input():
    rng = np.random.default_rng(3)
    k = rng.integers(0, 500, 9000).astype(np.int32)
    v = rng.integers(-(1 << 62), 1 << 62, 9000)  # sums wrap int64, as numpy's do
    g, c = T.groupby_sort(_tt({"k": k, "v": v}), aggs={"v": "sum"}, num_groups=600)
    uk = np.unique(k)
    ref = np.zeros(uk.shape[0], np.int64)
    np.add.at(ref, np.searchsorted(uk, k), v)
    assert int(c) == uk.shape[0] and g["v_sum"].dtype == torch.int64
    np.testing.assert_array_equal(g["k"].numpy()[:int(c)], uk)
    np.testing.assert_array_equal(g["v_sum"].numpy()[:int(c)], ref)
    e = {"k": np.zeros(0, np.int32), "v": np.zeros(0, np.float32)}
    _assert_close_tables(*J.group_aggregate(_jt(e), aggs={"v": "sum"}, num_groups=4),
                         *T.group_aggregate(_tt(e), aggs={"v": "sum"}, num_groups=4))


@pytest.mark.parametrize("aggs", [{"vf": "sum"}, {"vm": "mean", "vi": "count"},
                                  {"vf": "sum", "vm": "mean", "vc": "count"}],
                         ids=["sum", "mean_count", "all"])
@pytest.mark.parametrize("num_groups", [800, 300])
def test_groupby_sort_pallas_matches_jax(aggs, num_groups):
    d = _groupby_input(7)
    jg, jc = J.group_aggregate(_jt(d), key="k", aggs=aggs, num_groups=num_groups,
                               strategy="sort_pallas")
    tg, tc = T.group_aggregate(_tt(d), key="k", aggs=aggs, num_groups=num_groups,
                               strategy="sort_pallas")
    _assert_close_tables(jg, jc, tg, tc)


def test_groupby_sort_pallas_hoists_count_pass(monkeypatch):
    """The count pass is key-only and the same for every column: it runs at
    most once, and not at all when no mean or count needs it (the pin of
    tests/test_groupby.py::test_sort_pallas_hoists_count_kernel)."""
    calls = []
    real = tops.groupby_sorted_sum

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tops, "groupby_sorted_sum", spy)
    t = _tt(_groupby_input(1, n=1000, domain=20))
    for aggs, want in (({"vf": "sum", "vm": "sum"}, 2), ({"vf": "mean", "vm": "mean"}, 3),
                       ({"vf": "count"}, 1)):
        calls.clear()
        T.group_aggregate(t, aggs=aggs, num_groups=64, strategy="sort_pallas")
        assert len(calls) == want, aggs


def test_sort_plan_matches_jax():
    from repro.core import primitives as jprim
    from repro_torch.core import primitives as tprim

    k = np.random.default_rng(0).integers(-1, 50, 3000).astype(np.int32)
    for a, b in zip(jprim.plan_sort_permutation(jnp.asarray(k)),
                    tprim.plan_sort_permutation(torch.from_numpy(k))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tprim.plan_sort_permutation(torch.from_numpy(k))[1].dtype == torch.int32


# ---------------------------------------------------------------------------
# the fused group-join
# ---------------------------------------------------------------------------
def _groupjoin_case(case):
    """(R, S, phj_groupjoin kwargs) for one parity case, 4-byte payloads."""
    if case == "match_ratio_0.5":
        R, S = trel.generate(trel.JoinWorkload("J2h", 3662, 14_648, r_payloads=2,
                                               s_payloads=1, match_ratio=0.5, seed=3))
        S["k"][::17] = -1  # sentinel probe rows
        return R, S, dict(group_key="k", num_groups=4000)
    R, S, _ = trel.generate_tpc("J2", scale=J2_SCALE, payload_bytes=4, seed=1)
    if case == "payload_group_key":  # group by a probe payload, few groups
        S["g"] = (S["s1"] % 97).astype(np.int32)
        return R, S, dict(group_key="g", num_groups=128)
    return R, S, dict(group_key="k", num_groups=R["k"].shape[0])  # Q18: by the join key


# float32 sums of int payloads below 2^31: int -> float32 rounds each value
# by up to 2^-24 relative, the sum adds as much per term
FLOAT_OF_INT_TOL = dict(rtol=2e-6, atol=0)


@pytest.mark.parametrize("case", ["j2", "match_ratio_0.5", "payload_group_key"])
def test_phj_groupjoin_fused_arm_matches_jax_pallas(case, fused_on_cpu):
    R, S, kw = _groupjoin_case(case)
    aggs = {"s1": "sum", "r1": "mean", "r2": "count"}
    jg, jc = J.phj_groupjoin(_jt(R), _jt(S), aggs=aggs, probe_impl="pallas", **kw)
    tg, tc = T.phj_groupjoin(_tt(R), _tt(S), aggs=aggs, probe_impl="cuda", **kw)
    assert int(jc) == int(tc)
    assert jg.column_names == tg.column_names
    for name in jg.column_names:
        a, b = np.asarray(jg[name]), tg[name].numpy()
        assert a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, err_msg=name, **FLOAT_OF_INT_TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("strategy", ["sort", "sort_pallas", "partition"])
@pytest.mark.parametrize("case", ["j2", "match_ratio_0.5", "payload_group_key"])
def test_phj_groupjoin_torch_arm_matches_jax_xla(case, strategy):
    """The torch arm (plain probe, then group_aggregate) against the JAX xla
    arm with the same strategy. min and max run here only."""
    R, S, kw = _groupjoin_case(case)
    if strategy == "sort_pallas":
        aggs = {"s1": "sum", "r1": "mean", "r2": "count"}
    else:
        aggs = {"s1": "sum", "r1": "max", "r2": "min", "k": "count"}
    jg, jc = J.phj_groupjoin(_jt(R), _jt(S), aggs=aggs, agg_strategy=strategy,
                             probe_impl="xla", **kw)
    tg, tc = T.phj_groupjoin(_tt(R), _tt(S), aggs=aggs, agg_strategy=strategy, **kw)  # CPU
    if strategy == "partition":  # rows come in (partition, key) order: compare by key
        order_j = np.argsort(np.asarray(jg[kw["group_key"]])[:int(jc)], kind="stable")
        order_t = np.argsort(tg[kw["group_key"]].numpy()[:int(tc)], kind="stable")
        assert int(jc) == int(tc)
        for name in jg.column_names:
            np.testing.assert_array_equal(np.asarray(jg[name])[:int(jc)][order_j],
                                          tg[name].numpy()[:int(tc)][order_t], err_msg=name)
        return
    if strategy == "sort_pallas":
        assert int(jc) == int(tc) and jg.column_names == tg.column_names
        for name in jg.column_names:
            a, b = np.asarray(jg[name]), tg[name].numpy()
            assert a.dtype == b.dtype
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, err_msg=name, **FLOAT_OF_INT_TOL)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
        return
    _assert_close_tables(jg, jc, tg, tc)


def test_phj_groupjoin_arms_agree_with_numpy(fused_on_cpu):
    """Q18's group by l_orderkey on both arms: per key, the count of S rows,
    the sum of s1 and the sum of the key's r1, against numpy in int64."""
    R, S, kw = _groupjoin_case("j2")
    aggs = {"s1": "sum", "r1": "sum", "r2": "count"}
    n_r = R["k"].shape[0]
    cnt = np.bincount(S["k"], minlength=n_r)
    s1 = np.zeros(n_r, np.int64)
    np.add.at(s1, S["k"], S["s1"].astype(np.int64))
    r1 = np.zeros(n_r, np.int64)
    r1[R["k"]] = R["r1"]
    for impl in ("cuda", "torch"):
        g, c = T.phj_groupjoin(_tt(R), _tt(S), aggs=aggs, probe_impl=impl, **kw)
        m = int(c)
        keys = g["k"].numpy()[:m]
        np.testing.assert_array_equal(keys, np.flatnonzero(cnt))
        np.testing.assert_array_equal(g["r2_count"].numpy()[:m], cnt[keys])
        want = {"s1_sum": s1[keys], "r1_sum": r1[keys] * cnt[keys]}
        for name, ref in want.items():
            got = g[name].numpy()[:m]
            if impl == "cuda":
                assert got.dtype == np.float32
                np.testing.assert_allclose(got, ref, err_msg=name, **FLOAT_OF_INT_TOL)
            else:  # int32 sums wrap as the payload type does
                np.testing.assert_array_equal(got, ref.astype(np.int32), err_msg=name)


@pytest.mark.parametrize("call,match", [
    (dict(group_key="r1", aggs={"s1": "sum"}), "probe-side column"),
    (dict(group_key="k", aggs={"s1": "median"}), "unknown agg op"),
    (dict(group_key="k", aggs={"zz": "sum"}), "neither relation"),
    (dict(group_key="k", aggs={"s1": "max"}, probe_impl="cuda"), "supports sum/mean/count"),
    (dict(group_key="k", aggs={"r1": "min"}, probe_impl="cuda"), "supports sum/mean/count"),
], ids=["build_side_group_key", "unknown_op", "unknown_column", "max_on_cuda", "min_on_cuda"])
def test_phj_groupjoin_rejects_what_jax_rejects(call, match, fused_on_cpu):
    """The same ValueErrors as the JAX package; min and max on the fused arm
    point to the torch arm instead of switching to it."""
    R, S, _ = trel.generate_tpc("J2", scale=1 / 16384, payload_bytes=4)
    jkw = dict(call, probe_impl="pallas") if "probe_impl" in call else call
    with pytest.raises(ValueError, match=match):
        J.phj_groupjoin(_jt(R), _jt(S), num_groups=64, **jkw)
    with pytest.raises(ValueError, match=match) as err:
        T.phj_groupjoin(_tt(R), _tt(S), num_groups=64, **call)
    assert "probe_impl" not in call or "use probe_impl='torch'" in str(err.value)


def test_phj_groupjoin_cuda_arm_needs_the_card():
    R, S, _ = trel.generate_tpc("J2", scale=1 / 16384, payload_bytes=4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        T.phj_groupjoin(_tt(R), _tt(S), group_key="k", aggs={"s1": "sum"}, num_groups=64,
                        probe_impl="cuda")


@pytest.mark.parametrize("strategy", ["sort", "scatter"])
def test_groupjoin_capacity_checks_match_jax(strategy):
    R, S, _ = _groupjoin_case("match_ratio_0.5")
    S["g"] = (S["s1"] % 300).astype(np.int32)
    for gkey in ("k", "g"):
        kw = dict(group_key=gkey, agg_strategy=strategy)
        want = J.groupjoin_required_groups(_jt(S), **kw)
        assert T.groupjoin_required_groups(_tt(S), **kw) == want
        for ng in (want - 1, want):
            jo = J.groupjoin_overflowed(_jt(R), _jt(S), num_groups=ng, **kw)
            to = T.groupjoin_overflowed(_tt(R), _tt(S), num_groups=ng, **kw)
            assert tuple(map(type, to)) == (bool, int, bool, int)
            assert to == (bool(jo[0]), jo[1], bool(jo[2]), jo[3])
    empty = {k: v[:0] for k, v in S.items()}
    assert T.groupjoin_required_groups(_tt(empty), group_key="g") == 0
