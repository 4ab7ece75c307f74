"""Parity of the port's m:n partitioned hash join and of its partition_hash
and scatter group-bys with the JAX package, on the CPU.

One numpy dict per case, made from a seed, feeds both `repro.core.Table` and
`repro_torch.core.table_from_numpy(..., device="cpu")`. The m:n joins must
agree row for row: keys, valid counts and every payload. The group-bys must
agree on keys, counts and integer results exactly, and on float32 sums and
means to rtol 1e-5 plus an atol of 2 * 256 * max|v| * eps(float32): both
packages sum a 256-row tile's partials and then the partials of a group, in
different orders, so each result may carry a few ulp of a tile's sum.
`choose_groupby_strategy` must give the same (strategy, rationale) pairs.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import hash_join as thj  # noqa: E402

F32_EPS = float(np.finfo(np.float32).eps)
# the reference's probe chunk (rows per compiled probe step; no effect on the
# result): the default 8,192 costs seconds of compilation per input shape
JCHUNK = dict(probe_chunk=1024)


def _jt(d):
    return J.Table({k: jnp.asarray(v) for k, v in d.items()})


def _tt(d):
    return T.table_from_numpy(d, device="cpu")


def _assert_join_equal(jres, tres):
    (jt, jc), (tt, tc) = jres, tres
    assert int(jc) == int(tc)
    assert tc.dtype == torch.int32
    assert jt.column_names == tt.column_names
    for name in jt.column_names:
        a, b = np.asarray(jt[name]), tt[name].numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


def oracle_rows(R, S):
    """Exact m:n inner join as a sorted list of (k, r0, s0) rows."""
    rmap = collections.defaultdict(list)
    for i, k in enumerate(R["k"]):
        rmap[int(k)].append(i)
    return sorted((int(k), int(R["r0"][i]), int(S["s0"][j]))
                  for j, k in enumerate(S["k"]) if k != -1 for i in rmap.get(int(k), ()))


# ---------------------------------------------------------------------------
# m:n PHJ
# ---------------------------------------------------------------------------
def _mn_case(case):
    """(R, S, join kwargs) numpy dicts with 4-byte payloads."""
    rng = np.random.default_rng(len(case))
    kw = {}
    # one shape for every case: the reference compiles each new one
    n_r, n_s, key_range = 400, 600, 100
    if case == "overflowing_block":  # 8 keys over 400 rows: blocks of 64 overflow
        key_range = 8
        kw["build_block"] = 64
    R = {"k": rng.integers(0, key_range, n_r).astype(np.int32),
         "r0": rng.integers(0, 1 << 20, n_r).astype(np.int32),
         "r1": rng.integers(0, 1 << 20, n_r).astype(np.int32)}
    S = {"k": rng.integers(0, key_range, n_s).astype(np.int32),
         "s0": rng.integers(0, 1 << 20, n_s).astype(np.int32)}
    if case == "zipf":
        S["k"] = ((rng.zipf(1.5, n_s) - 1) % key_range).astype(np.int32)
    total = int((np.bincount(R["k"][R["k"] >= 0], minlength=key_range)
                 * np.bincount(S["k"][S["k"] >= 0], minlength=key_range)).sum())
    if case == "out_size_truncated":
        kw["out_size"] = total // 3
    elif case == "sentinel_keys":
        S["k"][::5] = -1
        R["k"][::7] = -1
    elif case == "empty_build":
        R = {k: v[:0] for k, v in R.items()}
    elif case == "empty_probe":
        S = {k: v[:0] for k, v in S.items()}
    return R, S, kw


MN_CASES = ["duplicates", "overflowing_block", "out_size_truncated", "sentinel_keys",
            "empty_build", "empty_probe", "zipf"]
# the raw-key partitions (hash_keys=False) on the cases whose blocks fill
MN_RAW_KEY_CASES = ["duplicates", "overflowing_block", "sentinel_keys"]


@pytest.mark.parametrize("pattern", ["gftr", "gfur"])
@pytest.mark.parametrize("case,hash_keys", [(c, True) for c in MN_CASES]
                         + [(c, False) for c in MN_RAW_KEY_CASES])
def test_phj_mn_matches_jax(case, hash_keys, pattern):
    R, S, kw = _mn_case(case)
    jres = J.phj_join(_jt(R), _jt(S), mode="mn", pattern=pattern, hash_keys=hash_keys, **kw,
                      **JCHUNK)
    tres = T.join(_tt(R), _tt(S), algorithm="phj", mode="mn", pattern=pattern,
                  hash_keys=hash_keys, **kw)
    _assert_join_equal(jres, tres)


def test_phj_mn_overflowing_block_drops_matches_as_the_reference():
    """Only the first 64 rows of a build partition can match: the join holds
    fewer rows than the exact m:n join, the same ones in both packages."""
    R, S, kw = _mn_case("overflowing_block")
    assert T.phj_overflowed(_tt(R), build_block=64)[0]
    tt, tc = T.join(_tt(R), _tt(S), algorithm="phj", mode="mn", **kw)
    assert 0 < int(tc) < len(oracle_rows(R, S))


@pytest.mark.parametrize("pattern", ["gfur", "gftr"])
def test_phj_mn_with_duplicates_matches_the_oracle(pattern):
    """tests/test_joins.py's m:n case: duplicate build keys, out_size past
    the total; every algorithm and the python oracle agree."""
    rng = np.random.default_rng(0)
    n_r, n_s = 400, 600
    R = {"k": rng.integers(0, n_r // 4, n_r).astype(np.int32),
         "r0": rng.integers(0, 1 << 20, n_r).astype(np.int32)}
    S = {"k": rng.integers(0, n_r, n_s).astype(np.int32),
         "s0": rng.integers(0, 1 << 20, n_s).astype(np.int32)}
    expected = oracle_rows(R, S)
    kw = dict(mode="mn", pattern=pattern, out_size=len(expected) + 64)
    tres = T.join(_tt(R), _tt(S), algorithm="phj", **kw)
    _assert_join_equal(J.join(_jt(R), _jt(S), algorithm="phj", **kw, **JCHUNK), tres)
    tt, tc = tres
    got = sorted(zip(*[tt[c][:int(tc)].tolist() for c in ("k", "r0", "s0")]))
    assert int(tc) == len(expected) and got == expected
    assert bool((tt["k"][int(tc):] == T.KEY_SENTINEL).all())
    smj = T.join(_tt(R), _tt(S), algorithm="smj", **kw)
    assert sorted(zip(*[smj[0][c][:int(smj[1])].tolist() for c in ("k", "r0", "s0")])) == got


def test_phj_mn_default_out_size_and_phases():
    R, S, _ = _mn_case("duplicates")
    phases = {}
    tt, tc = T.join(_tt(R), _tt(S), algorithm="phj", mode="mn", phases=phases)
    assert tt.num_rows == 2 * len(S["k"])
    assert list(phases) == ["plans", "probe", "expand", "gathers"]
    with pytest.raises(ValueError, match="mode"):
        T.join(_tt(R), _tt(S), algorithm="phj", mode="m:n")


def test_mn_probe_matches_the_reference_block_comparison():
    """The sorted match index gives the counts and the k-th matches of the
    reference's block comparison (`probe_counts`, `probe_kth_match`)."""
    from repro.core import hash_join as jhj
    from repro.core import primitives as jprim

    R, S, _ = _mn_case("overflowing_block")
    S["k"][::9] = -1
    p_bits, cap = 4, 64
    P = 1 << p_bits
    dig_r = thj._digits(torch.from_numpy(R["k"]), p_bits, True)
    dig_s = thj._digits(torch.from_numpy(S["k"]), p_bits, True)
    perm_r, off_r, sz_r = T.primitives.plan_partition_permutation(dig_r, P + 1)
    perm_s, _, _ = T.primitives.plan_partition_permutation(dig_s, P + 1)
    kr, ks = torch.from_numpy(R["k"])[perm_r], torch.from_numpy(S["k"])[perm_s]
    bkeys, _, _ = jhj.build_blocks(jnp.asarray(kr.numpy()), jnp.asarray(off_r[:P].numpy()),
                                   jnp.asarray(sz_r[:P].numpy()), cap)
    dsp = jnp.asarray(dig_s[perm_s].numpy())
    want = np.asarray(jhj.probe_counts(bkeys, jnp.asarray(ks.numpy()), dsp))
    sk, pos = thj.match_index(kr, off_r, cap)
    counts, first = thj.probe_counts(sk, ks)
    np.testing.assert_array_equal(counts.numpy(), want)
    total = int(counts.sum())
    rows, ranks, _, _ = T.primitives.expand_offsets(counts, total)
    jrows, jranks, _, _ = jprim.expand_offsets(jnp.asarray(want), total)
    jvr = jhj.probe_kth_match(bkeys, jnp.asarray(off_r.numpy()), jnp.asarray(ks.numpy()), dsp,
                              jrows, jranks)
    vr = thj.probe_kth_match(pos, first, rows, ranks)
    np.testing.assert_array_equal(vr.numpy(), np.asarray(jvr))


# ---------------------------------------------------------------------------
# partition_hash and scatter group-bys
# ---------------------------------------------------------------------------
def _groupby_case(case, n=3000, key_range=400):
    rng = np.random.default_rng(len(case) + 7)
    k = rng.integers(0, key_range, n).astype(np.int32)
    if case == "zipf":  # groupby_bench's skew shape
        k = ((rng.zipf(1.5, n) - 1) % key_range).astype(np.int32)
    elif case == "sentinel_keys":
        k[::3] = -1
    elif case == "int64_keys":
        k = k.astype(np.int64)
    elif case == "one_key":
        k[:] = 5
    d = {"k": k, "v": rng.random(n).astype(np.float32),
         "w": rng.integers(-1000, 1000, n).astype(np.int32),
         "u": (rng.random(n) * 100 - 50).astype(np.float32),
         "x": rng.integers(0, 1 << 20, n).astype(np.int32)}
    if case == "empty":
        d = {c: a[:0] for c, a in d.items()}
    return d


GROUPBY_CASES = ["uniform", "zipf", "sentinel_keys", "int64_keys", "one_key", "empty",
                 "small_capacity"]
AGG_SETS = [{"v": "sum", "w": "count", "u": "mean", "x": "max"},
            {"v": "min", "w": "sum", "u": "max", "x": "mean"},
            {"v": "max", "w": "min", "u": "sum", "x": "count"}]


@pytest.mark.parametrize("strategy", ["partition_hash", "scatter"])
@pytest.mark.parametrize("case", GROUPBY_CASES)
def test_groupby_strategies_match_jax(strategy, case):
    d = _groupby_case(case)
    num_groups = 100 if case == "small_capacity" else 512
    atol = 2 * 256 * max(float(np.abs(d[c]).max(initial=0)) for c in "vwux") * F32_EPS
    for aggs in AGG_SETS:
        jt, jc = J.group_aggregate(_jt(d), key="k", aggs=aggs, num_groups=num_groups,
                                   strategy=strategy)
        tt, tc = T.group_aggregate(_tt(d), key="k", aggs=aggs, num_groups=num_groups,
                                   strategy=strategy)
        assert int(jc) == int(tc) and tc.dtype == torch.int32
        assert jt.column_names == tt.column_names
        for name in jt.column_names:
            a, b = np.asarray(jt[name]), tt[name].numpy()
            # the reference runs with x64 off: its int64 keys become int32
            want = np.int64 if case == "int64_keys" and name == "k" else a.dtype
            assert b.dtype == want, (aggs, name, a.dtype, b.dtype)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=atol, err_msg=f"{aggs} {name}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{aggs} {name}")


def test_partition_hash_is_bit_identical_from_run_to_run():
    d = _groupby_case("zipf", n=5000)
    a = T.groupby_partition_hash(_tt(d), aggs={"v": "sum", "w": "mean"}, num_groups=512)
    b = T.groupby_partition_hash(_tt(d), aggs={"v": "sum", "w": "mean"}, num_groups=512)
    assert int(a[1]) == int(b[1])
    assert all(torch.equal(a[0][c], b[0][c]) for c in a[0].column_names)


def test_scatter_rejects_float_keys_and_group_aggregate_takes_five_strategies():
    d = _groupby_case("uniform", n=300)
    df = dict(d, k=d["k"].astype(np.float32))
    with pytest.raises(TypeError, match="integer keys"):
        T.group_aggregate(_tt(df), key="k", aggs={"w": "sum"}, num_groups=512,
                          strategy="scatter")
    counts = []
    for strategy in ("sort", "partition", "partition_hash", "scatter", "sort_pallas"):
        t, c = T.group_aggregate(_tt(d), key="k", aggs={"w": "count"}, num_groups=512,
                                 strategy=strategy)
        order = np.argsort(t["k"][:int(c)].numpy())
        counts.append(t["w_count"][:int(c)].numpy()[order].astype(np.int64))
    assert all(np.array_equal(counts[0], x) for x in counts[1:])
    with pytest.raises(ValueError, match="strategy"):
        T.group_aggregate(_tt(d), key="k", aggs={"w": "sum"}, num_groups=512, strategy="hash")


@pytest.mark.parametrize("integer_key", [True, False])
def test_choose_groupby_strategy_matches_jax(integer_key):
    grid = [(n_rows, est, kmin, kmax, z)
            for n_rows in (1_000, 100_000, 60_000_000)
            for est in (1, 100, 4096, 50_000, 15_000_000)
            for kmin, kmax in ((None, None), (0, 255), (0, 4095), (0, 1 << 20), (-5, 100))
            for z in (0.0, 1.0, 1.5)]
    for n_rows, est, kmin, kmax, z in grid:
        kw = dict(key_min=kmin, key_max=kmax, zipf=z, integer_key=integer_key)
        assert (T.choose_groupby_strategy(n_rows, est, **kw)
                == J.choose_groupby_strategy(n_rows, est, **kw)), (n_rows, est, kw)
