"""Parity of the PyTorch port's operators with the JAX package, on the CPU.

One numpy dict per case, made from a seed, feeds both `repro.core.Table` and
`repro_torch.core.table_from_numpy(..., device="cpu")`; the JAX side runs
with its default arms. Joins and group-bys must agree row for row; integer
aggregates bit for bit (int32 sums wrap the same way), float32 sums to the
tolerance stated in `test_groupby_partition_matches_jax`.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import primitives as jprim  # noqa: E402
from repro.data import relgen as jrel  # noqa: E402
from repro_torch.core import primitives as tprim  # noqa: E402
from repro_torch.data import relgen as trel  # noqa: E402

J2_SCALE = 1 / 4096  # 3,662 x 14,648 rows


def _jt(d):
    return J.Table({k: jnp.asarray(v) for k, v in d.items()})


def _tt(d):
    return T.table_from_numpy(d, device="cpu")


def _assert_tables_equal(jt, jc, tt, tc):
    assert int(jc) == int(tc)
    assert jt.column_names == tt.column_names
    for name in jt.column_names:
        a, b = np.asarray(jt[name]), tt[name].numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# table contract
# ---------------------------------------------------------------------------
def test_table_from_numpy_defaults_to_the_card():
    assert inspect.signature(T.table_from_numpy).parameters["device"].default == "cuda"


def test_table_matches_jax_table():
    rng = np.random.default_rng(0)
    d = {"k": rng.integers(0, 100, 50).astype(np.int32),
         "v": rng.normal(size=50).astype(np.float32)}
    jt, tt = _jt(d), _tt(d)
    back = T.table_to_numpy(tt)
    assert list(back) == ["k", "v"] and all(np.array_equal(back[k], d[k]) for k in d)
    idx = np.array([3, -2, 0, 49, 77], np.int32)  # take clips, as the reference does
    pairs = [
        (jt.take(jnp.asarray(idx)), tt.take(torch.from_numpy(idx))),
        (jt.head(7), tt.head(7)),
        (jt.pad_to(60, fill=-1), tt.pad_to(60, fill=-1)),
        (jt.pad_to(10), tt.pad_to(10)),
        (jt.select(["v"]), tt.select(["v"])),
        (jt.drop(["v"]), tt.drop(["v"])),
        (jt.rename({"v": "w"}), tt.rename({"v": "w"})),
        (jt.with_columns(z=jt["k"] * 2), tt.with_columns(z=tt["k"] * 2)),
        (J.concat_tables([jt, jt.head(3)]), T.concat_tables([tt, tt.head(3)])),
    ]
    for a, b in pairs:
        _assert_tables_equal(a, 0, b, 0)
    assert tt.nbytes() == jt.nbytes() and tt.num_rows == 50 and "k" in tt
    with pytest.raises(ValueError, match="ragged"):
        T.Table({"a": torch.zeros(2), "b": torch.zeros(3)})


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def test_primitives_match_jax():
    rng = np.random.default_rng(1)
    n = 2000
    mask = rng.random(n) < 0.6
    a = rng.integers(0, 1 << 30, n).astype(np.int32)
    b = rng.normal(size=n).astype(np.float32)
    for cap in (n, 500):  # 500 drops the overhang
        (ja, jb), jc = jprim.compact(jnp.asarray(mask), [jnp.asarray(a), jnp.asarray(b)], cap,
                                     fill=-1)
        (ta, tb), tc = tprim.compact(torch.from_numpy(mask), [torch.from_numpy(a),
                                                              torch.from_numpy(b)], cap, fill=-1)
        assert int(jc) == int(tc) and tc.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    idx = rng.integers(-5, n + 5, 300).astype(np.int32)
    for fill in (None, 0, 7):
        np.testing.assert_array_equal(
            np.asarray(jprim.gather(jnp.asarray(a), jnp.asarray(idx), fill=fill)),
            tprim.gather(torch.from_numpy(a), torch.from_numpy(idx), fill=fill).numpy())
    counts = rng.integers(0, 4, 100).astype(np.int32)
    for x, y in zip(jprim.expand_offsets(jnp.asarray(counts), 300),
                    tprim.expand_offsets(torch.from_numpy(counts), 300)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    d = rng.integers(0, 17, n).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jprim.histogram(jnp.asarray(d), 17)),
                                  tprim.histogram(torch.from_numpy(d), 17).numpy())


# ---------------------------------------------------------------------------
# the join
# ---------------------------------------------------------------------------
def _join_case(case):
    """(R, S, join kwargs) numpy dicts for one parity case."""
    if case == "match_ratio_0.5":
        n_r, n_s = int(15_000_000 * J2_SCALE), int(60_000_000 * J2_SCALE)
        R, S = trel.generate(trel.JoinWorkload("J2h", n_r, n_s, r_payloads=3, s_payloads=1,
                                               match_ratio=0.5, seed=3))
        return R, S, {}
    R, S, _ = trel.generate_tpc("J2", scale=J2_SCALE, payload_bytes=4, seed=1)
    if case == "sentinel_keys_in_S":
        S["k"][::5] = -1
        return R, S, {}
    if case == "empty_R":
        return {k: v[:0] for k, v in R.items()}, S, {}
    if case == "512_partitions":
        return R, S, {"partition_bits": 9}
    return R, S, {}


@pytest.mark.parametrize("pattern", ["gftr", "gfur"])
@pytest.mark.parametrize("case", ["j2", "match_ratio_0.5", "sentinel_keys_in_S", "empty_R",
                                  "512_partitions"])
def test_phj_join_matches_jax(case, pattern):
    R, S, kw = _join_case(case)
    jt, jc = J.join(_jt(R), _jt(S), algorithm="phj", pattern=pattern, **kw)
    tt, tc = T.join(_tt(R), _tt(S), algorithm="phj", pattern=pattern, **kw)
    _assert_tables_equal(jt, jc, tt, tc)
    assert tc.dtype == torch.int32


def test_phj_join_phases_and_overflow_check():
    R, S, _ = trel.generate_tpc("J2", scale=J2_SCALE, payload_bytes=4)
    jover = J.phj_overflowed(_jt(R))
    assert T.phj_overflowed(_tt(R)) == (bool(jover[0]), jover[1])
    times = {}
    T.join(_tt(R), _tt(S), phases=times)
    assert set(times) == {"plans", "probe", "compact", "gathers"}
    assert all(t >= 0 for t in times.values())


# ---------------------------------------------------------------------------
# the partition group-by
# ---------------------------------------------------------------------------
AGGS = {"vi": "sum", "vf": "sum", "vi2": "max", "vf2": "min", "vm": "mean", "vi3": "count"}


@pytest.mark.parametrize("num_groups,partition_bits", [(5000, None), (1000, None), (5000, 4)])
def test_groupby_partition_matches_jax(num_groups, partition_bits):
    """int32 sums wrap identically; float32 sums differ only in rounding.
    Each run's float sum is a difference of two block-local prefix sums, so
    either package's error is up to a few ulp of a block prefix: the stated
    tolerance is rtol 1e-5 plus 2 * row_block * max|v| * eps(float32)."""
    rng = np.random.default_rng(num_groups)
    n = 14_648
    k = rng.integers(0, 4000, n).astype(np.int32)
    k[::11] = -1  # sentinel padding rows are dropped
    d = {"k": k,
         "vi": rng.integers(1 << 28, 1 << 30, n).astype(np.int32),  # sums wrap int32
         "vf": rng.normal(size=n).astype(np.float32),
         "vi2": rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32),
         "vf2": rng.normal(size=n).astype(np.float32),
         "vm": rng.normal(size=n).astype(np.float32),
         "vi3": np.zeros(n, np.int32)}
    d["vf2"][::50] = np.inf  # min's identity as a value: pad slots must not change it
    kw = {"partition_bits": partition_bits, "row_block": 1024} if partition_bits else {}
    jg, jc = J.group_aggregate(_jt(d), key="k", aggs=AGGS, num_groups=num_groups,
                               strategy="partition", **kw)
    tg, tc = T.group_aggregate(_tt(d), key="k", aggs=AGGS, num_groups=num_groups,
                               strategy="partition", **kw)
    assert int(jc) == int(tc)
    row_block = kw.get("row_block", 128)
    for name in jg.column_names:
        a, b = np.asarray(jg[name]), tg[name].numpy()
        assert a.dtype == b.dtype, name
        if a.dtype == np.float32 and name.endswith(("_sum", "_mean")):
            atol = 2 * row_block * np.abs(d[name.split("_")[0]]).max() * np.finfo(np.float32).eps
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_groupby_partition_int64_sums_exact():
    """The port keeps int64 payloads (the JAX package runs with 32-bit
    integers), so int64 sums are held against a numpy reference."""
    rng = np.random.default_rng(7)
    n = 20_000
    k = rng.integers(0, 3000, n).astype(np.int32)
    v = rng.integers(-(1 << 62), 1 << 62, n)  # sums wrap int64, as numpy's do
    g, c = T.group_aggregate(_tt({"k": k, "v": v}), key="k",
                             aggs={"v": "sum"}, num_groups=4000, strategy="partition")
    keys, sums = g["k"].numpy()[:int(c)], g["v_sum"].numpy()[:int(c)]
    uk = np.unique(k)
    ref = np.zeros(uk.shape[0], np.int64)
    np.add.at(ref, np.searchsorted(uk, k), v)
    order = np.argsort(keys)
    np.testing.assert_array_equal(keys[order], uk)
    np.testing.assert_array_equal(sums[order], ref)
    assert g["v_sum"].dtype == torch.int64


def test_j2_slice_end_to_end():
    """The slice as chip_smoke.py drives it: PHJ-OM join, then the partition
    group-by on the join key, against the JAX package and numpy."""
    R, S, _ = trel.generate_tpc("J2", scale=J2_SCALE, payload_bytes=4)
    aggs = {"s1": "sum", "r1": "max", "r2": "count"}
    ng = R["k"].shape[0]
    jt, jc = J.join(_jt(R), _jt(S), algorithm="phj", pattern="gftr")
    jg, jgc = J.group_aggregate(jt, key="k", aggs=aggs, num_groups=ng, strategy="partition")
    tt, tc = T.join(_tt(R), _tt(S), algorithm="phj", pattern="gftr")
    tg, tgc = T.group_aggregate(tt, key="k", aggs=aggs, num_groups=ng, strategy="partition")
    _assert_tables_equal(jt, jc, tt, tc)
    _assert_tables_equal(jg, jgc, tg, tgc)
    # numpy: per key, row count, sum of s1 (int32 wrap) and r1 of the key
    cnt = np.bincount(S["k"], minlength=ng)
    s1 = np.zeros(ng, np.int64)
    np.add.at(s1, S["k"], S["s1"].astype(np.int64))
    r1 = np.empty(ng, np.int32)
    r1[R["k"]] = R["r1"]
    g = T.table_to_numpy(tg)
    m = int(tgc)
    keys = g["k"][:m]
    assert m == int((cnt > 0).sum()) and np.array_equal(np.sort(keys), np.flatnonzero(cnt))
    np.testing.assert_array_equal(g["r2_count"][:m], cnt[keys])
    np.testing.assert_array_equal(g["s1_sum"][:m], s1[keys].astype(np.int32))
    np.testing.assert_array_equal(g["r1_max"][:m], r1[keys])


# ---------------------------------------------------------------------------
# data and what is not ported yet
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jid", ["J1", "J2", "J3", "J4", "J5"])
def test_relgen_tpc_matches_jax(jid):
    for pb in (4, 8):
        tR, tS, tmode = trel.generate_tpc(jid, scale=1 / 8192, payload_bytes=pb, seed=2)
        jR, jS, jmode = jrel.generate_tpc(jid, scale=1 / 8192, payload_bytes=pb, seed=2)
        assert tmode == jmode
        for t, j in ((tR, jR), (tS, jS)):
            assert list(t) == list(j.column_names)
            for name in t:
                # the JAX package holds 8-byte payloads as int32 (x64 off);
                # the values are below 2^31 either way
                assert t[name].dtype == np.dtype(f"int{8 * (4 if name == 'k' else pb)}")
                np.testing.assert_array_equal(t[name], np.asarray(j[name]))


def test_relgen_knobs_match_jax():
    w = dict(name="x", n_r=3000, n_s=9000, r_payloads=1, s_payloads=2, match_ratio=0.7,
             zipf=1.3, seed=5)
    tR, tS = trel.generate(trel.JoinWorkload(**w))
    jR, jS = jrel.generate(jrel.JoinWorkload(**w))
    for t, j in ((tR, jR), (tS, jS)):
        for name in t:
            np.testing.assert_array_equal(t[name], np.asarray(j[name]))


@pytest.mark.parametrize("call", [
    lambda P, R: P.join(R, R, mode="mn"),
    lambda P, R: P.group_aggregate(R, aggs={"k": "count"}, num_groups=4, strategy="scatter"),
    lambda P, R: P.group_aggregate(R, aggs={"k": "count"}, num_groups=4,
                                   strategy="partition_hash"),
], ids=["mn", "scatter", "partition_hash"])
def test_unported_paths_raise(call):
    """The paths that raised NotImplementedError before they were ported
    now run, and agree with the JAX package."""
    d = {"k": np.arange(4, dtype=np.int32)}
    _assert_tables_equal(*call(J, _jt(d)), *call(T, _tt(d)))
