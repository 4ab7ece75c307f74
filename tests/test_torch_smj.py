"""Parity of the PyTorch port's sort-merge join, non-partitioned hash join
and join sequences with the JAX package, on the CPU.

One numpy dict per case, made from a seed, feeds both `repro.core.Table` and
`repro_torch.core.table_from_numpy(..., device="cpu")`. The JAX sort-merge
join runs its Pallas lower-bound kernel in interpret mode
(`find_impl="pallas"`); the port runs the kernel's plain version on the CPU.
Every join must agree row for row, keys, payloads and valid counts exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import nphj as jnphj  # noqa: E402
from repro.core import sort_merge as jsm  # noqa: E402
from repro.data import relgen as jrel  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import nphj as tnphj  # noqa: E402
from repro_torch.core import sort_merge as tsm  # noqa: E402
from repro_torch.data import relgen as trel  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

J2_SCALE = 1 / 4096  # 3,662 x 14,648 rows; cases below cut S to 5,000


def _jt(d):
    return J.Table({k: jnp.asarray(v) for k, v in d.items()})


def _tt(d):
    return T.table_from_numpy(d, device="cpu")


def _assert_equal(jres, tres):
    (jt, jc), (tt, tc) = jres, tres
    assert int(jc) == int(tc)
    assert tc.dtype == torch.int32
    assert jt.column_names == tt.column_names
    for name in jt.column_names:
        a, b = np.asarray(jt[name]), tt[name].numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _pk_fk_case(case):
    """(R, S, join kwargs) numpy dicts: J2's shape with 4-byte payloads."""
    n_r, n_s = int(15_000_000 * J2_SCALE), 5000
    kw = {}
    if case.startswith("match_ratio"):
        mr = float(case.split("_")[-1])
        R, S = trel.generate(trel.JoinWorkload("J2m", n_r, n_s, r_payloads=2, s_payloads=1,
                                               match_ratio=mr, seed=3))
    elif case == "zipf":
        R, S = trel.generate(trel.JoinWorkload("J2z", n_r, n_s, r_payloads=2, s_payloads=2,
                                               zipf=1.5, seed=4))
    else:
        R, S, _ = trel.generate_tpc("J2", scale=J2_SCALE, payload_bytes=4, seed=1)
        S = {k: v[:n_s] for k, v in S.items()}
        if case == "out_size_truncated":
            kw["out_size"] = 1234
        elif case == "sentinel_keys":
            S["k"][::5] = -1
            R["k"][::7] = -1
    return R, S, kw


PK_FK_CASES = ["match_ratio_1.0", "match_ratio_0.5", "match_ratio_0.0", "zipf",
               "out_size_truncated", "sentinel_keys"]


@pytest.mark.parametrize("pattern", ["gftr", "gfur"])
@pytest.mark.parametrize("case", PK_FK_CASES)
def test_smj_pk_fk_matches_jax_pallas_arm(case, pattern):
    R, S, kw = _pk_fk_case(case)
    jres = J.join(_jt(R), _jt(S), algorithm="smj", pattern=pattern, find_impl="pallas", **kw)
    tres = T.join(_tt(R), _tt(S), algorithm="smj", pattern=pattern, **kw)
    _assert_equal(jres, tres)
    if case == "match_ratio_0.0":
        assert int(tres[1]) == 0 and bool((tres[0]["k"] == -1).all())


def _mn_case(case):
    if case == "j5":
        R, S, mode = trel.generate_tpc("J5", scale=1 / 16384, payload_bytes=4, seed=2)
        assert mode == "mn"
        return R, S, {}
    rng = np.random.default_rng(8)
    # few distinct keys: long runs of duplicate build keys, some sentinels
    kr = rng.integers(-1, 40, 1500).astype(np.int32)
    ks = rng.integers(-1, 50, 2000).astype(np.int32)
    R = {"k": kr, "r1": rng.integers(0, 1 << 30, 1500).astype(np.int32)}
    S = {"k": ks, "s1": rng.integers(0, 1 << 30, 2000).astype(np.int32),
         "s2": rng.normal(size=2000).astype(np.float32)}
    return R, S, {"out_size": 40_000 if case == "duplicate_build_keys" else 5000}


@pytest.mark.parametrize("pattern", ["gftr", "gfur"])
@pytest.mark.parametrize("case", ["j5", "duplicate_build_keys", "out_size_truncated"])
def test_smj_mn_matches_jax(case, pattern):
    R, S, kw = _mn_case(case)
    jres = J.join(_jt(R), _jt(S), algorithm="smj", pattern=pattern, mode="mn", **kw)
    tres = T.join(_tt(R), _tt(S), algorithm="smj", pattern=pattern, mode="mn", **kw)
    _assert_equal(jres, tres)
    # the match total, from numpy's per-key counts, before truncation
    valid_r = R["k"][R["k"] >= 0]
    valid_s = S["k"][S["k"] >= 0]
    m = max(valid_r.max(), valid_s.max()) + 1
    total = int((np.bincount(valid_r, minlength=m) * np.bincount(valid_s, minlength=m)).sum())
    assert int(tres[1]) == min(total, kw.get("out_size", 2 * S["k"].shape[0]))


def test_merge_find_matches_jax():
    rng = np.random.default_rng(11)
    kr = np.sort(np.concatenate([rng.integers(0, 3000, 2000), [-1, -1]])).astype(np.int32)
    ks = np.sort(rng.integers(-1, 3500, 4000)).astype(np.int32)
    for a, b in zip(jsm.merge_find_pk_fk(jnp.asarray(kr), jnp.asarray(ks)),
                    tsm.merge_find_pk_fk(torch.from_numpy(kr), torch.from_numpy(ks))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jsm.merge_find_mn(jnp.asarray(kr), jnp.asarray(ks), 6000),
                    tsm.merge_find_mn(torch.from_numpy(kr), torch.from_numpy(ks), 6000)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_smj_find_arms_and_phases():
    """find_impl None and 'torch' give the same join on the CPU; phases
    are timed; 'cuda' on CPU tensors raises; an unknown mode raises."""
    R, S, _ = _pk_fk_case("match_ratio_1.0")
    times = {}
    a = T.join(_tt(R), _tt(S), algorithm="smj", phases=times)
    b = T.join(_tt(R), _tt(S), algorithm="smj", find_impl="torch")
    assert int(a[1]) == int(b[1]) == S["k"].shape[0]
    assert all(torch.equal(a[0][n], b[0][n]) for n in a[0].column_names)
    assert set(times) == {"transform", "find", "compact", "gathers"}
    assert all(t >= 0 for t in times.values())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        T.join(_tt(R), _tt(S), algorithm="smj", find_impl="cuda")
    with pytest.raises(ValueError, match="unknown mode"):
        T.join(_tt(R), _tt(S), algorithm="smj", mode="nm")


@pytest.mark.parametrize("algorithm", ["smj", "nphj"])
def test_empty_relations_join_to_nothing(algorithm):
    """The reference cannot take a zero-row relation (jnp.take from an empty
    axis); the port gives the empty join, as its PHJ does."""
    R, S, _ = _pk_fk_case("match_ratio_1.0")
    empty_r = {k: v[:0] for k, v in R.items()}
    t, c = T.join(_tt(empty_r), _tt(S), algorithm=algorithm)
    assert int(c) == 0 and t.num_rows == S["k"].shape[0]
    assert bool((t["k"] == -1).all()) and bool((t["r1"] == 0).all())
    t, c = T.join(_tt(R), _tt({k: v[:0] for k, v in S.items()}), algorithm=algorithm,
                  out_size=8)
    assert int(c) == 0 and t.num_rows == 8


# ---------------------------------------------------------------------------
# the non-partitioned hash join
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["match_ratio_1.0", "match_ratio_0.5", "zipf", "sentinel_keys",
                                  "out_size_truncated"])
def test_nphj_matches_jax(case):
    R, S, kw = _pk_fk_case(case)
    _assert_equal(J.join(_jt(R), _jt(S), algorithm="nphj", **kw),
                  T.join(_tt(R), _tt(S), algorithm="nphj", **kw))


@pytest.mark.parametrize("table_size,max_rounds", [(1 << 14, 16), (1 << 12, 3), (1 << 12, 1)])
def test_nphj_build_and_probe_match_jax(table_size, max_rounds):
    """The table, its failed count and the probe, including tables so full
    and rounds so few that insertions fail."""
    rng = np.random.default_rng(max_rounds)
    keys = rng.permutation(1 << 16)[:3500].astype(np.int32)
    probe = rng.integers(-1, 1 << 16, 5000).astype(np.int32)
    jb = jnphj.build_table(jnp.asarray(keys), table_size, max_rounds)
    tb = tnphj.build_table(torch.from_numpy(keys), table_size, max_rounds)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if max_rounds < 16:
        assert int(tb[2]) > 0
    jp = jnphj.probe_table(jb[0], jb[1], jnp.asarray(probe), max_rounds)
    tp = tnphj.probe_table(tb[0], tb[1], torch.from_numpy(probe), max_rounds)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("load_factor,max_rounds", [(0.25, 16), (1.0, 1)])
def test_nphj_join_reports_failed_inserts(load_factor, max_rounds):
    """nphj_join's stats give the size and failed count of the table the join
    built, equal to the JAX build_table's on that size; with a full table
    and one round, insertions fail and their probe rows miss, as in JAX."""
    R, S, _ = _pk_fk_case("match_ratio_1.0")
    kw = dict(algorithm="nphj", load_factor=load_factor, max_rounds=max_rounds)
    stats = {}
    tres = T.join(_tt(R), _tt(S), stats=stats, **kw)
    _assert_equal(J.join(_jt(R), _jt(S), **kw), tres)
    jfailed = jnphj.build_table(jnp.asarray(R["k"]), stats["table_size"], max_rounds)[2]
    assert int(stats["failed"]) == int(jfailed)
    assert (int(stats["failed"]) > 0) == (max_rounds == 1)
    slot_keys = tnphj.build_table(torch.from_numpy(R["k"]), stats["table_size"], max_rounds)[0]
    inserted = slot_keys[slot_keys != -1].numpy()
    assert int(tres[1]) == int(np.isin(S["k"], inserted).sum())


def test_nphj_rejects_mn_and_phj_mn_is_not_ported():
    R = _tt({"k": np.arange(4, dtype=np.int32)})
    with pytest.raises(ValueError, match="pk_fk only"):
        T.join(R, R, algorithm="nphj", mode="mn")
    # PHJ's m:n mode is ported: the self-join of four distinct keys
    _assert_equal(J.join(_jt({"k": np.arange(4, dtype=np.int32)}),
                         _jt({"k": np.arange(4, dtype=np.int32)}), algorithm="phj", mode="mn"),
                  T.join(R, R, algorithm="phj", mode="mn"))
    with pytest.raises(ValueError, match="unknown algorithm"):
        T.join(R, R, algorithm="hash")


# ---------------------------------------------------------------------------
# join sequences over a star schema
# ---------------------------------------------------------------------------
def test_generate_star_matches_jax():
    t = trel.generate_star(3000, 700, 3, payloads_per_dim=2, seed=5)
    j = jrel.generate_star(3000, 700, 3, payloads_per_dim=2, seed=5)
    assert t[2:] == j[2:]
    for td, jd in zip([t[0]] + t[1], [j[0]] + j[1]):
        assert list(td) == list(jd.column_names)
        for name in td:
            assert td[name].dtype == np.int32
            np.testing.assert_array_equal(td[name], np.asarray(jd[name]))


@pytest.mark.parametrize("restore_order", [False, True])
@pytest.mark.parametrize("algorithm,pattern", [("phj", "gftr"), ("phj", "gfur"),
                                               ("smj", "gftr"), ("smj", "gfur"),
                                               ("nphj", "gftr")])
def test_join_sequence_matches_jax(algorithm, pattern, restore_order):
    fact, dims, fks, dks = trel.generate_star(4000, 1000, 3, seed=6)
    kw = dict(fk_cols=fks, dim_keys=dks, algorithm=algorithm, pattern=pattern,
              restore_order=restore_order, keep_ids=restore_order)
    _assert_equal(J.join_sequence(_jt(fact), [_jt(d) for d in dims], **kw),
                  T.join_sequence(_tt(fact), [_tt(d) for d in dims], **kw))


def test_join_sequence_restored_order_matches_numpy():
    """With restore_order, row i is fact row i: its payload and each
    dimension's payload of its foreign key, for PHJ-OM and SMJ-OM alike."""
    fact, dims, fks, dks = trel.generate_star(5000, 1200, 4, seed=7)
    outs = [T.join_sequence(_tt(fact), [_tt(d) for d in dims], fk_cols=fks, dim_keys=dks,
                            algorithm=alg, restore_order=True) for alg in ("phj", "smj")]
    for t, c in outs:
        assert int(c) == 5000
        assert t.column_names == ("p3_0", "p2_0", "p1_0", "p0_0", "payload")
        np.testing.assert_array_equal(t["payload"].numpy(), fact["payload"])
        for i, fk in enumerate(fks):
            np.testing.assert_array_equal(t[f"p{i}_0"].numpy(),
                                          trel._payload(fact[fk], 7 * i, np.int32))
    assert all(torch.equal(outs[0][0][n], outs[1][0][n]) for n in outs[0][0].column_names)


