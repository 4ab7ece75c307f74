"""Parity of the port's planner, memory model and statistics with the JAX
package, on the CPU.

The same inputs go to both packages: `JoinStats` descriptors and one
explicit `PrimitiveProfile` for the decision trees and the cost model (the
chosen names must be equal, the predicted times equal to 1e-12 relative),
and numpy columns made from a seed for the statistics (every estimate must
be the same float: the optimizer sizes capacities from them). Columns hold
4-byte values, or int64 values inside int32's range: the JAX package runs
with x64 off, so it sees an int64 column as int32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import memmodel as jmem  # noqa: E402
from repro.core import planner as jplan  # noqa: E402
from repro.engine import stats as jstats  # noqa: E402
from repro_torch.core import memmodel as tmem  # noqa: E402
from repro_torch.core import planner as tplan  # noqa: E402
from repro_torch.data import relgen as trel  # noqa: E402
from repro_torch.engine import stats as tstats  # noqa: E402

# one explicit profile for both packages (neither package's defaults)
PROFILE = dict(seq_bw=2.1e11, sort_pass_bw=3.3e10, partition_pass_bw=5.7e10,
               unclustered_penalty=7.5, clustered_penalty=1.4)
JPROF, TPROF = jplan.PrimitiveProfile(**PROFILE), tplan.PrimitiveProfile(**PROFILE)
REL = 1e-12


def both(**kw):
    """The same JoinStats in each package."""
    return J.JoinStats(**kw), T.JoinStats(**kw)


def close(a, b):
    assert abs(a - b) <= REL * max(abs(a), abs(b)), (a, b)


def close_dict(a, b):
    assert a.keys() == b.keys()
    for k in a:
        close(a[k], b[k])


# the branches of tests/test_planner.py, and a few sizes around them
STATS = [
    dict(n_r=1000, n_s=1000, r_payload_cols=1, s_payload_cols=1, match_ratio=0.1),
    dict(n_r=1000, n_s=1000, r_payload_cols=1, s_payload_cols=1),
    dict(n_r=1000, n_s=1000, r_payload_cols=3, s_payload_cols=3, match_ratio=0.1),
    dict(n_r=1000, n_s=1000, r_payload_cols=3, s_payload_cols=3, zipf=1.5),
    dict(n_r=1000, n_s=1000, r_payload_cols=3, s_payload_cols=3, key_bytes=8),
    dict(n_r=1000, n_s=1000, r_payload_cols=3, s_payload_cols=3, payload_bytes=8),
    dict(n_r=1000, n_s=1000, r_payload_cols=3, s_payload_cols=3),
    dict(n_r=15_000_000, n_s=60_000_000, r_payload_cols=3, s_payload_cols=1,
         payload_bytes=8),
    dict(n_r=1 << 18, n_s=1 << 18, r_payload_cols=3, s_payload_cols=3, match_ratio=0.3),
]


@pytest.mark.parametrize("kw", STATS, ids=range(len(STATS)))
def test_decision_trees_match_jax(kw):
    js, ts = both(**kw)
    assert ts.wide == js.wide
    assert tplan.choose_algorithm(ts) == jplan.choose_algorithm(js)
    assert tplan.choose_smj_pattern(ts) == jplan.choose_smj_pattern(js)


@pytest.mark.parametrize("kw", STATS, ids=range(len(STATS)))
@pytest.mark.parametrize("algorithm,pattern", [("phj", "gftr"), ("phj", "gfur"),
                                               ("smj", "gftr"), ("smj", "gfur"),
                                               ("nphj", "gftr")])
def test_predict_join_time_matches_jax(kw, algorithm, pattern):
    js, ts = both(**kw)
    for bits in (8, 16, 18):
        close_dict(jplan.predict_join_time(js, algorithm, pattern, JPROF, partition_bits=bits),
                   tplan.predict_join_time(ts, algorithm, pattern, TPROF, partition_bits=bits))


@pytest.mark.parametrize("strategy", ["sort", "sort_pallas", "partition", "partition_hash",
                                      "scatter"])
def test_predict_groupby_time_matches_jax(strategy):
    for n, aggs, kb, vb, rb in ((1 << 18, 2, 4, 4, None), (1 << 20, 3, 8, 4, None),
                                (60_000_000, 3, 4, 8, 1024), (1000, 1, 4, 4, 256),
                                (1, 0, 4, 4, None)):
        close(jplan.predict_groupby_time(n, aggs, strategy, JPROF, key_bytes=kb, val_bytes=vb,
                                         row_block=rb),
              tplan.predict_groupby_time(n, aggs, strategy, TPROF, key_bytes=kb, val_bytes=vb,
                                         row_block=rb))
    with pytest.raises(ValueError):
        tplan.predict_groupby_time(1000, 1, "nope")


@pytest.mark.parametrize("kw", STATS[::2], ids=range(len(STATS[::2])))
@pytest.mark.parametrize("strategy", ["sort", "partition", "partition_hash", "scatter"])
def test_predict_groupjoin_time_matches_jax(kw, strategy):
    js, ts = both(**kw)
    for carried, build_aggs, rb in ((False, 0, None), (True, 1, None), (True, 2, 1024)):
        close_dict(jplan.predict_groupjoin_time(js, 3, strategy, JPROF, group_key_carried=carried,
                                                build_aggs=build_aggs, agg_row_block=rb),
                   tplan.predict_groupjoin_time(ts, 3, strategy, TPROF, group_key_carried=carried,
                                                build_aggs=build_aggs, agg_row_block=rb))


# tests/test_planner.py's chooser cases, and the density and skew edges
GROUPBY_CASES = [
    dict(n_rows=100_000, est_groups=1000, key_min=0, key_max=1023),
    dict(n_rows=100_000, est_groups=50_000, zipf=1.5),
    dict(n_rows=100_000, est_groups=1000, key_min=-5, key_max=1 << 30),
    dict(n_rows=100_000, est_groups=60_000, key_min=0, key_max=1 << 30),
    dict(n_rows=100_000, est_groups=60_000, key_min=0.0, key_max=1e9, integer_key=False),
    dict(n_rows=60_000_000, est_groups=14_724_964, key_min=0, key_max=14_999_999),
    dict(n_rows=10, est_groups=2, key_min=0, key_max=(1 << 18) - 1),
]


@pytest.mark.parametrize("kw", GROUPBY_CASES, ids=range(len(GROUPBY_CASES)))
def test_choose_groupby_strategy_matches_jax(kw):
    kw = dict(kw)
    n, g = kw.pop("n_rows"), kw.pop("est_groups")
    assert T.choose_groupby_strategy(n, g, **kw) == J.choose_groupby_strategy(n, g, **kw)


@pytest.mark.parametrize("mt", [0.5, 1.0, 1.5, 2.0, 4.0])
def test_memory_model_matches_jax(mt):
    for mc in (1.0, 3.0):
        assert [dataclasses.astuple(r) for r in tmem.gfur_ledger(mt, mc)] == \
            [dataclasses.astuple(r) for r in jmem.gfur_ledger(mt, mc)]
        assert [dataclasses.astuple(r) for r in tmem.gftr_ledger(mt, mc)] == \
            [dataclasses.astuple(r) for r in jmem.gftr_ledger(mt, mc)]
        for p in ("gftr", "gfur"):
            assert tmem.peak_memory(p, mt, mc) == jmem.peak_memory(p, mt, mc)
    for p in ("gftr", "gfur"):
        for n, item, mtb in ((5888, 4, None), (60_000_000, 8, None), (1000, 4, 123.0)):
            assert (tmem.peak_memory_bytes(p, n, item, mtb)
                    == jmem.peak_memory_bytes(p, n, item, mtb))
    # the paper's conclusion holds in the port's copy too
    assert tmem.peak_memory("gftr", mt=mt) <= tmem.peak_memory("gfur", mt=mt)


def test_profile_measure_on_the_cpu():
    """measure() times the same five programs on the device it is given
    (the partition plan's sort arm here) and backs out finite, physical
    constants."""
    prof = tplan.PrimitiveProfile.measure(n=1 << 12, iters=1, warmup=1, device="cpu")
    for f in dataclasses.fields(prof):
        v = getattr(prof, f.name)
        assert np.isfinite(v) and v > 0, (f.name, v)
    assert prof.unclustered_penalty >= prof.clustered_penalty >= 1.0
    t = tplan.predict_join_time(T.JoinStats(1 << 16, 1 << 17, 2, 2), "phj", "gftr", prof)
    assert np.isfinite(t["total"]) and t["total"] > 0
    # the defaults are a card's measurement, not another device's constants
    default = tplan.PrimitiveProfile()
    assert dataclasses.astuple(default) != dataclasses.astuple(jplan.PrimitiveProfile())
    assert default.unclustered_penalty >= default.clustered_penalty >= 1.0


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------
def _columns():
    """Named numpy columns, seeded: unique, duplicated, skewed, sparse,
    float and negative keys, a short column and an empty one."""
    rng = np.random.default_rng(7)
    R, S = trel.generate(trel.JoinWorkload("m", 30_000, 60_000, 1, 1, match_ratio=0.5, seed=2))
    _, Sz = trel.generate(trel.JoinWorkload("z", 30_000, 60_000, 1, 1, zipf=1.5, seed=3))
    return {
        "unique_int32": R["k"],
        "probe_int32": S["k"],
        "dup_int32": rng.integers(0, 500, 50_000).astype(np.int32),
        "zipf_int32": Sz["k"],
        "sparse_int64": rng.integers(0, 1 << 31, 20_000).astype(np.int64),
        "negative_int32": rng.integers(-1000, 1000, 9_000).astype(np.int32),
        "float32": rng.random(20_000).astype(np.float32),
        "coarse_float32": (rng.integers(0, 500, 20_000) / 50.0).astype(np.float32),
        "short_int32": rng.integers(0, 10, 100).astype(np.int32),
        "empty_int32": np.zeros(0, np.int32),
    }


COLUMNS = _columns()


def _pair(name):
    a = COLUMNS[name]
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_column_estimates_are_the_same_floats(name):
    jc, tc = _pair(name)
    assert tstats.estimate_distinct(tc) == jstats.estimate_distinct(jc)
    if tc.numel() == 0:
        return
    for m, seed in ((4096, 0), (100, 3), (1 << 20, 0)):
        np.testing.assert_array_equal(tstats.sample_column(tc, m, seed).numpy(),
                                      np.asarray(jstats.sample_column(jc, m, seed)))
    assert tstats.estimate_zipf(tc) == jstats.estimate_zipf(jc)
    assert tstats.estimate_zipf(tc, 500, 1) == jstats.estimate_zipf(jc, 500, 1)
    for op, value in (("<", 250), (">=", 0.5), ("==", 3), ("!=", 3)):
        assert (tstats.estimate_selectivity(tc, op, value)
                == jstats.estimate_selectivity(jc, op, value))
    js, ts = jstats.collect_column_stats(jc), tstats.collect_column_stats(tc)
    assert dataclasses.astuple(ts) == dataclasses.astuple(js)


@pytest.mark.parametrize("build,probe", [("unique_int32", "probe_int32"),
                                         ("dup_int32", "short_int32"),
                                         ("unique_int32", "zipf_int32"),
                                         ("sparse_int64", "unique_int32"),
                                         ("negative_int32", "dup_int32")])
def test_match_ratio_is_the_same_float(build, probe):
    (jb, tb), (jp, tp) = _pair(build), _pair(probe)
    for m, seed in ((4096, 0), (512, 5)):
        assert (tstats.estimate_match_ratio(tb, tp, m, seed)
                == jstats.estimate_match_ratio(jb, jp, m, seed))


def test_synthesize_join_stats_matches_jax():
    for key, payloads in (("int32", ["int32", "int64"]), ("int64", []), ("int32", ["float32"]),
                          ("int32", [])):
        kw = dict(n_build=100, n_probe=200.7, build_payload_cols=2, probe_payload_cols=1,
                  match_ratio=0.5, zipf=1.2)
        js = jstats.synthesize_join_stats(key_dtype=np.dtype(key),
                                          payload_dtypes=[np.dtype(d) for d in payloads], **kw)
        ts = tstats.synthesize_join_stats(key_dtype=getattr(torch, key),
                                          payload_dtypes=[getattr(torch, d) for d in payloads],
                                          **kw)
        assert dataclasses.astuple(ts) == dataclasses.astuple(js)


def test_catalog_estimates_are_the_same_floats():
    """The Catalog's memoized estimates over base columns: joint filter
    selectivity, match ratio under pushed-down predicates, exact maximum
    multiplicity, exact m:n output rows and exact uniqueness."""
    rng = np.random.default_rng(11)
    a = {"k": np.concatenate([np.arange(1, 9001), np.zeros(1000)]).astype(np.int32),
         "f": rng.integers(0, 10, 10_000).astype(np.int32),
         "v": rng.random(10_000).astype(np.float32)}
    b = {"k": rng.integers(0, 3000, 5000).astype(np.int32),
         "g": rng.integers(0, 4, 5000).astype(np.int32)}
    jc = jstats.Catalog({n: J.Table({c: jnp.asarray(v) for c, v in t.items()})
                         for n, t in (("A", a), ("B", b))})
    tc = tstats.Catalog({n: T.table_from_numpy(t, device="cpu") for n, t in (("A", a), ("B", b))})
    preds = [(), (("f", "<", 3),), (("f", "<", 3), ("v", ">=", 0.25)), (("k", "==", 0),)]
    for p in preds:
        assert tc.selectivity("A", p) == jc.selectivity("A", p)
        assert tc.max_multiplicity(("A", "k"), p) == jc.max_multiplicity(("A", "k"), p)
        assert tc.match_ratio(("B", "k"), ("A", "k"), p) == jc.match_ratio(("B", "k"),
                                                                          ("A", "k"), p)
        for q in ((), (("g", "==", 1),)):
            assert (tc.mn_output_rows(("A", "k"), ("B", "k"), p, q)
                    == jc.mn_output_rows(("A", "k"), ("B", "k"), p, q))
    for t, c in (("A", "k"), ("A", "f"), ("B", "k")):
        assert tc.is_unique(t, c) == jc.is_unique(t, c)
        assert dataclasses.astuple(tc.col_stats(t, c)) == dataclasses.astuple(jc.col_stats(t, c))
    assert tc.is_unique("A", "v") == jc.is_unique("A", "v")
    assert tc.stats("B").num_rows == jc.stats("B").num_rows == 5000
