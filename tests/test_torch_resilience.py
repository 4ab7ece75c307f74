"""Parity of the port's escalation ladders and fault injection with the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go to both packages' checked
drivers (`phj_join_checked`, `groupjoin_checked`, `groupby_partition_checked`)
under the same `REPRO_FAULTS` string, which both packages read. The two must
give the same `EscalationReport.as_dict()`, the same canonical rows (valid
rows as sorted tuples, so escalated bits that reorder rows do not matter),
the same exceptions and the same deltas of the `resilience.*` and
`core.overflow_escalations` counters, each package in its own registry.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.resilience import EscalationExhausted as JExhausted  # noqa: E402
from repro.resilience import EscalationStep as JStep  # noqa: E402
from repro.resilience import Ladder as JLadder  # noqa: E402
from repro.resilience import faults as jfaults  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.resilience import EscalationExhausted as TExhausted  # noqa: E402
from repro_torch.resilience import EscalationStep as TStep  # noqa: E402
from repro_torch.resilience import Ladder as TLadder  # noqa: E402
from repro_torch.resilience import faults as tfaults  # noqa: E402

# the reference's probe chunk (rows per compiled probe step; no effect on the
# result): the default 8,192 costs seconds of compilation per input shape
JCHUNK = dict(probe_chunk=1024)
COUNTERS = ("resilience.ladder_attempts", "resilience.ladder_escalations",
            "resilience.ladder_exhausted", "resilience.faults_fired",
            "core.overflow_escalations")


def _jt(d):
    return J.Table({k: jnp.asarray(v) for k, v in d.items()})


def _tt(d):
    return T.table_from_numpy(d, device="cpu")


def canon(table, count):
    """Valid rows, order- and shape-insensitive (integer columns only)."""
    n = int(count)
    cols = sorted(table.column_names)
    mats = [np.asarray(table[c])[:n] if not isinstance(table[c], torch.Tensor)
            else table[c][:n].numpy() for c in cols]
    return tuple(cols), sorted(zip(*[m.tolist() for m in mats]))


def join_tables(rng, n_r=256, n_s=1024):
    """The reference's `make_join_tables` (tests/test_resilience.py) as numpy
    dicts."""
    R = {"k": rng.permutation(n_r).astype(np.int32),
         "v": rng.integers(0, 99, n_r).astype(np.int32)}
    S = {"k": rng.integers(0, n_r, n_s).astype(np.int32),
         "w": rng.integers(0, 9, n_s).astype(np.int32)}
    return R, S


def _counts(registry):
    return {n: registry.counter(n).value for n in COUNTERS}


def _run_both(jfn, tfn):
    """Run each package's call, each watching its own counters. Returns
    ((outcome, counter deltas) of the reference, (the same) of the port);
    an outcome is ("ok", result) or ("exhausted", report dict)."""
    res = []
    for fn, reg, exc in ((jfn, jmetrics, JExhausted), (tfn, tmetrics, TExhausted)):
        before = _counts(reg)
        try:
            out = ("ok", fn())
        except exc as e:
            out = ("exhausted", e.report.as_dict())
        after = _counts(reg)
        res.append((out, {n: after[n] - before[n] for n in COUNTERS}))
    return res


def _assert_same(jres, tres):
    (jout, jdelta), (tout, tdelta) = jres, tres
    assert jout[0] == tout[0], (jout[0], tout[0])
    assert jdelta == tdelta
    if jout[0] == "exhausted":
        assert jout[1] == tout[1]
        return None
    (jtab, jrep), (ttab, trep) = jout[1], tout[1]
    assert jrep.as_dict() == trep.as_dict()
    assert canon(*jtab) == canon(*ttab)
    return trep


# ---------------------------------------------------------------------------
# the REPRO_FAULTS grammar (tests/test_resilience.py's cases)
# ---------------------------------------------------------------------------
def _spec_tuple(plan):
    return plan.raw, tuple((s.kind, s.target, s.when, s.factor, s.seed) for s in plan.specs)


@pytest.mark.parametrize("spec", [
    "overflow:phj@0, pallas:*, raise:executor.run@1+3,estimates:/16, seed:7",
    "  ", "", "overflow:phj@all", "overflow:groupjoin@0+1+2", "pallas:hash_probe@0+1",
    "oom:qserve.admit@2", "estimates:x4", "raise:qserve.execute",
    # rejected
    "overflow:phj", "overflow:@0", "pallas:", "raise:*", "oom:*", "estimates:16",
    "estimates:x0", "estimates:xnope", "seed:abc", "overflow:phj@-1", "overflow:phj@one",
    "typo:phj@0", "justaword",
])
def test_parse_accepts_and_rejects_what_the_reference_does(spec):
    try:
        want = ("ok", _spec_tuple(jfaults.parse(spec)))
    except ValueError as e:
        want = ("error", str(e))
    try:
        got = ("ok", _spec_tuple(tfaults.parse(spec)))
    except ValueError as e:
        got = ("error", str(e))
        assert tfaults.ENV_VAR in str(e) and "overflow:<ladder>@<when>" in str(e)
    assert got == want


def test_inject_context_wins_over_env_and_counters_reset(monkeypatch):
    monkeypatch.setenv(tfaults.ENV_VAR, "overflow:phj@all")
    with tfaults.inject(""):
        assert not tfaults.overflow_forced("phj", 0)
    assert tfaults.overflow_forced("phj", 0)
    monkeypatch.delenv(tfaults.ENV_VAR)
    for _ in range(2):  # counters restart at every activation
        with tfaults.inject("raise:somesite@0"):
            with pytest.raises(tfaults.FaultInjected):
                tfaults.check_site("somesite")
            tfaults.check_site("somesite")  # occurrence 1: not armed
    with tfaults.inject("oom:alloc@1"):
        tfaults.check_oom("alloc")
        with pytest.raises(MemoryError):
            tfaults.check_oom("alloc")
    with tfaults.inject("estimates:/16"):
        assert tfaults.estimate_factor("x") == jfaults.parse("estimates:/16").specs[0].factor
    assert tfaults.estimate_factor("x") == 1.0 and not tfaults.active()


# ---------------------------------------------------------------------------
# the ladder engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["converges", "yields", "exhausted"])
def test_toy_ladder_matches_reference(case):
    def ladder(Ladder, Step):
        grow = {"converges": lambda kn, d: {**kn, "cap": kn["cap"] * 2},
                "yields": lambda kn, d: None,
                "exhausted": lambda kn, d: {**kn, "cap": kn["cap"] * 2}}[case]
        return Ladder("toy", [Step("cap", grow, max_times=4),
                              Step("fallback", lambda kn, d: {**kn, "exact": True},
                                   max_times=1)], max_attempts=3 if case == "exhausted" else 8)

    def check(kn):
        ok = case != "exhausted" and bool(kn["cap"] >= 100 or kn.get("exact"))
        return ok, "" if ok else f"cap {kn['cap']} < 100", None

    jres, tres = _run_both(lambda: ladder(JLadder, JStep).resolve({"cap": 16}, check),
                           lambda: ladder(TLadder, TStep).resolve({"cap": 16}, check))
    assert jres[0][0] == tres[0][0] and jres[1] == tres[1]
    if case == "exhausted":
        assert jres[0][1] == tres[0][1]
    else:
        assert jres[0][1].as_dict() == tres[0][1].as_dict()
        assert jres[0][1].summary() == tres[0][1].summary()


# ---------------------------------------------------------------------------
# the three production ladders: natural, forced and exhausted
# ---------------------------------------------------------------------------
def _ladder_calls(ladder, rng):
    """(reference call, port call) of one checked driver on the reference's
    test inputs, each returning (result, report)."""
    if ladder == "groupby_partition":
        d = {"k": rng.integers(0, 256, 1024).astype(np.int32),
             "w": rng.integers(0, 9, 1024).astype(np.int32)}
        kw = dict(key="k", aggs={"w": "sum"}, num_groups=256, with_report=True)
        return (lambda: J.groupby_partition_checked(_jt(d), **kw),
                lambda: T.groupby_partition_checked(_tt(d), **kw))
    R, S = join_tables(rng)
    if ladder == "phj":
        return (lambda: J.phj_join_checked(_jt(R), _jt(S), key="k", with_report=True,
                                                   **JCHUNK),
                lambda: T.phj_join_checked(_tt(R), _tt(S), key="k", with_report=True))
    kw = dict(key="k", group_key="k", aggs={"w": "sum", "v": "count"}, num_groups=64,
              with_report=True)
    return (lambda: J.groupjoin_checked(_jt(R), _jt(S), **kw, **JCHUNK),
            lambda: T.groupjoin_checked(_tt(R), _tt(S), **kw))


@pytest.mark.parametrize("when", ["natural", "0", "0+1", "all"])
@pytest.mark.parametrize("ladder", ["phj", "groupjoin", "groupby_partition"])
def test_checked_drivers_match_reference(ladder, when, monkeypatch, rng):
    if when != "natural":
        monkeypatch.setenv(tfaults.ENV_VAR, f"overflow:{ladder}@{when}")
    jcall, tcall = _ladder_calls(ladder, rng)
    jres, tres = _run_both(jcall, tcall)
    rep = _assert_same(jres, tres)
    if when == "all":
        assert rep is None  # exhausted in both packages
    elif when != "natural":
        assert rep.escalated and rep.converged
    if ladder == "groupjoin":  # capacity 64 < 256 groups: grown to the count
        assert rep is None or rep.final_knobs["num_groups"] >= 256


def test_env_spec_is_read_per_call(monkeypatch, rng):
    R, S = join_tables(rng)
    monkeypatch.setenv(tfaults.ENV_VAR, "overflow:nonsense")
    with pytest.raises(ValueError):
        T.phj_join_checked(_tt(R), _tt(S), key="k")
    monkeypatch.setenv(tfaults.ENV_VAR, "overflow:phj@0")
    _, rep = T.phj_join_checked(_tt(R), _tt(S), key="k", with_report=True)
    assert rep.escalated and rep.converged
    monkeypatch.delenv(tfaults.ENV_VAR)
    _, rep2 = T.phj_join_checked(_tt(R), _tt(S), key="k", with_report=True)
    assert not rep2.escalated


def test_phj_ladder_falls_back_to_smj_on_unsplittable_skew():
    """tests/test_resilience.py's case: one key's 600 build rows co-hash at
    any fan-out, so the ladder ends on the sort-merge rung."""
    R = {"k": np.zeros(600, np.int32), "v": np.arange(600, dtype=np.int32)}
    S = {"k": np.zeros(50, np.int32), "w": np.arange(50, dtype=np.int32)}
    kw = dict(key="k", mode="mn", out_size=600 * 50, with_report=True)
    jres, tres = _run_both(lambda: J.phj_join_checked(_jt(R), _jt(S), **kw, **JCHUNK),
                           lambda: T.phj_join_checked(_tt(R), _tt(S), **kw))
    rep = _assert_same(jres, tres)
    assert rep.converged and rep.final_knobs["algorithm"] == "smj"
    assert int(tres[0][1][0][1]) == 600 * 50


def test_phj_ladder_smj_rung_under_forced_bits(monkeypatch, rng):
    """Bits forced to overflow until the cap (20): the ladder takes the
    sort-merge rung, which gets only the keywords both joins share."""
    R, S = join_tables(rng)
    monkeypatch.setenv(tfaults.ENV_VAR, "overflow:phj@0+1+2")
    kw = dict(key="k", partition_bits=18, with_report=True)
    jres, tres = _run_both(lambda: J.phj_join_checked(_jt(R), _jt(S), **kw, **JCHUNK),
                           lambda: T.phj_join_checked(_tt(R), _tt(S), probe_impl="torch",
                                                      gather_impl="torch", phases={}, **kw))
    rep = _assert_same(jres, tres)
    assert [a.knobs["partition_bits"] for a in rep.attempts] == [18, 19, 20, 20]
    assert [a.step for a in rep.attempts] == ["partition_bits", "partition_bits",
                                              "strategy:smj", ""]
    assert rep.final_knobs["algorithm"] == "smj"


def test_phj_checked_on_duplicate_heavy_build(rng):
    """tests/test_joins.py's case, cut to 1,200 x 200 rows: four keys over
    the build rows (300 each) overflow the default blocks; 2,048-row blocks
    hold them."""
    R = {"k": rng.integers(0, 4, 1200).astype(np.int32), "r0": np.arange(1200, dtype=np.int32)}
    S = {"k": rng.integers(0, 4, 200).astype(np.int32), "s0": np.arange(200, dtype=np.int32)}
    assert T.phj_overflowed(_tt(R))[0] and J.phj_overflowed(_jt(R))[0]
    total = int((np.bincount(R["k"], minlength=4) * np.bincount(S["k"], minlength=4)).sum())
    kw = dict(mode="mn", out_size=total + 64, build_block=2048, with_report=True)
    jres, tres = _run_both(lambda: J.phj_join_checked(_jt(R), _jt(S), **kw, **JCHUNK),
                           lambda: T.phj_join_checked(_tt(R), _tt(S), **kw))
    _assert_same(jres, tres)
    (jt, jc), (tt, tc) = jres[0][1][0], tres[0][1][0]
    for name in jt.column_names:  # the same PHJ rows in the same order
        np.testing.assert_array_equal(np.asarray(jt[name]), tt[name].numpy())
    assert int(tc) == total


# ---------------------------------------------------------------------------
# property: both packages' ladders converge alike under underestimates
# ---------------------------------------------------------------------------
@settings(max_examples=5, deadline=None)
@given(factor=st.sampled_from([2, 4, 16, 64]), seed=st.integers(0, 10))
def test_ladders_converge_alike_under_underestimates(factor, seed):
    """The reference's `test_ladders_converge_under_underestimates`, both
    packages side by side: partition bits as if R had n_r / factor rows,
    the group-join's capacity and the group-by's block `factor` times too
    small. Every ladder converges, with the same report and rows."""
    rng = np.random.default_rng(seed)
    n_r, n_s = 512, 1024
    R, S = join_tables(rng, n_r, n_s)
    bad_bits = T.choose_partition_bits(max(n_r // factor, 1), 64)
    assert bad_bits == J.choose_partition_bits(max(n_r // factor, 1), 64)
    kw = dict(key="k", build_block=64, partition_bits=bad_bits, with_report=True)
    rep = _assert_same(*_run_both(lambda: J.phj_join_checked(_jt(R), _jt(S), **kw, **JCHUNK),
                                  lambda: T.phj_join_checked(_tt(R), _tt(S), **kw)))
    assert rep.converged
    gkw = dict(key="k", group_key="k", aggs={"w": "sum"}, num_groups=max(n_r // factor, 1),
               with_report=True)
    rep = _assert_same(*_run_both(lambda: J.groupjoin_checked(_jt(R), _jt(S), **gkw, **JCHUNK),
                                  lambda: T.groupjoin_checked(_tt(R), _tt(S), **gkw)))
    assert rep.converged
    pkw = dict(key="k", aggs={"w": "sum"}, num_groups=n_r, row_block=max(128 // factor, 8),
               partition_bits=0, with_report=True)
    rep = _assert_same(*_run_both(lambda: J.groupby_partition_checked(_jt(S), **pkw),
                                  lambda: T.groupby_partition_checked(_tt(S), **pkw)))
    assert rep.converged
