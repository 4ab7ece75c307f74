"""The generator's determinism and recipe, the byte formulas, and the plain
references against the port's plain arms (its kernels' plain versions run
for CPU tensors) at a tiny size."""
import hashlib
import json
import time

import numpy as np
import pytest
import torch

from bench import check, control, datagen, loop, refops, roofline

from .conftest import HELD, HELD_CONFIG, Q1_CONFIG, shrink_config, tiny_parts

CONFIG_CELLS = ["q18-sf10.embedded", "star4-sf10.served4", *HELD]

# every TPC-H recipe over domains small enough that 20,000 rows reach both
# ends of each range, and CURRENTDATE inside the dates' range
RECIPES = {"name": "tpch-recipes", "tables": {"lineitem": {"rows": 20_000, "columns": {
    "o_orderdate": {"kind": "randint", "low": 0, "high": 9, "dtype": "int32"},
    "l_quantity": {"kind": "randint", "low": 1, "high": 3, "dtype": "int64"},
    "l_partkey": {"kind": "randint", "low": 1_999_990, "high": 2_000_000, "dtype": "int32"},
    "l_extendedprice": {"kind": "tpch_extendedprice", "quantity": "l_quantity",
                        "partkey": "l_partkey", "dtype": "int64"},
    "l_shipdate": {"kind": "shift", "of": "o_orderdate", "low": 1, "high": 4,
                   "dtype": "int32"},
    "l_receiptdate": {"kind": "shift", "of": "l_shipdate", "low": 1, "high": 3,
                      "dtype": "int16"},
    "l_returnflag": {"kind": "tpch_returnflag", "receiptdate": "l_receiptdate",
                     "currentdate": 8, "dtype": "int8"},
    "l_linestatus": {"kind": "tpch_linestatus", "shipdate": "l_shipdate", "currentdate": 8,
                     "dtype": "int8"}}}}}
# configurations that no cell runs, at the tests' size
TEST_CONFIGS = {c["name"]: c for c in (shrink_config(HELD_CONFIG), RECIPES,
                                       shrink_config(Q1_CONFIG))}


def config_of(name: str) -> dict:
    return TEST_CONFIGS[name] if name in TEST_CONFIGS else tiny_parts(name)["config"]


def digest(tables):
    return {(t, c): v.clone() for t, cols in tables.items() for c, v in cols.items()}


@pytest.mark.parametrize("cell", [*CONFIG_CELLS, RECIPES["name"], Q1_CONFIG["name"]])
def test_generator_is_a_function_of_the_seed(cell):
    cfg = config_of(cell)
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


# sha256 of the tables of the older configurations at the tests' size from
# seed 2^31 + 3: the listed cells' as the generator drew them before the
# zipf and real recipes were added, the held configuration's as it drew
# them before the TPC-H recipes were
PINNED = {
    "q18-sf10.embedded": "7947884c58abfa49961e63adae9603447ec427fdcac0dc650042cb4b0f53a37e",
    "star4-sf10.served4": "00afcad10ac72cee7207e904ad10143a57ce29b53dc1871514ffa6c44f52c19e",
    "skew-groupby": "12dc213879158ce22ee36c9661fb6b6bf5702324e0e507f0c613d386ad5600d8",
}


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_older_configurations_draw_the_same_tables(cell):
    h = hashlib.sha256()
    for tname, cols in datagen.make_tables(config_of(cell), 2**31 + 3, "cpu").items():
        for cname, v in cols.items():
            h.update(f"{tname}.{cname}:{v.dtype}:{v.numel()};".encode())
            h.update(v.numpy().tobytes())
    assert h.hexdigest() == PINNED[cell]


def test_zipf_pmf_is_the_folded_zipf_law():
    p = datagen.zipf_pmf(1.5, 4096)
    assert p.dtype == torch.float64 and abs(float(p.sum()) - 1) < 1e-12
    assert float(p[0]) == pytest.approx(0.3828, abs=5e-5)
    assert float(p[-1]) == pytest.approx(4096 ** -1.5, rel=1e-12)
    assert float(p[:100].sum()) == pytest.approx(0.924, abs=5e-4)
    # brute force at fold 8: the sum of x^-s over x = k + 1 + 8j, j < J,
    # and the tail past J by the midpoint rule, over zeta(1.5)
    s, fold, j = 1.5, 8, 10**6
    x = np.arange(1, fold * j + 1, dtype=np.float64).reshape(j, fold)
    head = (x ** -s).sum(axis=0)
    tail = (np.arange(1, fold + 1) + fold * (j - 0.5)) ** (1 - s) / (fold * (s - 1))
    folded = head + tail
    assert np.allclose(datagen.zipf_pmf(s, fold).numpy(), folded / folded.sum(),
                       rtol=1e-9, atol=0)


def tv(a: torch.Tensor, b: torch.Tensor) -> float:
    return 0.5 * float((a - b).abs().sum())


def test_zipf_draws_follow_the_pmf_and_numpy():
    n, fold = 10**6, 4096
    g = torch.Generator().manual_seed(2**31 + 5)
    keys = datagen.zipf_keys(n, 1.5, fold, g, "cpu")
    assert int(keys.min()) >= 0 and int(keys.max()) < fold
    mine = torch.bincount(keys, minlength=fold).double() / n
    numpy_keys = (np.random.default_rng(7).zipf(1.5, n) - 1) % fold
    theirs = torch.from_numpy(np.bincount(numpy_keys, minlength=fold)).double() / n
    # numpy's own draws read 0.0082 from the exact pmf
    assert tv(mine, datagen.zipf_pmf(1.5, fold)) < 0.015
    assert tv(mine, theirs) < 0.02


@pytest.mark.parametrize("low,high,dtype", [(0.0, 1.0, torch.float32),
                                            (-2.5, 3.0, torch.float32),
                                            (1.0, 1.0 + 2**-20, torch.float32),
                                            (0.0, 1.0, torch.float64)])
def test_real_values_stay_in_range(low, high, dtype):
    g = torch.Generator().manual_seed(11)
    v = datagen.real_values(10**5, low, high, dtype, g, "cpu")
    assert v.dtype == dtype and float(v.min()) >= low and float(v.max()) < high
    assert float(v.std()) > 0.2 * (high - low)


def test_skew_recipe():
    cfg = tiny_parts("skew-groupby.embedded")["config"]
    t = datagen.make_tables(cfg, 2**31 + 9, "cpu")["facts"]
    n = cfg["tables"]["facts"]["rows"]
    assert t["k"].dtype == torch.int32 and t["v"].dtype == torch.float32
    assert t["k"].numel() == t["v"].numel() == n
    assert int(t["k"].min()) == 0 and int(t["k"].max()) < 4096
    assert float(t["v"].min()) >= 0 and float(t["v"].max()) < 1
    # the values are drawn apart from the keys: key 0's rows have the mean
    # of all rows
    assert float(t["v"][t["k"] == 0].mean()) == pytest.approx(0.5, abs=0.02)


def retail_price(p: int) -> int:
    """P_RETAILPRICE in cents as TPC-H v3 clause 4.2.3 writes it:
    (90000 + ((P_PARTKEY/10) modulo 20001) + 100 * (P_PARTKEY modulo 1000)) / 100."""
    return 90000 + ((p // 10) % 20001) + 100 * (p % 1000)


def lineitem(name: str, seed: int) -> dict[str, torch.Tensor]:
    return datagen.make_tables(TEST_CONFIGS[name], seed, "cpu")["lineitem"]


def test_randint_and_shift_reach_both_ends():
    t = lineitem(RECIPES["name"], 2**31 + 13)
    for col, spec in RECIPES["tables"]["lineitem"]["columns"].items():
        assert t[col].dtype == getattr(torch, spec["dtype"]), col
    for col, low, high in (("o_orderdate", 0, 9), ("l_quantity", 1, 3),
                           ("l_partkey", 1_999_990, 2_000_000)):
        assert (int(t[col].min()), int(t[col].max())) == (low, high), col
    for col, of, low, high in (("l_shipdate", "o_orderdate", 1, 4),
                               ("l_receiptdate", "l_shipdate", 1, 3)):
        gap = t[col].to(torch.int64) - t[of].to(torch.int64)
        assert (int(gap.min()), int(gap.max())) == (low, high), col
        # the shift is drawn apart from the column it shifts
        assert abs(float(torch.corrcoef(torch.stack([gap, t[of].long()]).double())[0, 1])) < 0.05


def test_extendedprice_is_quantity_times_retail_price():
    t = {c: v.tolist() for c, v in lineitem(RECIPES["name"], 2**31 + 13).items()}
    assert t["l_extendedprice"] == [q * retail_price(p) for q, p in zip(t["l_quantity"],
                                                                        t["l_partkey"])]
    prices = [retail_price(p) for p in range(1_999_990, 2_000_001)]
    assert (min(t["l_extendedprice"]), max(t["l_extendedprice"])) == (min(prices),
                                                                      3 * max(prices))
    assert retail_price(2_000_000) == 109_991
    assert int(datagen.retail_price_cents(torch.tensor([2_000_000], dtype=torch.int32))) == 109_991
    # the SF10 configuration on sampled rows
    li = lineitem(Q1_CONFIG["name"], 2**31 + 17)
    for i in np.random.default_rng(3).choice(li["l_partkey"].numel(), 500, replace=False):
        assert int(li["l_extendedprice"][i]) == \
            int(li["l_quantity"][i]) * retail_price(int(li["l_partkey"][i]))


@pytest.mark.parametrize("name", [RECIPES["name"], Q1_CONFIG["name"]])
def test_flags_follow_the_rules_row_by_row(name):
    spec = TEST_CONFIGS[name]["tables"]["lineitem"]["columns"]
    current = spec["l_returnflag"]["currentdate"]
    assert spec["l_linestatus"]["currentdate"] == current
    cols = {c: v.tolist() for c, v in lineitem(name, 2**31 + 19).items()}
    flags = [chr(c) for c in cols["l_returnflag"]]
    status = [chr(c) for c in cols["l_linestatus"]]
    for i, (receipt, ship) in enumerate(zip(cols["l_receiptdate"], cols["l_shipdate"])):
        assert (flags[i] == "N") if receipt > current else (flags[i] in "RA"), i
        assert status[i] == ("O" if ship > current else "F"), i
    assert set(flags) == {"A", "N", "R"} and set(status) == {"F", "O"}
    # R or A by one fair draw a row
    ra = [f for f in flags if f != "N"]
    assert abs(ra.count("R") / len(ra) - 0.5) < 5 * 0.5 / len(ra) ** 0.5


# TPC-H v3's dates as days since 1992-01-01
Q1_CUT = 2436  # 1998-12-01 - 90 days: Q1's DELTA at its validation value
CURRENTDATE = 1263  # 1995-06-17
Q1_GROUPS = ("AF", "NF", "NO", "RF")


def q1_analytic_shares() -> dict[str, float]:
    """Each Q1 group's share of lineitem's rows, and the share the cut
    keeps, worked out exactly from dbgen's rules: the order's date uniform
    on [0, 2405], ship date that plus [1, 121], receipt date that plus
    [1, 30], each uniform; R and A half each of what is not N."""
    order = np.ones(2406, dtype=np.int64)
    ship = np.convolve(order, np.ones(121, dtype=np.int64))  # ship date i + 1
    receipt = np.convolve(ship, np.ones(30, dtype=np.int64))  # receipt date i + 2
    n_ship, n_receipt = ship.sum(), receipt.sum()
    ship_le = lambda d: int(ship[:d].sum()) / n_ship  # noqa: E731  P(ship <= d)
    receipt_by_current = int(receipt[:CURRENTDATE - 1].sum()) / n_receipt
    return {"AF": receipt_by_current / 2, "RF": receipt_by_current / 2,
            "NF": ship_le(CURRENTDATE) - receipt_by_current,
            "NO": ship_le(Q1_CUT) - ship_le(CURRENTDATE), "kept": ship_le(Q1_CUT)}


def q1_answer(li: dict[str, torch.Tensor]) -> dict[str, dict]:
    """TPC-H Q1 over these lineitem columns, on their device: per group
    (returnflag, linestatus) of the rows shipped by the cut, the four sums
    exact in int64 (price in cents, disc_price in 1e-4, charge in 1e-6),
    the three averages in float64 and the count."""
    kept = li["l_shipdate"] <= Q1_CUT
    qty, price, disc, tax = (li[c].to(torch.int64) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    out = {}
    for g in Q1_GROUPS:
        m = kept & (li["l_returnflag"] == ord(g[0])) & (li["l_linestatus"] == ord(g[1]))
        n = int(m.sum())
        s = {c: int(torch.where(m, v, 0).sum()) for c, v in (
            ("sum_qty", qty), ("sum_base_price", price), ("sum_disc_price", disc_price),
            ("sum_charge", charge), ("sum_disc", disc))}
        out[g] = {"sum_qty": s["sum_qty"], "sum_base_price": s["sum_base_price"],
                  "sum_disc_price": s["sum_disc_price"], "sum_charge": s["sum_charge"],
                  "avg_qty": s["sum_qty"] / n, "avg_price": s["sum_base_price"] / 100 / n,
                  "avg_disc": s["sum_disc"] / 100 / n, "count_order": n}
    return out


def within_5_sd(counts: dict[str, int], n: int) -> dict[str, float]:
    """Each group's share, and the kept share, minus the analytic one, in
    binomial standard deviations at n rows."""
    got = {**{g: counts[g] / n for g in Q1_GROUPS}, "kept": sum(counts.values()) / n}
    want = q1_analytic_shares()
    z = {k: (got[k] - p) / (p * (1 - p) / n) ** 0.5 for k, p in want.items()}
    assert all(abs(v) < 5 for v in z.values()), z
    return z


def test_q1_analytic_shares():
    want = {"AF": 0.246779, "NF": 0.006442, "NO": 0.485934, "RF": 0.246779, "kept": 0.985934}
    assert q1_analytic_shares() == pytest.approx(want, abs=5e-7)


@pytest.mark.parametrize("seed", [2**31 + 23, 3_000_000_029])
def test_q1_groups_have_the_analytic_shares(seed):
    n = TEST_CONFIGS[Q1_CONFIG["name"]]["tables"]["lineitem"]["rows"]
    ans = q1_answer(lineitem(Q1_CONFIG["name"], seed))
    within_5_sd({g: a["count_order"] for g, a in ans.items()}, n)


def test_q1_answer_is_the_row_by_row_sum():
    li = lineitem(Q1_CONFIG["name"], 2**31 + 29)
    cols = {c: v.tolist() for c, v in li.items()}
    want = {g: [0] * 6 for g in Q1_GROUPS}
    for i, ship in enumerate(cols["l_shipdate"]):
        if ship > Q1_CUT:
            continue
        q, e, d, t = (cols[c][i] for c in ("l_quantity", "l_extendedprice", "l_discount",
                                             "l_tax"))
        w = want[chr(cols["l_returnflag"][i]) + chr(cols["l_linestatus"][i])]
        for j, v in enumerate((q, e, e * (100 - d), e * (100 - d) * (100 + t), d, 1)):
            w[j] += v
    got = q1_answer(li)
    for g, (q, e, dp, ch, d, n) in want.items():
        assert got[g] == {"sum_qty": q, "sum_base_price": e, "sum_disc_price": dp,
                          "sum_charge": ch, "avg_qty": q / n, "avg_price": e / 100 / n,
                          "avg_disc": d / 100 / n, "count_order": n}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 31, 3_000_000_037, 4_000_000_039])
def test_q1_columns_at_sf10_on_the_card(card, seed):
    """Draws the Q1 configuration at SF10 on the card and prints one JSON
    line: the draw's seconds and bytes, the peak, and Q1's answer."""
    n = Q1_CONFIG["tables"]["lineitem"]["rows"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tables = datagen.make_tables(Q1_CONFIG, seed, card)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ans = q1_answer(tables["lineitem"])
    z = within_5_sd({g: a["count_order"] for g, a in ans.items()}, n)
    # the int64 sums do not wrap: a float64 sum of each group's charge agrees
    li = tables["lineitem"]
    charge = (li["l_extendedprice"].double() * (100 - li["l_discount"]).double()
              * (100 + li["l_tax"]).double())
    for g, a in ans.items():
        m = (li["l_shipdate"] <= Q1_CUT) & (li["l_returnflag"] == ord(g[0])) \
            & (li["l_linestatus"] == ord(g[1]))
        assert float(torch.where(m, charge, 0).sum()) == pytest.approx(a["sum_charge"], rel=1e-9)
    print("Q1_DRAW " + json.dumps({
        "seed": seed, "rows": n, "draw_s": draw_s, "table_bytes": datagen.table_bytes(tables),
        "draw_peak_bytes": peak, "device": torch.cuda.get_device_name(), "z": z,
        "answer": ans}))


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
    """The program's answer and group output; a served cell's tables are
    padded to their buckets and counted as the server pads and counts them."""
    from repro_torch.core.table import Table
    from repro_torch.engine import Catalog, executor, optimize, scan
    from repro_torch.serve.query import bucket_rows, pad_table

    prog = {n: Table(dict(c)) for n, c in tables.items()}
    counts = None
    if parts["traffic"]["entry"] == "server":
        counts = {n: t.num_rows for n, t in prog.items()}
        prog = {n: pad_table(t, bucket_rows(t.num_rows)) for n, t in prog.items()}
    plan = optimize(parts["query"].plan(scan), Catalog(prog), measure_profile=False)
    with loop.keep_output(loop.group_node(plan.root)) as kept:
        answer = loop.fetch(executor.run(plan, prog, counts=counts))
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
    narrow_ref = q.reference(tables, control.narrow(q))
    narrow = refops.top_rows(narrow_ref, q.ORDER, q.LIMIT)
    narrow = {c: v.numpy() for c, v in narrow.items()}
    numbers, right = q.judge([narrow], {c: v.numpy() for c, v in narrow_ref.items()}, ref)
    assert right == [False] and numbers["rows_wrong_max"] > 0 and numbers["groups_wrong"] > 0
    assert not check.within_limits(numbers, q.LIMITS)


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


def test_close_judge_counts_each_fault():
    ref = {"k": torch.tensor([1, 2, 3, 4], dtype=torch.int32),
           "s": torch.tensor([10.0, 40.0, 30.0, 40.0], dtype=torch.float64),
           "c": torch.tensor([1, 5, 3, 2])}
    rel = {"s": 1e-5}

    def rows(k, s, c):
        return {"k": np.array(k, dtype=np.int32), "s": np.array(s, dtype=np.float32),
                "c": np.array(c, dtype=np.int32)}

    def wrong(ans):
        return check.rows_wrong_close(ans, ref, "k", "s", 3, rel)

    good = rows([4, 2, 3], [40.0002, 40, 30], [2, 5, 3])
    assert wrong(good) == 0
    assert wrong(rows([2, 4, 3], [40.0002, 40, 30], [5, 2, 3])) == 0  # a near tie
    assert wrong(rows([4, 2, 3], [40.01, 40, 30], [2, 5, 3])) == 1  # a sum off
    assert wrong(rows([4, 2, 3], [40, 40, 30], [2, 4, 3])) == 1  # a count off
    assert wrong(rows([4, 2], [40, 40], [2, 5])) == 1  # a row missing
    assert wrong(rows([4, 4, 3], [40, 40, 30], [2, 2, 3])) == 1  # a key repeated
    assert wrong(rows([4, 2, 1], [40, 40, 10], [2, 5, 1])) == 1  # not the top 3
    assert wrong({"k": np.array([4, 2, 3])}) == 3
    full = rows([1, 2, 3, 4], [10, 40, 30.0003, 40], [1, 5, 3, 2])
    assert check.groups_close(full, ref, "k", rel) == (0, pytest.approx(1e-5, rel=0.02))
    off = rows([1, 2, 3, 4], [10, 40, 30.003, 40], [1, 5, 3, 2])
    assert check.groups_close(off, ref, "k", rel) == (2, pytest.approx(1e-4, rel=0.02))
    assert check.groups_close(rows([1, 2, 3], [10, 40, 30], [1, 5, 3]), ref, "k", rel) == (1, 1.0)
    assert check.groups_close(None, ref, "k", rel) == (4, 1.0)
    numbers, right = check.judge_close([good, None, good], full, ref, "k", "s", 3, rel)
    assert right == [True, False, True]
    assert numbers == {"answers_missing": 1, "answers_wrong": 0, "rows_wrong_max": 0,
                       "groups_wrong": 0, "rel_err_max": pytest.approx(1e-5, rel=0.02)}


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
