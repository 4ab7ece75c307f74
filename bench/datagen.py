"""The benchmark's tables, drawn on the device from the run's seed.

A rewrite of the recipe of the port's relational generator, so that the
program under test never makes its own inputs: keys are a permutation of
[0, rows), foreign keys are uniform over the rows of the table they point
into, and payloads are derived from a key by the same formula, so a check
can recompute them. Skewed keys and values independent of the key are
drawn by their own recipes, and so are the columns of TPC-H's lineitem
by dbgen's rules (TPC-H v3, clause 4.2.3). A configuration lists its
tables and, per column, a recipe:

  {"kind": "permutation"}                       a permutation of [0, rows)
  {"kind": "uniform", "domain": "<table>"}      uniform in [0, rows of <table>)
  {"kind": "payload", "of": "<column>", "j": j} payload j of that column
  {"kind": "row_number"}                        0, 1, ..., rows - 1
  {"kind": "zipf", "s": s, "fold": f}           (X - 1) mod f, X ~ Zipf(s) on 1, 2, ...
  {"kind": "real", "low": a, "high": b}         uniform in [a, b)
  {"kind": "randint", "low": a, "high": b}      uniform integers in [a, b], both ends
                                                included: dbgen's RANDOM(a, b)
  {"kind": "shift", "of": "<column>", "low": a, "high": b}
                                                that column plus its own randint [a, b]
  {"kind": "tpch_extendedprice", "quantity": "<column>", "partkey": "<column>"}
                                                quantity x P_RETAILPRICE(partkey) in cents
  {"kind": "tpch_returnflag", "receiptdate": "<column>", "currentdate": d}
                                                ord('N') where the date is past d, else
                                                ord('R') or ord('A') by a fair draw a row
  {"kind": "tpch_linestatus", "shipdate": "<column>", "currentdate": d}
                                                ord('O') where the date is past d, else
                                                ord('F'); draws nothing

each with its "dtype". Dates are days since 1992-01-01, dbgen's
STARTDATE; decimals are integers in hundredths; flags are ASCII codes, so
that the codes sort as the letters do. Tables are drawn in the order the
configuration lists them, columns in their order, all from one generator
on the device seeded with the run's seed: the same seed gives the same
tables.
"""
from __future__ import annotations

import torch

# the payload formula's multiplier (Knuth's multiplicative hash)
PAYLOAD_MULT = 2654435761
PAYLOAD_MOD = 1 << 31


def payload(keys: torch.Tensor, j: int, dtype: torch.dtype) -> torch.Tensor:
    """Payload column j of rows with these keys: (key * (j + 3) * 2654435761)
    mod 2^31, in `dtype`. The product is taken in int64 and must not wrap."""
    mult = (j + 3) * PAYLOAD_MULT
    if keys.numel() and int(keys.max()) * mult >= 1 << 63:
        raise ValueError(f"payload {j}: keys up to {int(keys.max())} overflow int64")
    return ((keys.to(torch.int64) * mult) % PAYLOAD_MOD).to(dtype)


def zipf_pmf(s: float, fold: int, device="cpu") -> torch.Tensor:
    """P(k), k in [0, fold), of (X - 1) mod fold with X ~ Zipf(s) on
    {1, 2, ...} (the law of numpy's `Generator.zipf`), in float64:
    fold^-s * zeta(s, (k + 1) / fold) / zeta(s), with the Hurwitz zeta."""
    s64 = torch.tensor(float(s), dtype=torch.float64, device=device)
    q = torch.arange(1, fold + 1, dtype=torch.float64, device=device) / fold
    return fold ** -float(s) * torch.special.zeta(s64, q) / torch.special.zeta(s64, 1.0)


def zipf_keys(n: int, s: float, fold: int, g: torch.Generator, device) -> torch.Tensor:
    """n int64 draws of `zipf_pmf(s, fold)`, by inverse CDF: float64
    uniforms from `g` searched in the cumulative pmf, its last entry 1."""
    cdf = torch.cumsum(zipf_pmf(s, fold, device), 0)
    cdf[-1] = 1.0
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u, right=True)


def real_values(n: int, low: float, high: float, dtype: torch.dtype, g: torch.Generator,
                device) -> torch.Tensor:
    """n uniforms in [low, high) in `dtype`; a value that rounds up to
    `high` is taken as the largest below it."""
    u = torch.rand(n, generator=g, device=device, dtype=dtype)
    v = low + (high - low) * u
    top = torch.nextafter(torch.tensor(high, dtype=dtype, device=device),
                          torch.tensor(low, dtype=dtype, device=device))
    return torch.where(v < high, v, top)


def retail_price_cents(partkey: torch.Tensor) -> torch.Tensor:
    """dbgen's P_RETAILPRICE of these part keys, in cents, as int64:
    90000 + ((p / 10) mod 20001) + 100 * (p mod 1000)."""
    p = partkey.to(torch.int64)
    return 90000 + torch.remainder(torch.div(p, 10, rounding_mode="floor"), 20001) \
        + 100 * torch.remainder(p, 1000)


def randint(n: int, low: int, high: int, g: torch.Generator, device) -> torch.Tensor:
    """n int64 draws uniform in [low, high], both ends included."""
    return torch.randint(int(low), int(high) + 1, (n,), generator=g, device=device,
                         dtype=torch.int64)


def make_tables(config: dict, seed: int, device) -> dict[str, dict[str, torch.Tensor]]:
    """{table: {column: tensor}} on `device`, drawn from `seed` by the
    configuration's recipes."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 64) - 1))
    rows = {t: int(spec["rows"]) for t, spec in config["tables"].items()}
    out: dict[str, dict[str, torch.Tensor]] = {}
    for tname, spec in config["tables"].items():
        n = rows[tname]
        cols: dict[str, torch.Tensor] = {}
        for cname, col in spec["columns"].items():
            dtype = getattr(torch, col["dtype"])
            kind = col["kind"]
            if kind == "permutation":
                v = torch.randperm(n, generator=g, device=device, dtype=torch.int64).to(dtype)
            elif kind == "uniform":
                v = torch.randint(0, rows[col["domain"]], (n,), generator=g, device=device,
                                  dtype=torch.int64).to(dtype)
            elif kind == "payload":
                v = payload(cols[col["of"]], int(col["j"]), dtype)
            elif kind == "row_number":
                v = torch.arange(n, device=device, dtype=dtype)
            elif kind == "zipf":
                v = zipf_keys(n, float(col["s"]), int(col["fold"]), g, device).to(dtype)
            elif kind == "real":
                v = real_values(n, float(col["low"]), float(col["high"]), dtype, g, device)
            elif kind == "randint":
                v = randint(n, col["low"], col["high"], g, device).to(dtype)
            elif kind == "shift":
                v = (cols[col["of"]].to(torch.int64)
                     + randint(n, col["low"], col["high"], g, device)).to(dtype)
            elif kind == "tpch_extendedprice":
                v = (cols[col["quantity"]].to(torch.int64)
                     * retail_price_cents(cols[col["partkey"]])).to(dtype)
            elif kind == "tpch_returnflag":
                ra = torch.where(randint(n, 0, 1, g, device) == 1, ord("R"), ord("A"))
                v = torch.where(cols[col["receiptdate"]] > int(col["currentdate"]),
                                ord("N"), ra).to(dtype)
            elif kind == "tpch_linestatus":
                v = torch.where(cols[col["shipdate"]] > int(col["currentdate"]),
                                ord("O"), ord("F")).to(dtype)
            else:
                raise ValueError(f"{tname}.{cname}: unknown column kind {kind!r}")
            cols[cname] = v
        out[tname] = cols
    return out


def table_bytes(tables: dict[str, dict[str, torch.Tensor]]) -> int:
    return sum(v.numel() * v.element_size() for cols in tables.values() for v in cols.values())
