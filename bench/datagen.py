"""The benchmark's tables, drawn on the device from the run's seed.

A rewrite of the recipe of the port's relational generator, so that the
program under test never makes its own inputs: keys are a permutation of
[0, rows), foreign keys are uniform over the rows of the table they point
into, and payloads are derived from a key by the same formula, so a check
can recompute them. A configuration lists its tables and, per column, a
recipe:

  {"kind": "permutation"}                       a permutation of [0, rows)
  {"kind": "uniform", "domain": "<table>"}      uniform in [0, rows of <table>)
  {"kind": "payload", "of": "<column>", "j": j} payload j of that column
  {"kind": "row_number"}                        0, 1, ..., rows - 1

each with its "dtype". Tables are drawn in the order the configuration
lists them, columns in their order, all from one generator on the device
seeded with the run's seed: the same seed gives the same tables.
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
            else:
                raise ValueError(f"{tname}.{cname}: unknown column kind {kind!r}")
            cols[cname] = v
        out[tname] = cols
    return out


def table_bytes(tables: dict[str, dict[str, torch.Tensor]]) -> int:
    return sum(v.numel() * v.element_size() for cols in tables.values() for v in cols.values())
