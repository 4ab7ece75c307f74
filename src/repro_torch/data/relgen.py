"""Relational workload generator — the paper's §5 experimental matrix.

Generates (R, S) pairs as `{name: np.ndarray}` dicts with the paper's knobs:
sizes, payload column counts, match ratio (a fraction of R's primary keys
replaced by out-of-domain values, §5.2.3), foreign-key Zipf skew (§5.2.4),
4- or 8-byte keys and payloads (§5.2.5), and the TPC-H/DS-shaped extracts of
Table 6, and star schemas for join sequences (§5.2.7). Keys are 0..|R|-1
shuffled; payloads are derived from the key, so a
check can recompute them. For the same seed the arrays equal the JAX
package's generator's. `table_from_numpy` puts them on a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class JoinWorkload:
    name: str
    n_r: int
    n_s: int
    r_payloads: int = 2
    s_payloads: int = 2
    match_ratio: float = 1.0
    zipf: float = 0.0
    key_dtype: str = "int32"
    payload_dtype: str = "int32"
    seed: int = 0


def _payload(keys: np.ndarray, j: int, dtype) -> np.ndarray:
    """Payload column j of rows with these keys."""
    return ((keys.astype(np.int64) * (j + 3) * 2654435761) % (1 << 31)).astype(dtype)


def generate(w: JoinWorkload) -> tuple[dict, dict]:
    rng = np.random.default_rng(w.seed)
    kdt = np.dtype(w.key_dtype)
    pdt = np.dtype(w.payload_dtype)

    rkeys = rng.permutation(w.n_r).astype(kdt)
    if w.match_ratio < 1.0:
        n_drop = int(round((1.0 - w.match_ratio) * w.n_r))
        drop_idx = rng.choice(w.n_r, n_drop, replace=False)
        rkeys[drop_idx] = (np.arange(n_drop) + 2 * w.n_r + 1).astype(kdt)

    if w.zipf > 0:
        ranks = rng.zipf(max(w.zipf, 1.01), size=w.n_s).astype(np.int64)
        skeys = ((ranks - 1) % w.n_r).astype(kdt)
    else:
        skeys = rng.integers(0, w.n_r, w.n_s).astype(kdt)

    R = {"k": rkeys}
    for j in range(w.r_payloads):
        R[f"r{j+1}"] = _payload(rkeys, j, pdt)
    S = {"k": skeys}
    for j in range(w.s_payloads):
        S[f"s{j+1}"] = _payload(skeys, 100 + j, pdt)
    return R, S


def generate_star(n_fact: int, n_dim: int, n_joins: int, *, payloads_per_dim: int = 1,
                  seed: int = 0):
    """A fact table with n_joins foreign keys and n_joins dimension tables
    for join sequences (Fig. 16): (fact, dims, fk_cols, dim_keys), tables as
    `{name: np.ndarray}` dicts. fact["payload"] is the row number; dimension
    i has key k{i} (a permutation of [0, n_dim)) and payloads p{i}_{j} =
    `_payload(k{i}, 7 i + j)`."""
    rng = np.random.default_rng(seed)
    fact = {"payload": np.arange(n_fact, dtype=np.int32)}
    dims, fks, dks = [], [], []
    for i in range(n_joins):
        fact[f"fk{i}"] = rng.integers(0, n_dim, n_fact).astype(np.int32)
        dkeys = rng.permutation(n_dim).astype(np.int32)
        cols = {f"k{i}": dkeys}
        for j in range(payloads_per_dim):
            cols[f"p{i}_{j}"] = _payload(dkeys, i * 7 + j, np.int32)
        dims.append(cols)
        fks.append(f"fk{i}")
        dks.append(f"k{i}")
    return fact, dims, fks, dks


# TPC-H/DS extracts (Table 6): (query, n_r, n_s, r_key_cols, r_nonkey,
# s_key_cols, s_nonkey, note)
TPC_JOINS = {
    "J1": ("TPC-H Q7", 15_000_000, 18_200_000, 1, 3, 0, 1, "PK-FK wide join"),
    "J2": ("TPC-H Q18", 15_000_000, 60_000_000, 1, 2, 0, 1, ""),
    "J3": ("TPC-H Q19", 2_000_000, 2_100_000, 0, 3, 0, 3, ""),
    "J4": ("TPC-DS Q64", 1_900_000, 58_000_000, 0, 1, 3, 7, "many S payloads"),
    "J5": ("TPC-DS Q95", 72_000_000, 72_000_000, 0, 1, 0, 1, "self narrow join, m:n"),
}


def generate_tpc(jid: str, *, scale: float = 1 / 64, payload_bytes: int = 8,
                 key_bytes: int = 4, seed: int = 0):
    """Scaled TPC-H/DS join extract: (R, S, mode). Key attributes are 4-byte
    ints; non-key attributes are `payload_bytes` ints (dictionary-encoded
    strings, §5.3)."""
    q, n_r, n_s, rk, rnk, sk, snk, note = TPC_JOINS[jid]
    n_r, n_s = max(int(n_r * scale), 1024), max(int(n_s * scale), 1024)
    kdt = "int32" if key_bytes == 4 else "int64"
    pdt = "int32" if payload_bytes == 4 else "int64"
    w = JoinWorkload(name=jid, n_r=n_r, n_s=n_s, r_payloads=rk + rnk, s_payloads=sk + snk,
                     match_ratio=1.0, key_dtype=kdt, payload_dtype=pdt, seed=seed)
    if jid == "J5":  # FK-FK self join: duplicate keys on the build side too
        rng = np.random.default_rng(seed)
        keys_r = rng.integers(0, n_r // 4, n_r).astype(kdt)
        keys_s = rng.integers(0, n_r // 4, n_s).astype(kdt)
        R = {"k": keys_r, "r1": _payload(keys_r, 0, np.dtype(pdt))}
        S = {"k": keys_s, "s1": _payload(keys_s, 9, np.dtype(pdt))}
        return R, S, "mn"
    R, S = generate(w)
    return R, S, "pk_fk"
