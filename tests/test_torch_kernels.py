"""Parity of the PyTorch port's kernel layer with the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernels in interpret mode, as the JAX package's own tests run them on
the CPU) and through the port's plain arm on the CPU. Integer and layout
outputs must be equal. tests/test_torch_cuda.py holds each hand-written
kernel against its plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import hash_join as jhj  # noqa: E402
from repro.core import primitives as jprim  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gather import gather_windowed_pallas  # noqa: E402
from repro.kernels.histogram import histogram_pallas  # noqa: E402
from repro.kernels.merge_join import lower_bound_windowed_pallas  # noqa: E402
from repro.kernels.hash_probe import (hash_probe_pallas, layout_probe_blocks,  # noqa: E402
                                      probe_agg_pallas)
from repro.kernels.segsum import segsum_partials_pallas  # noqa: E402
from repro.kernels.radix_partition import (block_histograms_pallas,  # noqa: E402
                                           partition_ranks_pallas, sort_plan_radix)
from repro_torch.core import Table as TTable  # noqa: E402
from repro_torch.core import groupby as tgb  # noqa: E402
from repro_torch.core import hash_join as thj  # noqa: E402
from repro_torch.core import primitives as tprim  # noqa: E402
from repro_torch.kernels import digits as tdigits  # noqa: E402
from repro_torch.kernels import gather as tgather  # noqa: E402
from repro_torch.kernels import hash_probe as thp  # noqa: E402
from repro_torch.kernels import histogram as thist  # noqa: E402
from repro_torch.kernels import merge_join as tmj  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import radix_partition as trp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import segsum as tseg  # noqa: E402
from test_torch_cuda import (GATHER_DTYPES, GATHER_EDGES, LB_EDGES,  # noqa: E402
                             PLAN_WIDTHS, PROBE_AGG_EDGES, PROBE_CAPS, PROBE_EDGES, RANK_CASES,
                             _gather_edge, _gather_numpy, _lb_edge, _probe_agg_edge,
                             _probe_edge, _rank_case)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(jax_arr, torch_t):
    a, b = np.asarray(jax_arr), torch_t.cpu().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# hashing and digits
# ---------------------------------------------------------------------------
def _np_hash32(x):
    """uint32 wrap-around reference in numpy."""
    with np.errstate(over="ignore"):
        x = x.astype(np.int64)
        u = (x ^ (x >> 32)).astype(np.uint32)
        u ^= u >> np.uint32(16)
        u *= np.uint32(0x7FEB352D)
        u ^= u >> np.uint32(15)
        u *= np.uint32(0x846CA68B)
        u ^= u >> np.uint32(16)
    return u.astype(np.int64)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_hash32_bit_exact(dtype):
    rng = np.random.default_rng(0)
    info = np.iinfo(dtype)
    edges = np.array([-1, 0, 1, -2, info.min, info.max], dtype)
    x = np.concatenate([rng.integers(info.min, info.max, 1 << 20, dtype=dtype), edges])
    got = thj.hash32(_t(x))
    assert got.dtype == torch.int64
    if dtype == np.int32:  # the JAX package runs with 32-bit integers
        _eq(np.asarray(jhj.hash32(jnp.asarray(x))).astype(np.int64), got)
    else:
        np.testing.assert_array_equal(got.numpy(), _np_hash32(x))


def _digit_keys(dtype, seed):
    """50,000 keys of `dtype`: every seventh KEY_SENTINEL, the rest random
    over the whole range, and the type's extremes (and INT32's, in int64)."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    keys = rng.integers(info.min, info.max, 50_000, dtype=dtype, endpoint=True)
    keys[::7] = -1  # sentinel rows go to partition P
    edges = [0, 1, -2, info.min, info.max, info.min + 1, info.max - 1]
    if dtype == np.int64:
        i32 = np.iinfo(np.int32)
        edges += [i32.min, i32.max, 1 << 32, (1 << 32) - 1, -(1 << 32)]
    keys[1:1 + len(edges)] = edges
    return keys


def _np_digits(keys, p_bits, hash_keys):
    """The digit formula in numpy's uint32 arithmetic: 2^p_bits for -1, else
    the low p_bits of hash32 of the key (an int64 key's words folded first;
    its low 32 bits, unhashed)."""
    low = keys.astype(np.int64) & 0xFFFFFFFF
    h = _np_hash32(keys if keys.dtype == np.int64 else low) if hash_keys else low
    return np.where(keys == -1, 1 << p_bits, h & ((1 << p_bits) - 1)).astype(np.int32)


@pytest.mark.parametrize("p_bits,hash_keys", [(b, h) for h in (True, False)
                                              for b in (1, 6, 8, 18, 20)])
def test_digits_bit_exact(p_bits, hash_keys):
    """The partition digits' plain version (`ref.partition_digits`, which
    `_digits` and `ops.partition_digits` run on the CPU) against the JAX
    package's `_digits` on int32 keys, and on int64 keys, which the
    reference (32-bit integers) cannot take, against the formula in numpy."""
    for dtype in (np.int32, np.int64):
        keys = _digit_keys(dtype, p_bits)
        got = thj._digits(_t(keys), p_bits, hash_keys)
        assert got.dtype == torch.int32
        assert torch.equal(got, tref.partition_digits(_t(keys), p_bits, hash_keys))
        assert torch.equal(got, tops.partition_digits(_t(keys), p_bits, hash_keys))
        np.testing.assert_array_equal(got.numpy(), _np_digits(keys, p_bits, hash_keys))
        assert int((got == 1 << p_bits).sum()) == int((keys == -1).sum())
        if dtype == np.int32:
            _eq(jhj._digits(jnp.asarray(keys), p_bits, hash_keys), got)


@pytest.mark.parametrize("how", ["float keys", "bool keys", "p_bits 31", "p_bits -1"])
def test_partition_digits_reject_what_no_int32_digit_holds(how):
    """Keys that are not integers raise TypeError and a p_bits whose
    sentinel digit 2^p_bits no int32 holds raises ValueError, in `_digits`
    and in the wrapper, before any arm runs."""
    keys, p_bits = torch.arange(8, dtype=torch.int32), 4
    if how == "float keys":
        keys = keys.float()
    elif how == "bool keys":
        keys = keys > 3
    else:
        p_bits = int(how.split()[1])
    err = TypeError if how.endswith("keys") else ValueError
    for fn in (thj._digits, tdigits.partition_digits):
        for hash_keys in (True, False):
            with pytest.raises(err):
                fn(keys, p_bits, hash_keys)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_groupby_partition_digits_bit_exact(dtype):
    from repro.core import groupby as jgb

    rng = np.random.default_rng(3)
    keys = rng.integers(-1, 5000, 20_000).astype(dtype)
    if dtype == np.float32:
        keys = keys * np.float32(0.37)
        keys[:4] = [0.0, -0.0, np.nan, -1.0]  # -0.0 co-partitions with 0.0
    _eq(jgb._partition_digits(jnp.asarray(keys), 9), tgb._partition_digits(_t(keys), 9))


# ---------------------------------------------------------------------------
# radix partition passes and the planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,bins", [(1, 2), (1000, 16), (5000, 256), (4097, 257)])
def test_block_histograms_and_ranks_match_pallas(n, bins):
    rng = np.random.default_rng(n)
    d = rng.integers(-1, bins, n).astype(np.int32)  # -1 = PAD_DIGIT
    jd = jnp.asarray(d)
    _eq(block_histograms_pallas(jd, bins, interpret=True), trp.block_histograms(_t(d), bins))
    dest, off, sz = trp.partition_ranks(_t(d), bins)
    for a, b in zip(partition_ranks_pallas(jd, bins, interpret=True), (dest, off, sz)):
        _eq(a, b)
    assert dest.dtype == off.dtype == sz.dtype == torch.int32


@pytest.mark.parametrize("case", RANK_CASES)
def test_rank_edge_cases_match_pallas(case):
    """The edge cases the card tests hold the rank kernel to (all digits
    equal, only pads, below one tile, a ragged tail, a skewed mix, 1 to 1024
    bins): the plain version against the Pallas kernels. The port treats a
    digit >= num_bins as a pad; the Pallas rank kernel gives such a digit
    base + 0, so it is handed -1 there instead."""
    d, bins = _rank_case(np.random.default_rng(len(case)), case)
    jd = jnp.asarray(np.where(d >= bins, -1, d).astype(np.int32))
    _eq(block_histograms_pallas(jd, bins, interpret=True), trp.block_histograms(_t(d), bins))
    for a, b in zip(partition_ranks_pallas(jd, bins, interpret=True),
                    trp.partition_ranks(_t(d), bins)):
        _eq(a, b)


@pytest.mark.parametrize("num_partitions", [5, 256, 257, 300, 1025, 65537])
@pytest.mark.parametrize("jax_pass_bits", [None, 3])
def test_partition_plan_matches_both_jax_arms(num_partitions, jax_pass_bits):
    """The port's stable-sort arm and its 8-bit LSD rank-pass composition
    (run here with the kernels' plain versions) against the JAX xla and
    pallas arms, past 256 partitions and through the 2^k + 1 tail layout.
    The JAX arms run with their default passes and with 3-bit passes: every
    composition gives the one stable partition."""
    rng = np.random.default_rng(num_partitions)
    n = 20_000
    d = rng.integers(0, num_partitions, n).astype(np.int32)
    d[rng.random(n) < 0.2] = num_partitions - 1  # a heavy top (sentinel) partition
    carry = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
    ref_arms = [jops.partition_plan(jnp.asarray(d), num_partitions, carry=(jnp.asarray(carry),),
                                    max_pass_bits=jax_pass_bits, impl=impl)
                for impl in ("xla", "pallas")]
    port_arms = [
        tops.partition_plan(_t(d), num_partitions, carry=(_t(carry),), impl="torch"),
        trp.partition_plan(_t(d), num_partitions, carry=(_t(carry),)),
    ]
    for jperm, (jc,), joff, jsz in ref_arms:
        for perm, (c,), off, sz in port_arms:
            assert perm.dtype == off.dtype == sz.dtype == torch.int32
            for a, b in ((jperm, perm), (jc, c), (joff, off), (jsz, sz)):
                _eq(a, b)


# rows: none, one, fewer than a tile, and a ragged count of tiles
PLAN_ROWS = [0, 1, 700, 5003]


def _counted_pass_scatter(monkeypatch):
    calls = []

    def counted(dest, digits, perm=None, *, shift, bits, tail_key):
        calls.append((perm is None, shift))
        return tref.pass_scatter(dest, digits, perm)

    monkeypatch.setattr(trp, "pass_scatter", counted)
    return calls


@pytest.mark.parametrize("n", PLAN_ROWS)
@pytest.mark.parametrize("num_partitions, passes", PLAN_WIDTHS)
def test_lsd_composition_on_plain_arms_equals_stable_sort(monkeypatch, num_partitions, passes, n):
    """The composition with the kernels' plain versions against one stable
    sort (the torch arm): perm, carried, offsets and sizes, for one to three
    passes with the tail class on and off; one scatter a pass, the first
    with no permutation to move, each told its pass's digit."""
    rng = np.random.default_rng(n + num_partitions)
    d = rng.integers(0, num_partitions, n).astype(np.int32)
    d[rng.random(n) < 0.2] = num_partitions - 1
    c = rng.integers(-(1 << 40), 1 << 40, n)
    calls = _counted_pass_scatter(monkeypatch)
    got = trp.partition_plan(_t(d), num_partitions, carry=(_t(c),))
    assert calls == [(i == 0, 8 * i) for i in range(passes)]
    want = tops.partition_plan(_t(d), num_partitions, carry=(_t(c),), impl="torch")
    for a, b in zip((got[0], got[1][0], got[2], got[3]), (want[0], want[1][0], want[2], want[3])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n", PLAN_ROWS)
def test_radix_sort_plan_on_plain_arms_equals_stable_sort(monkeypatch, n):
    """Four 8-bit passes over the sign-flipped keys; the sorted keys come
    out of the last pass's scatter, not out of a gather."""
    k = np.random.default_rng(n).integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    k[::3] = -1
    calls = _counted_pass_scatter(monkeypatch)
    sk, perm = trp.sort_plan_radix(_t(k))
    assert calls == [(i == 0, 8 * i) for i in range(4)]
    ts, tperm = tops.sort_plan(_t(k))
    assert torch.equal(sk, ts) and torch.equal(perm, tperm)


@pytest.mark.parametrize("first", [True, False])
def test_pass_scatter_plain_version(first):
    rng = np.random.default_rng(int(first))
    n = 1000
    dest, perm = rng.permutation(n).astype(np.int32), rng.permutation(n).astype(np.int32)
    keys = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    src = np.arange(n, dtype=np.int32) if first else perm
    want_perm, want_keys = np.empty_like(src), np.empty_like(keys)
    want_perm[dest], want_keys[dest] = src, keys
    got = trp.pass_scatter(_t(dest), _t(keys), None if first else _t(perm))
    _eq(want_perm, got[0])
    _eq(want_keys, got[1])


@pytest.mark.parametrize("num_partitions", [60, 257, (1 << 18) + 1])
def test_partition_plan_gathers_nothing_through_its_permutation(num_partitions):
    """Every pass moves its keys by the scatter that moves the permutation:
    a plan makes one ATen gather (`aten.index`) per carried column and no
    other, and the radix sort plan none."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    d = _t(np.random.default_rng(3).integers(0, num_partitions, 5003).astype(np.int32))
    for carry in ((), (d.long(),)):
        with Ops() as mode:
            trp.partition_plan(d, num_partitions, carry=carry)
        assert mode.names.count("aten.index") == len(carry), mode.names
        assert "aten.index_put_" in mode.names
    with Ops() as mode:
        trp.sort_plan_radix(d)
    assert "aten.index" not in mode.names


def test_partition_plan_default_arm_is_device_resolved(monkeypatch):
    d = _t(np.random.default_rng(0).integers(0, 9, 100).astype(np.int32))
    monkeypatch.delenv(tops.PARTITION_PLAN_ENV, raising=False)
    assert tops.partition_plan_impl() is None
    from repro_torch.core import primitives as tprim

    perm, off, sz = tprim.plan_partition_permutation(d, 9)  # CPU tensor -> torch arm
    _eq(np.argsort(d.numpy(), kind="stable").astype(np.int32), perm)
    monkeypatch.setenv(tops.PARTITION_PLAN_ENV, "pallas")
    with pytest.raises(ValueError, match="REPRO_PARTITION_PLAN_IMPL"):
        tprim.plan_partition_permutation(d, 9)


def test_apply_partition_matches_jax():
    rng = np.random.default_rng(5)
    d = rng.integers(0, 7, 3000).astype(np.int32)
    dest = np.asarray(jops._partition_ranks_xla(jnp.asarray(d), 7)[0])
    vals = rng.normal(size=3000).astype(np.float32)
    (a,) = jops.apply_partition(jnp.asarray(dest), jnp.asarray(vals))
    (b,) = tops.apply_partition(_t(dest), _t(vals))
    _eq(a, b)


# ---------------------------------------------------------------------------
# hash probe
# ---------------------------------------------------------------------------
def _probe_inputs(seed=0, nR=1500, nS=4000, p_bits=5, cap=256):
    """Partitioned build/probe sides from the port's planner; a fifth of the
    probe keys have no partner and a few are sentinels. Returns (kr, off_r,
    sz_r, ks, off_s, sz_s) for the P real partitions."""
    rng = np.random.default_rng(seed)
    P = 1 << p_bits
    rkeys = rng.permutation(50_000)[:nR].astype(np.int32)
    skeys = rng.choice(rkeys, nS).astype(np.int32)
    miss = rng.random(nS) < 0.2
    skeys[miss] = rng.integers(60_000, 70_000, int(miss.sum()))
    skeys[::97] = -1
    dig_r = thj._digits(_t(rkeys), p_bits, True)
    dig_s = thj._digits(_t(skeys), p_bits, True)
    perm_r, _, off_r, sz_r = tops.partition_plan(dig_r, P + 1, impl="torch")
    perm_s, _, off_s, sz_s = tops.partition_plan(dig_s, P + 1, impl="torch")
    assert int(sz_r[:P].max()) <= cap
    return _t(rkeys)[perm_r], off_r[:P], sz_r[:P], _t(skeys)[perm_s], off_s[:P], sz_s[:P]


def _jax_probe_arms(kr, off_r, sz_r, ks, off_s, sz_s, cap):
    """The JAX package's `ops.hash_probe` on the same partitioned columns,
    its bkeys from its own `build_blocks`: {"xla": (vid, hit), "pallas":
    (vid, hit)}. The pallas arm runs the Pallas kernel in interpret mode; at
    build blocks wider than 256 keys it is called directly on 256-row probe
    sub-blocks (the arm's own capS = capR would compare 12288 x 12288
    matrices in the interpreter), and its results are put back in row order
    as the arm does. An empty probe column has no pallas entry: the JAX
    layout cannot take one (`jnp.take` from an empty axis), and the arm
    degrades to the xla arm there."""
    j = [jnp.asarray(x.numpy()) for x in (kr, off_r, sz_r, ks, off_s, sz_s)]
    bkeys = jhj.build_blocks(j[0], j[1], j[2], cap)[0]
    out = {"xla": jops.hash_probe(bkeys, j[1], j[3], j[4], j[5], "xla")}
    if ks.shape[0] == 0:
        return out
    if cap <= 256:
        out["pallas"] = jops.hash_probe(bkeys, j[1], j[3], j[4], j[5], "pallas")
        return out
    cap_s, n = 256, ks.shape[0]
    pk, part, src = layout_probe_blocks(j[3], j[4], j[5], cap_s, -(-n // cap_s) + off_r.shape[0])
    vid, hit = hash_probe_pallas(bkeys, j[1], pk, part, interpret=True)
    src, vid, hit = (np.asarray(x).reshape(-1) for x in (src, vid, hit))
    v, h = np.full(n, -1, np.int32), np.zeros(n, bool)
    v[src[src >= 0]], h[src[src >= 0]] = vid[src >= 0], hit[src >= 0]
    out["pallas"] = (v, h)
    return out


def _check_probe_arms(arms, vid, hit):
    """Hits equal both JAX arms'; vid equals the pallas arm's everywhere (-1
    on a miss, as the kernel gives) and the xla arm's on the hits (its plain
    probe gives off_r[part] on a miss)."""
    h = hit.numpy()
    for arm, (jvid, jhit) in arms.items():
        np.testing.assert_array_equal(np.asarray(jhit), h, err_msg=arm)
        jvid = np.asarray(jvid)
        if arm == "xla":
            jvid = np.where(h, jvid, -1)
        np.testing.assert_array_equal(jvid, vid.numpy(), err_msg=arm)


def test_hash_probe_matches_pallas_arm():
    args = _probe_inputs()
    arms = _jax_probe_arms(*args, 256)
    vid, hit = tops.hash_probe(*args, 256)  # CPU -> plain arm
    assert vid.dtype == torch.int32 and hit.dtype == torch.bool
    _check_probe_arms(arms, vid, hit)
    assert 0 < int(hit.sum()) < args[3].shape[0]


def test_hash_probe_blocks_match_pallas_kernel():
    """The probe kernel's plain version (kernels/hash_probe.hash_probe, which
    reads the partitioned columns) against the Pallas kernel itself on the
    JAX package's padded layout, put back in row order; the layout the
    group-join's probe_agg still reads equals the JAX one."""
    kr, off_r, sz_r, ks, off_s, sz_s = _probe_inputs(seed=1)
    cap = 256
    max_blocks = -(-ks.shape[0] // cap) + off_r.shape[0]
    jlay = layout_probe_blocks(*[jnp.asarray(x.numpy()) for x in (ks, off_s, sz_s)], cap,
                               max_blocks)
    lay = thp.layout_probe_blocks(ks, off_s, sz_s, cap, max_blocks)
    for a, b in zip(jlay, lay):
        _eq(a, b)
    bkeys = jhj.build_blocks(*[jnp.asarray(x.numpy()) for x in (kr, off_r, sz_r)], cap)[0]
    jvid, jhit = hash_probe_pallas(bkeys, jnp.asarray(off_r.numpy()), jlay[0], jlay[1],
                                   interpret=True)
    src = np.asarray(jlay[2]).reshape(-1)
    vid, hit = thp.hash_probe(kr, off_r, sz_r, ks, off_s, sz_s, cap)  # the plain version
    np.testing.assert_array_equal(vid.numpy()[src[src >= 0]], np.asarray(jvid).reshape(-1)[src >= 0])
    np.testing.assert_array_equal(hit.numpy()[src[src >= 0]],
                                  np.asarray(jhit).reshape(-1)[src >= 0] == 1)
    # rows in no sub-block are the sentinel partition's: misses
    rest = np.setdiff1d(np.arange(ks.shape[0]), src[src >= 0])
    assert rest.size and bool((vid.numpy()[rest] == -1).all()) and not hit.numpy()[rest].any()


@pytest.mark.parametrize("cap", PROBE_CAPS)
@pytest.mark.parametrize("case", PROBE_EDGES)
def test_hash_probe_edge_cases_match_jax_arms(case, cap):
    """Every edge case of the card tests (overflowing and duplicate build
    keys, empty partitions, sentinels, P = 1, an empty probe side, all
    misses, full blocks) at build blocks of 1, 256 and 12288 keys: the
    port's plain arm against the JAX package's xla and pallas arms,
    integers exact."""
    args = [_t(a) for a in _probe_edge(case, cap)]
    vid, hit = tops.hash_probe(*args, cap)
    assert vid.dtype == torch.int32 and hit.dtype == torch.bool
    _check_probe_arms(_jax_probe_arms(*args, cap), vid, hit)


# ---------------------------------------------------------------------------
# clustered gather
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_clustered_gather_matches_pallas_arm(dtype):
    rng = np.random.default_rng(2)
    n = 3000  # two indices per source row keep each tile inside its 2W window
    src = (rng.integers(-(1 << 31), (1 << 31) - 1, n) if dtype == np.int32
           else rng.normal(size=n)).astype(dtype)
    idx = np.sort(rng.integers(0, n, 6000)).astype(np.int32)
    idx[-100:] = -1  # invalid tail, as a compacted join output has
    a = jops.clustered_gather(jnp.asarray(src), jnp.asarray(idx), "pallas",
                              window_rows=512, tile=512)
    _eq(a, tops.clustered_gather(_t(src), _t(idx)))


def test_clustered_gather_any_index():
    """Unclustered, 8-byte and out-of-range indices: the port's gather is
    right for any index, as the JAX auto arm's fallback is."""
    rng = np.random.default_rng(4)
    src = rng.normal(size=4096).astype(np.float32)
    idx = rng.permutation(4096).astype(np.int32)
    _eq(jops.clustered_gather(jnp.asarray(src), jnp.asarray(idx), "auto", window_rows=256,
                              tile=256), tops.clustered_gather(_t(src), _t(idx)))
    src64 = rng.integers(-(1 << 62), 1 << 62, 1000)
    idx = np.array([-1, 0, 999, 1000, 5000, 3], np.int32)
    want = np.where(idx >= 0, src64[np.clip(idx, 0, 999)], 0)
    np.testing.assert_array_equal(tops.clustered_gather(_t(src64), _t(idx)).numpy(), want)


# the Pallas kernels' geometry for the edge cases, interpreted on the CPU: a
# 2W window of W rows, tiles of 256 (the port's smallest tile), and inputs
# small enough to interpret. The lower bound's window holds the spans around
# the port's ring of 8192 int32 keys; the gather's holds every source row of
# the cases at most 5000 rows long, so that unclustered and clipped indices
# fit it.
EDGE_PALLAS = dict(window_rows=8192, tile=256)
EDGE_GATHER_PALLAS = dict(window_rows=8192, tile=256)
EDGE_PALLAS_MAX = 20_000


@pytest.mark.parametrize("case", GATHER_EDGES)
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
def test_clustered_gather_edge_cases_match_pallas_kernel(case, dtype):
    """The card tests' edge cases on the CPU: the plain version (the wrapper's
    CPU arm) against numpy always, and against the Pallas kernel in interpret
    mode where it takes the shape: 4-byte elements (the reference runs with
    x64 off), at least one index, and every tile inside the window the
    reference's auto arm picks for it."""
    src, idx, off = _gather_edge(case, dtype)
    src, idx = src[off:], idx[off:]
    got = tops.clustered_gather(_t(src), _t(idx))
    np.testing.assert_array_equal(got.numpy(), _gather_numpy(src, idx))
    np.testing.assert_array_equal(tgather.clustered_gather(_t(src), _t(idx)).numpy(),
                                  got.numpy())
    w, tile = EDGE_GATHER_PALLAS["window_rows"], EDGE_GATHER_PALLAS["tile"]
    safe = np.clip(idx, 0, src.shape[0] - 1)
    win = safe[::tile] // w
    padded = np.pad(safe, (0, -len(safe) % tile)).reshape(-1, tile)
    fits = len(idx) > 0 and bool(((padded.max(1) < (win + 2) * w)
                                  & (padded.min(1) >= win * w)).all())
    if np.dtype(dtype).itemsize == 4 and fits and len(idx) <= EDGE_PALLAS_MAX:
        want = gather_windowed_pallas(jnp.asarray(src), jnp.asarray(safe), jnp.asarray(win),
                                      interpret=True, **EDGE_GATHER_PALLAS)
        _eq(jnp.where(jnp.asarray(idx) >= 0, want, 0), got)


# ---------------------------------------------------------------------------
# fused probe + aggregate (group-join)
# ---------------------------------------------------------------------------
# float32 sums of at most capS values of N(0, 1) in another order (one-hot
# matmuls in JAX, row order in the port): both within a few ulp of sums of
# magnitude < 50
SUM_TOL = dict(rtol=1e-5, atol=1e-4)
COL_SIDES = {
    "probe_and_build": (("probe", 1), ("build", 0), ("probe", 0), ("build", 1)),
    "build_only": (("build", 1),),
    "count_only": (),
}


def _probe_agg_inputs(seed, B=14, P=6, cap=32):
    """Sub-blocks of probe keys against build blocks of unique keys: about
    half the keys match, a fifth are sentinels; sub-block 2 is all padding
    and sub-block 5 misses every key. Group keys come from a small range so
    that slots own several rows."""
    rng = np.random.default_rng(seed)
    bkeys = np.full((P, cap), -1, np.int32)
    for p in range(P):
        nb = int(rng.integers(1, cap + 1))
        bkeys[p, :nb] = rng.choice(10_000, nb, replace=False)
    part = rng.integers(0, P, B).astype(np.int32)
    probe = rng.integers(10_000, 20_000, (B, cap)).astype(np.int32)  # misses
    hit = rng.random((B, cap)) < 0.5
    for b in range(B):
        live = bkeys[part[b]][bkeys[part[b]] >= 0]
        probe[b, hit[b]] = rng.choice(live, int(hit[b].sum()))
    probe[rng.random((B, cap)) < 0.2] = -1
    probe[2] = -1
    probe[5] = rng.integers(10_000, 20_000, cap)
    gk = rng.integers(0, 7, (B, cap)).astype(np.int32)
    bvals = rng.normal(size=(P, 2, cap)).astype(np.float32)
    pv = rng.normal(size=(B, 2, cap)).astype(np.float32)
    return bkeys, bvals, probe, gk, pv, part


@pytest.mark.parametrize("cap", [32, 256])
@pytest.mark.parametrize("sides", list(COL_SIDES))
def test_probe_agg_blocks_match_pallas_kernel(sides, cap):
    """The kernel's plain version against the Pallas kernel in interpret
    mode: keys and counts exactly, float32 sums to SUM_TOL. For count only,
    the JAX kernel is fed one dummy column (as its ops layer does) and the
    port none."""
    bkeys, bvals, probe, gk, pv, part = _probe_agg_inputs(cap, cap=cap)
    col_sides = COL_SIDES[sides]
    jk, js, jc = probe_agg_pallas(*map(jnp.asarray, (bkeys, bvals, probe, gk, pv, part)),
                                  col_sides=col_sides or (("probe", 0),), interpret=True)
    pk, ps, pc = thp.probe_agg(*map(_t, (bkeys, bvals, probe, gk, pv, part)), col_sides)
    assert pk.dtype == torch.int32 and ps.dtype == torch.float32 and pc.dtype == torch.int32
    assert ps.shape == (probe.shape[0], len(col_sides), cap)
    _eq(jk, pk)
    _eq(jc, pc)
    if col_sides:
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), **SUM_TOL)
    assert int(pc[2].sum()) == 0 and int(pc[5].sum()) == 0  # all padding, all misses
    assert bool((pk[2] == -1).all()) and bool((pk[5] == -1).all())
    assert int(pc.sum()) > 0 and int((pc > 1).sum()) > 0  # slots own several rows


def test_probe_agg_blocks_int64_group_keys():
    """int64 group keys (beyond the JAX package's 32-bit integers) give the
    same slots, counts and sums as the same keys in int32, shifted."""
    bkeys, bvals, probe, gk, pv, part = _probe_agg_inputs(7)
    sides = COL_SIDES["probe_and_build"]
    a = thp.probe_agg(*map(_t, (bkeys, bvals, probe, gk, pv, part)), sides)
    gk64 = gk.astype(np.int64) + (1 << 40)
    b = thp.probe_agg(*map(_t, (bkeys, bvals, probe, gk64, pv, part)), sides)
    assert b[0].dtype == torch.int64
    k32 = a[0].numpy().astype(np.int64)
    _eq(np.where(k32 >= 0, k32 + (1 << 40), -1), b[0])
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


# the edge cases the card tests hold the redesigned kernel to
# (tests/test_torch_cuda.py), on the plain version against the Pallas kernel
EDGE_CASES = [c for c, k in PROBE_AGG_EDGES if k == np.int32] + ["low32_agree"]


@pytest.mark.parametrize("cap", [32, 256, 100])
@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("sides", ["count_only", "probe_and_build"])
def test_probe_agg_blocks_edge_cases_match_pallas_kernel(case, cap, sides):
    """Every row its own group, one group, build keys held twice, int64 keys
    equal in their low word, all-miss and all-padding sub-blocks. The JAX
    package's integers are 32-bit, so int64 group keys reach it as their
    ranks (slots depend only on key equality) and its keys are mapped back.
    Keys and counts exactly, float32 sums to SUM_TOL."""
    key_dtype = np.int64 if case == "low32_agree" else np.int32
    bkeys, bvals, probe, gk, pv, part = _probe_agg_edge(np.random.default_rng(cap), case, cap,
                                                        key_dtype)
    uniq, ids = np.unique(gk, return_inverse=True)
    jgk = np.where(gk == -1, -1, ids.reshape(gk.shape)).astype(np.int32)
    col_sides = COL_SIDES[sides]
    jk, js, jc = probe_agg_pallas(*map(jnp.asarray, (bkeys, bvals, probe, jgk, pv, part)),
                                  col_sides=col_sides or (("probe", 0),), interpret=True)
    pk, ps, pc = thp.probe_agg(*map(_t, (bkeys, bvals, probe, gk, pv, part)), col_sides)
    assert pk.dtype == torch.from_numpy(gk).dtype
    jk = np.asarray(jk)
    _eq(np.where(jk >= 0, uniq[np.maximum(jk, 0)], -1).astype(key_dtype), pk)
    _eq(jc, pc)
    if col_sides:
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), **SUM_TOL)
    if case == "miss_and_padding":
        assert int(pc.sum()) == 0
    else:  # every row matches
        assert int(pc.sum()) == probe.size


# ---------------------------------------------------------------------------
# per-tile segmented sums
# ---------------------------------------------------------------------------
def _sorted_keys(seed, n):
    """Key-sorted rows: a few sentinel rows first (they sort before every
    valid key), runs of 1-11 rows, and one run of 300 rows across tile
    edges."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 12, max(n, 4))
    lengths[3] = 300
    keys = np.repeat(np.arange(lengths.shape[0], dtype=np.int32) * 3, lengths)[:n]
    keys[:5] = -1
    return keys, rng.normal(size=n).astype(np.float32)


def _live(jax_out):
    """The live slots of the reference's slot layout, in slot order: the
    port's compact layout."""
    jk, js, jc = (np.asarray(a) for a in jax_out)
    live = jk != -1
    return jk[live], js[live], jc[live]


@pytest.mark.parametrize("n,tile", [(1, 256), (1000, 256), (4096, 256), (777, 64)])
def test_segsum_partials_match_pallas_kernel(n, tile):
    """The port's compact partials are the reference's live slots in slot
    order: keys and counts exactly, sums to SUM_TOL."""
    keys, vals = _sorted_keys(n, n)
    jk, js, jc = _live(segsum_partials_pallas(jnp.asarray(keys), jnp.asarray(vals), tile=tile,
                                              interpret=True))
    pk, ps, pc = tseg.segsum_partials(_t(keys), _t(vals), tile)  # the plain version
    assert pk.shape == ps.shape == pc.shape == jk.shape
    assert pc.dtype == torch.int32 and ps.dtype == torch.float32
    _eq(jk, pk)
    _eq(jc, pc)
    np.testing.assert_allclose(ps.numpy(), js, **SUM_TOL)
    assert int(pc.sum()) == int((keys != -1).sum())


def test_segsum_partials_int64_keys_and_equal_tile():
    """A tile of 256 equal keys is one partial; int64 keys keep their type."""
    keys = np.r_[np.full(256, 5), np.full(300, 1 << 40), [(1 << 40) + 1]].astype(np.int64)
    vals = np.ones(keys.shape[0], np.float32)
    pk, ps, pc = tref.segsum_partials(_t(keys), _t(vals), 256)
    assert pk.dtype == torch.int64
    _eq(np.array([5, 1 << 40, 1 << 40, (1 << 40) + 1]), pk)
    _eq(np.array([256, 256, 44, 1], np.int32), pc)
    _eq(np.array([256, 256, 44, 1], np.float32), ps)


def _segsum_edge(case):
    """(keys, values, tile) of an edge case: offsets carried over many
    chunks, one key over 50 tiles, sentinel rows only, negative keys that
    are not the sentinel before the sentinel rows."""
    rng = np.random.default_rng(len(case))
    if case == "many_chunks":
        keys, vals = _sorted_keys(5, 200_000)
        return keys, vals, 64
    if case == "one_key_50_tiles":
        keys = np.r_[np.full(3, 2), np.full(50 * 256, 7), [9, 9]].astype(np.int32)
    elif case == "sentinels_only":
        keys = np.full(1000, -1, np.int32)
    else:  # negative_keys
        keys = np.r_[np.full(300, -9), np.full(5, -5), np.full(40, -1),
                     np.repeat(np.arange(200), 3)].astype(np.int32)
    return keys, rng.normal(size=keys.shape[0]).astype(np.float32), 256


@pytest.mark.parametrize("case", ["many_chunks", "one_key_50_tiles", "sentinels_only",
                                  "negative_keys"])
def test_segsum_partials_edge_cases_match_pallas_kernel(case):
    keys, vals, tile = _segsum_edge(case)
    jk, js, jc = _live(segsum_partials_pallas(jnp.asarray(keys), jnp.asarray(vals), tile=tile,
                                              interpret=True))
    pk, ps, pc = tseg.segsum_partials(_t(keys), _t(vals), tile)
    _eq(jk, pk)
    _eq(jc, pc)
    np.testing.assert_allclose(ps.numpy(), js, **SUM_TOL)
    if case == "sentinels_only":
        assert pk.shape == (0,)
    if case == "one_key_50_tiles":
        assert pc.tolist() == [3] + [253] + [256] * 49 + [3, 2]


def test_segsum_partials_empty():
    """No rows, no partials (the reference cannot lay out zero tiles)."""
    for dtype in (torch.int32, torch.int64):
        pk, ps, pc = tseg.segsum_partials(torch.zeros(0, dtype=dtype), torch.zeros(0), 256)
        assert pk.shape == ps.shape == pc.shape == (0,) and pk.dtype == dtype
    k, s, c = tops.groupby_sorted_sum(torch.zeros(0, dtype=torch.int32), torch.zeros(0), 8)
    assert k.tolist() == [-1] * 8 and s.tolist() == [0.0] * 8 and int(c) == 0


@pytest.mark.parametrize("keys", [[3, 2], [0, 0, 5, 4, 9], [-1, 4, -1], list(range(600)) + [7]])
def test_segsum_partials_reject_unsorted_keys(keys):
    """Unsorted rows raise: the reference re-sorts its partials and sums them
    by key anyway; the port's combine does not sort, so it refuses them."""
    k = torch.tensor(keys, dtype=torch.int32)
    v = torch.ones(k.shape[0])
    with pytest.raises(ValueError, match="not sorted"):
        tseg.segsum_partials(k, v)
    with pytest.raises(ValueError, match="not sorted"):
        tops.groupby_sorted_sum(k, v, 16)


def _groupjoin_inputs(seed, match_ratio=0.8, p_bits=4, cap=256):
    """Partitioned build and probe sides of a small pk_fk join from the
    port's planner (which equals the JAX one), with two probe value columns,
    two build value columns and a probe-side group key of a few hundred
    values."""
    rng = np.random.default_rng(seed)
    P = 1 << p_bits
    n_r, n_s = 900, 3000
    rkeys = rng.permutation(5000)[:n_r].astype(np.int32)
    skeys = rng.choice(rkeys, n_s).astype(np.int32)
    miss = rng.random(n_s) > match_ratio
    skeys[miss] = rng.integers(6000, 9000, int(miss.sum()))
    skeys[::53] = -1
    perm_r, _, off_r, sz_r = tops.partition_plan(thj._digits(_t(rkeys), p_bits, True), P + 1,
                                                 impl="torch")
    perm_s, _, off_s, sz_s = tops.partition_plan(thj._digits(_t(skeys), p_bits, True), P + 1,
                                                 impl="torch")
    bkeys, _, _ = thj.build_blocks(_t(rkeys)[perm_r], off_r[:P], sz_r[:P], cap)
    bv = _t(rng.normal(size=(2, n_r)).astype(np.float32))[:, perm_r]
    bvals = torch.stack([thj.blocked_partitions(c, off_r[:P], sz_r[:P], cap, 0.0)[0]
                         for c in bv], dim=1)
    gk = _t(rng.integers(0, 400, n_s).astype(np.int32))[perm_s]
    pv = _t(rng.normal(size=(2, n_s)).astype(np.float32))[:, perm_s]
    return dict(bkeys=bkeys, bvals=bvals, off_r=off_r[:P], probe_keys_part=_t(skeys)[perm_s],
                gk_part=gk, pv_part=pv, probe_off=off_s[:P], probe_sz=sz_s[:P])


@pytest.mark.parametrize("sides", list(COL_SIDES))
def test_groupjoin_probe_agg_matches_jax_arms(sides):
    """The port's one arm (layout, the kernel's plain version on the CPU,
    combine) against the JAX xla and pallas arms: keys, counts and valid
    counts exactly, sums to SUM_TOL."""
    a = _groupjoin_inputs(11)
    if sides == "count_only":
        a["bvals"] = a["pv_part"] = None
    col_sides = COL_SIDES[sides]
    G = 300  # fewer than the groups present: the overflow is dropped alike
    j = {k: None if v is None else jnp.asarray(v.numpy()) for k, v in a.items()}
    keys, sums, counts, found = tops.groupjoin_probe_agg(
        *(v for k, v in a.items() if k != "off_r"), G, col_sides=col_sides)
    assert sums.shape == (len(col_sides), G) and sums.dtype == torch.float32
    for impl in ("xla", "pallas"):
        jkeys, jsums, jcounts, jfound = jops.groupjoin_probe_agg(*j.values(), G,
                                                                 col_sides=col_sides, impl=impl)
        _eq(jkeys, keys)
        _eq(jcounts, counts)
        assert int(jfound) == int(found) == G
        np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), **SUM_TOL)


@pytest.mark.parametrize("n,num_groups", [
    pytest.param(5000, 50, id="50"), pytest.param(5000, 400, id="400"),
    pytest.param(5000, 2000, id="5000-2000"), pytest.param(200_000, 1000, id="200000-1000"),
    pytest.param(200_000, 40_000, id="200000-40000")])
def test_groupby_sorted_sum_matches_jax(n, num_groups):
    """Runs that cross tile edges merge; groups past num_groups are dropped
    alike (the 200,000-row case has 783 tiles and about 33,000 runs)."""
    keys, vals = _sorted_keys(3, n)
    n_runs = np.unique(keys[keys >= 0]).shape[0]
    for impl in ("pallas", "xla"):
        jk, js, jc = jops.groupby_sorted_sum(jnp.asarray(keys), jnp.asarray(vals), num_groups,
                                             impl)
        k, s, c = tops.groupby_sorted_sum(_t(keys), _t(vals), num_groups)  # CPU: torch
        _eq(jk, k)
        assert int(jc) == int(c) == min(n_runs, num_groups)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **SUM_TOL)


def _runs(seed, num_groups=40):
    """Run starts over fewer than 1000 rows: the first rows outside every
    run (sentinel keys sort first), empty runs among the rest and at the
    end."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 40, num_groups)
    lengths[rng.random(num_groups) < 0.2] = 0
    lengths[-3:] = 0
    starts = 17 + np.r_[0, np.cumsum(lengths)]
    return _t(starts.astype(np.int32)), lengths


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64])
def test_run_sums_match_numpy(dtype):
    """Sums over each run in the column's dtype: integers exact (int32 sums
    wrap as numpy's do), floats to SUM_TOL; empty runs give 0."""
    starts, lengths = _runs(4)
    rng = np.random.default_rng(5)
    if dtype == np.float32:
        vals = rng.normal(size=1000).astype(dtype)
    else:
        vals = rng.integers(1 << 28, 1 << 30, 1000).astype(dtype)
    got = tops.RunSums(starts)(_t(vals))
    s = starts.numpy()
    want = np.array([vals[a:b].sum(dtype=dtype) for a, b in zip(s[:-1], s[1:])], dtype)
    assert got.dtype == _t(vals).dtype and got.shape == (lengths.shape[0],)
    if dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, **SUM_TOL)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[lengths == 0] == 0).all()
    for empty in (_t(np.zeros(1, np.int32)), _t(np.full(5, 17, np.int32))):
        assert (tops.RunSums(empty)(_t(vals)) == 0).all()


def test_run_sums_share_one_geometry(monkeypatch):
    """The float scan's geometry (one host sync and one binary search) is
    computed once for every column summed over the same runs, and not at
    all for integer columns."""
    calls = []
    real = torch.searchsorted

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(torch, "searchsorted", spy)
    starts, _ = _runs(6)
    run_sums = tops.RunSums(starts)
    rng = np.random.default_rng(7)
    run_sums(_t(rng.integers(0, 9, 1000).astype(np.int32)))
    assert not calls
    cols = [_t(rng.normal(size=1000).astype(np.float32)) for _ in range(3)]
    sums = [run_sums(c) for c in cols]
    assert len(calls) == 1
    for c, got in zip(cols, sums):
        torch.testing.assert_close(got, tops.RunSums(starts)(c), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# merge lower bound (SMJ match finding)
# ---------------------------------------------------------------------------
def _lb_case(case):
    """(build_sorted, probe_sorted) int32 for one case, at most 5K keys."""
    rng = np.random.default_rng(len(case))
    if case == "duplicates_and_sentinels":
        build = np.concatenate([np.full(300, -1), rng.integers(0, 400, 3000)])
        probe = np.concatenate([np.full(700, -1), rng.integers(-1, 420, 4300)])
    elif case == "past_the_end":  # a third of the probe keys lie past the last build key
        build = rng.integers(0, 20_000, 2500)
        probe = rng.integers(0, 30_000, 5000)
    else:  # "dense"
        build = rng.integers(0, 1 << 20, 5000)
        probe = rng.integers(0, 1 << 20, 4000)
    return np.sort(build).astype(np.int32), np.sort(probe).astype(np.int32)


@pytest.mark.parametrize("case", ["duplicates_and_sentinels", "past_the_end", "dense"])
def test_lower_bound_matches_pallas_kernel(case):
    """The port's plain version (its CPU arm) against the Pallas kernel in
    interpret mode, with the windows the reference's auto arm chooses, and
    against that arm (which checks the spans and may fall back)."""
    build, probe = _lb_case(case)
    jb, jp = jnp.asarray(build), jnp.asarray(probe)
    win = jnp.searchsorted(jb, jp[::1024]).astype(jnp.int32) // 1024
    want = lower_bound_windowed_pallas(jb, jp, win, interpret=True)
    _eq(want, tref.lower_bound(_t(build), _t(probe)))
    _eq(want, tmj.lower_bound(_t(build), _t(probe)))  # CPU tensors: the plain version
    _eq(jops.merge_lower_bound(jb, jp, "auto"), tops.merge_lower_bound(_t(build), _t(probe)))
    _eq(jref.upper_bound(jb, jp), tref.upper_bound(_t(build), _t(probe)))
    assert tops.merge_lower_bound(_t(build), _t(probe)).dtype == torch.int32


@pytest.mark.parametrize("case", LB_EDGES)
@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_lower_bound_edge_cases_match_pallas_kernel(case, key_dtype):
    """The card tests' edge cases on the CPU: the plain version (the wrapper's
    CPU arm) against numpy always, and against the Pallas kernel in interpret
    mode where it takes the shape: int32 keys, a few tiles, and every bound
    of a tile inside the 2W window the reference's auto arm picks (the lower
    bound of the tile's first key, in units of W)."""
    build, probe = _lb_edge(case, key_dtype)
    got = tmj.lower_bound(_t(build), _t(probe))
    want = np.searchsorted(build, probe, "left")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.lower_bound(_t(build), _t(probe)).numpy(), want)
    w, tile = EDGE_PALLAS["window_rows"], EDGE_PALLAS["tile"]
    win = want[::tile] // w
    padded = np.pad(want, (0, -len(want) % tile), mode="edge").reshape(-1, tile)
    fits = bool(((padded >= (win * w)[:, None]) & (padded <= ((win + 2) * w)[:, None])).all())
    if key_dtype == np.int32 and fits and 0 < len(probe) <= EDGE_PALLAS_MAX and len(build):
        _eq(lower_bound_windowed_pallas(jnp.asarray(build), jnp.asarray(probe),
                                        jnp.asarray(win.astype(np.int32)), interpret=True,
                                        **EDGE_PALLAS), got)


@settings(max_examples=10, deadline=None)
@given(st.lists(st.integers(-1, 60), max_size=300), st.lists(st.integers(-1, 70), max_size=300))
def test_lower_bound_property(build, probe):
    b = np.sort(np.array(build, np.int32))
    p = np.sort(np.array(probe, np.int32))
    got = tops.merge_lower_bound(_t(b), _t(p), "torch")
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(b, p, "left"))


# ---------------------------------------------------------------------------
# global histogram
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,bins", [(1, 2), (1000, 16), (5000, 256), (4097, 257)])
def test_histogram_matches_pallas_kernel(n, bins):
    """Negative digits (PAD_DIGIT and below) and digits >= bins count
    nowhere, as in histogram_pallas."""
    d = np.random.default_rng(n).integers(-3, bins + 4, n).astype(np.int32)
    want = histogram_pallas(jnp.asarray(d), bins, interpret=True)
    _eq(want, thist.histogram(_t(d), bins))  # CPU tensors: the plain version
    _eq(want, tops.histogram(_t(d), bins))
    assert tops.histogram(_t(d), bins).dtype == torch.int32


def test_histogram_follows_the_kernel_not_the_reference_bincount():
    """The reference's two arms disagree on negative digits: jnp.bincount
    counts -1 in bin 0, the Pallas kernel counts it nowhere. The port
    follows the kernel."""
    d = np.array([-1, 0, 0, 3, 5], np.int32)
    np.testing.assert_array_equal(np.asarray(jref.histogram(jnp.asarray(d), 4)), [3, 0, 0, 1])
    _eq(histogram_pallas(jnp.asarray(d), 4, interpret=True), tops.histogram(_t(d), 4))
    assert tops.histogram(_t(d), 4).tolist() == [2, 0, 0, 1]


# ---------------------------------------------------------------------------
# sort plans and the remaining primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 1000, 5000])
def test_sort_plan_radix_matches_jax(n):
    k = np.random.default_rng(n).integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    k[::3] = np.random.default_rng(0).integers(-5, 5, k[::3].shape[0])  # duplicates, -1
    jk, jperm = sort_plan_radix(jnp.asarray(k), interpret=True)
    for sk, perm in (trp.sort_plan_radix(_t(k)), tops.sort_plan(_t(k)),
                     tprim.plan_sort_permutation(_t(k))):
        assert perm.dtype == torch.int32
        _eq(jk, sk)
        _eq(jperm, perm)
    with pytest.raises(TypeError, match="int32 keys"):
        trp.sort_plan_radix(_t(k.astype(np.int64)))


@pytest.mark.parametrize("num_partitions", [300, 1025])
@pytest.mark.parametrize("max_pass_bits", [1, 3, 8])
def test_partition_plan_max_pass_bits_matches_jax(num_partitions, max_pass_bits):
    """The port's one plan (8-bit passes on the card, one stable sort on the
    CPU), through every layer, against the JAX xla arm's multi-pass loop
    with capped passes, carry included."""
    rng = np.random.default_rng(max_pass_bits)
    d = rng.integers(0, num_partitions, 3000).astype(np.int32)
    c = rng.integers(-(1 << 30), 1 << 30, 3000).astype(np.int32)
    jperm, (jc,), joff, jsz = jops.partition_plan(jnp.asarray(d), num_partitions,
                                                  carry=(jnp.asarray(c),),
                                                  max_pass_bits=max_pass_bits, impl="xla")
    port = [tops.partition_plan(_t(d), num_partitions, carry=(_t(c),), impl="torch"),
            trp.partition_plan(_t(d), num_partitions, carry=(_t(c),)),
            tprim.plan_partition_permutation(_t(d), num_partitions, carry=(_t(c),))]
    for perm, (pc,), off, sz in port:
        for a, b in ((jperm, perm), (jc, pc), (joff, off), (jsz, sz)):
            _eq(a, b)


def test_sort_and_radix_primitives_match_jax():
    rng = np.random.default_rng(12)
    n = 2000
    k = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    k[::4] = rng.integers(0, 9, k[::4].shape[0])
    nonneg = rng.integers(0, 1 << 31, n).astype(np.int32)
    v = rng.normal(size=n).astype(np.float32)
    w = rng.integers(0, 99, n).astype(np.int32)
    for a, b in zip(jprim.sort_pairs(jnp.asarray(k), jnp.asarray(v), jnp.asarray(w)),
                    tprim.sort_pairs(_t(k), _t(v), _t(w))):
        _eq(a, b)
    _eq(jprim.sort_pairs(jnp.asarray(k)), tprim.sort_pairs(_t(k)))
    _eq(jprim.argsort_stable(jnp.asarray(k)), tprim.argsort_stable(_t(k)))
    assert tprim.argsort_stable(_t(k)).dtype == torch.int32
    for start, bits in ((0, 8), (8, 8), (24, 8), (28, 4), (3, 11), (0, 1)):
        _eq(jprim.radix_digits(jnp.asarray(k), start, bits), tprim.radix_digits(_t(k), start, bits))
    for a, b in zip(jprim.partition_permutation(jnp.asarray(w), 99),
                    tprim.plan_partition_permutation(_t(w), 99)):
        _eq(a, b)
    for a, b in zip(jprim.radix_partition(jnp.asarray(k), jnp.asarray(v), start_bit=4, num_bits=6),
                    tprim.radix_partition(_t(k), _t(v), start_bit=4, num_bits=6)):
        _eq(a, b)
    for total_bits in (10, 12):
        for a, b in zip(jprim.multi_pass_radix_partition(jnp.asarray(k), jnp.asarray(w),
                                                         total_bits=total_bits, start_bit=5),
                        tprim.multi_pass_radix_partition(_t(k), _t(w), total_bits=total_bits,
                                                         start_bit=5)):
            _eq(a, b)
    for bits in (1, 8, 9, 16, 31):
        assert jprim.num_radix_passes(bits) == tprim.num_radix_passes(bits)
    for a, b in zip(jprim.radix_sort_pairs(jnp.asarray(nonneg), jnp.asarray(v)),
                    tprim.radix_sort_pairs(_t(nonneg), _t(v))):
        _eq(a, b)
    _eq(jprim.radix_sort_pairs(jnp.asarray(nonneg)), tprim.radix_sort_pairs(_t(nonneg)))


def test_radix_digits_of_int64_keys_match_numpy():
    """The JAX package runs without 64-bit integers; the port's 8-byte keys
    are held against numpy's unsigned pattern."""
    k = np.random.default_rng(3).integers(-(1 << 63), (1 << 63) - 1, 500)
    u = k.view(np.uint64)
    for start, bits in ((0, 8), (56, 8), (60, 8), (33, 20), (63, 1)):
        want = ((u >> np.uint64(start)) & np.uint64((1 << bits) - 1)).astype(np.int32)
        np.testing.assert_array_equal(tprim.radix_digits(_t(k), start, bits).numpy(), want)


# ---------------------------------------------------------------------------
# arm selection
# ---------------------------------------------------------------------------
_I32 = torch.zeros(4, dtype=torch.int32)
_BK = torch.full((2, 4), -1, dtype=torch.int32)


@pytest.mark.parametrize("call,match", [
    (lambda: tops.partition_plan(_I32, 3, impl="cuda"), "needs CUDA tensors"),
    (lambda: tops.hash_probe(_I32, _I32[:2], _I32[:2], _I32, _I32[:2], _I32[:2], 4, "cuda"),
     "needs CUDA tensors"),
    (lambda: tops.clustered_gather(_I32, _I32, "cuda"), "needs CUDA tensors"),
    (lambda: thj.phj_join(TTable({"k": _I32}), TTable({"k": _I32}), probe_impl="cuda"),
     "needs CUDA tensors"),
    (lambda: tops.clustered_gather(_I32, _I32, "pallas"), "unknown impl"),
    (lambda: tops.groupjoin_probe_agg(_BK, None, _I32, _I32, None, _I32[:2], _I32[:2], 4,
                                      col_sides=(), impl="cuda"),
     "needs CUDA tensors"),
    (lambda: tops.merge_lower_bound(_I32, _I32, "cuda"), "needs CUDA tensors"),
    (lambda: tops.histogram(_I32, 4, "cuda"), "needs CUDA tensors"),
    (lambda: tops.histogram(_I32, 4, "pallas"), "unknown impl"),
], ids=["partition_plan", "hash_probe", "clustered_gather", "phj_join", "unknown",
        "groupjoin_probe_agg", "merge_lower_bound", "histogram", "histogram_unknown"])
def test_impl_selection_raises(call, match):
    """'cuda' on a CPU tensor raises instead of running the plain arm."""
    with pytest.raises(ValueError, match=match):
        call()
