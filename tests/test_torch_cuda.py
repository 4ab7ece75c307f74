"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs an NVIDIA GPU and skips elsewhere; the
file imports neither JAX nor the JAX package, so it runs where only the port
is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.core import hash_join as thj  # noqa: E402
from repro_torch.data import relgen  # noqa: E402
from repro_torch.kernels import gather as kgather  # noqa: E402
from repro_torch.kernels import hash_probe as kprobe  # noqa: E402
from repro_torch.kernels import histogram as khist  # noqa: E402
from repro_torch.kernels import merge_join as kmj  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import radix_partition as krp  # noqa: E402
from repro_torch.kernels import segsum as kseg  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("bins", [2, 256, 257, 1024])
def test_pass_kernels_equal_plain(dev, bins):
    rng = np.random.default_rng(bins)
    d = _on(dev, rng.integers(-1, bins, 300_001).astype(np.int32))  # -1 = pad
    before = ops.launch_counts()
    hist = krp.block_histograms(d, bins)
    assert torch.equal(hist, ref.block_histograms(d, bins, krp.TILE))
    base, _, _ = krp.tile_base(hist)
    assert torch.equal(krp.rank_with_base(d, base, bins), ref.partition_ranks(d, bins))
    after = ops.launch_counts()
    assert after["block_histograms"] == before["block_histograms"] + 1
    assert after["partition_ranks"] == before["partition_ranks"] + 1


@pytest.mark.parametrize("num_partitions", [7, 257, (1 << 18) + 1, (1 << 16) + 1])
def test_partition_plan_kernel_arm_equals_sort_arm(dev, num_partitions):
    rng = np.random.default_rng(num_partitions)
    d = _on(dev, rng.integers(0, num_partitions, 1_000_003).astype(np.int32))
    carry = _on(dev, rng.integers(-(1 << 40), 1 << 40, d.shape[0]))
    a = ops.partition_plan(d, num_partitions, carry=(carry,), impl="cuda")
    b = ops.partition_plan(d, num_partitions, carry=(carry,), impl="torch")
    for x, y in zip((a[0], a[1][0], a[2], a[3]), (b[0], b[1][0], b[2], b[3])):
        assert torch.equal(x, y)


def _probe_sides(dev, p_bits, n_r, n_s, seed, key_range=200_000):
    """Build and probe sides of a pk_fk join, partitioned by the card's
    plans: (kr, off_r, sz_r, ks, off_s, sz_s) for the P = 2^p_bits real
    partitions; an eighth of the probe keys are sentinels."""
    rng = np.random.default_rng(seed)
    P = 1 << p_bits
    rkeys = _on(dev, rng.permutation(key_range)[:n_r].astype(np.int32))
    skeys = rng.integers(0, key_range, n_s).astype(np.int32)
    skeys[::8] = -1
    skeys = _on(dev, skeys)
    perm_r, _, off_r, sz_r = ops.partition_plan(thj._digits(rkeys, p_bits, True), P + 1)
    perm_s, _, off_s, sz_s = ops.partition_plan(thj._digits(skeys, p_bits, True), P + 1)
    return rkeys[perm_r], off_r[:P], sz_r[:P], skeys[perm_s], off_s[:P], sz_s[:P]


def test_probe_kernel_equals_plain(dev):
    """The kernel on a planned join's partitioned columns against its plain
    version and the padded-block reference (`ref.hash_probe_blocks` over
    `build_blocks` and the per-row partitions), exactly; one launch a call."""
    cap = thj.BUILD_BLOCK
    kr, off_r, sz_r, ks, off_s, sz_s = _probe_sides(dev, 8, 20_000, 80_000, 2)
    assert int(sz_r.max()) <= cap
    before = ops.launch_counts()["hash_probe"]
    got = ops.hash_probe(kr, off_r, sz_r, ks, off_s, sz_s, cap, "cuda")
    assert ops.launch_counts()["hash_probe"] == before + 1
    plain = ops.hash_probe(kr, off_r, sz_r, ks, off_s, sz_s, cap, "torch")
    assert ops.launch_counts()["hash_probe"] == before + 1
    bkeys, _, _ = thj.build_blocks(kr, off_r, sz_r, cap)
    row = torch.arange(ks.shape[0], dtype=torch.int32, device=dev)
    part = (torch.searchsorted(off_s, row, right=True, out_int32=True) - 1).clamp(min=0)
    vid, hit = ref.hash_probe_blocks(bkeys, off_r, ks, part)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert torch.equal(got[0], vid) and torch.equal(got[1], hit.bool())
    assert 0 < int(got[1].sum()) < ks.shape[0]


# The probe's edge cases, each a small partitioned layout made with numpy:
# (kr, off_r, sz_r, ks, off_s, sz_s) int32, partitions in row order, the
# probe side followed by the sentinel partition's rows (KEY_SENTINEL keys)
# past partition P - 1. tests/test_torch_kernels.py holds the plain version
# against the JAX package on the same layouts.
PROBE_EDGES = ["plain", "overflow", "dup_build_keys", "empty_partitions", "sentinels",
               "one_partition", "empty_probe", "all_miss", "full_blocks"]
PROBE_CAPS = [1, 256, 12288]
_MISS = 1 << 22  # probe keys at or above this match no build key


def _probe_edge(case, cap, seed=0):
    rng = np.random.default_rng([seed, cap, PROBE_EDGES.index(case)])
    P = 1 if case == "one_partition" else 8
    sz_r = rng.integers(0, min(cap, 40) + 1, P)
    sz_s = rng.integers(0, 60, P)
    if case == "overflow":
        sz_r[1] = cap + 5  # only the first cap rows can match
    if case == "full_blocks":
        sz_r[:] = min(cap, 3000)
    if case == "empty_partitions":
        sz_r[[0, 3, 4]] = 0
        sz_s[[2, 3, 7]] = 0
    if case == "empty_probe":
        sz_s[:] = 0
    keys = rng.permutation(1 << 21)[:int(sz_r.sum())].astype(np.int32)
    off_r = np.concatenate([[0], np.cumsum(sz_r)[:-1]]).astype(np.int32)
    ks = []
    for p in range(P):
        part = keys[off_r[p]:off_r[p] + sz_r[p]]
        if case == "dup_build_keys" and part.shape[0] > 1:
            # a third of the rows repeat an earlier row's key: the first wins
            for i in range(1, part.shape[0]):
                if rng.random() < 0.33:
                    part[i] = part[rng.integers(0, i)]
        if case == "sentinels" and part.shape[0]:
            part[rng.random(part.shape[0]) < 0.2] = -1
        n = sz_s[p]
        if part.shape[0] and case != "all_miss":
            probe = rng.choice(part, n)
            if case == "overflow" and p == 1:
                # both rows kept in the block and rows past it
                probe[: n // 2] = rng.choice(part[:cap], n // 2)
                probe[n // 2:] = rng.choice(part[cap:], n - n // 2)
        else:
            probe = np.zeros(n, np.int32)
        probe[rng.random(n) < 0.3] = 0
        probe = np.where(probe == 0, rng.integers(_MISS, 2 * _MISS, n), probe)
        if case == "sentinels":
            probe[rng.random(n) < 0.1] = -1
        ks.append(probe.astype(np.int32))
    tail = 0 if case == "empty_probe" else 17 if case == "sentinels" else 5
    ks = np.concatenate(ks + [np.full(tail, -1, np.int32)])
    off_s = np.concatenate([[0], np.cumsum(sz_s)[:-1]]).astype(np.int32)
    return (keys, off_r, sz_r.astype(np.int32), ks, off_s, sz_s.astype(np.int32))


@pytest.mark.parametrize("cap", PROBE_CAPS + [32, 257])
@pytest.mark.parametrize("case", PROBE_EDGES)
def test_probe_kernel_edge_cases_equal_plain(dev, case, cap):
    """Every edge case on the warp tables (cap <= 256) and the block tables
    (257: wider than a warp's table; 12288: the widest block); one launch a
    call, none on an empty probe side."""
    args = [_on(dev, a) for a in _probe_edge(case, cap)]
    before = ops.launch_counts()["hash_probe"]
    vid, hit = ops.hash_probe(*args, cap, "cuda")
    assert ops.launch_counts()["hash_probe"] == before + (args[3].shape[0] > 0)
    pv, ph = ref.hash_probe(*args, cap)
    assert torch.equal(vid, pv) and torch.equal(hit, ph)
    if case == "all_miss":
        assert not bool(hit.any()) and bool((vid == -1).all())
    if case == "overflow":
        assert bool(hit.any()) and not bool(hit.all())


def test_probe_kernel_wide_partitions(dev):
    """Partitions far wider than a warp's table and than one block's
    threads: a few thousand build and probe rows each, duplicates included,
    at cap 2048 and 12288."""
    rng = np.random.default_rng(9)
    P = 6
    sz_r = np.array([3000, 0, 12288, 5000, 1, 2048], np.int32)
    keys = rng.integers(0, 30_000, int(sz_r.sum())).astype(np.int32)
    off_r = np.concatenate([[0], np.cumsum(sz_r)[:-1]]).astype(np.int32)
    sz_s = np.array([7000, 100, 20_000, 0, 3, 9000], np.int32)
    ks = rng.integers(-1, 40_000, int(sz_s.sum()) + 9).astype(np.int32)
    off_s = np.concatenate([[0], np.cumsum(sz_s)[:-1]]).astype(np.int32)
    args = [_on(dev, a) for a in (keys, off_r, sz_r, ks, off_s, sz_s)]
    for cap in (2048, 12288):
        vid, hit = ops.hash_probe(*args, cap, "cuda")
        pv, ph = ref.hash_probe(*args, cap)
        assert torch.equal(vid, pv) and torch.equal(hit, ph)


def test_probe_wrapper_rejects_what_the_kernel_does_not_take(dev):
    args = [_on(dev, a) for a in _probe_edge("plain", 256)]
    with pytest.raises(ValueError):
        kprobe.hash_probe(*args, 12289)
    with pytest.raises(ValueError):
        kprobe.hash_probe(*args, 0)
    with pytest.raises(TypeError):
        kprobe.hash_probe(args[0].long(), *args[1:], 256)
    with pytest.raises(ValueError):
        kprobe.hash_probe(*args[:2], args[2][:-1], *args[3:], 256)


def test_kernel_arms_raise_kernel_error_for_every_failure(dev):
    """Through `ops`, whatever a kernel arm raises on card tensors is a
    KernelError naming the kernel, the wrapper's own type kept as its cause,
    so the engine can never re-plan around a kernel that failed."""
    from repro_torch.kernels._build import KernelError

    args = [_on(dev, a) for a in _probe_edge("plain", 256)]
    i32 = torch.zeros(8, dtype=torch.int32, device=dev)
    unsorted = torch.tensor([3, 1, 2], dtype=torch.int32, device=dev)
    for name, call, cause in (
            ("hash_probe", lambda: ops.hash_probe(*args, 12289, "cuda"), ValueError),
            ("histogram", lambda: ops.histogram(i32, 0, impl="cuda"), ValueError),
            ("lower_bound", lambda: ops.merge_lower_bound(i32.long(), i32, impl="cuda"),
             TypeError),
            ("segsum_partials", lambda: ops.groupby_sorted_sum(unsorted, unsorted.float(), 4),
             ValueError)):
        with pytest.raises(KernelError, match=name) as err:
            call()
        assert isinstance(err.value.__cause__, cause), name


def test_phj_join_and_join_sequence_probe_arms_equal(dev, monkeypatch):
    """phj_join and a join sequence with the probe kernel against the same
    calls on the probe's plain arm (probe_impl='torch'; the sequence, which
    takes no probe_impl, through ops.hash_probe patched to that arm), row
    for row."""
    R, S, _ = relgen.generate_tpc("J2", scale=1 / 256, payload_bytes=8)
    Rt, St = T.table_from_numpy(R, device="cuda"), T.table_from_numpy(S, device="cuda")
    fact, dims, fks, dks = relgen.generate_star(200_000, 50_000, 3, seed=4)
    ft = T.table_from_numpy(fact, device="cuda")
    dt = [T.table_from_numpy(d, device="cuda") for d in dims]

    def run(arm):
        return [thj.phj_join(Rt, St, probe_impl=arm),
                T.join_sequence(ft, dt, fk_cols=fks, dim_keys=dks, algorithm="phj",
                                restore_order=True)]

    before = ops.launch_counts()["hash_probe"]
    kernel = run(None)
    assert ops.launch_counts()["hash_probe"] == before + 1 + 3
    probe = ops.hash_probe
    monkeypatch.setattr(ops, "hash_probe", lambda *a: probe(*a[:7], "torch"))
    plain = run("torch")
    assert ops.launch_counts()["hash_probe"] == before + 1 + 3
    for (a, ca), (b, cb) in zip(kernel, plain):
        assert int(ca) == int(cb) > 0
        for name in a.column_names:
            assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("dtype", [np.int64, np.float32, np.int32, np.float64])
def test_gather_kernel_equals_plain(dev, dtype):
    rng = np.random.default_rng(6)
    src = _on(dev, (rng.normal(size=5000) * 1e6).astype(dtype))
    idx = np.concatenate([np.sort(rng.integers(0, 5000, 20_000)), [-1, 4999, 7000, -5]])
    idx = _on(dev, idx.astype(np.int32))
    assert torch.equal(kgather.clustered_gather(src, idx), ref.clustered_gather(src, idx))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    with pytest.raises(TypeError):
        krp.block_histograms(torch.zeros(8, dtype=torch.int64, device=dev), 4)
    with pytest.raises(TypeError):
        kgather.clustered_gather(torch.zeros(8, dtype=torch.int16, device=dev),
                                 torch.zeros(8, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        krp.block_histograms(torch.zeros(8, dtype=torch.int32, device=dev), 1 << 12)


def test_j2_slice_on_card_equals_cpu(dev):
    """The slice at J2 scale 1/256 on the card (kernel arms) against the same
    query on the CPU (plain arms), row for row."""
    R, S, _ = relgen.generate_tpc("J2", scale=1 / 256, payload_bytes=8)
    aggs = {"s1": "sum", "r1": "max", "r2": "count"}
    out = {}
    for where in ("cpu", "cuda"):
        Rt, St = T.table_from_numpy(R, device=where), T.table_from_numpy(S, device=where)
        before = ops.launch_counts()
        J, jc = T.join(Rt, St, algorithm="phj", pattern="gftr")
        G, gc = T.group_aggregate(J, key="k", aggs=aggs, num_groups=R["k"].shape[0],
                                  strategy="partition")
        moved = {k: v - before[k] for k, v in ops.launch_counts().items()}
        if where == "cuda":
            assert all(moved[k] for k in ("block_histograms", "partition_ranks", "hash_probe",
                                          "clustered_gather"))
            assert moved["probe_agg"] == moved["segsum_partials"] == 0
        else:
            assert not any(moved.values())
        out[where] = (T.table_to_numpy(J), int(jc), T.table_to_numpy(G), int(gc))
    (j0, c0, g0, gc0), (j1, c1, g1, gc1) = out["cpu"], out["cuda"]
    assert c0 == c1 and gc0 == gc1
    for a, b in ((j0, j1), (g0, g1)):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# ---------------------------------------------------------------------------
# the group-join's fused probe + aggregate, and the per-tile segmented sums
# ---------------------------------------------------------------------------
# Keys, slots and counts must be equal. The kernels and their plain versions
# both add each slot's rows in row order in float32, so the sums agree to
# the last bit unless a compiler reorders an add; the stated tolerance is
# one ulp of sums below 2^10.
SUM_TOL = dict(rtol=0, atol=2 ** -13)


def _probe_agg_case(dev, rng, B, P, cap, key_dtype=np.int32, n_groups=7):
    """Sub-blocks of probe keys against build blocks of unique keys: half
    match, a fifth are sentinels; sub-block 1 is all padding, sub-block 2
    misses every key, and sub-block 3 matches every row with one group key
    (a tile of cap equal keys)."""
    bkeys = np.full((P, cap), -1, np.int32)
    for p in range(P):
        nb = int(rng.integers(1, cap + 1))
        bkeys[p, :nb] = rng.choice(1 << 20, nb, replace=False)
    part = rng.integers(0, P, B).astype(np.int32)
    probe = rng.integers(1 << 21, 1 << 22, (B, cap)).astype(np.int32)
    hit = rng.random((B, cap)) < 0.5
    hit[3] = True
    for b in range(B):
        live = bkeys[part[b]][bkeys[part[b]] >= 0]
        probe[b, hit[b]] = rng.choice(live, int(hit[b].sum()))
    probe[rng.random((B, cap)) < 0.2] = -1
    probe[1] = -1
    probe[2] = rng.integers(1 << 21, 1 << 22, cap)
    probe[3] = rng.choice(bkeys[part[3]][bkeys[part[3]] >= 0], cap)
    gk = rng.integers(0, n_groups, (B, cap)).astype(key_dtype)
    if key_dtype == np.int64:
        gk += 1 << 40
    gk[3] = gk[3, 0]
    bvals = rng.normal(size=(P, 2, cap)).astype(np.float32)
    pv = rng.normal(size=(B, 3, cap)).astype(np.float32)
    return tuple(_on(dev, a) for a in (bkeys, bvals, probe, gk, pv, part))


@pytest.mark.parametrize("cap", [256, 32, 512])
@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("col_sides", [(("probe", 2), ("build", 0), ("build", 1)),
                                       (("build", 1),), ()],
                         ids=["probe_and_build", "build_only", "count_only"])
def test_probe_agg_kernel_equals_plain(dev, cap, key_dtype, col_sides):
    args = _probe_agg_case(dev, np.random.default_rng(cap), 40, 9, cap, key_dtype)
    before = ops.launch_counts()["probe_agg"]
    pk, ps, pc = kprobe.probe_agg(*args, col_sides)
    assert ops.launch_counts()["probe_agg"] == before + 1
    rk, rs, rc = ref.probe_agg_blocks(*args, col_sides)
    assert pk.dtype == rk.dtype == args[3].dtype
    assert torch.equal(pk, rk) and torch.equal(pc, rc)
    assert ps.shape == rs.shape == (40, len(col_sides), cap)
    torch.testing.assert_close(ps, rs, **SUM_TOL)
    assert int(pc[1].sum()) == int(pc[2].sum()) == 0  # all padding, all misses
    assert int(pc[3, 0]) == cap and int(pc[3, 1:].sum()) == 0  # one group owns the tile


def test_probe_agg_kernel_many_groups_per_tile(dev):
    """Wide group keys: most rows own their slot."""
    args = _probe_agg_case(dev, np.random.default_rng(1), 300, 64, 256, n_groups=1 << 30)
    out = kprobe.probe_agg(*args, (("probe", 0), ("build", 1)))
    want = ref.probe_agg_blocks(*args, (("probe", 0), ("build", 1)))
    assert torch.equal(out[0], want[0]) and torch.equal(out[2], want[2])
    torch.testing.assert_close(out[1], want[1], **SUM_TOL)


# Edge cases of the redesigned kernel (hash tables in shared memory, slots by
# atomicMin, rows ordered by a block scan): keys, counts and the float32 sums
# must equal the plain version's exactly, and a second launch must give the
# same bits.
PROBE_AGG_EDGES = [(case, key_dtype) for case in ("own_group", "one_group", "dup_build_key",
                                                  "miss_and_padding")
                   for key_dtype in (np.int32, np.int64)] + [("low32_agree", np.int64)]


def _probe_agg_edge(rng, case, cap, key_dtype, B=12, P=5):
    """(bkeys, bvals, probe, gk, pv, part) numpy arrays for one edge case:
    every row its own group; every row one group; build blocks that hold
    each key twice (the second copy with other values, so the first match
    must win); int64 group keys equal in their low 32 bits; sub-blocks all
    padding or all misses."""
    nb = max(1, cap // 2) if case == "dup_build_key" else cap
    bkeys = np.full((P, cap), -1, np.int32)
    for p in range(P):
        keys = rng.choice(1 << 20, nb, replace=False)
        bkeys[p, :nb] = keys
        if case == "dup_build_key":
            bkeys[p, nb:2 * nb] = rng.permutation(keys)[:cap - nb]
    part = rng.integers(0, P, B).astype(np.int32)
    probe = np.stack([rng.choice(bkeys[p][bkeys[p] >= 0], cap) for p in part]).astype(np.int32)
    if case == "own_group":
        gk = rng.permutation(B * cap).reshape(B, cap) + 3
    elif case == "one_group":
        gk = np.full((B, cap), 11)
    elif case == "low32_agree":
        gk = (rng.integers(0, 6, (B, cap)) << 32) + 5
    else:
        gk = rng.integers(0, 9, (B, cap))
    if case == "miss_and_padding":
        probe[::2] = -1
        probe[1::2] = rng.integers(1 << 21, 1 << 22, (B // 2, cap))
    gk = gk.astype(key_dtype)
    if key_dtype == np.int64 and case != "low32_agree":
        gk += 1 << 40
    bvals = rng.normal(size=(P, 2, cap)).astype(np.float32)
    pv = rng.normal(size=(B, 2, cap)).astype(np.float32)
    return bkeys, bvals, probe, gk, pv, part


@pytest.mark.parametrize("cap", [32, 256, 100])
@pytest.mark.parametrize("case,key_dtype", PROBE_AGG_EDGES,
                         ids=[f"{c}-{np.dtype(k).name}" for c, k in PROBE_AGG_EDGES])
@pytest.mark.parametrize("col_sides", [(), (("probe", 1), ("build", 0), ("build", 1))],
                         ids=["count_only", "three_columns"])
def test_probe_agg_kernel_edge_cases_equal_plain_exactly(dev, cap, case, key_dtype, col_sides):
    args = tuple(_on(dev, a) for a in _probe_agg_edge(np.random.default_rng(cap), case, cap,
                                                      key_dtype))
    before = ops.launch_counts()["probe_agg"]
    got = kprobe.probe_agg(*args, col_sides)
    again = kprobe.probe_agg(*args, col_sides)
    assert ops.launch_counts()["probe_agg"] == before + 2
    want = ref.probe_agg_blocks(*args, col_sides)
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, a)
    pc = got[2]
    live = int((args[2] != -1).sum())
    if case == "miss_and_padding":
        assert int(pc.sum()) == 0 and bool((got[0] == -1).all())
    else:  # every row matches
        assert int(pc.sum()) == live
    if case == "own_group":
        assert bool((pc == 1).all())
    if case == "one_group":
        assert bool((pc[:, 0] == cap).all()) and int(pc[:, 1:].sum()) == 0
    if case == "low32_agree":  # six keys of one low word: six slots a sub-block at most
        assert bool(((pc > 0).sum(dim=1) <= 6).all()) and int((pc > 0).sum()) > pc.shape[0]


def _rank_case(rng, case):
    """(digits, num_bins) for one edge case of the rank kernel."""
    if case == "all_equal":
        return np.full(5000, 7, np.int32), 256
    if case == "only_pads":  # negative, and past the last bin
        return np.where(rng.random(3000) < 0.5, -1, 300).astype(np.int32), 256
    if case == "below_one_tile":
        return rng.integers(-1, 256, 333).astype(np.int32), 256
    if case == "one_digit":
        return np.array([3], np.int32), 8
    if case == "ragged_tail":  # 3 tiles and 5 digits: the tail takes 4-byte copies
        return rng.integers(-1, 256, 3 * krp.TILE + 5).astype(np.int32), 256
    if case == "skewed":  # half the digits 0, the rest geometric
        d = np.minimum(rng.geometric(0.05, 200_003) - 1, 255)
        d[rng.random(d.shape[0]) < 0.5] = 0
        return d.astype(np.int32), 256
    bins = int(case.split("_")[1])  # "bins_<n>"
    return rng.integers(-1, bins + 2, 100_000).astype(np.int32), bins


RANK_CASES = ["all_equal", "only_pads", "below_one_tile", "one_digit", "ragged_tail", "skewed",
              "bins_1", "bins_8", "bins_257", "bins_1024"]


@pytest.mark.parametrize("case", RANK_CASES)
def test_rank_kernel_edge_cases_equal_plain_exactly(dev, case):
    """The digits also as a view that starts one element in, off the 16-byte
    boundary (4-byte copies)."""
    d_np, bins = _rank_case(np.random.default_rng(len(case)), case)
    whole = _on(dev, np.concatenate([[0], d_np]).astype(np.int32))
    for d in (_on(dev, d_np), whole[1:]):
        base, _, _ = krp.tile_base(ref.block_histograms(d, bins, krp.TILE))
        before = ops.launch_counts()["partition_ranks"]
        got = krp.rank_with_base(d, base, bins)
        again = krp.rank_with_base(d, base, bins)
        assert ops.launch_counts()["partition_ranks"] == before + 2
        assert torch.equal(got, ref.partition_ranks(d, bins)) and torch.equal(got, again)


def _sorted_case(rng, n, key_dtype=np.int32):
    """Key-sorted rows: sentinel rows first, runs of 1-20 rows, one run of
    256 rows on a tile edge, one of 700 across tiles, and a ragged tail."""
    lengths = rng.integers(1, 21, max(n, 8))
    lengths[2], lengths[5] = 256, 700
    keys = np.repeat(np.arange(lengths.shape[0], dtype=np.int64) * 5, lengths)[:n]
    keys[:3] = -1
    if key_dtype == np.int64:
        keys = np.where(keys >= 0, keys + (1 << 40), -1)
    return keys.astype(key_dtype), rng.normal(size=n).astype(np.float32)


def _segsum_equal(got, want):
    """Compact partials of the kernel against its plain version: the same
    n_live, keys and counts, and sums bit for bit (both add each run's rows
    in row order in float32)."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,tile", [(100_003, 256), (5000, 64), (2, 256), (70_000, 1024)])
@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_segsum_kernel_equals_plain(dev, n, tile, key_dtype):
    keys, vals = _sorted_case(np.random.default_rng(n), n, key_dtype)
    k, v = _on(dev, keys), _on(dev, vals)
    before = ops.launch_counts()["segsum_partials"]
    got = kseg.segsum_partials(k, v, tile)
    assert ops.launch_counts()["segsum_partials"] == before + 1
    _segsum_equal(got, ref.segsum_partials(k, v, tile))
    assert int(got[2].sum()) == int((k != -1).sum())


def test_segsum_tile_of_equal_keys(dev):
    k = torch.full((512,), 9, dtype=torch.int32, device=dev)
    pk, ps, pc = kseg.segsum_partials(k, torch.ones(512, device=dev), 256)
    assert pk.tolist() == [9, 9] and pc.tolist() == [256, 256] and ps.tolist() == [256.0, 256.0]


@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_segsum_two_launches_are_identical(dev, key_dtype):
    """2M rows: about a thousand chunks race through the look-back, and two
    launches give the same bytes."""
    keys, vals = _sorted_case(np.random.default_rng(7), 2_000_000, key_dtype)
    k, v = _on(dev, keys), _on(dev, vals)
    a, b = kseg.segsum_partials(k, v), kseg.segsum_partials(k, v)
    _segsum_equal(a, b)
    _segsum_equal(a, ref.segsum_partials(k, v, kseg.TILE))


def test_segsum_one_key_over_a_million_rows(dev):
    """The serial-add worst case: every tile one run of 256 rows."""
    n = 1_000_000
    k = torch.full((n,), 3, dtype=torch.int32, device=dev)
    v = _on(dev, np.random.default_rng(1).normal(size=n).astype(np.float32))
    got = kseg.segsum_partials(k, v)
    assert got[0].shape == (-(-n // 256),) and int(got[2].sum()) == n
    _segsum_equal(got, ref.segsum_partials(k, v, 256))


@pytest.mark.parametrize("where", [1, 2047, 2048, 300_000, 499_999])
def test_segsum_rejects_unsorted_keys(dev, where):
    """One key below the one before it, inside a tile, at a tile edge, at a
    chunk edge and at the end: the kernel raises, as its plain version does."""
    keys = np.arange(500_000, dtype=np.int32) // 3
    keys[where] = keys[where - 1] - 1
    k, v = _on(dev, keys), torch.ones(keys.shape[0], device=dev)
    for fn in (lambda: kseg.segsum_partials(k, v), lambda: ref.segsum_partials(k, v, 256)):
        with pytest.raises(ValueError, match="not sorted"):
            fn()


def test_sort_group_bys_on_card_equal_cpu(dev):
    """sort and sort_pallas on the card against the same call on the CPU:
    keys, counts and integer sums equal, float sums to SUM_TOL; sort_pallas
    runs one segsum_partials launch per pass (a hoisted count pass and one
    per summed column)."""
    rng = np.random.default_rng(4)
    n = 300_000
    d = {"k": rng.integers(0, 40_000, n).astype(np.int32),
         "vi": rng.integers(-(1 << 40), 1 << 40, n),
         "vf": rng.normal(size=n).astype(np.float32)}
    d["k"][::31] = -1
    for strategy, aggs, passes in (("sort", {"vi": "sum", "vf": "max", "k": "count"}, 0),
                                   ("sort_pallas", {"vf": "sum", "vi": "mean", "k": "count"}, 3)):
        out = []
        for where in ("cpu", "cuda"):
            before = ops.launch_counts()["segsum_partials"]
            g, c = T.group_aggregate(T.table_from_numpy(d, device=where), aggs=aggs,
                                     num_groups=50_000, strategy=strategy)
            moved = ops.launch_counts()["segsum_partials"] - before
            assert moved == (passes if where == "cuda" else 0)
            out.append((T.table_to_numpy(g), int(c)))
        (a, ca), (b, cb) = out
        assert ca == cb
        for name in a:
            if a[name].dtype.kind == "f":
                np.testing.assert_allclose(b[name], a[name], rtol=1e-5, atol=1e-4)
            else:
                np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_groupjoin_on_card_fused_equals_torch_arm_and_reruns_bit_identically(dev):
    """Q18's group by the join key at J2 scale 1/256: the fused arm (one
    probe_agg launch, no other kernel but the plans' passes) against the torch arm
    with the sort strategy on the card, and a second fused run equal bit for
    bit."""
    R, S, _ = relgen.generate_tpc("J2", scale=1 / 256, payload_bytes=8)
    Rt, St = T.table_from_numpy(R, device=dev), T.table_from_numpy(S, device=dev)
    aggs = {"s1": "sum", "r1": "sum", "r2": "count"}
    kw = dict(key="k", group_key="k", aggs=aggs, num_groups=R["k"].shape[0])
    ops.reset_launch_counts()
    g, c = T.phj_groupjoin(Rt, St, **kw)
    got = ops.launch_counts()
    # one histogram and one rank launch per plan pass of each side
    assert got["block_histograms"] == got["partition_ranks"] > 0
    assert got["probe_agg"] == 1
    assert got["hash_probe"] == got["clustered_gather"] == got["segsum_partials"] == 0
    g2, c2 = T.phj_groupjoin(Rt, St, **kw)
    assert int(c) == int(c2) and all(torch.equal(g[n], g2[n]) for n in g.column_names)
    t, tc = T.phj_groupjoin(Rt, St, probe_impl="torch", agg_strategy="sort", **kw)
    m = int(c)
    assert m == int(tc) == int((np.bincount(S["k"]) > 0).sum())
    assert torch.equal(g["k"], t["k"]) and torch.equal(g["r2_count"], t["r2_count"])
    for name in ("s1_sum", "r1_sum"):
        exact = t[name][:m].double()
        assert g[name].dtype == torch.float32 and t[name].dtype == torch.int64
        # float32 of int64 values below 2^31: each value and each add
        # rounds by at most 2^-24 relative
        err = (g[name][:m].double() - exact).abs()
        assert bool((err <= 2 * g["r2_count"][:m].double() * 2 ** -24 * exact.abs()).all())


# ---------------------------------------------------------------------------
# the merge lower bound and the global histogram
# ---------------------------------------------------------------------------
def _lower_bound_case(rng, case, key_dtype):
    """(build_sorted, probe) numpy columns for one lower-bound case."""
    build = np.sort(rng.integers(0, 1 << 22, 300_000))
    if case == "narrow":  # sorted probe from the build's range: tiles fit the window
        probe = np.sort(rng.integers(-5, 1 << 22, 1_000_003))
    elif case == "wide":  # a sparse probe: every tile spans far past the window
        probe = np.sort(rng.integers(0, 1 << 22, 3000))
    elif case == "duplicates":  # runs of equal build keys, -1 sentinels first
        build = np.sort(np.concatenate([rng.integers(0, 50, 200_000), np.full(777, -1)]))
        probe = np.sort(np.concatenate([rng.integers(-1, 60, 100_001), np.full(2048, -1)]))
    elif case == "past_the_end":  # half the probe keys beyond the last build key
        probe = np.sort(rng.integers(0, 1 << 23, 50_000))
    elif case == "unsorted":
        probe = rng.integers(-3, (1 << 22) + 3, 40_000)
    else:  # "empty_build"
        build, probe = build[:0], np.sort(rng.integers(0, 100, 5000))
    if key_dtype == np.int64:
        build = np.where(build >= 0, build << 30, -1)
        probe = np.where(probe >= 0, probe << 30, -1)
    return build.astype(key_dtype), probe.astype(key_dtype)


@pytest.mark.parametrize("case", ["narrow", "wide", "duplicates", "past_the_end", "unsorted",
                                  "empty_build"])
@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_lower_bound_kernel_equals_plain(dev, case, key_dtype):
    build, probe = _lower_bound_case(np.random.default_rng(len(case)), case, key_dtype)
    b, p = _on(dev, build), _on(dev, probe)
    before = ops.launch_counts()["lower_bound"]
    got = kmj.lower_bound(b, p)
    assert ops.launch_counts()["lower_bound"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.lower_bound(b, p))
    np.testing.assert_array_equal(got.cpu().numpy(), np.searchsorted(build, probe, "left"))
    assert torch.equal(ops.merge_lower_bound(b, p), got)


# one persistent wave of the lower-bound kernel on an H100 holds at most 132
# SMs x 8 blocks x 2048 keys; one key more starts a second
LB_WAVE = 132 * 8 * 2048 + 1
LB_SPANS = ("span_window-1", "span_window", "span_window+1", "span_sample9", "span_sample9+1",
            "span_wide")
LB_EDGES = ["n1", "n31", "n1023", "n1025", "wave", *LB_SPANS, "tiles_descending",
            "keys_descending", "shuffled", "sentinels", "empty_build"]


def _lb_edge(case, key_dtype):
    """(build_sorted, probe) numpy columns for one edge case of the lower-bound
    kernel: probe counts around its tiles and waves; tiles whose bounds span
    just below, at and above its ring of build keys and its sampled index's
    steps;
    probe keys out of order across tiles, within runs and everywhere;
    sentinels; an empty build column. int64 keys are the int32 ones times
    2^30 (sentinels stay -1), so every bound is the same."""
    rng = np.random.default_rng(len(case))
    build = np.sort(rng.integers(0, 1 << 20, 200_000))
    if case.startswith("n") or case == "wave":
        n = LB_WAVE if case == "wave" else int(case[1:])
        probe = np.sort(rng.integers(-1, (1 << 20) + 10, n))
    elif case in LB_SPANS:
        # six tiles of 256 keys (a short probe column gets the smallest
        # tile); tile i runs from 3 a to 3 (a + span) over build = 3 arange,
        # so its bounds are exactly a and a + span
        window = kmj.RING_BYTES // np.dtype(key_dtype).itemsize
        span = {"span_window-1": window - 1, "span_window": window,
                "span_window+1": window + 1, "span_sample9": 9 * kmj.SAMPLE,
                "span_sample9+1": 9 * kmj.SAMPLE + 1, "span_wide": 1_000_003}[case]
        build = 3 * np.arange(6 * (span + 17) + 1)
        tiles = []
        for i in range(6):
            a = i * (span + 17)
            t = np.sort(rng.integers(3 * a, 3 * (a + span) + 1, kmj.TILE_KEYS[0]))
            t[0], t[-1] = 3 * a, 3 * (a + span)
            tiles.append(t)
        probe = np.concatenate(tiles)
    elif case == "tiles_descending":
        # past one wave, in the kernel's widest tiles: each tile sorted, every
        # tile below the one before, so each block's next tile breaks the
        # bracket it searches from
        tile = kmj.TILE_KEYS[1]
        probe = np.sort(rng.integers(0, 1 << 20, (LB_WAVE // tile + 1) * tile))
        probe = probe.reshape(-1, tile)[::-1].ravel()
    elif case == "keys_descending":
        probe = np.sort(rng.integers(-1, (1 << 20) + 10, LB_WAVE))[::-1]
    elif case == "shuffled":
        probe = rng.integers(-3, (1 << 20) + 3, 40_000)
    elif case == "sentinels":  # -1 in both columns; the first tiles hold only -1
        build = np.sort(np.concatenate([rng.integers(0, 50, 200_000), np.full(777, -1)]))
        probe = np.sort(np.concatenate([rng.integers(-1, 60, 2000), np.full(3000, -1)]))
    else:  # "empty_build"
        build, probe = build[:0], np.sort(rng.integers(0, 100, 5000))
    if key_dtype == np.int64:
        build = np.where(build >= 0, build << 30, -1)
        probe = np.where(probe >= 0, probe << 30, -1)
    return build.astype(key_dtype), np.ascontiguousarray(probe).astype(key_dtype)


@pytest.mark.parametrize("case", LB_EDGES)
@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_lower_bound_kernel_edge_cases_equal_plain(dev, case, key_dtype):
    build, probe = _lb_edge(case, key_dtype)
    b, p = _on(dev, build), _on(dev, probe)
    before = ops.launch_counts()["lower_bound"]
    got = kmj.lower_bound(b, p)
    assert ops.launch_counts()["lower_bound"] == before + 1
    assert torch.equal(got, ref.lower_bound(b, p))
    np.testing.assert_array_equal(got.cpu().numpy(), np.searchsorted(build, probe, "left"))


GATHER_EDGES = [f"len{n}" for n in range(10)] + [
    "ragged_tail", "offset1", "offset2", "offset3", "negative_and_past_end", "unclustered",
    "wide_windows"]
GATHER_DTYPES = [np.int32, np.float32, np.int64, np.float64]


def _gather_edge(case, dtype):
    """(src, idx, offset) numpy arrays for one edge case of the gather kernel;
    the kernel gets the views src[offset:] and idx[offset:], which start
    offset elements past a 16-byte boundary on the card. Lengths 0 to 9 and
    a ragged tail; negative, past-the-end and unclustered indices; clustered
    indices whose windows are wider than a warp step's share of shared memory."""
    rng = np.random.default_rng(len(case))
    n_src, offset = 5000, 0
    if case.startswith("len"):
        idx = np.sort(rng.integers(-1, n_src + 10, int(case[3:])))
    elif case == "ragged_tail":  # not a whole number of steps; compacted -1 tail
        idx = np.sort(rng.integers(0, n_src, 256 * 37 + 173))
        idx[-300:] = -1
    elif case.startswith("offset"):
        offset = int(case[6:])
        idx = np.sort(rng.integers(0, n_src, 10_000 + offset))
    elif case == "negative_and_past_end":
        idx = rng.integers(-n_src, 2 * n_src, 20_000)
    elif case == "unclustered":
        idx = rng.permutation(np.resize(np.arange(n_src), 20_001))
    else:  # "wide_windows": every step of 256 outputs spans about 12,800 rows
        n_src = 1_000_000
        idx = np.sort(rng.integers(0, n_src, 20_000))
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        src = rng.integers(info.min, info.max, n_src, dtype=dtype, endpoint=True)
    else:
        src = (rng.normal(size=n_src) * 1e6).astype(dtype)
    return src, idx.astype(np.int32), offset


def _gather_numpy(src, idx):
    return np.where(idx >= 0, src[np.clip(idx, 0, src.shape[0] - 1)], 0).astype(src.dtype)


@pytest.mark.parametrize("case", GATHER_EDGES)
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
def test_gather_kernel_edge_cases_equal_plain(dev, case, dtype):
    src, idx, off = _gather_edge(case, dtype)
    s_all, i_all = _on(dev, src), _on(dev, idx)
    s, i = s_all[off:], i_all[off:]
    assert i.data_ptr() % 16 == 4 * off  # the indices start off the boundary
    before = ops.launch_counts()["clustered_gather"]
    got = kgather.clustered_gather(s, i)
    assert ops.launch_counts()["clustered_gather"] == before + (i.shape[0] > 0)
    assert torch.equal(got, ref.clustered_gather(s, i))
    np.testing.assert_array_equal(got.cpu().numpy(), _gather_numpy(src[off:], idx[off:]))


@pytest.mark.parametrize("bins", [1, 256, khist.SMEM_BINS, khist.SMEM_BINS + 1, (1 << 18) + 1])
def test_histogram_kernel_equals_plain(dev, bins):
    """Both branches (shared-memory counts up to SMEM_BINS bins, device
    memory past them); pads (-1) and digits >= bins count nowhere; a view
    that starts off the 16-byte boundary takes the scalar head."""
    rng = np.random.default_rng(bins)
    d = _on(dev, rng.integers(-2, bins + 3, 2_000_003).astype(np.int32))
    before = ops.launch_counts()["histogram"]
    for x in (d, d[1:], d[3:11]):
        got = khist.histogram(x, bins)
        assert torch.equal(got, ref.histogram(x, bins))
        assert int(got.sum()) == int(((x >= 0) & (x < bins)).sum())
    assert ops.launch_counts()["histogram"] == before + 3
    assert torch.equal(ops.histogram(d, bins), ref.histogram(d, bins))


def test_histogram_equals_the_partition_plans_sizes(dev):
    rng = np.random.default_rng(3)
    keys = _on(dev, rng.integers(0, 1 << 24, 1_000_000).astype(np.int32))
    P = 1 << 12
    dig = thj._digits(keys, 12, True)
    sizes = ops.partition_plan(dig, P + 1, impl="cuda")[3]
    assert torch.equal(ops.histogram(dig, P + 1, impl="cuda"), sizes)


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    i32 = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kmj.lower_bound(i32.long(), i32)
    with pytest.raises(TypeError):
        kmj.lower_bound(i32.float(), i32.float())
    with pytest.raises(TypeError):
        khist.histogram(i32.long(), 4)
    with pytest.raises(ValueError):
        khist.histogram(i32, 0)
    # probe_agg runs one thread per row: at most 1024 rows a sub-block
    wide = torch.full((1, 1056), -1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kprobe.probe_agg(wide[:, :8], torch.zeros((1, 0, 8), device=dev), wide, wide,
                         torch.zeros((1, 0, 1056), device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev), ())


def test_radix_sort_plan_on_card_equals_stable_sort(dev):
    rng = np.random.default_rng(5)
    k = rng.integers(-(1 << 31), (1 << 31) - 1, 2_000_001).astype(np.int32)
    k[::9] = -1
    k = _on(dev, k)
    ops.reset_launch_counts()
    sk, perm = krp.sort_plan_radix(k)
    got = ops.launch_counts()
    assert got["block_histograms"] == got["partition_ranks"] == 4
    tk, tperm = ops.sort_plan(k)
    assert torch.equal(sk, tk) and torch.equal(perm, tperm) and perm.dtype == torch.int32


@pytest.mark.parametrize("pattern", ["gftr", "gfur"])
def test_smj_on_card_equals_cpu(dev, pattern):
    """SMJ at J2 scale 1/256 (pk_fk, one lower_bound launch) and at J5 scale
    1/4096 (m:n) on the card against the same joins on the CPU."""
    for jid, mode_launches in (("J2", 1), ("J5", 0)):
        R, S, mode = relgen.generate_tpc(jid, scale=1 / 256 if jid == "J2" else 1 / 4096,
                                         payload_bytes=8)
        out = []
        for where in ("cpu", "cuda"):
            before = ops.launch_counts()["lower_bound"]
            J, c = T.join(T.table_from_numpy(R, device=where), T.table_from_numpy(S, device=where),
                          algorithm="smj", pattern=pattern, mode=mode)
            moved = ops.launch_counts()["lower_bound"] - before
            assert moved == (mode_launches if where == "cuda" else 0)
            out.append((T.table_to_numpy(J), int(c)))
        (a, ca), (b, cb) = out
        assert ca == cb > 0
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_nphj_and_join_sequences_on_card_equal_cpu(dev):
    R, S, _ = relgen.generate_tpc("J2", scale=1 / 256, payload_bytes=8)
    fact, dims, fks, dks = relgen.generate_star(200_000, 50_000, 3, seed=2)
    runs = {}
    for where in ("cpu", "cuda"):
        Rt, St = T.table_from_numpy(R, device=where), T.table_from_numpy(S, device=where)
        ft = T.table_from_numpy(fact, device=where)
        dt = [T.table_from_numpy(d, device=where) for d in dims]
        runs[where] = [T.join(Rt, St, algorithm="nphj")] + [
            T.join_sequence(ft, dt, fk_cols=fks, dim_keys=dks, algorithm=alg,
                            restore_order=True) for alg in ("phj", "smj")]
    for (a, ca), (b, cb) in zip(runs["cpu"], runs["cuda"]):
        assert int(ca) == int(cb)
        for name in a.column_names:
            assert torch.equal(a[name], b[name].cpu()), name


@pytest.mark.parametrize("pattern", ["gftr", "gfur"])
def test_phj_mn_on_card_equals_cpu(dev, pattern):
    """m:n PHJ at J5 scale 1/256 (281,250 x 281,250 rows) on the card against
    the same join on the CPU, row for row: the plans' passes and, for GFTR,
    one gather per payload column; no probe kernel."""
    R, S, mode = relgen.generate_tpc("J5", scale=1 / 256, payload_bytes=8)
    n_keys = R["k"].shape[0] // 4  # J5's keys are uniform in [0, n_r / 4)
    total = int((np.bincount(R["k"], minlength=n_keys)
                 * np.bincount(S["k"], minlength=n_keys)).sum())
    out = []
    for where in ("cpu", "cuda"):
        ops.reset_launch_counts()
        J, c = T.join(T.table_from_numpy(R, device=where), T.table_from_numpy(S, device=where),
                      algorithm="phj", pattern=pattern, mode=mode, out_size=total)
        got = ops.launch_counts()
        if where == "cuda":
            assert got["block_histograms"] == got["partition_ranks"] > 0
            assert got["clustered_gather"] == (2 if pattern == "gftr" else 0)
            assert got["hash_probe"] == got["probe_agg"] == 0
        out.append((T.table_to_numpy(J), int(c)))
    (a, ca), (b, cb) = out
    assert ca == cb == total
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _ladder_call(ladder, where, rng_seed=0):
    """One checked driver on the reference's test inputs (n_r = 256,
    n_s = 1,024): (result table, count, report)."""
    rng = np.random.default_rng(rng_seed)
    R = {"k": rng.permutation(256).astype(np.int32),
         "v": rng.integers(0, 99, 256).astype(np.int32)}
    S = {"k": rng.integers(0, 256, 1024).astype(np.int32),
         "w": rng.integers(0, 9, 1024).astype(np.int32)}
    Rt, St = T.table_from_numpy(R, device=where), T.table_from_numpy(S, device=where)
    if ladder == "phj":
        (t, c), rep = T.phj_join_checked(Rt, St, with_report=True)
    elif ladder == "phj_smj":  # 18 bits, forced past 20: the sort-merge rung
        (t, c), rep = T.phj_join_checked(Rt, St, partition_bits=18, with_report=True)
    elif ladder == "groupjoin":
        (t, c), rep = T.groupjoin_checked(Rt, St, group_key="k", aggs={"w": "sum"},
                                          num_groups=64, with_report=True)
    else:
        (t, c), rep = T.groupby_partition_checked(St, aggs={"w": "sum"}, num_groups=256,
                                                  with_report=True)
    return T.table_to_numpy(t), int(c), rep


@pytest.mark.parametrize("ladder,spec", [
    ("phj", ""), ("phj", "overflow:phj@0"), ("phj_smj", "overflow:phj@0+1+2"),
    ("groupjoin", ""), ("groupjoin", "overflow:groupjoin@0"),
    ("groupby_partition", ""), ("groupby_partition", "overflow:groupby_partition@0"),
    ("groupby_partition", "overflow:groupby_partition@all")])
def test_checked_ladders_on_card_equal_cpu(dev, ladder, spec):
    """Each checked driver on the card and on the CPU under the same fault
    spec: the same report, and the same valid rows (the group-join's fused
    arm gives float32 sums of small integers, exact here)."""
    from repro_torch.resilience import EscalationExhausted, faults

    runs = []
    for where in ("cpu", "cuda"):
        with faults.inject(spec):
            try:
                runs.append(_ladder_call(ladder, where))
            except EscalationExhausted as e:
                runs.append(e.report.as_dict())
    if isinstance(runs[0], dict):
        assert spec.endswith("@all") and runs[0] == runs[1]
        return
    (a, ca, ra), (b, cb, rb) = runs
    assert ra.as_dict() == rb.as_dict() and ca == cb
    if ladder == "phj_smj":
        assert ra.final_knobs["algorithm"] == "smj"
        assert [x.knobs["partition_bits"] for x in ra.attempts] == [18, 19, 20, 20]
    rows_a = sorted(zip(*[a[n][:ca].astype(np.int64).tolist() for n in sorted(a)]))
    rows_b = sorted(zip(*[b[n][:cb].astype(np.int64).tolist() for n in sorted(b)]))
    assert rows_a == rows_b


def test_partition_hash_and_scatter_on_card_equal_cpu(dev):
    """groupby_bench's skew shape at 300,000 rows: keys and counts equal to
    the CPU's, float32 sums within the parity tolerance, and a second run on
    the card equal bit for bit."""
    rng = np.random.default_rng(5)
    n = 300_000
    d = {"k": ((rng.zipf(1.5, n) - 1) % 4096).astype(np.int32),
         "v": rng.random(n).astype(np.float32),
         "w": rng.integers(-1000, 1000, n).astype(np.int32)}
    aggs = {"v": "sum", "w": "max", "k": "count"}
    for strategy in ("partition_hash", "scatter"):
        runs = [T.group_aggregate(T.table_from_numpy(d, device=where), aggs=aggs,
                                  num_groups=8192, strategy=strategy)
                for where in ("cpu", "cuda", "cuda")]
        (a, ca), (b, cb), (b2, cb2) = runs
        assert int(ca) == int(cb) == int(cb2)
        for name in a.column_names:
            assert torch.equal(b[name], b2[name]), name
            x, y = a[name].numpy(), b[name].cpu().numpy()
            if x.dtype.kind == "f":
                np.testing.assert_allclose(y, x, rtol=1e-5, atol=2 * 256 * np.finfo(np.float32).eps)
            else:
                np.testing.assert_array_equal(x, y, err_msg=name)


# ---------------------------------------------------------------------------
# the per-tile histograms
# ---------------------------------------------------------------------------
# 20M digits: 19,532 tiles, several waves of the persistent grid on an H100
HIST_SIZES = [1, 1000, 37 * 1024 + 5, 20_000_003]


@pytest.mark.parametrize("n", HIST_SIZES)
@pytest.mark.parametrize("bins", [1, 8, 256, 257, 1024])
def test_block_histograms_kernel_equals_plain(dev, bins, n):
    """Pads (< 0) and digits >= bins count nowhere; a ragged last tile, a
    column shorter than a tile, and a view one digit off the 16-byte
    boundary (the scalar path) all equal the plain version exactly."""
    rng = np.random.default_rng([bins, n])
    whole = _on(dev, rng.integers(-2, bins + 3, n + 1).astype(np.int32))
    before = ops.launch_counts()["block_histograms"]
    for d in (whole[:n], whole[1:]):
        got = krp.block_histograms(d, bins)
        assert got.shape == (-(-n // krp.TILE), bins)
        assert torch.equal(got, ref.block_histograms(d, bins, krp.TILE))
    assert ops.launch_counts()["block_histograms"] == before + 2


@pytest.mark.parametrize("tile", [1, 100, 4096])
def test_block_histograms_kernel_other_tiles(dev, tile):
    rng = np.random.default_rng(tile)
    d = _on(dev, rng.integers(-1, 260, 1_000_003).astype(np.int32))
    for bins in (8, 256, 257):
        assert torch.equal(krp.block_histograms(d, bins, tile=tile),
                           ref.block_histograms(d, bins, tile))


def test_block_histograms_kernel_one_digit(dev):
    """Every digit the same bin: every atomic of a warp on one address."""
    d = torch.full((3 * 1024 * 1024 + 3,), 7, dtype=torch.int32, device=dev)
    got = krp.block_histograms(d, 256)
    assert torch.equal(got, ref.block_histograms(d, 256, krp.TILE))
    assert int(got[:, 7].sum()) == d.shape[0] and int(got.sum()) == d.shape[0]


# ---------------------------------------------------------------------------
# every kernel launches on the card that holds its tensors
# ---------------------------------------------------------------------------
def test_kernels_launch_on_their_tensors_card(dev):
    """Each of the eight kernels on tensors of cuda:1 while cuda:0 is the
    current card, against its plain version on the same tensors; the
    current card is left as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the kernels' tensors on the second, the first current")
    other = torch.device("cuda", 1)
    rng = np.random.default_rng(1)
    digits = _on(other, rng.integers(-1, 256, 300_001).astype(np.int32))
    probe = [_on(other, a) for a in _probe_edge("plain", 256)]
    agg = tuple(_on(other, a) for a in _probe_agg_edge(rng, "dup_build_key", 256, np.int64))
    keys, vals = _sorted_case(rng, 100_003)
    sk, sv = _on(other, keys), _on(other, vals)
    src = _on(other, rng.normal(size=5000).astype(np.float32))
    idx = _on(other, np.sort(rng.integers(-1, 5000, 20_000)).astype(np.int32))
    build = torch.sort(_on(other, rng.integers(0, 1 << 20, 50_000).astype(np.int32))).values
    sides = (("probe", 0), ("build", 1))
    calls = {
        "block_histograms": (lambda: krp.block_histograms(digits, 256),
                             lambda: ref.block_histograms(digits, 256, krp.TILE)),
        "partition_ranks": (
            lambda: krp.rank_with_base(digits, krp.tile_base(
                ref.block_histograms(digits, 256, krp.TILE))[0], 256),
            lambda: ref.partition_ranks(digits, 256)),
        "hash_probe": (lambda: kprobe.hash_probe(*probe, 256),
                       lambda: ref.hash_probe(*probe, 256)),
        "clustered_gather": (lambda: kgather.clustered_gather(src, idx),
                             lambda: ref.clustered_gather(src, idx)),
        "probe_agg": (lambda: kprobe.probe_agg(*agg, sides),
                      lambda: ref.probe_agg_blocks(*agg, sides)),
        "segsum_partials": (lambda: kseg.segsum_partials(sk, sv, 256),
                            lambda: ref.segsum_partials(sk, sv, 256)),
        "lower_bound": (lambda: kmj.lower_bound(build, sk),
                        lambda: ref.lower_bound(build, sk)),
        "histogram": (lambda: khist.histogram(digits, 256),
                      lambda: ref.histogram(digits, 256)),
    }
    assert sorted(calls) == sorted(ops.launch_counts())
    with torch.cuda.device(0):
        for name, (kernel, plain) in calls.items():
            before = ops.launch_counts()[name]
            got = kernel()
            torch.cuda.synchronize(other)
            assert ops.launch_counts()[name] == before + 1, name
            assert torch.cuda.current_device() == 0, name
            got = got if isinstance(got, tuple) else (got,)
            want = plain()
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                assert g.device == other, name
                if g.dtype.is_floating_point:
                    torch.testing.assert_close(g, w, **SUM_TOL)
                else:
                    assert torch.equal(g, w), name


# ---------------------------------------------------------------------------
# the engine on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("checked", [False, True])
def test_engine_two_joins_and_group_by_on_card(dev, checked):
    """A two-join star plan with a group-by through the engine: the same
    plan as on the CPU (one explicit profile), the same rows, and kernel
    launches that fit its nodes — the plan passes, one probe per PHJ join,
    a gather per GFTR join, and for a group-join the probe feeding the
    node's accumulator (never probe_agg, as the JAX package's engine never
    runs its fused kernel) — with no degradation."""
    from repro_torch.core.planner import PrimitiveProfile
    from repro_torch.engine import Catalog, optimize, scan
    from repro_torch.engine import physical as PH
    from repro_torch.obs import metrics

    fact, dims, _, _ = relgen.generate_star(400_000, 100_000, 2, seed=3)
    q = (scan("fact").join(scan("dim0"), left_key="fk0", right_key="k0")
         .join(scan("dim1"), left_key="fk1", right_key="k1")
         .group_by("fk0", p1_0="sum", p0_0="count"))
    prof = PrimitiveProfile(seq_bw=2.1e11, sort_pass_bw=3.3e10, partition_pass_bw=5.7e10,
                            unclustered_penalty=7.5, clustered_penalty=1.4)
    plans = {}
    for d in ("cpu", dev):
        tabs = {"fact": fact, "dim0": dims[0], "dim1": dims[1]}
        cat = Catalog({n: T.table_from_numpy(t, device=d) for n, t in tabs.items()})
        plans[d] = optimize(q, cat, profile=prof)
    assert plans[dev].explain() == plans["cpu"].explain()
    deg = metrics.counter("resilience.plan_degradations").value
    ops.reset_launch_counts()
    g, c = plans[dev].run(checked=checked)
    got = ops.launch_counts()
    assert metrics.counter("resilience.plan_degradations").value == deg
    want_g, want_c = plans["cpu"].run()
    assert int(c) == int(want_c)
    order, want_order = torch.sort(g["fk0"][:int(c)]).indices, torch.sort(
        want_g["fk0"][:int(c)]).indices
    for name in want_g.column_names:
        assert torch.equal(g[name][:int(c)][order].cpu(), want_g[name][:int(c)][want_order]), name
    nodes, stack = [], [plans[dev].root]
    while stack:
        nodes.append(stack.pop())
        stack.extend(nodes[-1].children())
    joins = [n for n in nodes if isinstance(n, PH.PJoin) and n.algorithm == "phj"]
    gjs = [n for n in nodes if isinstance(n, PH.PGroupJoin)]
    assert joins or gjs
    assert got["block_histograms"] == got["partition_ranks"] > 0
    assert got["hash_probe"] == len(joins) + len(gjs)
    assert got["probe_agg"] == 0
    assert got["clustered_gather"] >= sum(n.pattern == "gftr" for n in joins)
    assert got["lower_bound"] == got["segsum_partials"] == got["histogram"] == 0


# ---------------------------------------------------------------------------
# the trace layer, the run auditor and the query server on the card
# ---------------------------------------------------------------------------
def test_span_time_against_a_synchronized_wall(dev):
    """A span's CUDA-event time of a known kernel (the radix partition plan
    of 16M digits: histogram and rank passes) against the host wall of the
    same calls ended by a synchronize: the event time is the device's, so
    it cannot exceed the wall, and on a call this long the two agree to a
    few launch gaps."""
    import time

    from repro_torch.obs import timed_call

    rng = np.random.default_rng(0)
    d = _on(dev, rng.integers(0, 4097, 1 << 24).astype(np.int32))

    def plan(digits):
        return ops.partition_plan(digits, 4097)

    (_, _, off, sz), ev = timed_call(plan, d, iters=5, warmup=2)
    assert off.device.type == "cuda" and int(sz.sum()) == d.shape[0]
    walls = []
    for _ in range(5):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        plan(d)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[2]
    assert 0 < ev <= wall * 1.05
    assert ev >= 0.5 * wall, (ev, wall)


def _server_tables(dev, seed=0, n_r=40_000, n_s=160_000):
    R, S = relgen.generate(relgen.JoinWorkload("t", n_r, n_s, 2, 1, seed=seed))
    return ({"R": T.table_from_numpy(R, dev), "S": T.table_from_numpy(S, dev)},
            {"R": T.table_from_numpy(R, "cpu"), "S": T.table_from_numpy(S, "cpu")})


def test_plan_peak_bytes_against_the_allocator(dev):
    """plan_peak_bytes of a join + group-by on the card against
    max_memory_allocated over the same run (reset before it): the storages
    alone from one run, with each op's workspace from another; within 5%."""
    from repro_torch.analysis import dispatch_audit as A
    from repro_torch.engine import Catalog, executor, optimize, scan

    tabs, _ = _server_tables(dev)
    plan = optimize(scan("S").join(scan("R"), key="k").group_by("k", s1="sum", r1="max"),
                    Catalog(tabs), measure_profile=False)
    plan.run()
    inputs = sum(t.nbytes() for t in tabs.values())
    torch.cuda.synchronize(dev)
    a0 = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    storages = A.audit(lambda tb: executor.execute(plan.root, tb), tabs,
                       workspace=False).peak_live_bytes
    torch.cuda.synchronize(dev)
    allocator = torch.cuda.max_memory_allocated(dev) - a0 + inputs
    peak = executor.plan_peak_bytes(plan)
    assert storages <= peak
    assert abs(peak - allocator) <= 0.05 * allocator, (peak, allocator, storages)


def test_audit_budget_on_the_card_equals_the_cpu(dev):
    """The kernel-call marks make a plan's budget the same on every device;
    on the card every mark launched its kernels."""
    from repro_torch.engine import Catalog, executor, optimize, scan
    from repro_torch.core.planner import PrimitiveProfile

    on_card, on_cpu = _server_tables(dev)
    q = scan("S").join(scan("R"), key="k").group_by("k", s1="sum")
    prof = PrimitiveProfile()
    card = executor.audit(optimize(q, Catalog(on_card), profile=prof))
    cpu = executor.audit(optimize(q, Catalog(on_cpu), profile=prof))
    assert card.root_report.budget == cpu.root_report.budget
    assert not card.violations and not cpu.violations
    launches = dict(card.root_report.launches)
    assert launches and not cpu.root_report.launches
    assert sum(launches.values()) >= card.root_report.budget.kernel_calls


def test_server_tick_on_card_equals_cpu(dev):
    """One server tick with three requests on the card gives the rows the
    same tick gives on the CPU."""
    from repro_torch.engine import scan
    from repro_torch.serve import QueryRequest, QueryServer
    from repro_torch.serve.chaos import canon

    plan = scan("S").join(scan("R"), key="k").group_by("k", s1="sum", r1="max")
    out = {}
    for where in ("cuda", "cpu"):
        server = QueryServer(device=where)
        reqs = []
        for i in range(3):
            card, host = _server_tables(dev, seed=i, n_r=30_000 + 1000 * i)
            reqs.append(QueryRequest(qid=i, plan=plan, tables=card if where == "cuda" else host))
        for r in reqs:
            server.submit(r)
        server.step()
        assert all(r.done and not r.error and r.path == "fast" for r in reqs)
        assert len({r.signature for r in reqs}) == 1 and server.tick == 1
        out[where] = [canon(*r.result) for r in reqs]
    assert out["cuda"] == out["cpu"]


def test_chaos_soak_on_card(dev):
    from repro_torch.serve.chaos import run_chaos

    rep = run_chaos(queries_per_family=8, families=("estimates",), device="cuda")
    assert rep["ok"], rep["failures"]
    assert rep["config"]["device"] == "cuda"
    assert rep["families"]["estimates"]["counters"]["qserve.saturations"] > 0
    assert rep["memory"]["big_morsels"] and min(rep["memory"]["big_morsels"]) >= 2


# ---------------------------------------------------------------------------
# the LM server: token routing on the radix-partition kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [4, 16, 32, 4096])
def test_moe_dispatch_plan_on_card_equals_cpu(dev, n):
    """The MoE dispatch plan at decode's shapes (one partial 1024-digit
    tile, most of the 60 bins empty) and at a prefill's: the card's plan
    (one histogram and one rank launch) equals the CPU arm's exactly."""
    from repro_torch.models import moe as TMOE

    E, k = 60, 4
    rng = np.random.default_rng(n)
    eidx = np.stack([rng.choice(E, k, replace=False) for _ in range(n // k)]).astype(np.int32)
    for C in (TMOE._capacity(n // k, k, E, 1.25), 1):
        before = ops.launch_counts()
        got = TMOE._plan_sort(_on(dev, eidx), E, C)
        after = ops.launch_counts()
        want = TMOE._plan_sort(torch.from_numpy(eidx), E, C)
        for g, w in zip(got, want):
            assert g.is_cuda and g.dtype == w.dtype and torch.equal(g.cpu(), w)
        assert after["block_histograms"] == before["block_histograms"] + 1
        assert after["partition_ranks"] == before["partition_ranks"] + 1
    d = _on(dev, eidx.reshape(-1))
    for x, y in zip(T.primitives.plan_partition_permutation(d, E),
                    T.primitives.plan_partition_permutation(d, E, impl="torch")):
        assert torch.equal(x, y)


def _qwen_reduced(dev, dtype=torch.float32):
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.models import model as M

    cfg = get_reduced_config("qwen2-moe-a2.7b")
    return cfg, M.init_params(cfg, torch.Generator(dev).manual_seed(0), dtype, dev)


def test_moe_decode_on_card_equals_its_torch_arm_bit_for_bit(dev, monkeypatch):
    from repro_torch.models import model as M

    cfg, params = _qwen_reduced(dev)
    tok = _on(dev, np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 6)).astype(np.int32))
    runs = {}
    for arm in ("cuda", "torch"):
        monkeypatch.setenv(ops.PARTITION_PLAN_ENV, arm)
        cache = M.init_cache(cfg, params, 3, 16, None, torch.float32)
        before = ops.launch_counts()["partition_ranks"]
        logits = []
        for step in range(6):
            lg, cache = M.decode_step(cfg, params, cache, tok[:, step], step)
            logits.append(lg)
        launched = ops.launch_counts()["partition_ranks"] - before
        assert launched == (6 * cfg.num_layers if arm == "cuda" else 0)
        runs[arm] = (torch.stack(logits), cache["kv"]["k"], cache["kv"]["v"])
    assert all(torch.equal(a, b) for a, b in zip(runs["cuda"], runs["torch"]))


def test_serve_engine_completes_on_card(dev):
    from repro_torch.serve.engine import Request, ServeEngine

    cfg, params = _qwen_reduced(dev, torch.bfloat16)
    eng = ServeEngine(cfg, params, max_batch=3, max_len=32, eos_id=-1, dtype=torch.bfloat16)
    assert eng.cache["kv"]["k"].is_cuda
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab_size, 3).tolist(), max_tokens=4)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and not r.error and len(r.out) == 4 for r in reqs)
