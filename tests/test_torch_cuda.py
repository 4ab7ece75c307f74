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
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import radix_partition as krp  # noqa: E402

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


def test_probe_kernel_equals_plain(dev):
    rng = np.random.default_rng(2)
    p_bits, cap = 8, thj.BUILD_BLOCK
    P = 1 << p_bits
    rkeys = _on(dev, rng.permutation(200_000)[:20_000].astype(np.int32))
    skeys = rng.integers(0, 200_000, 80_000).astype(np.int32)
    skeys[::13] = -1
    skeys = _on(dev, skeys)
    perm_r, _, off_r, sz_r = ops.partition_plan(thj._digits(rkeys, p_bits, True), P + 1)
    perm_s, _, off_s, sz_s = ops.partition_plan(thj._digits(skeys, p_bits, True), P + 1)
    kr, ks = rkeys[perm_r], skeys[perm_s]
    bkeys, _, overflow = thj.build_blocks(kr, off_r[:P], sz_r[:P], cap)
    assert not bool(overflow)
    for x, y in zip(ops.hash_probe(bkeys, off_r[:P], ks, off_s[:P], sz_s[:P], "cuda"),
                    ops.hash_probe(bkeys, off_r[:P], ks, off_s[:P], sz_s[:P], "torch")):
        assert torch.equal(x, y)
    pk, part, _ = kprobe.layout_probe_blocks(ks, off_s[:P], sz_s[:P], cap,
                                             -(-ks.shape[0] // cap) + P)
    vid, hit = kprobe.hash_probe(bkeys, off_r[:P].contiguous(), pk, part)
    pv, ph = ref.hash_probe_blocks(bkeys, off_r[:P], pk.reshape(-1),
                                   part.repeat_interleave(cap))
    assert torch.equal(vid.reshape(-1), pv) and torch.equal(hit.reshape(-1), ph)


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
        assert all(moved.values()) if where == "cuda" else not any(moved.values())
        out[where] = (T.table_to_numpy(J), int(jc), T.table_to_numpy(G), int(gc))
    (j0, c0, g0, gc0), (j1, c1, g1, gc1) = out["cpu"], out["cuda"]
    assert c0 == c1 and gc0 == gc1
    for a, b in ((j0, j1), (g0, g1)):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
