"""Sequence sharding in the port: the JAX package's `seq_shard=True` layout
(activations' seq over 'model' in train and prefill) in the port's sharded
train step, held against the JAX package's single-device step and the
port's one-card step, and the (batch, seq) flatten that keeps strided
shards out of the step.

One gloo world of 4 ranks (a subprocess that spawns them, each on one torch
thread) on a (2, 2) ('data', 'model') mesh runs the olmo-1b reduced train
step with seq_shard=True, the mixtral-8x7b reduced train step without and
with it, and the xlstm-125m and zamba2-2.7b reduced train steps with it
(their recurrences gather the sequence; the mLSTM and sLSTM cores run per
rank, the sLSTM's R and bias gradients summed over the batch's ranks);
the tests read its npz results. The JAX side runs here, on
one device, on the same numpy inputs, its partition plan on its 'xla' arm.
Bounds are the JAX package's own (`tests/test_distributed.py`): a sharded
step's loss within 1e-4 and every parameter within 5e-3 of the
single-device step. The sequence (16) divides 'model'.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.train import optimizer as JOPT

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
# (arch, seq_shard) of each sharded train step the world runs
STEPS = (("olmo-1b", True), ("mixtral-8x7b", False), ("mixtral-8x7b", True),
         ("xlstm-125m", True), ("zamba2-2.7b", True))

WORLD_SCRIPT = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

STEPS = (("olmo-1b", True), ("mixtral-8x7b", False), ("mixtral-8x7b", True),
         ("xlstm-125m", True), ("zamba2-2.7b", True))


def tree_from(arrays, like):
    from repro_torch.models.params import map_leaves
    it = iter(arrays)
    return map_leaves(lambda _: torch.from_numpy(next(it)), like, is_leaf=torch.is_tensor)


def flat(tree):
    from repro_torch.dist import sharding as SH
    from repro_torch.models.params import leaves
    return [SH.full(t).detach().numpy() for t in leaves(tree, torch.is_tensor)]


class StridedWatch:
    """Counts the ops (forward and backward) given a DTensor that holds a
    strided shard: a dispatch mode sees each DTensor op before DTensor
    does."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.placement_types import _StridedShard
        from torch.utils._python_dispatch import TorchDispatchMode

        watch = self
        self.n = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                for t in torch.utils._pytree.tree_leaves((args, kwargs or {})):
                    if isinstance(t, DTensor) and any(isinstance(p, _StridedShard)
                                                      for p in t.placements):
                        watch.n += 1
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                return func(*args, **(kwargs or {}))

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def run(rank, port, inp, outdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import step as STEP

    d = dict(np.load(inp))
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    seq_rules = SH.default_rules(seq_shard=True)

    # merge_lead / split_lead on a (b, s, d) tensor sharded on batch and seq
    x = torch.from_numpy(d["lead_x"])
    c = torch.from_numpy(d["lead_c"])
    xs = SH.place(x, SH.NamedSharding(mesh, ("data", "model", None))).requires_grad_()
    seen = {}

    def keep(name, t):
        seen[name] = tuple(t.placements)
        t.register_hook(lambda g: seen.__setitem__(name + "_grad", tuple(g.placements)))
        return t

    with SH.sharding_ctx(mesh, seq_rules), StridedWatch() as watch:
        flat2 = keep("flat", SH.merge_lead(xs))
        back = keep("back", SH.split_lead(flat2 * 2.0, (4, 8)))
        y = keep("y", SH.shard_act(back, ("batch", "seq", "embed")))
        (y * SH.replicated(c, mesh)).sum().backward()
    out["lead_flat"] = SH.full(flat2).detach().numpy()
    out["lead_y"] = SH.full(y).detach().numpy()
    out["lead_grad"] = SH.full(xs.grad).numpy()
    out["lead_strided_ops"] = np.array(watch.n)
    for k, v in sorted(seen.items()):
        out[f"lead_pl_{k}"] = np.array(str(v))
    out["lead_pl_x_grad"] = np.array(str(tuple(xs.grad.placements)))

    # the residual stream of the seq-sharded olmo-1b enters the layers split over 'model'
    cfg = get_reduced_config("olmo-1b")
    like = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    olmo = tree_from([d[f"olmo-1b_p{i}"] for i in range(int(d["olmo-1b_n"]))], like)
    toks = torch.from_numpy(d["olmo-1b_tokens"])
    with SH.sharding_ctx(mesh, seq_rules):
        emb = M._embed(cfg, SH.place_tree(olmo, SH.named_shardings(M.template(cfg), mesh,
                                                                   seq_rules)),
                       STEP.place_batch({"tokens": toks[:, :-1]}, mesh, seq_rules)["tokens"])
    out["embed_placements"] = np.array(str(tuple(emb.placements)))

    # the sharded train steps, each against the port's one-card step
    one_done = set()
    for arch, seq in STEPS:
        tag = f"{arch}_{int(seq)}"
        cfg = get_reduced_config(arch)
        like = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        params = tree_from([d[f"{arch}_p{i}"] for i in range(int(d[f"{arch}_n"]))], like)
        batch = {"tokens": torch.from_numpy(d[f"{arch}_tokens"])}
        opt = OPT.AdamW(lr=1e-2, master_weights=True)
        step, _, _ = STEP.build_train_step(cfg, mesh, SH.default_rules(seq_shard=seq), opt,
                                           donate=False)
        with StridedWatch() as watch:
            p2, _, m2 = step(params, opt.init(params), batch)
        out[f"{tag}_loss"] = m2["loss"].numpy()
        out[f"{tag}_strided_ops"] = np.array(watch.n)
        for i, a in enumerate(flat(p2)):
            out[f"{tag}_p{i}"] = a
        if arch not in one_done:
            one_done.add(arch)
            one, _, _ = STEP.build_train_step(cfg, None, None, opt, donate=False)
            p1, _, m1 = one(params, opt.init(params), batch)
            out[f"{arch}_one_loss"] = m1["loss"].numpy()
            for i, a in enumerate(flat(p1)):
                out[f"{arch}_one_p{i}"] = a
    np.savez(f"{outdir}/rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    port, inp, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mp.spawn(run, args=(port, inp, outdir), nprocs=4)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_step(arch, rng):
    """The reduced arch's weights, a (4, 17) token batch, and one jitted
    single-device AdamW step of the JAX package (lr 1e-2, master weights)."""
    cfg = jbase.get_reduced_config(arch)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tokens = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    opt = JOPT.AdamW(lr=1e-2, master_weights=True)

    def ref_step(params, opt_state, batch):
        (loss, met), g = jax.value_and_grad(
            lambda p: JM.loss_fn(cfg, p, batch), has_aux=True)(params)
        p, s, _ = opt.update(g, opt_state, params)
        return p, dict(met, loss=loss)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "partition_plan_impl", lambda: "xla")
        p1, m1 = jax.jit(ref_step)(params, opt.init(params), {"tokens": jnp.asarray(tokens)})
    return params, tokens, p1, m1


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs made here (numpy seeds, the JAX package's weights), the 4-rank
    world run once, and the JAX side's results."""
    rng = np.random.default_rng(0)
    tmp = tmp_path_factory.mktemp("seq_world")
    inp, ref = {}, {}
    for arch in dict(STEPS):
        jp, tokens, p1, m1 = _jax_step(arch, rng)
        leaves = jax.tree_util.tree_leaves(jp)
        inp.update({f"{arch}_p{i}": np.asarray(a) for i, a in enumerate(leaves)},
                   **{f"{arch}_n": np.array(len(leaves)), f"{arch}_tokens": tokens})
        ref[f"{arch}_loss"] = float(m1["loss"])
        ref[f"{arch}_params"] = [np.asarray(a) for a in jax.tree_util.tree_leaves(p1)]
    inp["lead_x"] = rng.normal(size=(4, 8, 6)).astype(np.float32)
    inp["lead_c"] = rng.normal(size=(4, 8, 6)).astype(np.float32)
    np.savez(tmp / "in.npz", **inp)
    (tmp / "world.py").write_text(WORLD_SCRIPT)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("PYTEST_", "REPRO_"))}
    env.update(PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, str(tmp / "world.py"), str(_free_port()),
                        str(tmp / "in.npz"), str(tmp)],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert p.returncode == 0, (p.stdout[-3000:], p.stderr[-6000:])
    outs = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return inp, ref, outs


@pytest.mark.parametrize("arch,seq", STEPS, ids=[f"{a}-seq{int(s)}" for a, s in STEPS])
def test_sharded_train_step_matches_the_jax_step_and_one_card(world, arch, seq):
    """One AdamW step (lr 1e-2, master weights, donate=False) on the (2, 2)
    mesh with `default_rules(seq_shard=seq)`: the loss within 1e-4 and every
    parameter within 5e-3 of the JAX package's single-device jitted step and
    of the port's one-card step on the same inputs, the same metrics on
    every rank, and no op of the step given a strided shard."""
    _, ref, outs = world
    o, tag = outs[0], f"{arch}_{int(seq)}"
    loss = float(o[f"{tag}_loss"])
    assert abs(loss - ref[f"{arch}_loss"]) < 1e-4
    assert abs(loss - float(o[f"{arch}_one_loss"])) < 1e-4
    want = ref[f"{arch}_params"]
    dw = max(float(np.abs(o[f"{tag}_p{i}"] - w).max()) for i, w in enumerate(want))
    dw1 = max(float(np.abs(o[f"{tag}_p{i}"] - o[f"{arch}_one_p{i}"]).max())
              for i in range(len(want)))
    assert dw < 5e-3 and dw1 < 5e-3, (dw, dw1)
    for r in range(1, WORLD):
        assert float(outs[r][f"{tag}_loss"]) == loss
    assert all(int(x[f"{tag}_strided_ops"]) == 0 for x in outs)


def test_seq_shard_splits_the_residual_stream_over_model(world):
    """With seq_shard=True the embedding's output, (b, s, d), is split over
    'data' on the batch and over 'model' on the sequence."""
    _, _, outs = world
    assert str(outs[0]["embed_placements"]) == "(Shard(dim=0), Shard(dim=1))"


def test_merge_and_split_lead_keep_strided_shards_out_both_ways(world):
    """A (4, 8, 6) tensor sharded on batch ('data') and seq ('model'):
    merge_lead gathers the sequence and flattens to (32, 6) on 'data'
    alone, split_lead gives (4, 8, 6) on 'data' alone, the constraint
    after it splits the sequence again; in the backward the gradients of
    the flat and the unflattened tensors come back on their forward
    values' placements and x's on batch and seq, no op ever sees a strided
    shard, and the values are the plain ones."""
    inp, _, outs = world
    x, c = inp["lead_x"], inp["lead_c"]
    for o in outs:
        np.testing.assert_array_equal(o["lead_flat"], x.reshape(32, 6))
        np.testing.assert_array_equal(o["lead_y"], x * 2)
        np.testing.assert_array_equal(o["lead_grad"], c * 2)
        assert int(o["lead_strided_ops"]) == 0
    o = outs[0]
    batch_only, both = "(Shard(dim=0), Replicate())", "(Shard(dim=0), Shard(dim=1))"
    for name in ("flat", "flat_grad", "back", "back_grad"):
        assert str(o[f"lead_pl_{name}"]) == batch_only, name
    for name in ("y", "x_grad"):
        assert str(o[f"lead_pl_{name}"]) == both, name


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
def test_lead_helpers_and_linear_are_plain_ops_off_a_mesh(rng):
    """Off a mesh merge_lead and split_lead are reshapes, gather_seq and pin
    return their input, seq_sharded is False, and linear is x @ w, bit for
    bit."""
    from repro_torch.dist import sharding as SH
    from repro_torch.models import layers as L

    x = torch.from_numpy(rng.normal(size=(2, 5, 3, 4)).astype(np.float32))
    assert torch.equal(SH.merge_lead(x), x.reshape(10, 3, 4))
    assert torch.equal(SH.merge_lead(x, 3), x.reshape(30, 4))
    assert torch.equal(SH.split_lead(x.reshape(10, 3, 4), (2, 5)), x)
    assert SH.pin(x) is x and L.gather_seq(x) is x and not L.seq_sharded(x)
    w = torch.from_numpy(rng.normal(size=(4, 7)).astype(np.float32))
    assert torch.equal(L.linear(x, w, "mlp"), x @ w)
