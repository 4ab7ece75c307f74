"""The port's distributed layer on the CPU: sharded train and serve steps on
a DeviceMesh, the grouped MoE dispatch under a mesh, GPipe, the int8
error-feedback all-reduce and elastic resharding, held against the JAX
package's.

One gloo world of 4 ranks (a subprocess that spawns them, each pinned to
one torch thread) runs every multi-rank scenario once; the tests read its
results. The JAX side runs here, on one device, on the same numpy inputs.
Bounds, stated per test, are the JAX package's own tests' (its
`tests/test_distributed.py`): a sharded step's loss within 1e-4 and every
parameter within 5e-3 of the single-device step (Adam amplifies
reduction-order noise), the pipeline within 1e-5, the replicated all-reduce
within one int8 step of its input.
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
from repro.dist import collectives as JCOL
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.train import optimizer as JOPT
from repro_torch.dist import collectives as TCOL
from repro_torch.dist import pipeline as TPIPE

REPO = Path(__file__).resolve().parent.parent
WORLD = 4

WORLD_SCRIPT = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def tree_from(arrays, like):
    from repro_torch.models.params import leaves, map_leaves
    it = iter(arrays)
    return map_leaves(lambda _: torch.from_numpy(next(it)), like, is_leaf=torch.is_tensor)


def flat(tree):
    from repro_torch.dist import sharding as SH
    from repro_torch.models.params import leaves
    return [SH.full(t).detach().numpy() for t in leaves(tree, torch.is_tensor)]


def run(rank, port, inp, outdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.dist import collectives as COL
    from repro_torch.dist import pipeline as PIPE
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import leaves
    from repro_torch.train import elastic as EL
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import step as STEP

    d = dict(np.load(inp))
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    rules = SH.default_rules()

    # sharded train step (olmo-1b reduced), against the port's one-card step
    cfg = get_reduced_config("olmo-1b")
    like = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = tree_from([d[f"olmo_p{i}"] for i in range(int(d["olmo_n"]))], like)
    batch = {"tokens": torch.from_numpy(d["olmo_tokens"])}
    opt = OPT.AdamW(lr=1e-2, master_weights=True)
    step, psh, bsh = STEP.build_train_step(cfg, mesh, rules, opt, donate=False)
    p2, s2, m2 = step(params, opt.init(params), batch)
    out["train_loss"] = m2["loss"].numpy()
    out["train_sharded_leaves"] = np.array(sum(SH.is_dtensor(t) and
                                               any(p.is_shard() for p in t.placements)
                                               for t in leaves(p2, torch.is_tensor)))
    for i, a in enumerate(flat(p2)):
        out[f"train_p{i}"] = a
    one, _, _ = STEP.build_train_step(cfg, None, None, opt, donate=False)
    p1, _, m1 = one(params, opt.init(params), batch)
    out["one_loss"] = m1["loss"].numpy()
    for i, a in enumerate(flat(p1)):
        out[f"one_p{i}"] = a

    # sharded serve step (mixtral-8x7b reduced, b=4, w=32)
    cfg = get_reduced_config("mixtral-8x7b")
    like = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = tree_from([d[f"mx_p{i}"] for i in range(int(d["mx_n"]))], like)
    serve, _, csh, tsh = STEP.build_serve_step(cfg, mesh, rules, 4, 32)
    cache = M.init_cache(cfg, params, 4, 32, {}, torch.float32)
    tok = torch.from_numpy(d["mx_tok"])
    logits, cache2 = serve(params, cache, tok, 0)
    out["serve_logits"] = SH.full(logits).numpy()
    out["serve_logits_one"] = M.decode_step(cfg, params, cache, tok, 0)[0].numpy()
    logits, _ = serve(params, cache2, tok + 1, 1)
    out["serve_logits_2"] = SH.full(logits).numpy()
    out["serve_logits_2_one"] = M.decode_step(
        cfg, params, M.decode_step(cfg, params, cache, tok, 0)[1], tok + 1, 1)[0].numpy()

    # the grouped MoE dispatch under the mesh: groups = 2 token shards
    p = {k: torch.from_numpy(d[f"moe_{k}"]) for k in ("router", "wg", "wu", "wd")}
    with SH.sharding_ctx(mesh, rules):
        assert MOE._num_token_groups(32) == 2
        y = MOE._dispatch_sort_grouped(p, torch.from_numpy(d["moe_x"]),
                                       torch.from_numpy(d["moe_idx"]),
                                       torch.from_numpy(d["moe_gates"]),
                                       k=2, E=4, cf=float(d["moe_cf"]), groups=2)
    out["moe_y"] = SH.full(y).numpy()
    out["moe_y_placements"] = np.array(str(tuple(y.placements)))

    # GPipe over 'pod' on a (2, 2, 1) mesh
    mesh3 = make_mesh((2, 2, 1), ("pod", "data", "model"), device_type="cpu")

    def stage_fn(wstack, h):
        for w in wstack:
            h = torch.tanh(h @ w)
        return h

    stages = PIPE.split_layers_to_stages(torch.from_numpy(d["pipe_ws"]), 2)
    out["pipe_y"] = PIPE.pipeline_forward(stage_fn, stages, torch.from_numpy(d["pipe_x"]),
                                          mesh=mesh3, axis="pod", n_micro=4).numpy()

    # the int8 EF all-reduce over 'data': replicated input, then each rank's own
    g = {"w": torch.from_numpy(d["psum_lin"])}
    o, _ = COL.compressed_psum_dp(g, COL.init_ef_state(g), mesh, axis="data")
    out["psum_lin"] = o["w"].numpy()
    g = {"w": torch.from_numpy(d[f"psum_rank{rank}"])}
    o, ef = COL.compressed_psum_dp(g, COL.init_ef_state(g), mesh, axis=("pod", "data"))
    out["psum_mean"] = o["w"].numpy()
    out["psum_err"] = ef.error["w"].numpy()

    # elastic: (2, 2) -> (4, 1) -> (1, 2) over ranks 0-1, and back to plain tensors
    cfg = get_reduced_config("granite-8b")
    params = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    opt = OPT.AdamW()
    state = opt.init(params)
    state.step.fill_(7)
    before = flat(params) + flat(state.mu)
    p4, s4 = EL.reshard_state(cfg, params, state, mesh)
    p8, s8 = EL.reshard_state(cfg, p4, s4, make_mesh((4, 1), ("data", "model"),
                                                     device_type="cpu"))
    out["elastic_model_shard"] = np.array(str(leaves(p8, torch.is_tensor)[0].placements))
    small = make_mesh((1, 2), ("data", "model"), device_type="cpu", ranks=[0, 1])
    p2_, s2_ = EL.reshard_state(cfg, p8, s8, small)
    if rank in (0, 1):
        pf, sf = EL.reshard_state(cfg, p2_, s2_, None)
        after = flat(pf) + flat(sf.mu)
        out["elastic_equal"] = np.array(all(np.array_equal(a, b)
                                            for a, b in zip(before, after)))
        out["elastic_step"] = sf.step.numpy()
    out["elastic_div"] = np.array([EL.validate_batch_divisibility(8, mesh),
                                   EL.validate_batch_divisibility(7, mesh)])
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


def _olmo(rng):
    cfg = jbase.get_reduced_config("olmo-1b")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tokens = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    opt = JOPT.AdamW(lr=1e-2, master_weights=True)

    def ref_step(params, opt_state, batch):
        (loss, met), g = jax.value_and_grad(
            lambda p: JM.loss_fn(cfg, p, batch), has_aux=True)(params)
        p, s, _ = opt.update(g, opt_state, params)
        return p, dict(met, loss=loss)

    p1, m1 = jax.jit(ref_step)(params, opt.init(params), {"tokens": jnp.asarray(tokens)})
    return params, tokens, p1, m1


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs made here (numpy seeds, the JAX package's weights), the 4-rank
    world run once, and the JAX side's results."""
    rng = np.random.default_rng(0)
    tmp = tmp_path_factory.mktemp("world")
    inp, ref = {}, {}
    jp, tokens, p1, m1 = _olmo(rng)
    leaves = jax.tree_util.tree_leaves(jp)
    inp.update({f"olmo_p{i}": np.asarray(a) for i, a in enumerate(leaves)},
               olmo_n=np.array(len(leaves)), olmo_tokens=tokens)
    ref["olmo_loss"] = float(m1["loss"])
    ref["olmo_params"] = [np.asarray(a) for a in jax.tree_util.tree_leaves(p1)]

    cmx = jbase.get_reduced_config("mixtral-8x7b")
    jmx = JM.init_params(cmx, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(jmx)
    inp.update({f"mx_p{i}": np.asarray(a) for i, a in enumerate(leaves)},
               mx_n=np.array(len(leaves)),
               mx_tok=rng.integers(0, cmx.vocab_size, (4,)).astype(np.int32))
    moe = {k: np.asarray(v[0]) for k, v in jmx["layers"]["moe"].items()}
    x2 = rng.normal(size=(32, cmx.d_model)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "partition_plan_impl", lambda: "xla")
        idx, gates, _ = JMOE._route(moe, jnp.asarray(x2), cmx.moe.top_k)
        ref["moe_y"] = np.asarray(JMOE._dispatch_sort_grouped(
            moe, jnp.asarray(x2), idx, gates, k=cmx.moe.top_k, E=cmx.moe.num_experts,
            cf=cmx.moe.capacity_factor, groups=2))
    inp.update({f"moe_{k}": v for k, v in moe.items()}, moe_x=x2,
               moe_idx=np.asarray(idx), moe_gates=np.asarray(gates),
               moe_cf=np.array(cmx.moe.capacity_factor))

    ws = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 16, 16)) * 0.3)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 16)))

    def stage_fn(wstack, xm):
        return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), xm, wstack)[0]

    ref["pipe_y"] = np.asarray(stage_fn(jnp.asarray(ws), jnp.asarray(x)))
    inp.update(pipe_ws=ws, pipe_x=x)
    inp["psum_lin"] = np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8)
    for r in range(WORLD):
        inp[f"psum_rank{r}"] = np.random.default_rng(100 + r).normal(
            size=(8, 8)).astype(np.float32)
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


def test_sharded_train_step_matches_the_jax_step_and_one_card(world):
    """olmo-1b reduced on a (2, 2) mesh, donate=False: the JAX package's
    bounds against its single-device jitted step (dloss < 1e-4, dw < 5e-3);
    the port's one-card step on the same inputs within the same bounds; and
    the parameters really sharded."""
    _, ref, outs = world
    o = outs[0]
    assert abs(float(o["train_loss"]) - ref["olmo_loss"]) < 1e-4
    assert abs(float(o["train_loss"]) - float(o["one_loss"])) < 1e-4
    n = len(ref["olmo_params"])
    dw = max(float(np.abs(o[f"train_p{i}"] - ref["olmo_params"][i]).max()) for i in range(n))
    dw1 = max(float(np.abs(o[f"train_p{i}"] - o[f"one_p{i}"]).max()) for i in range(n))
    assert dw < 5e-3 and dw1 < 5e-3, (dw, dw1)
    assert int(o["train_sharded_leaves"]) > 0
    for r in range(1, WORLD):  # every rank returns the same metrics
        assert float(outs[r]["train_loss"]) == float(o["train_loss"])


def test_sharded_serve_step_matches_one_card(world):
    """mixtral-8x7b reduced, b=4, w=32, two decode steps: finite logits of
    shape (4, padded_vocab) within 1e-4 of the largest logit of the
    one-card decode_step's."""
    _, _, outs = world
    cfg = jbase.get_reduced_config("mixtral-8x7b")
    for key in ("serve_logits", "serve_logits_2"):
        got, want = outs[0][key], outs[0][key + "_one"]
        assert got.shape == (4, cfg.padded_vocab) and np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), key


def test_grouped_moe_dispatch_on_a_mesh_matches_the_jax_package(world):
    """groups = 2 token shards, each planned on its rank's local tensors,
    against the JAX package's _dispatch_sort_grouped with groups=2."""
    _, ref, outs = world
    np.testing.assert_allclose(outs[0]["moe_y"], ref["moe_y"], rtol=1e-5, atol=1e-5)
    assert "Shard(dim=0)" in str(outs[0]["moe_y_placements"])


def test_pipeline_forward_over_pod_matches_the_jax_stage_fn(world):
    """L=4, D=16, n_micro=4 over 'pod' of a (2, 2, 1) mesh: every rank holds
    the last stage's outputs, within 1e-5 of stage_fn(ws, x)."""
    _, ref, outs = world
    for o in outs:
        assert float(np.abs(o["pipe_y"] - ref["pipe_y"]).max()) < 1e-5


def test_compressed_psum_dp_replicated_input_within_one_int8_step(world):
    """An 8x8 linspace on every rank: the mean equals the input within one
    quantization step (the JAX package's bound)."""
    inp, _, outs = world
    g = inp["psum_lin"]
    scale = float(np.abs(g).max()) / 127
    for o in outs:
        assert float(np.abs(o["psum_lin"] - g).max()) <= scale * 1.01 + 1e-7


def test_compressed_psum_dp_is_the_mean_of_each_ranks_dequantized_value(world):
    """A different gradient per rank, axis ('pod', 'data') (pod is absent
    and dropped): each rank gets the float64 mean of its data group's
    dequantized values (ranks r and r+2 of the (2, 2) mesh), within float32
    rounding, and keeps its own residual."""
    inp, _, outs = world
    deq = []
    for r in range(WORLD):
        g = {"w": torch.from_numpy(inp[f"psum_rank{r}"])}
        dec, ef = TCOL.ef_compress_decompress(g, TCOL.init_ef_state(g))
        deq.append(dec["w"].double().numpy())
        np.testing.assert_array_equal(outs[r]["psum_err"], ef.error["w"].numpy())
    for r in range(WORLD):
        want = (deq[r % 2] + deq[r % 2 + 2]) / 2
        np.testing.assert_allclose(outs[r]["psum_mean"], want, rtol=0, atol=1e-6)


def test_reshard_state_round_trips_bit_for_bit(world):
    """granite-8b reduced from plain tensors onto (2, 2), then (4, 1), then
    (1, 2) over ranks 0-1 and back to plain tensors: parameters and moments
    bit-equal, the step kept; the batch divisibility check."""
    _, _, outs = world
    for r in (0, 1):
        assert bool(outs[r]["elastic_equal"]) and int(outs[r]["elastic_step"]) == 7
    assert "Shard(dim=1)" in str(outs[0]["elastic_model_shard"])  # the table's embed dim
    for o in outs:
        assert o["elastic_div"].tolist() == [True, False]


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
def test_int8_quantization_and_error_feedback_equal_the_jax_package(rng):
    x = rng.normal(size=(37, 11)).astype(np.float32) * 3
    jq, js = JCOL.quantize_int8(jnp.asarray(x))
    tq, ts = TCOL.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == torch.float32 and ts.numpy() == np.asarray(js)
    np.testing.assert_array_equal(TCOL.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(JCOL.dequantize_int8(jq, js)))
    g = {"a": x, "b": rng.normal(size=(5,)).astype(np.float32)}
    e = {"a": rng.normal(size=x.shape).astype(np.float32) * 1e-3,
         "b": np.zeros(5, np.float32)}
    jd, je = JCOL.ef_compress_decompress(jax.tree_util.tree_map(jnp.asarray, g),
                                         JCOL.EFState(jax.tree_util.tree_map(jnp.asarray, e)))
    td, te = TCOL.ef_compress_decompress({k: torch.from_numpy(v) for k, v in g.items()},
                                         TCOL.EFState({k: torch.from_numpy(v)
                                                       for k, v in e.items()}))
    for k in g:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
        np.testing.assert_array_equal(te.error[k].numpy(), np.asarray(je.error[k]))


def test_int8_quantize_roundtrip(rng):
    x = torch.from_numpy(rng.normal(size=1000).astype(np.float32))
    q, s = TCOL.quantize_int8(x)
    assert float((TCOL.dequantize_int8(q, s) - x).abs().max()) <= float(s) * 0.51 + 1e-7


def test_ef_compression_converges():
    """EF-int8 SGD reaches the optimum a plain-quantized SGD cannot (the
    JAX package's test_ef_compression_converges on the port)."""
    w = torch.tensor([1.0, -2.0, 0.5])
    target = torch.tensor([0.3, 0.7, -0.2])
    ef = TCOL.init_ef_state({"w": w})
    params = {"w": w}
    for _ in range(400):
        g_c, ef = TCOL.ef_compress_decompress({"w": params["w"] - target}, ef)
        params = {"w": params["w"] - 0.05 * g_c["w"]}
    assert float((params["w"] - target).abs().max()) < 1e-2


class _Mesh:
    shape = {"data": 1, "model": 4}


def test_compressed_psum_dp_with_no_axis_to_reduce_is_ef_bit_for_bit(rng):
    """Axes of size 1 or absent are dropped: over none, the result is
    ef_compress_decompress's, bit for bit (what a one-card mesh returns)."""
    g = {"w": torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32))}
    ef = TCOL.init_ef_state(g)
    got, gef = TCOL.compressed_psum_dp(g, ef, _Mesh(), axis=("pod", "data"))
    want, wef = TCOL.ef_compress_decompress(g, ef)
    assert torch.equal(got["w"], want["w"]) and torch.equal(gef.error["w"], wef.error["w"])


def test_pipeline_without_a_pipeline_axis_runs_the_sequential_schedule():
    ws = torch.randn(4, 8, 8, generator=torch.Generator().manual_seed(0)) * 0.3
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))

    def stage_fn(wstack, h):
        for w in wstack:
            h = torch.tanh(h @ w)
        return h

    stages = TPIPE.split_layers_to_stages(ws, 2)
    assert stages.shape == (2, 2, 8, 8)
    want = stage_fn(ws, x)
    assert torch.equal(TPIPE.pipeline_forward(stage_fn, stages, x), want)
    assert torch.equal(TPIPE.pipeline_forward(stage_fn, stages, x, mesh=_Mesh(), axis="pod"),
                       want)
    with pytest.raises(ValueError, match="do not split"):
        TPIPE.split_layers_to_stages(ws, 3)
