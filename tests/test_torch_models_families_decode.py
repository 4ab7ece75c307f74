"""The port's hybrid, xLSTM, vision and audio families decoding and serving,
against the JAX package's, on the CPU (reduced configs, float32, the JAX
package's own weights carried across):

- teacher-forced decode against the port's own `forward` (tests/
  test_models.py's bound, 5e-2), and decode logits and caches against the
  JAX package's `decode_step` (1e-4 of max(1, max |reference|));
- both `ServeEngine`s side by side on zamba2 and xlstm (the scenarios of
  tests/test_torch_lm_serve.py: the same streams, ticks, errors and counter
  deltas);
- a reused slot decodes as a fresh engine does (every recurrent state leaf
  is reset along its batch axis);
- the serve launcher for a vision and an audio arch draws the same stub
  embeddings and prompts as the JAX package's launcher.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import serve as jlaunch
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM
from repro_torch.serve import engine as TE
from test_torch_lm_serve import SCENARIOS, _run
from test_torch_models import close, t, weights
from test_torch_models_families import FAMILIES, family_batch

RECURRENT = ["zamba2-2.7b", "xlstm-125m"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub(batch, pkg):
    """The family's stub embeddings of a numpy batch, for one package."""
    conv = jnp.asarray if pkg == "jax" else torch.from_numpy
    return {k: conv(v) for k, v in batch.items() if k != "tokens"}


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_equals_reference_and_own_forward(arch):
    """8 decode steps (batch 2) against the JAX package's: logits at every
    step, and the whole cache after the last; then the port's decode,
    teacher-forced, against its own forward."""
    cfg_j, cfg_t = jbase.get_reduced_config(arch), tbase.get_reduced_config(arch)
    jp, tp = weights(arch)
    nb = family_batch(cfg_j, s=8)
    tok = nb["tokens"][:, :8]
    jc = JM.init_cache(cfg_j, jp, 2, 32, _stub(nb, "jax"), jnp.float32)
    tc = TM.init_cache(cfg_t, tp, 2, 32, _stub(nb, "torch"), torch.float32)
    assert jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                  JM.cache_shapes(cfg_j, 2, 32, jnp.float32)) == \
        jax.tree_util.tree_map(lambda s: (s.shape, str(s.dtype).replace("torch.", "")),
                               TM.cache_shapes(cfg_t, 2, 32, torch.float32),
                               is_leaf=lambda x: isinstance(x, TM.TensorSpec))
    assert repr(TM.cache_axes(cfg_t, 2, 32)) == repr(JM.cache_axes(cfg_j, 2, 32))
    step_j = jax.jit(lambda c, tk, pos: JM.decode_step(cfg_j, jp, c, tk, pos))
    logits = []
    for step in range(8):
        jlog, jc = step_j(jc, jnp.asarray(tok[:, step]), jnp.int32(step))
        snap = jax.tree_util.tree_map(torch.clone, tc)
        tlog, tc_next = TM.decode_step(cfg_t, tp, tc, t(tok[:, step]), step)
        # the cache handed in is never written
        assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(snap),
                                                     jax.tree_util.tree_leaves(tc)))
        tc = tc_next
        close(tlog, jlog, what=f"decode logits step {step}")
        logits.append(tlog)
    jl, tl = jax.tree_util.tree_leaves(jc), jax.tree_util.tree_leaves(tc)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        close(a, b, what=f"cache leaf {i}")

    fwd, _ = TM.forward(cfg_t, tp, {**_stub(nb, "torch"), "tokens": t(tok)}, remat=False)
    for step, lg in enumerate(logits):
        assert float((lg - fwd[:, step]).abs().max()) < 5e-2, (arch, step)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("arch", RECURRENT)
def test_engines_side_by_side(arch, scenario):
    """The JAX package's engine (its jitted step) and the port's on the same
    weights and prompts: every step's logits within 1e-4, and the same
    streams, ticks, errors and serve counter deltas."""
    cfg_j = jbase.get_reduced_config(arch)
    jp, tp = weights(arch, seed=7)
    sc = SCENARIOS[scenario]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, cfg_j.vocab_size, r["plen"]).tolist() for r in sc["reqs"]]
    jrec, trec = [], []
    j = _run("jax", cfg_j, jp, sc, prompts, jrec)
    tt = _run("torch", tbase.get_reduced_config(arch), tp, sc, prompts, trec)
    assert len(jrec) == len(trec)
    for step, (a, b) in enumerate(zip(jrec, trec)):
        assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(a).max()), step
    assert j == tt
    assert j[0] > 0 and any(f[0] for f in j[1])


@pytest.mark.parametrize("arch", FAMILIES)
def test_reused_slot_decodes_as_a_fresh_engine(arch, rng):
    """A request admitted into a freed slot produces exactly the output it
    would produce in a fresh engine: every cache leaf with a batch axis (SSM
    conv and state, mLSTM C, n, m and conv, sLSTM c, n, m and h, KV) is
    reset from the pristine cache."""
    cfg = tbase.get_reduced_config(arch)
    _, params = weights(arch, seed=3)
    nb = family_batch(cfg, b=1)
    stub = _stub(nb, "torch")
    p1 = rng.integers(3, cfg.vocab_size, 6).tolist()
    p2 = rng.integers(3, cfg.vocab_size, 4).tolist()
    eng_ref = TE.ServeEngine(cfg, params, max_batch=1, max_len=64, eos_id=-1, batch_stub=stub)
    r_ref = TE.Request(rid=0, prompt=list(p2), max_tokens=5)
    eng_ref.submit(r_ref)
    eng_ref.run()
    eng = TE.ServeEngine(cfg, params, max_batch=1, max_len=64, eos_id=-1, batch_stub=stub)
    r1 = TE.Request(rid=1, prompt=list(p1), max_tokens=7)
    r2 = TE.Request(rid=2, prompt=list(p2), max_tokens=5)
    eng.submit(r1)
    eng.submit(r2)
    eng.run()
    assert r1.done and r2.done
    assert r2.out == r_ref.out, (r2.out, r_ref.out)
    axes = jax.tree_util.tree_leaves(TM.cache_axes(cfg, 1, 64),
                                     is_leaf=lambda x: isinstance(x, TM.AxesLeaf))
    assert all("batch" in a.axes for a in axes)


class _Recorder:
    """Stands in for a launcher's ServeEngine: records the stub embeddings
    and the requests it is given, and runs nothing."""

    def __init__(self, log, Request):
        self.log, self.Request = log, Request

    def __call__(self, cfg, params, *, batch_stub=None, **kw):
        self.log["stub"] = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
                            for k, v in (batch_stub or {}).items()}
        self.log["engine"] = kw
        self.log["requests"] = []
        log = self.log

        class Eng:
            def submit(self, r):
                log["requests"].append((r.rid, list(r.prompt), r.max_tokens))

            def run(self):
                return 1

        return Eng()


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3"])
def test_launcher_serves_the_reference_launchers_prompts(arch, monkeypatch, capsys):
    """Both launchers draw the stub embeddings from numpy's seed before the
    prompts: the same stubs (float32) and the same requests; the port's
    launcher then serves them on the CPU."""
    argv = ["--arch", arch, "--requests", "3", "--max-tokens", "4", "--max-batch", "2",
            "--seed", "5"]
    logs = {"jax": {}, "torch": {}}
    monkeypatch.setattr(jlaunch, "ServeEngine", _Recorder(logs["jax"], JE.Request))
    monkeypatch.setattr(tlaunch, "ServeEngine", _Recorder(logs["torch"], TE.Request))
    monkeypatch.setattr(jlaunch.M, "init_params", lambda cfg, key: {})
    jlaunch.main(argv)
    tlaunch.main(argv + ["--device", "cpu"])
    j, p = logs["jax"], logs["torch"]
    assert sorted(j["stub"]) == sorted(p["stub"]) == [
        "vision_emb" if "vision" in arch else "enc_emb"]
    for k in j["stub"]:
        assert p["stub"][k].dtype == np.float32
        np.testing.assert_array_equal(p["stub"][k], j["stub"][k])
    assert p["requests"] == j["requests"] and len(j["requests"]) == 3
    assert p["engine"] == j["engine"]
    monkeypatch.undo()
    ticks = tlaunch.main(argv + ["--device", "cpu"])
    assert f"3 requests in {ticks} ticks" in capsys.readouterr().out and ticks > 4
