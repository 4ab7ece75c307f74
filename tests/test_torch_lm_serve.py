"""The port's continuous-batching LM server (`repro_torch.serve.engine`) and
its launcher (`repro_torch.launch.serve`), on the CPU.

Every assertion of the JAX package's ServeEngine tests holds on the port
(tests/test_data_and_serve.py and tests/test_resilience.py); the two engines
run side by side on carried weights (reduced olmo-1b and qwen2-moe-a2.7b) and
give the same token streams, ticks, errors and serve counter deltas; a
kernel failure reaches the caller instead of being retried or evicted.
"""
from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jget
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.obs import metrics as jmetrics
from repro.resilience import faults as jfaults
from repro.serve import engine as JE
from repro_torch.configs.base import get_reduced_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels._build import KernelError
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as M
from repro_torch.models.params import params_from_numpy
from repro_torch.obs import metrics
from repro_torch.resilience import faults
from repro_torch.serve import engine as TE
from repro_torch.serve.engine import Request, ServeEngine


@pytest.fixture(autouse=True)
def jax_partition_plan_on_its_xla_arm(monkeypatch):
    monkeypatch.setattr(jops, "partition_plan_impl", lambda: "xla")


def init(arch, seed):
    return M.init_params(get_reduced_config(arch), torch.Generator().manual_seed(seed),
                         torch.float32, "cpu")


def decode(cfg):
    return lambda p, c, t, pos: M.decode_step(cfg, p, c, t, pos)


# ---------------------------------------------------------------------------
# tests/test_data_and_serve.py's serving tests, on the port
# ---------------------------------------------------------------------------
def test_serve_engine_completes_all_requests(rng):
    cfg = get_reduced_config("olmo-1b")
    params = init("olmo-1b", 0)
    eng = ServeEngine(cfg, params, max_batch=3, max_len=64, eos_id=-1)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab_size, 4).tolist(),
                    max_tokens=5) for i in range(7)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 5 for r in reqs)
    # slot reuse happened: 7 requests through 3 slots
    assert not eng.queue and all(s is None for s in eng.slot_req)


def test_serve_engine_greedy_determinism(rng):
    """Same prompt twice -> same output (greedy decode, shared cache pos)."""
    cfg = get_reduced_config("granite-8b")
    params = init("granite-8b", 1)
    prompt = rng.integers(3, cfg.vocab_size, 5).tolist()
    outs = []
    for _ in range(2):
        eng = ServeEngine(cfg, params, max_batch=2, max_len=64, eos_id=-1)
        r = Request(rid=0, prompt=list(prompt), max_tokens=6)
        eng.submit(r)
        eng.run()
        outs.append(r.out)
    assert outs[0] == outs[1]


def test_slot_reuse_no_leak(rng):
    """A request admitted into a freed slot produces exactly the output it
    would produce in a fresh engine."""
    cfg = get_reduced_config("olmo-1b")
    params = init("olmo-1b", 3)
    p1 = rng.integers(3, cfg.vocab_size, 6).tolist()
    p2 = rng.integers(3, cfg.vocab_size, 4).tolist()
    eng_ref = ServeEngine(cfg, params, max_batch=1, max_len=64, eos_id=-1)
    r_ref = Request(rid=0, prompt=list(p2), max_tokens=5)
    eng_ref.submit(r_ref)
    eng_ref.run()
    eng = ServeEngine(cfg, params, max_batch=1, max_len=64, eos_id=-1)
    r1 = Request(rid=1, prompt=list(p1), max_tokens=7)
    r2 = Request(rid=2, prompt=list(p2), max_tokens=5)
    eng.submit(r1)
    eng.submit(r2)
    eng.run()
    assert r1.done and r2.done
    assert r2.out == r_ref.out, (r2.out, r_ref.out)


def test_serve_engine_memory_deferral_accounting(rng):
    cfg = get_reduced_config("olmo-1b")
    params = init("olmo-1b", 5)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=64, eos_id=-1,
                      mem_budget_bytes=1000)
    prompts = [rng.integers(3, cfg.vocab_size, 3).tolist() for _ in range(2)]
    r1 = Request(rid=0, prompt=prompts[0], max_tokens=4, mem_bytes=800)
    r2 = Request(rid=1, prompt=prompts[1], max_tokens=4, mem_bytes=800)
    eng.submit(r1)
    eng.submit(r2)
    eng.run()
    assert r1.done and r2.done and not r1.error and not r2.error
    assert r1.ticks_deferred == 0
    assert r2.ticks_deferred > 0
    assert r2.ticks_running == r1.ticks_running
    assert eng.budget.reserved == 0
    assert eng.budget.peak_reserved <= 1000
    assert "ticks_deferred" in ServeEngine.latency_summary()


def test_vector_pos_decode_matches_scalar(rng):
    cfg = get_reduced_config("granite-8b")
    params = init("granite-8b", 0)
    b = 2
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 4)).astype(np.int32))
    c1 = M.init_cache(cfg, params, b, 16, None, torch.float32)
    c2 = jax.tree_util.tree_map(torch.clone, c1)
    for step in range(3):
        l1, c1 = M.decode_step(cfg, params, c1, tokens[:, step], step)
        l2, c2 = M.decode_step(cfg, params, c2, tokens[:, step],
                               torch.full((b,), step, dtype=torch.int32))
        assert float((l1 - l2).abs().max()) < 1e-6


# ---------------------------------------------------------------------------
# tests/test_resilience.py's serving tests, on the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def serve_setup():
    return get_reduced_config("olmo-1b"), init("olmo-1b", 0)


def _engine(serve_setup, **kw):
    cfg, params = serve_setup
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("eos_id", -1)
    kw.setdefault("retry_backoff_s", 0.0)
    return ServeEngine(cfg, params, **kw)


def test_serve_poisoned_query_fails_alone(serve_setup, rng):
    cfg, params = serve_setup
    eng = _engine(serve_setup, step_retries=1)
    real = decode(cfg)

    def step_fn(p, c, t, pos):
        if any(r is not None and r.rid == 2 for r in eng.slot_req):
            raise RuntimeError("poisoned query")
        return real(p, c, t, pos)

    eng._step = step_fn
    reqs = [Request(rid=i, max_tokens=4, retries_left=1,
                    prompt=rng.integers(3, cfg.vocab_size, 3).tolist())
            for i in range(4)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert reqs[2].done and reqs[2].error == "poisoned"
    for r in reqs:
        if r.rid != 2:
            assert r.done and r.error == "" and len(r.out) == 4


def test_serve_step_retry_recovers_transient(serve_setup, rng):
    cfg, params = serve_setup
    eng = _engine(serve_setup, step_retries=2)
    real = decode(cfg)
    calls = {"n": 0}

    def flaky(p, c, t, pos):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return real(p, c, t, pos)

    eng._step = flaky
    before = metrics.counter("resilience.serve_retries").value
    r = Request(rid=0, max_tokens=3, prompt=rng.integers(3, cfg.vocab_size, 3).tolist())
    eng.submit(r)
    eng.run()
    assert r.done and r.error == "" and len(r.out) == 3
    assert metrics.counter("resilience.serve_retries").value == before + 1


def test_serve_load_shedding(serve_setup):
    eng = _engine(serve_setup, max_batch=1, max_queue=2)
    before = metrics.counter("resilience.serve_shed").value
    reqs = [Request(rid=i, prompt=[3, 4], max_tokens=2) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    shed = [r for r in reqs if r.error == "shed"]
    assert len(shed) == 3 and all(r.done for r in shed)
    assert metrics.counter("resilience.serve_shed").value == before + 3
    eng.run()
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 2 for r in reqs if r.error == "")


def test_serve_deadline_eviction(serve_setup):
    eng = _engine(serve_setup, max_batch=1)
    slow = Request(rid=0, prompt=[3, 4, 5], max_tokens=50, deadline_ticks=4)
    queued = Request(rid=1, prompt=[3, 4], max_tokens=2, deadline_ticks=2)
    eng.submit(slow)
    eng.submit(queued)
    eng.run()
    assert slow.done and slow.error == "deadline"
    assert queued.done and queued.error == "deadline"


def test_serve_fault_site(serve_setup):
    eng = _engine(serve_setup, max_batch=1, step_retries=0)
    r = Request(rid=9, prompt=[3, 4], max_tokens=2, retries_left=0)
    eng.submit(r)
    with faults.inject("raise:serve.step@all"):
        eng.run()
    assert r.done and r.error == "poisoned"


def test_serve_deadline_expires_on_admission_tick(serve_setup):
    def occupied_engine():
        eng = _engine(serve_setup, max_batch=1)
        eng.submit(Request(rid=0, prompt=[3, 4, 5], max_tokens=4))
        return eng

    eng = occupied_engine()
    ref = Request(rid=1, prompt=[3, 4], max_tokens=2)
    eng.submit(ref)
    eng.run()
    assert ref.done and ref.error == ""
    admit_tick = ref.submit_tick + ref.ticks_queued

    eng = occupied_engine()
    victim = Request(rid=1, prompt=[3, 4], max_tokens=2, deadline_ticks=admit_tick)
    eng.submit(victim)
    eng.run()
    assert victim.done and victim.error == "deadline"
    assert victim.out == [] and victim.done_tick == admit_tick

    eng = occupied_engine()
    ok = Request(rid=1, prompt=[3, 4], max_tokens=2, deadline_ticks=admit_tick + 10)
    eng.submit(ok)
    eng.run()
    assert ok.done and ok.error == "" and len(ok.out) == 2


def test_serve_requeued_request_reruns_full_prefill(serve_setup, rng):
    cfg, params = serve_setup
    prompt = rng.integers(3, cfg.vocab_size, 3).tolist()
    eng_ref = _engine(serve_setup, max_batch=1)
    r_ref = Request(rid=0, prompt=list(prompt), max_tokens=4)
    eng_ref.submit(r_ref)
    eng_ref.run()
    assert r_ref.done and len(r_ref.out) == 4

    eng = _engine(serve_setup, max_batch=1, step_retries=0)
    real = decode(cfg)
    calls = {"n": 0}

    def step_fn(p, c, t, pos):
        calls["n"] += 1
        if calls["n"] == 5:  # two decode outputs exist; then the step dies
            raise RuntimeError("mid-decode fault")
        return real(p, c, t, pos)

    eng._step = step_fn
    r = Request(rid=1, prompt=list(prompt), max_tokens=4, retries_left=1)
    eng.submit(r)
    eng.run()
    assert r.done and r.error == "" and r.retries_left == 0
    assert r.ticks_retrying >= 1
    assert r.out == r_ref.out, (r.out, r_ref.out)


def test_serve_latency_breakdown(serve_setup, rng):
    cfg, _ = serve_setup
    eng = _engine(serve_setup, max_batch=1)
    reqs = [Request(rid=i, max_tokens=3, prompt=rng.integers(3, cfg.vocab_size, 3).tolist())
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        assert r.done and r.error == ""
        assert r.ticks_running > 0 and r.ticks_retrying == 0
        assert r.ticks_queued + r.ticks_running == r.done_tick - r.submit_tick + 1
    waits = [r.ticks_queued for r in reqs]
    assert waits == sorted(waits) and waits[-1] > waits[0]
    summary = ServeEngine.latency_summary()
    for stage in ("ticks_queued", "ticks_running", "ticks_retrying"):
        assert summary[stage]["count"] >= 3
        assert {"p50", "p95", "p99"} <= set(summary[stage])


# ---------------------------------------------------------------------------
# a failed step leaves the cache as it was; a kernel failure is not retried
# ---------------------------------------------------------------------------
def test_failed_step_leaves_the_cache_untouched(serve_setup, rng):
    """A step that fails after the attention of its first layers (in the
    MLP of the last layer) leaves the engine's cache bit for bit as it was."""
    cfg, params = serve_setup
    eng = _engine(serve_setup, max_batch=2, step_retries=0)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=[5, 6, 7], max_tokens=6, retries_left=1))
    eng.step()
    eng.step()
    snap = jax.tree_util.tree_map(torch.clone, eng.cache)
    real_mlp = M.L.apply_mlp
    calls = {"n": 0}

    def mlp(kind, p, x):
        calls["n"] += 1
        if calls["n"] == cfg.num_layers:
            raise RuntimeError("dies in the last layer")
        return real_mlp(kind, p, x)

    M.L.apply_mlp = mlp
    try:
        eng.step()
    finally:
        M.L.apply_mlp = real_mlp
    assert calls["n"] == cfg.num_layers
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(snap),
                                                 jax.tree_util.tree_leaves(eng.cache)))


def test_kernel_error_is_reraised_not_retried(serve_setup):
    eng = _engine(serve_setup, max_batch=1, step_retries=3)

    def broken(p, c, t, pos):
        raise KernelError("partition_plan: launch failed")

    eng._step = broken
    before = {k: metrics.counter(k).value for k in
              ("resilience.serve_retries", "resilience.serve_evictions")}
    r = Request(rid=0, prompt=[3, 4], max_tokens=2)
    eng.submit(r)
    with pytest.raises(KernelError):
        eng.run()
    assert {k: metrics.counter(k).value for k in before} == before
    assert eng.slot_req[0] is r and not r.done and r.ticks_retrying == 0


def test_kernel_failure_in_moe_routing_reaches_the_caller(monkeypatch):
    """End to end: the MoE layer's partition plan on its kernel arm fails to
    launch; ops turns that into a KernelError, and the engine re-raises it
    on the first attempt instead of retrying or evicting."""
    cfg = get_reduced_config("qwen2-moe-a2.7b")
    eng = ServeEngine(cfg, init("qwen2-moe-a2.7b", 0), max_batch=2, max_len=16, eos_id=-1,
                      step_retries=2, retry_backoff_s=0.0)

    def launch_fails(*a, **k):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(tops, "resolve_impl", lambda impl, *ts: "cuda")
    monkeypatch.setattr(tops, "_partition_plan_radix", launch_fails)
    before = metrics.counter("resilience.serve_retries").value
    eng.submit(Request(rid=0, prompt=[3, 4], max_tokens=2))
    with pytest.raises(KernelError, match="partition_plan: RuntimeError"):
        eng.run()
    assert metrics.counter("resilience.serve_retries").value == before


# ---------------------------------------------------------------------------
# both engines side by side on carried weights
# ---------------------------------------------------------------------------
SERVE_COUNTERS = ("serve.mem_deferrals", "resilience.serve_shed", "resilience.serve_retries",
                  "resilience.serve_evictions", "resilience.serve_deadline_evictions")
SCENARIOS = {
    # 7 requests over 3 slots: slot reuse, per-slot positions
    "plain": dict(engine={"max_batch": 3}, faults=None, reqs=[
        dict(plen=p, max_tokens=m) for p, m in ((4, 5), (2, 6), (6, 3), (3, 7), (5, 2),
                                                 (1, 4), (4, 4))]),
    # a full queue sheds, deadlines evict from the slot and from the queue
    "shed_deadline": dict(engine={"max_batch": 1, "max_queue": 2}, faults=None, reqs=[
        dict(plen=3, max_tokens=40, deadline_ticks=6), dict(plen=2, max_tokens=2),
        dict(plen=2, max_tokens=3, deadline_ticks=4), dict(plen=2, max_tokens=2)]),
    # step failures: one absorbed by a retry, then a poisoned eviction
    "faults": dict(engine={"max_batch": 2, "step_retries": 1},
                   faults="raise:serve.step@2+5+6+7", reqs=[
        dict(plen=3, max_tokens=4), dict(plen=2, max_tokens=5, retries_left=0),
        dict(plen=4, max_tokens=3)]),
    # a memory budget defers the queue head
    "memory": dict(engine={"max_batch": 3, "mem_budget_bytes": 1000}, faults=None, reqs=[
        dict(plen=3, max_tokens=4, mem_bytes=600), dict(plen=2, max_tokens=3, mem_bytes=600),
        dict(plen=2, max_tokens=3, mem_bytes=300)]),
}


def _run(pkg, cfg, params, scenario, prompts, record):
    E, mets, flt = (JE, jmetrics, jfaults) if pkg == "jax" else (TE, metrics, faults)
    eng = E.ServeEngine(cfg, params, max_len=32, eos_id=-1, retry_backoff_s=0.0,
                        **scenario["engine"])
    real = eng._step

    def step_fn(p, c, t, pos):
        logits, cache = real(p, c, t, pos)
        record.append(np.asarray(logits) if pkg == "jax" else logits.numpy())
        return logits, cache

    eng._step = step_fn
    reqs = [E.Request(rid=i, prompt=prompts[i], **{k: v for k, v in r.items() if k != "plen"})
            for i, r in enumerate(scenario["reqs"])]
    before = {k: mets.counter(k).value for k in SERVE_COUNTERS}
    with flt.inject(scenario["faults"]) if scenario["faults"] else contextlib.nullcontext():
        for r in reqs:
            eng.submit(r)
        ticks = eng.run()
    deltas = {k: mets.counter(k).value - before[k] for k in SERVE_COUNTERS}
    fields = [(r.out, r.error, r.done, r.submit_tick, r.done_tick, r.ticks_queued,
               r.ticks_running, r.ticks_retrying, r.ticks_deferred) for r in reqs]
    return ticks, fields, deltas


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b"])
def test_engines_side_by_side(arch, scenario):
    cfg_j = jget(arch)
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    sc = SCENARIOS[scenario]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, cfg_j.vocab_size, r["plen"]).tolist() for r in sc["reqs"]]
    jrec, trec = [], []
    j = _run("jax", cfg_j, jp, sc, prompts, jrec)
    tt = _run("torch", get_reduced_config(arch), tp, sc, prompts, trec)
    assert len(jrec) == len(trec)
    for step, (a, b) in enumerate(zip(jrec, trec)):
        assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(a).max()), step
    if j != tt:
        # a greedy choice between logits closer than the tolerance may go
        # either way: say so, having compared the logits step by step
        margins = [np.diff(np.sort(a, axis=-1)[:, -2:], axis=-1).min() for a in jrec]
        assert min(margins) < 1e-4, (j, tt)
        pytest.fail(f"streams differ at a top-2 margin of {min(margins)} (< 1e-4); "
                    f"the logits agree within the tolerance at every step")
    assert j[0] > 0 and any(f[0] for f in j[1])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_on_the_cpu(capsys):
    ticks = tlaunch.main(["--arch", "qwen2-moe-a2.7b", "--device", "cpu", "--requests", "3",
                          "--max-tokens", "4", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert f"3 requests in {ticks} ticks" in out and ticks > 4


def test_launcher_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--arch", "olmo-1b"])
    assert e.value.code == 1
    assert "--device cpu" in capsys.readouterr().err
