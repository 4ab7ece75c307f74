"""Fault-tolerant training loop: checkpoint/restart, straggler detection,
preemption handling.

  * crash-resume: every `ckpt_every` steps the full (params, opt) state is
    saved atomically; on start the loop resumes from LATEST — killing the
    process at any point loses at most `ckpt_every` steps (two half-runs
    equal one run, bit for bit).
  * preemption: SIGTERM flips a flag; the loop checkpoints and exits so the
    scheduler can reschedule without losing work.
  * straggler detection: per-step wall time is tracked against a rolling
    median; steps slower than `straggler_factor`x are logged with their
    step index (advisory on one process).

A step's time ends at `float(metrics["loss"])`, which waits for the card.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Callable

from . import checkpoint as CKPT


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    final_step: int
    losses: list
    straggler_steps: list
    resumed_from: int | None
    preempted: bool = False


class _Preemption:
    def __init__(self):
        self.flag = False
        try:
            signal.signal(signal.SIGTERM, self._handler)
        except ValueError:
            pass  # not in main thread (tests)

    def _handler(self, *_):
        self.flag = True


def train_loop(step_fn: Callable, params, opt_state, data_iter, cfg: LoopConfig,
               *, state_extra: dict | None = None,
               log: Callable = print) -> tuple:
    """Runs step_fn(params, opt_state, batch) -> (params, opt_state, metrics).

    data_iter must be resumable: it is constructed from a step index by the
    caller (deterministic synthetic pipeline), so resume replays nothing.
    Returns (params, opt_state, LoopReport).
    """
    start_step = 0
    resumed_from = None
    if cfg.ckpt_dir and CKPT.latest_step(cfg.ckpt_dir) is not None:
        (params, opt_state), start_step, _ = CKPT.restore_checkpoint(
            cfg.ckpt_dir, (params, opt_state)
        )
        resumed_from = start_step
        log(f"[loop] resumed from step {start_step}")

    preempt = _Preemption()
    losses, stragglers, times = [], [], []
    step = start_step
    while step < cfg.total_steps:
        batch = data_iter(step)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        times.append(dt)
        step += 1
        losses.append(loss)
        if len(times) >= 5:
            med = statistics.median(times[-50:])
            if dt > cfg.straggler_factor * med:
                stragglers.append((step, dt, med))
                log(f"[straggler] step {step}: {dt:.3f}s vs median {med:.3f}s")
        if step % cfg.log_every == 0:
            log(f"[loop] step {step} loss={losses[-1]:.4f} ({dt*1e3:.0f} ms)")
        if cfg.ckpt_dir and (step % cfg.ckpt_every == 0 or step == cfg.total_steps
                             or preempt.flag):
            CKPT.save_checkpoint(cfg.ckpt_dir, step, (params, opt_state),
                                 extra=state_extra, keep=cfg.keep)
        if preempt.flag:
            log(f"[loop] preempted at step {step}; checkpointed and exiting")
            break

    report = LoopReport(
        steps_run=step - start_step, final_step=step, losses=losses,
        straggler_steps=stragglers, resumed_from=resumed_from,
        preempted=preempt.flag,
    )
    return params, opt_state, report
