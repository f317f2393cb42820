"""Fault-tolerant training: checkpoint, restart, resume (port of
``repro.training.fault_tolerance``).

A failure kills the step. ``run_resilient`` restarts: it makes a fresh
state, restores the latest checkpoint into it, moves the data cursor to
where that checkpoint was taken, and continues, so every step runs
exactly once on exactly its batch. ``StepTimer`` keeps the wall time of
each step and flags one above ``straggler_factor`` times the median of
the last 50. With a checkpoint every ``ckpt_every`` steps, a failure
loses at most that many steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.data.pipeline import DataPipeline
from repro_torch.training.checkpoint import Checkpointer


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StepTimer:
    times: list = dataclasses.field(default_factory=list)
    straggler_factor: float = 3.0

    def record(self, dt: float) -> bool:
        """Records a step's time; True if it is a straggler."""
        self.times.append(dt)
        if len(self.times) < 5:
            return False
        med = float(np.median(self.times[-50:]))
        return dt > self.straggler_factor * med


def run_resilient(
    *,
    train_step: Callable,
    init_state: Callable[[], Any],
    pipeline: DataPipeline,
    ckpt: Checkpointer,
    total_steps: int,
    ckpt_every: int = 10,
    failure_hook: Optional[Callable[[int], None]] = None,
    max_restarts: int = 10,
) -> dict:
    """Run to ``total_steps`` through injected failures.

    ``train_step(state, batch) -> (state, metrics)``; ``init_state()``
    makes a fresh state that a checkpoint restores into (for a model:
    its modules, loaded in place). ``failure_hook(step)`` may raise
    :class:`SimulatedFailure` to model a node loss. Returns
    ``{"metrics", "restarts", "steps_run", "stragglers", "final_state"}``.
    """
    restarts = 0
    timer = StepTimer()
    stragglers = 0

    while True:
        state = init_state()
        start = 0
        if ckpt.latest_step() is not None:
            state, meta = ckpt.restore(state)
            start = meta["step"]
            pipeline.restore(meta["extra"]["data"])
        try:
            metrics = None
            for step in range(start, total_steps):
                batch = pipeline.next()
                if failure_hook is not None:
                    failure_hook(step)
                t0 = time.perf_counter()
                state, metrics = train_step(state, batch)
                if timer.record(time.perf_counter() - t0):
                    stragglers += 1
                if (step + 1) % ckpt_every == 0 or step + 1 == total_steps:
                    ckpt.save(step + 1, state,
                              extra={"data": pipeline.state()}, async_=True)
            ckpt.wait()
            return {"metrics": metrics, "restarts": restarts,
                    "steps_run": total_steps, "stragglers": stragglers,
                    "final_state": state}
        except SimulatedFailure:
            try:  # drain an in-flight save before restarting
                ckpt.wait()
            except Exception:
                pass
            restarts += 1
            if restarts > max_restarts:
                raise
            # the failed run's cursor is dropped; the restore above takes
            # the checkpoint's
            pipeline.step = 0
