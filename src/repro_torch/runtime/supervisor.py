"""Fault-tolerant training supervisor (port of
``repro/runtime/supervisor.py:30-141``).

The policies are real, the failure source is injected:

  * **checkpoint-restart**: every ``ckpt_every`` steps via CheckpointManager
    (atomic + async).  On a step failure the supervisor restores the last
    committed checkpoint and replays from there — the data pipeline is a pure
    function of step, so replay is exact.
  * **failure detection**: a FailureInjector raises on chosen steps to
    simulate device loss / preemption, ``repeat`` times each (a persistently
    bad node), and sleeps on others (a slow one).
  * **straggler mitigation**: per-step wall-time EWMA; a step slower than
    ``straggler_factor``× the EWMA is logged and counted.
  * **elastic re-mesh**: after ``remesh_after_failures`` consecutive
    failures the supervisor calls ``on_remesh(n)``, which may shrink the
    mesh and re-lower the step on it, then continues from the checkpoint.
    The port's hook may return a function that places a state on the new
    mesh (``launch/steps.shard_train_state``): the supervisor applies it to
    its state, and the whole-leaf checkpoint is then restored into that
    placement.  A hook that returns None (the reference's) leaves the
    state where it is.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.checkpoint import CheckpointManager


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raises SimulatedFailure on the given (1-based) step indices.

    ``repeat`` controls how many times each listed step fails before the
    retry succeeds (repeat > 1 simulates a persistently bad node — the case
    elastic re-meshing exists for); a step of ``slow_at`` sleeps
    ``slow_seconds`` first (a straggler).
    """

    fail_at: tuple[int, ...] = ()
    slow_at: tuple[int, ...] = ()
    slow_seconds: float = 0.05
    repeat: int = 1
    _fired: dict = dataclasses.field(default_factory=dict)

    def check(self, step: int) -> None:
        if step in self.slow_at:
            time.sleep(self.slow_seconds)
        if step in self.fail_at and self._fired.get(step, 0) < self.repeat:
            self._fired[step] = self._fired.get(step, 0) + 1
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 10
    keep_n: int = 3
    straggler_factor: float = 3.0
    max_restarts: int = 5
    remesh_after_failures: int = 3


@dataclasses.dataclass
class StepResult:
    step: int
    metrics: dict
    seconds: float
    straggler: bool


class Supervisor:
    """Drives (state, batch) -> (state, metrics) step functions with
    checkpoint-restart, a straggler watchdog and the elastic re-mesh hook."""

    def __init__(self, cfg: TrainLoopConfig, ckpt_dir: str,
                 injector: FailureInjector | None = None,
                 on_remesh: "Callable[[int], Callable[[Any], Any] | None] | None" = None):
        self.cfg = cfg
        self.manager = CheckpointManager(ckpt_dir, keep_n=cfg.keep_n)
        self.injector = injector or FailureInjector()
        self.on_remesh = on_remesh
        self.history: list[StepResult] = []
        self.restarts = 0
        self.straggler_steps = 0
        self.remeshes = 0

    def run(self, state: Any, step_fn: Callable[[Any, dict], tuple[Any, dict]],
            batch_fn: Callable[[int], dict], start_step: int = 0) -> Any:
        """Run to total_steps with recovery. Returns the final state."""
        step = start_step
        ewma = None
        consecutive_failures = 0

        # resume if a checkpoint exists
        restored, manifest = self.manager.restore_latest(state)
        if restored is not None:
            state = restored
            step = int(manifest["step"])

        while step < self.cfg.total_steps:
            try:
                t0 = time.perf_counter()
                self.injector.check(step + 1)
                batch = batch_fn(step)
                state, metrics = step_fn(state, batch)
                dt = time.perf_counter() - t0

                straggler = ewma is not None and \
                    dt > self.cfg.straggler_factor * ewma
                if straggler:
                    self.straggler_steps += 1
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                step += 1
                consecutive_failures = 0
                self.history.append(StepResult(step, metrics, dt, straggler))

                if step % self.cfg.ckpt_every == 0 or \
                        step == self.cfg.total_steps:
                    self.manager.save(step, state)
            except SimulatedFailure:
                self.restarts += 1
                consecutive_failures += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                if consecutive_failures >= self.cfg.remesh_after_failures \
                        and self.on_remesh is not None:
                    self.remeshes += 1
                    place = self.on_remesh(self.remeshes)
                    if place is not None:
                        state = place(state)
                    consecutive_failures = 0
                restored, manifest = self.manager.restore_latest(state)
                if restored is not None:
                    state = restored
                    step = int(manifest["step"])
                else:
                    step = start_step
        self.manager.wait()
        return state
