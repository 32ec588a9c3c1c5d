"""Fault-tolerant training supervisor (port of
``repro/runtime/supervisor.py:30-141``).

The policies are real, the failure source is injected:

  * **checkpoint-restart**: every ``ckpt_every`` steps via CheckpointManager
    (atomic + async).  On a step failure the supervisor restores the last
    committed checkpoint and replays from there — the data pipeline is a pure
    function of step, so replay is exact.
  * **failure detection**: a FailureInjector raises on chosen steps to
    simulate device loss / preemption.
  * **straggler mitigation**: per-step wall-time EWMA; a step slower than
    ``straggler_factor``× the EWMA is logged and counted.

The reference's elastic re-mesh hook and its slow-step and repeated-failure
injection are left to the sharded train step (ROADMAP queue 1,
"Multi-device"), the slice that trains across a mesh: the port's meshes
(``launch/mesh.py``) run the overlay, expert-parallel MoE and gradient
compression, but its train step still runs on one device.
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
    """Raises SimulatedFailure once on each of the given (1-based) step
    indices; the retry of that step succeeds."""

    fail_at: tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 10
    keep_n: int = 3
    straggler_factor: float = 3.0
    max_restarts: int = 5


@dataclasses.dataclass
class StepResult:
    step: int
    metrics: dict
    seconds: float
    straggler: bool


class Supervisor:
    """Drives (state, batch) -> (state, metrics) step functions with
    checkpoint-restart and a straggler watchdog."""

    def __init__(self, cfg: TrainLoopConfig, ckpt_dir: str,
                 injector: FailureInjector | None = None):
        self.cfg = cfg
        self.manager = CheckpointManager(ckpt_dir, keep_n=cfg.keep_n)
        self.injector = injector or FailureInjector()
        self.history: list[StepResult] = []
        self.restarts = 0
        self.straggler_steps = 0

    def run(self, state: Any, step_fn: Callable[[Any, dict], tuple[Any, dict]],
            batch_fn: Callable[[int], dict], start_step: int = 0) -> Any:
        """Run to total_steps with recovery. Returns the final state."""
        step = start_step
        ewma = None

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
                self.history.append(StepResult(step, metrics, dt, straggler))

                if step % self.cfg.ckpt_every == 0 or \
                        step == self.cfg.total_steps:
                    self.manager.save(step, state)
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                restored, manifest = self.manager.restore_latest(state)
                if restored is not None:
                    state = restored
                    step = int(manifest["step"])
                else:
                    step = start_step
        self.manager.wait()
        return state
