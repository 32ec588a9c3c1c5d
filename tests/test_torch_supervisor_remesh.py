"""The supervisor's elastic re-mesh, straggler and repeated-failure
injection (``runtime/supervisor.py``) against the JAX package's
``repro/runtime/supervisor.py``.

Twins: the reference's ``Supervisor`` and the port's run the same failure
schedules on a scalar state (a jnp scalar there, a torch one here; each
step adds ``step + 1``): their restarts, straggler steps, re-meshes, the
hook's calls, the history's steps and the final state are equal.  Each
step sleeps 20 ms, so that only a step of ``slow_at`` (250 ms more) is a
straggler.

On 4 gloo ranks (``tests/torch_ranks.py``) the hook moves a sharded phi3
run (float32 smoke config) from ``(data 2, model 2)`` to ``(data 4, model
1)`` after step 3 fails 3 times; the state is restored onto the new mesh
from the whole-leaf checkpoint of step 2.  Held to an uninterrupted
single-device run of the same 4 steps: each step's loss within a relative
1e-5, each final parameter within 1e-5 of the leaf's largest plus 0.1 x lr
a step (a sharded contraction sums in another order), and within lr a
step where some step's gradient was below 1e-6 (AdamW's ``lr * g / (|g| +
eps)`` turns on the rounding of such a gradient).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import supervisor as jsup
from repro_torch.runtime import supervisor as tsup
from tests.torch_ranks import REMESH_FAIL_AT, REMESH_LR, REMESH_STEPS, remesh_run, spawn

STEP_S = 0.02
NEAR_EPS = 1e-6

SCHEDULES = {   # name: (loop config, injector)
    "clean": (dict(total_steps=7, ckpt_every=3), dict()),
    "one_failure": (dict(total_steps=8, ckpt_every=2), dict(fail_at=(5,))),
    "two_failures": (dict(total_steps=9, ckpt_every=3), dict(fail_at=(4, 7))),
    "straggler": (dict(total_steps=8, ckpt_every=100, straggler_factor=3.0),
                  dict(slow_at=(6,), slow_seconds=0.25)),
    "remesh": (dict(total_steps=6, ckpt_every=1, max_restarts=10, remesh_after_failures=3),
               dict(fail_at=(2,), repeat=3)),
    "remesh_twice": (dict(total_steps=7, ckpt_every=1, max_restarts=10,
                          remesh_after_failures=3), dict(fail_at=(2, 5), repeat=3)),
    "repeat_below_remesh": (dict(total_steps=6, ckpt_every=1, max_restarts=10,
                                 remesh_after_failures=3), dict(fail_at=(3,), repeat=2)),
    "no_checkpoint_yet": (dict(total_steps=5, ckpt_every=10, max_restarts=10,
                               remesh_after_failures=2), dict(fail_at=(2,), repeat=2)),
}


def _run(lib, zeros, as_value, tmp_path, name):
    loop, inj = SCHEDULES[name]
    calls = []
    sup = lib.Supervisor(lib.TrainLoopConfig(**loop), str(tmp_path / name),
                         injector=lib.FailureInjector(**inj), on_remesh=calls.append)

    def step(state, batch):
        time.sleep(STEP_S)
        return state + batch["v"], {}

    final = sup.run(zeros, step, lambda s: {"v": as_value(s + 1.0)})
    return {"restarts": sup.restarts, "straggler_steps": sup.straggler_steps,
            "remeshes": sup.remeshes, "calls": calls,
            "history": [h.step for h in sup.history],
            "stragglers": [h.step for h in sup.history if h.straggler],
            "final": float(final)}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_supervisor_matches_the_reference(tmp_path, name):
    ref = _run(jsup, jnp.zeros(()), jnp.asarray, tmp_path / "jax", name)
    got = _run(tsup, torch.zeros(()), torch.tensor, tmp_path / "torch", name)
    assert got == ref
    loop, _ = SCHEDULES[name]
    assert got["history"][-1] == loop["total_steps"]


def test_schedules_do_what_they_say(tmp_path):
    """The twins above are not vacuous: the straggler, the re-meshes and
    the restarts each happen."""
    run = lambda name: _run(tsup, torch.zeros(()), torch.tensor, tmp_path, name)  # noqa: E731
    assert run("straggler")["stragglers"] == [6]
    assert run("remesh")["calls"] == [1] and run("remesh_twice")["calls"] == [1, 2]
    r = run("repeat_below_remesh")
    assert (r["restarts"], r["remeshes"]) == (2, 0)
    # with no checkpoint the run replays step 1, whose success resets the count
    r = run("no_checkpoint_yet")
    assert (r["restarts"], r["remeshes"], r["history"][:3]) == (2, 0, [1, 1, 1])
    assert run("two_failures")["final"] == sum(range(1, 10))


def test_restarts_past_the_limit_raise_in_both(tmp_path):
    for lib, zeros, as_value in ((jsup, jnp.zeros(()), jnp.asarray),
                                 (tsup, torch.zeros(()), torch.tensor)):
        sup = lib.Supervisor(lib.TrainLoopConfig(total_steps=4, max_restarts=2),
                             str(tmp_path / lib.__name__),
                             injector=lib.FailureInjector(fail_at=(2,), repeat=5))
        with pytest.raises(lib.SimulatedFailure):
            sup.run(zeros, lambda s, b: (s + b["v"], {}), lambda s: {"v": as_value(1.0)})
        assert sup.restarts == 3


def test_failure_injector_repeats_then_lets_the_step_through():
    for lib in (jsup, tsup):
        inj = lib.FailureInjector(fail_at=(3,), repeat=2)
        inj.check(2)
        for _ in range(2):
            with pytest.raises(lib.SimulatedFailure):
                inj.check(3)
        inj.check(3)


def test_remesh_hook_places_the_state_before_the_restore(tmp_path):
    """A hook that returns a function: the supervisor places its state
    with it, then restores the checkpoint into that placement; without a
    checkpoint the placed state goes on."""
    placed = []

    def on_remesh(n):
        def place(state):
            placed.append(n)
            return state.clone()
        return place

    sup = tsup.Supervisor(tsup.TrainLoopConfig(total_steps=4, ckpt_every=1, max_restarts=10,
                                               remesh_after_failures=2),
                          str(tmp_path), injector=tsup.FailureInjector(fail_at=(3,), repeat=2),
                          on_remesh=on_remesh)
    final = sup.run(torch.zeros(()), lambda s, b: (s + b["v"], {}),
                    lambda s: {"v": torch.tensor(s + 1.0)})
    assert placed == [1] and sup.remeshes == 1 and float(final) == 10.0


@pytest.fixture(scope="module")
def remesh(tmp_path_factory):
    d = tmp_path_factory.mktemp("remesh")
    return spawn(4, remesh_run, d, str(d), time_limit=300)


def test_remesh_moves_the_run_to_the_smaller_mesh(remesh):
    for rank in remesh:
        assert rank["remeshes"] == 1 and rank["calls"] == [1] and rank["restarts"] == 3
        assert rank["history"] == [1, 2, 3, 4]
        assert rank["on_last_mesh"]
        assert rank["losses"] == remesh[0]["losses"]


def test_remeshed_run_ends_at_the_single_device_run(remesh):
    r = remesh[0]
    np.testing.assert_allclose(r["losses"], r["single_losses"], rtol=1e-5)
    assert len(r["params"]) == len(r["single_params"])
    for i, (got, want) in enumerate(zip(r["params"], r["single_params"])):
        got, want = got.numpy(), want.numpy()
        near = np.zeros(want.shape, bool)
        for grads in r["single_grads"]:
            near |= np.abs(grads[i].numpy()) < NEAR_EPS
        atol = 1e-5 * float(np.abs(want).max()) + 0.1 * REMESH_LR * REMESH_STEPS
        np.testing.assert_allclose(np.where(near, 0, got), np.where(near, 0, want), rtol=0,
                                   atol=atol, err_msg=f"leaf {i}")
        np.testing.assert_allclose(np.where(near, got, 0), np.where(near, want, 0), rtol=0,
                                   atol=atol + REMESH_LR * REMESH_STEPS,
                                   err_msg=f"leaf {i} near eps")
    assert REMESH_FAIL_AT <= REMESH_STEPS
