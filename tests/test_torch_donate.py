"""Buffer donation in the port's overlay frontend: ``Overlay.jit(...,
donate_argnums=)``.

Held against the JAX package where the logic is shared (the user-level
argnums expanded to flat leaf indices, ``JitAssembled._donate_leaf_indices``,
and their shift past the kernel's ``routes`` argument,
``cache.kernel_jit_kwargs``), and against plain PyTorch for the numbers:
each donated output lands in its input's storage on every path that serves
a call — the generic walk, the route-constant tier, the eager fallback of an
asynchronous overlay and of a failed dispatch — with values equal to the
function run eagerly, and a donated and an undonated kernel of one function
keep distinct cache and store keys.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Overlay as JOverlay
from repro.core import cache as jcache
from repro_torch.core import (BitstreamStore, FaultPlan, FleetOverlay, Overlay,
                              PlacementPolicy, SpecializedKernel)
from repro_torch.core import cache as tcache
from repro_torch.core import interpreter as interp
from repro_torch.core.trace import SerialError


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rand(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def step(state, x):
    """A functional "train step": new state, and a metric."""
    w, m = state["w"], state["m"]
    m2 = 0.9 * m + x
    w2 = w - 0.1 * m2
    return {"w": w2, "m": m2}, (w * m).sum()


def _state(seed=0):
    return {"w": _rand(seed, 4, 8), "m": _rand(seed + 1, 4, 8)}


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


def _ptrs(tree):
    return {k: v.data_ptr() for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the shared logic, against the JAX package
# ---------------------------------------------------------------------------
PYTREES = [
    # (args as nested python structure of leaf shapes, static, donated)
    ((((2,), (3,)), (4,)), (), (0,)),
    ((((2,), (3,)), (4,)), (), (1,)),
    (({"b": (2,), "a": [(3,), (1, 2)]}, (4,), [(5,), (6,)]), (), (0, 2)),
    (({"a": (2,)}, 7, [(5,), (6,)]), (1,), (2,)),
    (((), (3,), ((2,), ((4,), (5,)))), (), (2,)),
    ((((2,),), ((3,),)), (), ()),
]


def _make(spec, leaf):
    if isinstance(spec, int):
        return spec                                  # a static python value
    if isinstance(spec, dict):
        return {k: _make(v, leaf) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_make(v, leaf) for v in spec]
    if spec and all(isinstance(d, int) for d in spec):
        return leaf(spec)
    if spec == ():
        return leaf(())
    return tuple(_make(v, leaf) for v in spec)


@pytest.mark.parametrize("case", range(len(PYTREES)))
def test_donate_leaf_indices_match_the_reference(case):
    structure, static, donate = PYTREES[case]
    jargs = _make(structure, lambda s: jnp.zeros(s, jnp.float32))
    targs = _make(structure, lambda s: torch.zeros(s))
    jw = JOverlay(3, 3).jit(lambda *a: a, static_argnums=static, donate_argnums=donate)
    tw = Overlay(3, 3).jit(lambda *a: a, static_argnums=static, donate_argnums=donate)
    assert tw._donate_leaf_indices(targs) == jw._donate_leaf_indices(jargs)
    assert tw._jit_kwargs(targs) == jw._jit_kwargs(jargs)


@pytest.mark.parametrize("kw", [None, {}, {"donate_argnums": 0},
                                {"donate_argnums": (0, 2, 5)},
                                {"static_argnums": (1,), "donate_argnums": (0,)},
                                {"donate_argnums": ()}])
def test_kernel_key_shift_matches_the_reference(kw):
    assert tcache.kernel_jit_kwargs(kw) == jcache.kernel_jit_kwargs(kw)


def test_argnames_are_refused_like_the_reference():
    for mod in (tcache, jcache):
        with pytest.raises(ValueError):
            mod.kernel_jit_kwargs({"donate_argnames": ("x",)})


def test_static_and_donated_argument_is_refused():
    with pytest.raises(ValueError):
        Overlay(3, 3).jit(step, static_argnums=(0,), donate_argnums=(0,))


# ---------------------------------------------------------------------------
# keys: donated and undonated kernels never share an entry
# ---------------------------------------------------------------------------
def test_donated_and_undonated_kernels_have_distinct_cache_keys():
    ov = Overlay(3, 3)
    plain = ov.jit(step, name="step")
    donated = ov.jit(step, name="step", donate_argnums=(0,))
    x = _rand(5, 4, 8)
    want = step(_state(), x)
    got_plain = plain(_state(), x)
    got_donated = donated(_state(), x)
    for got in (got_plain, got_donated):
        assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
        assert torch.equal(got[1], want[1])
    keys = sorted(ov.cache._store)
    assert len(keys) == 2 and keys[0] != keys[1]
    (res,) = ov.fabric.residents.values()          # one resident, two kernels
    assert sorted(res.cache_keys) == keys
    (pe,), (de,) = plain._entries.values(), donated._entries.values()
    assert pe.acc.kernel.donate_argnums == () and de.acc.kernel.donate_argnums == (1, 2)
    # an undonated key is what it was before donation existed
    g = pe.lowered.graph
    assert ov._kernel_key(g, g.input_avals()) == tcache.kernel_key(
        g.name, tcache.signature_of(g.input_avals()), fingerprint=g.fingerprint())
    ov.close()


def test_donated_and_undonated_kernels_have_distinct_store_entries(tmp_path):
    d = str(tmp_path / "store")
    x = _rand(5, 4, 8)
    want = step(_state(), x)
    ov = Overlay(3, 3, store_path=d)
    ov.jit(step, name="step")(_state(), x)
    ov.jit(step, name="step", donate_argnums=(0,))(_state(), x)
    ov.close()
    assert len(BitstreamStore(d).keys()) == 2
    # a warm boot loads the donated kernel with its donation
    ov2 = Overlay(3, 3, store_path=d)
    f = ov2.jit(step, name="step", donate_argnums=(0,))
    s = _state()
    ptrs = _ptrs(s)
    got, metric = f(s, x)
    assert ov2.cache.stats.store_hits == 1
    assert _ptrs(got) == ptrs
    assert all(torch.equal(got[k], want[0][k]) for k in got)
    assert torch.equal(metric, want[1])
    (entry,) = f._entries.values()
    assert entry.acc.kernel.donate_argnums == (1, 2)
    assert entry.acc.kernel.aliases == ((0, 0), (1, 1))
    ov2.close()


def test_serial_form_round_trips_the_donation():
    ov = Overlay(3, 3)
    f = ov.jit(step, donate_argnums=(0,))
    f(_state(), _rand(5, 4, 8))
    (entry,) = f._entries.values()
    kernel = BitstreamStore.unpack_kernel(BitstreamStore.pack_kernel(entry.acc.kernel))
    assert kernel.donate_argnums == (1, 2) and kernel.aliases == ((0, 0), (1, 1))
    program, consts = entry.acc.kernel.serial_form()
    for bad in ({"aliases": [[0, 2]]},               # input 2 is not donated
                {"aliases": [[0, 0], [1, 0]]},       # two outputs, one input
                {"donate_argnums": [0, 1]},          # the routes argument
                {"aliases": [[0]]}):
        with pytest.raises(SerialError):
            interp.Kernel.from_serial({**program, **bad}, consts)
    old = {k: v for k, v in program.items() if k not in ("donate_argnums", "aliases")}
    kernel = interp.Kernel.from_serial(old, consts)  # written before donation
    assert kernel.donate_argnums == () and kernel.aliases == ()
    ov.close()


# ---------------------------------------------------------------------------
# the walk: outputs land in the donated storage, values equal eager
# ---------------------------------------------------------------------------
def test_donated_walk_lands_outputs_in_the_inputs_and_chains():
    ov = Overlay(3, 3)
    f = ov.jit(step, name="step", donate_argnums=(0,))
    s, ref = _state(), _state()
    ptrs = _ptrs(s)
    for i in range(4):
        x = _rand(10 + i, 4, 8)
        s, metric = f(s, x)
        ref, want = step(ref, x)
        assert _ptrs(s) == ptrs
        assert all(torch.equal(s[k], ref[k]) for k in s)
        assert torch.equal(metric, want)
    ov.close()


def late_reader(a, b):
    """``a``'s new value is ready before ``a`` is read for the last time."""
    na = a + 1.0
    nb = b * a.sum()
    return na, nb


def view_output(a, b):
    """The second output views ``a``: ``a`` cannot take the first output."""
    return a * 2.0 + b, a.view(-1)


def view_reader(a, b):
    """A view of ``a`` is read after ``a``'s own last read."""
    at = a.t()
    na = a + b
    return na, (at * 3.0).sum()


@pytest.mark.parametrize("fn", [late_reader, view_output, view_reader])
def test_donated_walk_equals_eager_under_aliasing(fn):
    ov = Overlay(3, 3)
    f = ov.jit(fn, donate_argnums=(0,))
    a, b = _rand(1, 4, 4), _rand(2, 4, 4)
    want = fn(a.clone(), b.clone())
    got = f(a, b)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ov.close()


def test_input_passed_twice_is_not_donated():
    ov = Overlay(3, 3)
    f = ov.jit(late_reader, donate_argnums=(0,))
    a = _rand(1, 4, 4)
    f(_rand(1, 4, 4), _rand(2, 4, 4))                # assemble on distinct inputs
    want = late_reader(a.clone(), a.clone())
    got = f(a, a)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ov.close()


def test_failure_after_a_write_raises_instead_of_serving_stale_state():
    ov = Overlay(3, 3)
    f = ov.jit(late_reader, donate_argnums=(0,))
    f(_rand(1, 4, 4), _rand(2, 4, 4))
    (entry,) = f._entries.values()
    kernel = entry.acc.kernel
    last = kernel.steps[-1]

    def boom(*args):
        raise RuntimeError("late failure")

    kernel.steps = kernel.steps[:-1] + (dataclasses.replace(last, fn=boom),)
    with pytest.raises(RuntimeError, match="late failure"):
        f(_rand(1, 4, 4), _rand(2, 4, 4))
    assert ov.stats.dispatch_fallbacks == 0
    ov.close()


# ---------------------------------------------------------------------------
# the other paths that serve a call
# ---------------------------------------------------------------------------
def test_specialized_tier_writes_back_into_the_callers_tensors():
    ov = Overlay(3, 3)
    f = ov.jit(step, name="step", donate_argnums=(0,))
    s, ref = _state(), _state()
    x = _rand(3, 4, 8)
    f.specialize(_state(), x)
    (res,) = ov.fabric.residents.values()
    assert res.tier == "specialized"
    assert isinstance(res.spec_fn.func, SpecializedKernel)
    assert res.spec_fn.func.donate_argnums == (1, 2)
    ptrs = _ptrs(s)
    for i in range(3):
        x = _rand(20 + i, 4, 8)
        s, metric = f(s, x)
        ref, want = step(ref, x)
        assert _ptrs(s) == ptrs
        assert all(torch.equal(s[k], ref[k]) for k in s)
        assert torch.equal(metric, want)
    assert ov.cache.spec_stats.specialized_hits == 3
    # a relocation still despecializes, and the generic walk donates too
    ov.reconfigure(relocate=True, policy=PlacementPolicy.STATIC)
    assert ov.cache.spec_stats.despecializations == 1
    assert res.tier == "generic" and res.spec_fn is None
    (entry,) = f._entries.values()
    s, _ = f(s, x)
    ref, _ = step(ref, x)
    assert entry.record.tier == "generic"
    assert _ptrs(s) == ptrs and all(torch.equal(s[k], ref[k]) for k in s)
    ov.close()


def test_undonated_wrapper_never_serves_the_donated_specialization():
    ov = Overlay(3, 3)
    donated = ov.jit(step, name="step", donate_argnums=(0,))
    plain = ov.jit(step, name="step")
    x = _rand(3, 4, 8)
    donated.specialize(_state(), x)
    s = _state()
    before = _clone(s)
    out, _ = plain(s, x)
    assert all(torch.equal(s[k], before[k]) for k in s)   # nothing donated
    (pe,) = plain._entries.values()
    assert pe.record.tier == "generic"
    assert all(torch.equal(out[k], step(before, x)[0][k]) for k in out)
    ov.close()


def test_async_fallback_lands_in_the_donated_inputs():
    ov = Overlay(3, 3, async_downloads=True)
    f = ov.jit(step, name="step", donate_argnums=(0,))
    s, ref = _state(), _state()
    ptrs = _ptrs(s)
    x = _rand(4, 4, 8)
    s, metric = f(s, x)                               # served by the fallback
    ref, want = step(ref, x)
    assert ov.stats.fallback_calls == 1
    assert _ptrs(s) == ptrs and all(torch.equal(s[k], ref[k]) for k in s)
    assert torch.equal(metric, want)
    assert ov.drain(30.0)
    s, _ = f(s, x)                                    # the kernel
    ref, _ = step(ref, x)
    assert ov.stats.fallback_calls == 1
    assert _ptrs(s) == ptrs and all(torch.equal(s[k], ref[k]) for k in s)
    ov.close()


def test_failed_dispatch_fallback_lands_in_the_donated_inputs():
    ov = Overlay(3, 3, faults=FaultPlan(3, dispatch_failure_rate=1.0))
    f = ov.jit(step, name="step", donate_argnums=(0,))
    s, ref = _state(), _state()
    ptrs = _ptrs(s)
    for i in range(3):
        x = _rand(30 + i, 4, 8)
        s, metric = f(s, x)
        ref, want = step(ref, x)
        assert _ptrs(s) == ptrs and all(torch.equal(s[k], ref[k]) for k in s)
        assert torch.equal(metric, want)
    assert ov.stats.dispatch_fallbacks >= 1
    ov.close()


# ---------------------------------------------------------------------------
# the hazard a fleet adds: a retry after a failed dispatch
# ---------------------------------------------------------------------------
def _fleet_run(faulty: bool, members: int = 2):
    ovs = [Overlay(3, 3) for _ in range(members)]
    fleet = FleetOverlay(ovs, window=4, replicate_after=2, drain_below=1,
                         quarantine_errors=10 ** 6)
    f = fleet.jit(step, name="step", donate_argnums=(0,))
    s = _state()
    ptrs = _ptrs(s)
    outs = []
    for i in range(16):
        if faulty and i == 8:
            ovs[0].faults = FaultPlan(17, dispatch_failure_rate=1.0)
        s, metric = f(s, _rand(40 + i, 4, 8))
        outs.append((_clone(s), metric))
    return fleet, s, ptrs, outs


@pytest.mark.parametrize("members", [1, 2])
def test_fleet_retry_of_a_donated_call_matches_a_fault_free_run(members):
    clean, s0, _, want = _fleet_run(False, members)
    fleet, s, ptrs, got = _fleet_run(True, members)
    assert len(got) == len(want)
    for (gs, gm), (ws, wm) in zip(got, want):
        assert all(torch.equal(gs[k], ws[k]) for k in gs)
        assert torch.equal(gm, wm)
    assert _ptrs(s) == ptrs                           # the caller's tensors
    assert all(torch.equal(s[k], s0[k]) for k in s)
    assert fleet.members[0].stats.dispatch_failures >= 1
    if members == 2:
        assert fleet.stats.replications >= 1 and fleet.stats.dispatch_retries >= 1
    else:
        assert fleet.stats.dispatch_retries == 0      # nowhere to retry: landed
    clean.close()
    fleet.close()


def test_fleet_donation_reaches_every_member_wrapper():
    fleet = FleetOverlay(2, rows=3, cols=3, window=4, replicate_after=2, drain_below=1)
    f = fleet.jit(step, name="step", donate_argnums=(0,))
    s = _state()
    ptrs = _ptrs(s)
    for i in range(12):
        s, _ = f(s, _rand(60 + i, 4, 8))
    assert _ptrs(s) == ptrs
    assert len(f._member_wrappers) == 2
    assert all(w.donate_argnums == (0,) for w in f._member_wrappers.values())
    assert min(fleet.describe()["fleet"]["routed_per_member"]) > 0
    fleet.close()
