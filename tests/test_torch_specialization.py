"""The route-constant specialized tier of the port against the JAX package.

``specialize_kernel`` bakes a placement's hop vector into the walk; it is
bit-identical to the generic walk on the same placement and within rtol 1e-6
(f32) of the reference's ``specialize_kernel`` on the same inputs and the same
hand-built graphs.  The overlay-level tests mirror the assertions of the
reference's jit-level specialization tests (which fail here on the JAX
tracer, ``repro/core/trace.py:127``) against the port's own jit path.  On the
card the tier is the walk captured once as a CUDA graph
(``interpreter.GraphKernel``): the ``cuda``-marked tests hold it to the
generic walk bit for bit and check its buffers, its launch counts and its
release; they skip here.  JAX is imported in a fixture, so the ``cuda`` tests
also run where JAX is not installed.
"""

import types

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import smoke_config
from repro_torch.core import (Overlay, PlacementPolicy, TileGrid, graph as tgraph,
                              interpreter as tinterp, patterns as tpat, place,
                              place_static, saxpy_graph, spec_key,
                              specialize_kernel, zero_hop)
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as trn
from repro_torch.models import params as tparams
from repro_torch.serving.engine import Request, ServeEngine


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons."""
    jax = pytest.importorskip("jax")
    from repro.core import cache, graph, interpreter, patterns, placement
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, cache=cache, graph=graph,
                                 interp=interpreter, pat=patterns, place=placement)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python -m pytest -m cuda)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# kernel level
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hops", [(), (0, 1, 1, 0), (0, 2), (3,), (1, 1, 1), (2, 0, 5)])
def test_zero_hop_matches_jax(jx, hops):
    assert zero_hop(hops) == jx.interp.zero_hop(hops)


def test_spec_key_matches_jax(jx):
    assert spec_key("g:0123", (0, 2, 1)) == jx.cache.spec_key("g:0123", (0, 2, 1))
    assert spec_key("g:0123", ()) == jx.cache.spec_key("g:0123", ())


def test_specialize_kernel_rejects_wrong_arity():
    with pytest.raises(ValueError):
        specialize_kernel(saxpy_graph(32), (0,))


UNARY = ("abs", "relu", "sigmoid", "neg", "sin", "cos", "tanh")
BINARY = ("add", "sub", "mul", "max", "min")
# spread pins on the 3x3 grid (LARGE tiles on the diagonal): consecutive ops
# land far apart, so edges cross pass-through tiles
SMALL_PINS = ((0, 2), (2, 0), (0, 1), (2, 1), (1, 2), (1, 0))
LARGE_PINS = ((0, 0), (2, 2), (1, 1))


def _build(graph_mod, pat, dtype, seed: int, n: int = 257):
    """A random DAG of safe elementwise ops (no NaN from these inputs)."""
    rng = np.random.default_rng(seed)
    g = graph_mod.Graph(f"spec{seed}")
    vals = [g.input(f"x{i}", (n,), dtype) for i in range(2)]
    for _ in range(int(rng.integers(4, 9))):
        if rng.random() < 0.5:
            i, j = (int(v) for v in rng.choice(len(vals), size=2, replace=False))
            vals.append(g.apply(pat.LIBRARY[BINARY[int(rng.integers(len(BINARY)))]],
                                vals[i], vals[j]))
        else:
            vals.append(g.apply(pat.LIBRARY[UNARY[int(rng.integers(len(UNARY)))]],
                                vals[int(rng.integers(len(vals)))]))
    g.output(vals[-1], vals[-2])
    return g


def _spread_pins(graph, large):
    small_i = large_i = 0
    pins = {}
    for node in graph.op_nodes():
        if node.op.name in large:
            pins[node.node_id] = LARGE_PINS[large_i % 3]
            large_i += 1
        else:
            pins[node.node_id] = SMALL_PINS[small_i % 6]
            small_i += 1
    return pins


@pytest.mark.parametrize("seed", range(6))
def test_specialized_walk_bit_identical_and_matches_jax(jx, seed):
    tg = _build(tgraph, tpat, torch.float32, seed)
    jg = _build(jx.graph, jx.pat, jx.jnp.float32, seed)
    large = {"sin", "cos", "tanh"}
    pins = _spread_pins(tg, large)
    tpl = place_static(tg, TileGrid(3, 3), pins)
    jpl = jx.place.place_static(jg, jx.place.TileGrid(3, 3), pins)
    hops = tinterp.route_hops(tg, tpl)
    assert hops == jx.interp.route_hops(jg, jpl)
    assert max(hops) >= 2 and not zero_hop(hops)         # multi-hop edges
    rng = np.random.default_rng(seed + 100)
    xs = [rng.standard_normal(257).astype(np.float32) for _ in range(2)]
    txs = [torch.from_numpy(x) for x in xs]
    generic = tinterp.build_kernel(tg)(tinterp.route_vector(tg, tpl), *txs)
    spec = specialize_kernel(tg, hops)(None, *txs)
    for got, want in zip(spec, generic):          # bit for bit, NaN equal to NaN
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.numpy().view(np.int32))
    jout = jx.jax.jit(jx.interp.specialize_kernel(jg, hops))(
        jx.interp.route_vector(jg, jpl), *(jx.jnp.asarray(x) for x in xs))
    for got, want in zip(spec, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, equal_nan=True)


def test_specialized_walk_reads_no_routes():
    g = saxpy_graph(32)
    pl = place(g, TileGrid(3, 3), PlacementPolicy.DYNAMIC)
    hops = tinterp.route_hops(g, pl)
    x = torch.linspace(0.0, 1.0, 32)
    routes = tinterp.route_vector(g, pl)
    want = tinterp.build_kernel(g)(routes, x, x)
    assert torch.equal(specialize_kernel(g, hops)(None, x, x), want)


# ---------------------------------------------------------------------------
# overlay: the reference's jit-level specialization tests, mirrored
# ---------------------------------------------------------------------------
def _disjoint_placement(ov, graph, res):
    """A placement on tiles no resident holds (``res`` included)."""
    return place(graph, ov.grid, ov.policy, occupied=ov.fabric.occupied())


def test_sync_specialize_swaps_tier_and_stays_bit_identical():
    ov = Overlay(3, 3)
    jitted = ov.jit(lambda x, w: torch.sqrt((x * w) ** 2 + 1.0) * 2.0, name="spec_me")
    x, w = torch.linspace(0.1, 1.0, 128), torch.linspace(0.9, 1.1, 128)
    y0 = jitted(x, w)
    (entry,) = jitted._entries.values()
    assert entry.record is not None and entry.record.tier == "generic"
    ins = ov.cache.stats.insertions
    jitted.specialize(x, w)
    assert entry.record.tier == "specialized"
    res = ov.fabric.get(entry.acc.resident_id)
    assert res.tier == "specialized"
    assert ov.cache.specialized_count() == 1
    assert ov.cache.stats.insertions == ins
    assert ov.cache.spec_stats.specializations == 1
    assert torch.equal(jitted(x, w), y0)
    assert ov.cache.spec_stats.specialized_hits == 1
    assert jitted.specialize(x, w) is None            # already specialized
    assert ov.cache.spec_stats.specializations == 1


def test_sync_overlay_never_auto_specializes():
    ov = Overlay(3, 3)
    jitted = ov.jit(lambda x: x * 2.0, name="no_auto")
    x = torch.ones(64)
    for _ in range(40):
        jitted(x)
    (res,) = ov.fabric.residents.values()
    assert res.tier == "generic" and res.zero_hop
    assert ov.cache.spec_stats.specializations == 0
    assert ov.describe()["specialization"]["auto"] is False


def test_relocation_despecializes_instantly():
    ov = Overlay(3, 3)
    jitted = ov.jit(lambda x, w: torch.maximum(x * w, torch.tensor(0.5)) + w, name="mover")
    x = torch.linspace(0.1, 1.0, 64)
    y0 = jitted(x, x)
    (entry,) = jitted._entries.values()
    jitted.specialize(x, x)
    assert torch.equal(jitted(x, x), y0)
    res = ov.fabric.get(entry.acc.resident_id)
    g = entry.lowered.graph
    ov.relocate(g, _disjoint_placement(ov, g, res))
    res2 = ov.fabric.get(res.rid)
    assert res2.tier == "generic" and res2.spec_fn is None
    assert ov.cache.specialized_count() == 0
    assert ov.cache.spec_stats.despecializations == 1
    assert torch.equal(jitted(x, x), y0)
    assert entry.record.tier == "generic"
    jitted.specialize(x, x)                           # fresh routes, fresh artifact
    assert ov.fabric.get(res.rid).tier == "specialized"
    assert torch.equal(jitted(x, x), y0)


def test_eviction_drops_specialized_artifacts():
    ov = Overlay(3, 3)
    jitted = ov.jit(lambda x: x - 1.5, name="doomed")
    x = torch.ones(32)
    jitted(x)
    jitted.specialize(x)
    assert ov.cache.specialized_count() == 1
    ov.evict("doomed")
    assert ov.cache.specialized_count() == 0 and len(ov.cache) == 0
    assert ov.cache.spec_stats.despecializations == 1


def test_reconfigure_flush_clears_specialized_tier():
    ov = Overlay(3, 3)
    jitted = ov.jit(lambda x: x + 7.0, name="flushed")
    x = torch.ones(16)
    jitted(x)
    jitted.specialize(x)
    assert ov.cache.specialized_count() == 1
    ov.reconfigure()
    assert ov.cache.specialized_count() == 0
    torch.testing.assert_close(jitted(x), x + 7.0)
    assert ov.fabric.lru().tier == "generic"


def test_specialization_stats_accounting_full_cycle():
    ov = Overlay(3, 3)
    jitted = ov.jit(lambda x: torch.abs(x) + 1.0, name="counted")
    x = torch.linspace(-1.0, 1.0, 64)
    jitted(x)
    jitted.specialize(x)
    for _ in range(3):
        jitted(x)
    (entry,) = jitted._entries.values()
    res = ov.fabric.get(entry.acc.resident_id)
    g = entry.lowered.graph
    ov.relocate(g, _disjoint_placement(ov, g, res))
    jitted(x)                                         # generic again
    spec = ov.describe()["specialization"]
    assert spec["specializations"] == 1 and spec["despecializations"] == 1
    assert spec["specialized_hits"] == 3 and spec["dropped_stale"] == 0
    assert spec["specialized_artifacts"] == 0
    assert spec["compile_seconds"] > 0.0
    rep = ov.describe()["fabric"]["residents"][res.rid]
    assert rep["tier"] == "generic"
    assert "zero_hop" in rep and "specializing" in rep


def test_describe_reports_specialized_tier_per_resident():
    ov = Overlay(3, 3)
    jitted = ov.jit(lambda x: x * 9.0, name="seen")
    x = torch.ones(16)
    jitted(x)
    jitted.specialize(x)
    (entry,) = jitted._entries.values()
    rep = ov.describe()["fabric"]["residents"][entry.acc.resident_id]
    assert rep["tier"] == "specialized" and rep["specializing"] is False


def test_routes_built_once_at_admit_and_refreshed_on_relocate():
    ov = Overlay(3, 3)
    g = saxpy_graph(64)
    acc = ov.assemble(g)
    res = ov.fabric.get(acc.resident_id)
    assert isinstance(res.routes, torch.Tensor)
    assert ov.cache.route_stats.emitted == 1
    x = torch.ones(64)
    acc(x, x)
    ov.assemble(saxpy_graph(64))
    assert ov.cache.route_stats.emitted == 1
    new_pl = place(g, ov.grid, ov.policy, occupied=set(res.tiles))
    ov.relocate(g, new_pl)
    res2 = ov.fabric.get(res.rid)
    assert ov.cache.route_stats.emitted == 2
    assert res2.routes.tolist() == tinterp.route_vector(g, new_pl).tolist()


def test_specialize_accepts_tensor_specs_and_admits_first():
    ov = Overlay(3, 3)
    jitted = ov.jit(lambda x: x * 3.0, name="specs")
    spec = tgraph.TensorSpec((16,), torch.float32, torch.device("cpu"))
    jitted.specialize(spec)
    assert ov.stats.downloads == 1
    assert ov.fabric.lru().tier == "specialized"
    x = torch.arange(16.0)
    assert torch.equal(jitted(x), x * 3.0)
    assert ov.cache.spec_stats.specialized_hits == 1


# ---------------------------------------------------------------------------
# overlay: the auto-specialize triggers, run inline on the synchronous overlay
# ---------------------------------------------------------------------------
def test_auto_specialize_contiguous_resident_inline():
    ov = Overlay(3, 3, auto_specialize=True)
    jitted = ov.jit(lambda x: x * 3.0 + 1.0, name="hot")
    x = torch.ones(64)
    y0 = jitted(x)                  # zero-hop trigger: built, this call generic
    (res,) = ov.fabric.residents.values()
    assert res.zero_hop and res.tier == "specialized"
    assert ov.cache.spec_stats.specializations == 1
    assert torch.equal(jitted(x), y0)
    assert ov.cache.spec_stats.specialized_hits == 1


def test_auto_specialize_stability_trigger_after_n_dispatches():
    ov = Overlay(3, 3, auto_specialize=True, specialize_after=3)
    jitted = ov.jit(lambda x: x + 0.5, name="stable")
    x = torch.ones(32)
    ov.assemble(jitted.lower(x).graph)
    res = ov.fabric.lru()
    res.zero_hop = False                              # force the stability path
    jitted(x)
    jitted(x)
    assert res.tier == "generic"                      # 2 < specialize_after
    jitted(x)
    assert res.tier == "specialized"


def test_defragment_specializes_contiguous_residents_with_auto():
    ov = Overlay(2, 2, large_fraction=0.0, auto_specialize=True)
    filler = ov.jit(lambda x: x * 2.0, name="filler")
    mover = ov.jit(lambda x, y: (x - 4.0) * y, name="mover")
    x = torch.ones(32)
    filler(x)
    y0 = mover(x, x)                  # zero-hop trigger: specialized
    ov.evict("filler")
    assert ov.defragment() == 1       # the move despecializes, the hook rebuilds
    (res,) = ov.fabric.residents.values()
    assert res.zero_hop and res.tier == "specialized" and res.relocations == 1
    assert ov.cache.spec_stats.despecializations == 2   # the move + the evicted filler
    (entry,) = mover._entries.values()
    assert entry.record.tier == "specialized"
    assert torch.equal(mover(x, x), y0)


def test_failed_specialization_raises_counts_and_caps():
    """No quiet fallback: a failed build raises to the caller, is counted on
    the resident, leaves it generic and unwedged, and stops being retried at
    these routes after the cap."""
    ov = Overlay(3, 3, auto_specialize=True)
    jitted = ov.jit(lambda x: x * 2.0, name="failer")
    x = torch.ones(16)

    def fail(pending):
        raise RuntimeError("synthetic specialization failure")

    ov._compile_specialized_tier = fail
    for _ in range(3):
        with pytest.raises(RuntimeError, match="synthetic"):
            jitted(x)
    (res,) = ov.fabric.residents.values()
    assert res.spec_failures == 3 and not res.spec_pending and res.tier == "generic"
    torch.testing.assert_close(jitted(x), x * 2.0)    # capped: generic serves
    ov2 = Overlay(3, 3)
    ov2._compile_specialized_tier = fail
    f2 = ov2.jit(lambda x: x + 1.0, name="explicit")
    f2(x)
    with pytest.raises(RuntimeError, match="synthetic"):
        f2.specialize(x)
    assert ov2.fabric.lru().spec_failures == 1


class _Tracked:
    """A specialized artifact that records its release."""

    def __init__(self, kernel, log):
        self.kernel, self.log, self.released = kernel, log, False
        log.append(self)

    def __call__(self, routes, *inputs):
        assert not self.released, "dispatched a released artifact"
        return self.kernel(routes, *inputs)

    def release(self):
        self.released = True


@pytest.mark.parametrize("drop", ["relocate", "evict", "flush", "reconfigure_relocate",
                                  "defragment", "repack"])
def test_dropping_the_tier_releases_its_artifact(drop):
    ov = Overlay(3, 3, large_fraction=0.0)
    log = []
    ov._compile_specialized_tier = lambda p: _Tracked(
        tinterp.specialize_kernel(p.graph, p.hops), log)
    filler = ov.jit(lambda x: x - 1.0, name="filler")
    jitted = ov.jit(lambda x, y: x * y + 1.0, name="tracked", tile_budget=2)
    x = torch.linspace(0.0, 1.0, 16)
    filler(x)
    y0 = jitted(x, x)
    jitted.specialize(x, x)
    (art,) = log
    (entry,) = jitted._entries.values()
    res = ov.fabric.get(entry.acc.resident_id)
    if drop == "relocate":
        g = entry.lowered.graph
        ov.relocate(g, _disjoint_placement(ov, g, res))
    elif drop == "evict":
        ov.evict("tracked")
    elif drop == "flush":
        ov.reconfigure()
    elif drop == "reconfigure_relocate":
        ov.reconfigure(policy=PlacementPolicy.STATIC, relocate=True)
    elif drop == "defragment":
        ov.evict("filler")
        assert ov.defragment() == 1
    else:
        jitted.tile_budget = 1
    assert torch.equal(jitted(x, x), y0)
    assert art.released and ov.cache.specialized_count() == 0
    assert ov.fabric.get(res.rid) is None or ov.fabric.get(res.rid).tier == "generic"


# ---------------------------------------------------------------------------
# serving: the decode step on the specialized tier (smoke size)
# ---------------------------------------------------------------------------
class _SpecializeAfterFirst:
    """Calls the wrapped decode step; after its first call, specializes it on
    that call's inputs (what chip_smoke.py does on the card)."""

    def __init__(self, jitted):
        self.fn, self.calls = jitted, 0

    def __call__(self, *args):
        out = self.fn(*args)
        self.calls += 1
        if self.calls == 1:
            self.fn.specialize(*args)
        return out


def test_engine_decode_on_specialized_tier_matches_plain():
    cfg = smoke_config("phi3-mini-3.8b").scaled(d_model=128, head_dim=32, dtype="float32")
    params = pytree.tree_map(lambda t: t.float(),
                             tparams.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=(6,)).tolist() for _ in range(3)]

    def serve(overlay):
        eng = ServeEngine(params, cfg, batch=2, max_len=16, overlay=overlay, device="cpu")
        if overlay is not None:
            eng._decode = _SpecializeAfterFirst(eng._decode)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
        out = [r.out for r in sorted(eng.run_until_drained(), key=lambda r: r.rid)]
        return out, eng

    want, _ = serve(None)
    ov = Overlay(3, 3)
    got, eng = serve(ov)
    assert got == want
    tiers = {r.name: r.tier for r in ov.fabric.residents.values()}
    assert tiers[f"{cfg.name}.decode"] == "specialized"
    assert tiers[f"{cfg.name}.prefill"] == "generic"
    assert ov.cache.spec_stats.specialized_hits == eng._decode.calls - 1


# ---------------------------------------------------------------------------
# on the card: the CUDA-graph tier
# ---------------------------------------------------------------------------
def _norm_mlp(x, w, m):
    """A step with a kernel (rmsnorm), a cuBLAS product and elementwise ops."""
    h = ops.rmsnorm(x, w)
    return torch.mm(h, m) * 0.5 + x, h.sum(dim=-1)


def _card_inputs(cuda, seed, rows=4, d=256):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(rows, d, generator=g, device=cuda).bfloat16()
    w = 1.0 + 0.1 * torch.randn(d, generator=g, device=cuda)
    m = (torch.randn(d, d, generator=g, device=cuda) / 16).bfloat16()
    return x, w, m


@pytest.mark.cuda
def test_graph_tier_bit_identical_to_generic_on_card(cuda):
    ov = Overlay(3, 3)
    f = ov.jit(_norm_mlp, name="norm_mlp")
    x, w, m = _card_inputs(cuda, 0)
    f(x, w, m)
    f.specialize(x, w, m)
    (entry,) = f._entries.values()
    res = ov.fabric.get(entry.acc.resident_id)
    assert entry.record.tier == "specialized"
    assert isinstance(ov.cache.specialized(
        spec_key(res.cache_keys[0], tinterp.route_hops(res.graph, res.placement))),
        tinterp.GraphKernel)
    for seed in range(1, 4):
        args = _card_inputs(cuda, seed)
        generic = entry.acc.fn(*args)
        spec = f(*args)
        for got, want in zip(spec, generic):
            assert torch.equal(got, want) and got.stride() == want.stride()


@pytest.mark.cuda
def test_graph_tier_output_unchanged_by_next_call_on_card(cuda):
    ov = Overlay(3, 3)
    f = ov.jit(_norm_mlp, name="norm_mlp")
    a = _card_inputs(cuda, 0)
    f.specialize(*a)
    y1 = f(*a)
    keep = [t.clone() for t in y1]
    b = _card_inputs(cuda, 1)
    y2 = f(*b)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(y1, keep))
    assert not torch.equal(y1[0], y2[0])
    # an input written in place (same tensor, new version) is read anew
    a[0].mul_(2)
    assert torch.equal(f(*a)[0], entry_generic(ov, f, a)[0])


def entry_generic(ov, f, args):
    (entry,) = f._entries.values()
    return entry.acc.fn(*args)


@pytest.mark.cuda
def test_graph_tier_counts_launches_per_replay_on_card(cuda):
    ov = Overlay(3, 3)
    f = ov.jit(_norm_mlp, name="norm_mlp")
    args = _card_inputs(cuda, 0)
    f(*args)
    trn.launches.reset()
    f.specialize(*args)
    assert trn.launches.count == 1                    # the warm-up walk
    exe = ov.fabric.lru().spec_fn.func
    assert exe.launches_per_replay() == {"rmsnorm": 1}
    for _ in range(5):
        f(*args)
    torch.cuda.synchronize()
    assert trn.launches.count == 6
    assert trn.launches.by_variant["warp"] == 6 and exe.replays == 5


@pytest.mark.cuda
def test_graph_tier_dropped_and_freed_on_relocation_on_card(cuda):
    """A relocation releases the graph and its buffers, and a cycle of
    specialize + relocate leaves no memory behind: the first card run of
    this tier found each capture's own stream keeping a 32 MiB cuBLAS
    workspace, one more a cycle."""
    ov = Overlay(3, 3)
    f = ov.jit(_norm_mlp, name="norm_mlp")
    args = _card_inputs(cuda, 0, rows=64, d=1024)
    y0 = f(*args)
    (entry,) = f._entries.values()
    g = entry.lowered.graph
    held = sum(t.numel() * t.element_size() for t in args)
    after = []
    for _ in range(3):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        f.specialize(*args)
        exe = ov.fabric.lru().spec_fn.func
        assert torch.cuda.memory_allocated() >= before + held   # input copies
        res = ov.fabric.get(entry.acc.resident_id)
        ov.relocate(g, _disjoint_placement(ov, g, res))
        torch.cuda.synchronize()
        assert exe._graph is None and ov.cache.specialized_count() == 0
        after.append(torch.cuda.memory_allocated())
        with pytest.raises(RuntimeError, match="released"):
            exe(None, *args)
        assert all(torch.equal(u, v) for u, v in zip(f(*args), y0))
    assert after[2] <= after[1] <= after[0]


@pytest.mark.cuda
def test_decode_ticks_concurrent_with_a_low_lane_capture_on_card(cuda):
    """On an asynchronous overlay the decode step's CUDA graph is captured
    on a scheduler worker while the serving thread keeps running decode
    ticks, each ended by a device-to-host copy as the engine's.  Every
    tick's outputs are bit-identical to the generic walk's on the same
    inputs, at least one tick ran during the build, and the launch counts
    are exact: one rmsnorm launch per norm of every tick and of the
    capture's one warm-up walk, none booked twice."""
    import sys
    import threading

    from repro_torch.models import model as tmodel

    cfg = smoke_config("phi3-mini-3.8b").scaled(d_model=256, head_dim=32,
                                                blocks=((("dense",), 4),))
    norms = 2 * cfg.num_layers + 1
    params = tparams.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    ov = Overlay(3, 3, async_downloads=True, auto_specialize=False)
    dec = ov.jit(lambda p, t, c, pos: tmodel.decode_step(p, cfg, t, c, positions=pos),
                 name="decode")
    tok = torch.tensor([[5], [9]], dtype=torch.int32, device=cuda)
    caches = tmodel.init_cache(cfg, 2, 64, cuda)
    pos = torch.tensor([3, 7], dtype=torch.int32, device=cuda)
    dec(params, tok, caches, pos)                     # the fallback; download queued
    assert ov.drain(60)
    (entry,) = dec._entries.values()
    generic = entry.acc.fn
    res = ov.fabric.get(entry.acc.resident_id)
    building = threading.Event()
    build = ov._compile_specialized_tier

    def traced(pending):
        building.set()
        return build(pending)

    ov._compile_specialized_tier = traced
    torch.cuda.synchronize()
    trn.launches.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    ticks, overlapped, after = [], 0, 0
    try:
        dec.specialize(params, tok, caches, pos)      # queued on the low lane
        assert res.spec_pending
        while after < 3 and len(ticks) < 2000:
            during = building.is_set() and res.tier == "generic"
            logits, nxt = dec(params, tok, caches, pos)
            ticks.append(((tok, caches, pos), (logits, nxt)))
            overlapped += during
            after += res.tier == "specialized"
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            tok.tolist()                              # the tick's device-to-host copy
            caches, pos = nxt, (pos + 1) % 60
    finally:
        sys.setswitchinterval(old)
    assert ov.drain(60)
    torch.cuda.synchronize()
    launches = (trn.launches.count, trn.launches.by_variant["warp"])
    assert res.tier == "specialized" and after == 3 and overlapped >= 1
    exe = res.spec_fn.func
    assert isinstance(exe, tinterp.GraphKernel)
    assert exe.launches_per_replay() == {"rmsnorm": norms}
    assert ov.scheduler.stats.low_jobs == 1 and ov.cache.spec_stats.specializations == 1
    assert launches == (norms * (len(ticks) + 1),) * 2
    for inputs, outputs in ticks:
        want = generic(*pytree.tree_leaves((params, *inputs)))
        got = pytree.tree_leaves(outputs)
        assert all(torch.equal(u, v) for u, v in zip(got, pytree.tree_leaves(want)))
    ov.close()


@pytest.mark.cuda
def test_graph_tier_writes_donated_state_into_the_callers_tensors_on_card(cuda):
    """With ``donate_argnums`` the captured graph keeps its private buffers
    and each call lands the new state in the caller's donated tensors after
    the replay: the returned leaves are the caller's, their values the
    eager function's, and a relocation still despecializes."""
    def step(state, x):
        m2 = 0.9 * state["m"] + x
        return {"w": state["w"] - 0.1 * m2, "m": m2}, (state["w"] * state["m"]).sum()

    gen = torch.Generator().manual_seed(0)
    rand = lambda: torch.randn(4, 8, generator=gen).to(cuda)
    ov = Overlay(3, 3)
    f = ov.jit(step, name="donated_step", donate_argnums=(0,))
    s = {"w": rand(), "m": rand()}
    ref = {k: v.clone() for k, v in s.items()}
    f.specialize({k: v.clone() for k, v in s.items()}, rand())
    (res,) = ov.fabric.residents.values()
    assert isinstance(res.spec_fn.func, tinterp.GraphKernel)
    ptrs = {k: v.data_ptr() for k, v in s.items()}
    for _ in range(3):
        x = rand()
        s, metric = f(s, x)
        ref, want = step(ref, x)
        assert {k: v.data_ptr() for k, v in s.items()} == ptrs
        assert all(torch.equal(s[k], ref[k]) for k in s)
        assert torch.equal(metric, want)
    assert ov.cache.spec_stats.specialized_hits == 3
    ov.reconfigure(relocate=True, policy=PlacementPolicy.STATIC)
    assert ov.cache.spec_stats.despecializations == 1
    s, _ = f(s, x)
    ref, _ = step(ref, x)
    assert all(torch.equal(s[k], ref[k]) for k in s)
    ov.close()

