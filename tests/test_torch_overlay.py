"""The port's core pipeline against the JAX package: Graph IR, operator
library, placement, controller ISA, interpreter, cache, fabric and the
synchronous Overlay.

The same numpy inputs go to both packages.  The JAX package's tracer cannot
run on the installed jax (``repro/core/trace.py:127`` reads
``jax.core.Literal``, which jax 0.9 no longer has), so the port's tracer is
held against hand-built graphs, and the placement/ISA parity uses the
hand-built canned graphs of both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import isa as jisa
from repro.core import placement as jplace
from repro_torch.core import (Graph, Overlay, PlacementError, PlacementPolicy,
                              TileGrid, TraceError, assemble, branchy_graph,
                              compile_graph, patterns, place_dynamic,
                              place_static, run_program, saxpy_graph,
                              trace_to_graph, vmul_reduce_graph)
from repro_torch.core.isa import Opcode
from repro_torch.kernels import ops
from tests.torch_ranks import mesh_overlay_modes, spawn

N = 4096          # the paper's 16 KB of f32 (PAPER_VECTOR_LEN)
# fig. 2 scenarios: Reduce (node 3, LARGE) pinned at (0,0), VMUL (node 2)
# moved away (benchmarks/fig3_vmul_reduce.py:42-57)
SCENARIOS = [("static_0pass", (0, 1)), ("static_1pass", (0, 2)),
             ("static_2pass", (1, 2)), ("static_3pass", (2, 2))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(seed: int, n: int = N, k: int = 2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


def _dot(a, b):
    return torch.sum(a * b)


# ---------------------------------------------------------------------------
# Graph IR and operator library
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["vmul_reduce", "saxpy", "branchy"])
def test_graph_evaluate_matches_jax(name):
    builders = {"vmul_reduce": (vmul_reduce_graph, jgraph.vmul_reduce_graph, 2),
                "saxpy": (saxpy_graph, jgraph.saxpy_graph, 2),
                "branchy": (branchy_graph, jgraph.branchy_graph, 1)}
    tb, jb, k = builders[name]
    xs = _inputs(11, k=k)
    got = tb(N).evaluate(*(torch.from_numpy(x) for x in xs))
    want = jb(N).evaluate(*(jnp.asarray(x) for x in xs))
    # f32 elementwise ops agree to an ulp; the sum reorders (rtol 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_library_names_match_reference():
    from repro.core import patterns as jpat
    assert patterns.LIBRARY.names() == jpat.LIBRARY.names()


def test_graph_shapes_and_fingerprint():
    g = vmul_reduce_graph(N)
    avals = g.infer_shapes()
    assert avals[g.output_ids[0]].shape == ()
    assert g.fingerprint() == vmul_reduce_graph(N).fingerprint()
    assert saxpy_graph(N, 2.0).fingerprint() != saxpy_graph(N, 3.0).fingerprint()


# ---------------------------------------------------------------------------
# Placement and controller ISA: identical decisions in both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario,vmul_tile", SCENARIOS)
def test_fig3_static_placements_match_jax(scenario, vmul_tile):
    fixed = {2: vmul_tile, 3: (0, 0)}
    tg, jg = vmul_reduce_graph(N), jgraph.vmul_reduce_graph(N)
    tp = place_static(tg, TileGrid(3, 3), fixed)
    jp = jplace.place_static(jg, jplace.TileGrid(3, 3), fixed)
    assert tp.assignment == jp.assignment
    assert (tp.total_hops, tp.total_passthrough) == (jp.total_hops, jp.total_passthrough)
    assert tp.total_passthrough == int(scenario[7])
    assert compile_graph(tg, tp).mix() == jisa.compile_graph(jg, jp).mix()


@pytest.mark.parametrize("name", ["vmul_reduce", "saxpy", "branchy"])
@pytest.mark.parametrize("max_tiles", [None, 1, 2])
def test_place_dynamic_matches_jax(name, max_tiles):
    tg = {"vmul_reduce": vmul_reduce_graph, "saxpy": saxpy_graph,
          "branchy": branchy_graph}[name](N)
    jg = {"vmul_reduce": jgraph.vmul_reduce_graph, "saxpy": jgraph.saxpy_graph,
          "branchy": jgraph.branchy_graph}[name](N)
    occupied = {(1, 1)} if max_tiles == 2 else set()
    tp = place_dynamic(tg, TileGrid(3, 3), occupied=occupied, max_tiles=max_tiles)
    jp = jplace.place_dynamic(jg, jplace.TileGrid(3, 3), occupied=occupied,
                              max_tiles=max_tiles)
    assert tp.assignment == jp.assignment
    assert (tp.total_hops, tp.total_passthrough) == (jp.total_hops, jp.total_passthrough)
    assert compile_graph(tg, tp).mix() == jisa.compile_graph(jg, jp).mix()


def test_isa_has_the_papers_42_opcodes():
    assert len(Opcode) == 42 == len(jisa.Opcode)
    assert [o.name for o in Opcode] == [o.name for o in jisa.Opcode]


def test_traced_dot_places_like_hand_built_graph():
    """The port's tracer gives the paper's VMUL -> Reduce graph: the same
    node ids, edges and placements as the hand-built graph."""
    a, b = (torch.from_numpy(x) for x in _inputs(1))
    traced = trace_to_graph(_dot, a, b).graph
    hand = vmul_reduce_graph(N)
    assert traced.edges() == hand.edges()
    assert [n.name for n in traced.op_nodes()] == ["mul", "reduce[add,axis=None]"]
    for _, vmul_tile in SCENARIOS:
        fixed = {2: vmul_tile, 3: (0, 0)}
        assert place_static(traced, TileGrid(3, 3), fixed).edge_hops == \
            place_static(hand, TileGrid(3, 3), fixed).edge_hops
    assert place_dynamic(traced, TileGrid(3, 3)).assignment == \
        place_dynamic(hand, TileGrid(3, 3)).assignment


# ---------------------------------------------------------------------------
# Trace frontend
# ---------------------------------------------------------------------------
def test_trace_where_becomes_select_and_literals_become_consts():
    def f(x):
        return torch.where(x > 0, torch.sqrt(torch.abs(x)), torch.sin(x))
    x = torch.from_numpy(_inputs(2, k=1)[0])
    lowered = trace_to_graph(f, x, strict=True)
    kinds = [n.kind for n in lowered.graph.nodes]
    assert "select" in kinds and "const" in kinds
    assert {n.name for n in lowered.graph.op_nodes()} >= {"gt", "abs", "sqrtf", "sin"}
    assert torch.equal(lowered.graph.evaluate(x), f(x))


def test_trace_strict_raises_and_residue_stays_correct():
    def f(x):
        return torch.cumsum(x, 0) * 2.0
    x = torch.from_numpy(_inputs(3, k=1)[0])
    with pytest.raises(TraceError):
        trace_to_graph(f, x, strict=True)
    lowered = trace_to_graph(f, x)
    assert lowered.unmapped == ("cumsum.default",)
    assert torch.equal(lowered.graph.evaluate(x), f(x))


def test_trace_multi_result_op_projects_each_output():
    def f(x):
        lo, hi = torch.split(x, [3, 5])
        return lo.sum() + hi.sum()
    x = torch.arange(8.0)
    g = trace_to_graph(f, x).graph
    assert [n.name for n in g.op_nodes()][:3] == ["aten[split_with_sizes.default]",
                                                 "proj[0]", "proj[1]"]
    assert torch.equal(g.evaluate(x), f(x))


def test_register_op_extends_the_frontend():
    def f(x):
        return torch.cumsum(x, 0)
    op = patterns.Operator("cumsum0", 1, lambda x: torch.cumsum(x, 0))
    patterns.register_op("aten.cumsum.default", lambda args, kw, specs: op)
    try:
        g = trace_to_graph(f, torch.arange(5.0), strict=True).graph
        assert [n.name for n in g.op_nodes()] == ["cumsum0"]
    finally:
        patterns.unregister_op("aten.cumsum.default")


# ---------------------------------------------------------------------------
# Interpreter: placement-free kernels, bit-identical outputs
# ---------------------------------------------------------------------------
def test_outputs_bit_identical_across_placements():
    a, b = (torch.from_numpy(x) for x in _inputs(4))
    g = trace_to_graph(_dot, a, b).graph
    outs, accs = {}, {}
    for name, vmul_tile in SCENARIOS:
        pl = place_static(g, TileGrid(3, 3), {2: vmul_tile, 3: (0, 0)})
        accs[name] = assemble(g, pl)
        outs[name] = accs[name](a, b)
    accs["dynamic"] = assemble(g, place_dynamic(g, TileGrid(3, 3)))
    outs["dynamic"] = accs["dynamic"](a, b)
    for name, out in outs.items():
        assert torch.equal(out, outs["dynamic"]), name
    # pass-through tiles are real copy passes: more tiles, more copies
    hops = [int(accs[name].routes.max()) for name, _ in SCENARIOS]
    assert hops == [1, 2, 3, 4]
    # one kernel serves every placement (relocatable bitstream)
    k = accs["static_3pass"].kernel
    assert torch.equal(k(accs["static_0pass"].routes, a, b), outs["dynamic"])
    # the eager ISA interpreter agrees and counts the interconnect it crossed
    pl = accs["static_3pass"].placement
    out, st = run_program(compile_graph(g, pl), g, (a, b), return_state=True)
    assert torch.equal(out, outs["dynamic"])
    assert (st.hops, st.bypasses) == (4, 3)


def test_copy_passes_keep_layout_for_strided_values():
    """An edge's copy passes keep the value's layout exactly, so a kernel
    reading a transposed/strided value sees the same strides."""
    def f(x):
        return (x.t() * 2.0)[:, ::2].sum(0)
    x = torch.from_numpy(_inputs(5, n=48, k=1)[0]).reshape(6, 8)
    g = trace_to_graph(f, x).graph
    base = g.evaluate(x)
    far = {n.node_id: ((0, 0) if i % 2 else (2, 2)) for i, n in enumerate(g.op_nodes())}
    acc = assemble(g, place_static(g, TileGrid(3, 3, large_fraction=1.0), far))
    assert int(acc.routes.max()) == 4
    assert torch.equal(acc(x), base)


# ---------------------------------------------------------------------------
# Overlay (synchronous subset)
# ---------------------------------------------------------------------------
def test_overlay_jit_large_kernel_call_is_one_node_and_cached():
    ov = Overlay(3, 3)
    a, b = (torch.from_numpy(x) for x in _inputs(6))
    f = ov.jit(lambda x, y: ops.vmul_reduce(x, y), name="paper")
    out = f(a, b)
    g = f.lower(a, b).graph
    assert [(n.name, n.op.tile_class) for n in g.op_nodes()] == \
        [("kernels/vmul_reduce", patterns.TileClass.LARGE)]
    assert torch.equal(out, ops.vmul_reduce(a, b))
    traces, downloads = ov.stats.traces, ov.stats.downloads
    assert torch.equal(f(a, b), out)                    # resident hit
    assert (ov.stats.traces, ov.stats.downloads) == (traces, downloads)
    # a fresh wrapper of the same function: a bitstream-cache hit
    hits = ov.cache.stats.hits
    g2 = ov.jit(lambda x, y: ops.vmul_reduce(x, y), name="paper")
    assert torch.equal(g2(a, b), out)
    assert ov.cache.stats.hits == hits + 1


def test_overlay_static_and_dynamic_jit_bit_identical():
    a, b = (torch.from_numpy(x) for x in _inputs(8))
    static = Overlay(3, 3, policy=PlacementPolicy.STATIC)
    dyn = Overlay(3, 3)
    want = dyn.jit(_dot)(a, b)
    for name, vmul_tile in SCENARIOS:
        f = static.jit(_dot, name="vmul_reduce", fixed={2: vmul_tile, 3: (0, 0)})
        assert torch.equal(f(a, b), want), name
        assert f.accelerator(a, b).placement.total_passthrough == int(name[7])
    # every pinned scenario wants tile (0,0): each admission reclaimed the last
    assert static.stats.reclaims == 3


def test_overlay_aot_pytree_static_args_and_evict():
    ov = Overlay(3, 3)

    def f(d, k):
        return {"s": d["x"] * k + d["y"], "m": torch.amax(d["x"])}
    d = {"x": torch.arange(6.0), "y": torch.ones(6)}
    jf = ov.jit(f, static_argnums=(1,))
    out = jf(d, 3.0)
    assert torch.equal(out["s"], d["x"] * 3.0 + d["y"]) and out["m"].item() == 5.0
    assert torch.equal(jf(d, 2.0)["s"], d["x"] * 2.0 + d["y"])
    assert ov.stats.traces == 2 and len(ov.fabric) == 2
    assert ov.evict("f") >= 1 and len(ov.fabric) == 0
    desc = ov.reconfigure()
    assert desc["fabric"]["tiles_used"] == 0 and desc["cached_bitstreams"] == 0
    assert torch.equal(jf(d, 3.0)["s"], out["s"])           # re-downloads


def test_overlay_lru_reclaim_under_pressure():
    ov = Overlay(2, 2)
    a = torch.arange(4.0)
    fns = [ov.jit(lambda x, k=k: torch.sin(x) + k, name=f"f{k}") for k in range(3)]
    # (default arguments are closed over, not traced)
    for f in fns:
        f(a)
    assert ov.stats.reclaims >= 1
    assert fns[-1].accelerator(a).resident_id in ov.fabric.residents


def test_overlay_raises_on_deferred_options(tmp_path):
    # the store, the sanitizer and sharded assembly are ported: mesh= and
    # tile_axis= run on a 1-rank gloo mesh; an unknown option still raises
    (res,) = spawn(1, mesh_overlay_modes, tmp_path, str(tmp_path / "mesh_store"))
    assert res["tile_axis"] == "tiles" and torch.equal(res["y"], res["local"])
    assert Overlay(3, 3, sanitize=True).sanitize is True
    assert Overlay(3, 3, store_path=str(tmp_path)).store is not None
    with pytest.raises(TypeError):
        Overlay(3, 3, not_an_option=1)


def test_unplaceable_graph_raises_without_evicting():
    ov = Overlay(3, 3, large_fraction=0.0)
    ov.jit(lambda x: x + 1.0, name="small")(torch.ones(3))
    g = Graph("large")
    x = g.input("x", (3,))
    g.output(g.apply(patterns.SQRT, x))
    with pytest.raises(PlacementError):
        ov.assemble(g)
    assert len(ov.fabric) == 1
