"""The port's module-level frontend and the model step as an overlay graph.

* ``jit`` / ``jit_assemble`` / ``default_overlay`` against one process-wide
  3x3 dynamic overlay (``repro/core/overlay.py:2299-2330``): the decorator
  with and without arguments, each wrapper's outputs equal to the eager
  function's;
* the ``Instruction`` and ``cache_key`` exports of ``repro_torch.core``;
* ``models.model.build_step_graph``: embed -> group stages -> head as LARGE
  operators, assembled on an ``Overlay``, bit-identical to ``forward`` +
  ``unembed`` on the CPU, and against the JAX package's own step graph
  assembled on its overlay from the same numpy weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as core
from repro.configs.archs import smoke_config as jax_smoke_config
from repro.core import Overlay as JOverlay
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models.transformer import model_spec as jax_model_spec
from repro_torch.configs import smoke_config
from repro_torch.core import (Instruction, JitAssembled, Opcode, Overlay, TileClass,
                              TraceError, cache_key, default_overlay, jit, jit_assemble)
from repro_torch.core import overlay as overlay_mod
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.models import transformer as tfm


def _x(n=64, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))


# ---------------------------------------------------------------------------
# module-level frontend
# ---------------------------------------------------------------------------
def test_default_overlay_is_one_process_wide_3x3_fabric():
    ov = default_overlay()
    assert isinstance(ov, Overlay) and ov is default_overlay()
    assert (ov.grid.rows, ov.grid.cols) == (3, 3)
    assert overlay_mod._DEFAULT_OVERLAY is ov


def test_jit_assemble_bare_decorator_uses_the_default_overlay():
    @jit_assemble
    def dot(a, b):
        return torch.sum(a * b)

    a, b = _x(seed=1), _x(seed=2)
    assert isinstance(dot, JitAssembled) and dot.overlay is default_overlay()
    assert dot.__name__ == "dot"
    assert torch.equal(dot(a, b), torch.sum(a * b))
    assert dot.accelerator(a, b) is not None


def test_jit_assemble_with_arguments_on_a_given_overlay():
    ov = Overlay(2, 2)

    @jit_assemble(strict=True, overlay=ov, name="scaled")
    def scaled(x):
        return torch.sqrt(torch.abs(x)) * 2.0

    x = _x(seed=3)
    assert scaled.overlay is ov and scaled.name == "scaled" and scaled.strict
    assert torch.equal(scaled(x), torch.sqrt(torch.abs(x)) * 2.0)
    assert ov.describe()["traces"] == 1

    @jit_assemble(strict=True, overlay=ov)
    def cum(x):
        return torch.cumsum(x, 0)

    with pytest.raises(TraceError):
        cum(x)


def test_jit_function_and_decorator_forms():
    def f(x):
        return torch.sin(x) + x

    x = _x(seed=4)
    direct = jit(f)
    assert direct.overlay is default_overlay()
    assert torch.equal(direct(x), f(x))
    ov = Overlay(3, 3)
    deco = jit(overlay=ov, tile_budget=2)(f)
    assert deco.overlay is ov and deco.tile_budget == 2
    assert torch.equal(deco(x), f(x))
    assert core.jit is jit and core.jit_assemble is jit_assemble


def test_instruction_and_cache_key_exports():
    ins = Instruction(Opcode.POP, dst=3, srcs=(1, 2), tile=(0, 1))
    assert repr(ins) == "POP@(0, 1) d=3 s=[1,2]"
    g = core.vmul_reduce_graph(16)
    prog = core.compile_graph(g, core.place_dynamic(g, core.TileGrid(3, 3)))
    assert prog.instructions and all(isinstance(i, Instruction) for i in prog.instructions)
    assert {"Instruction", "cache_key", "default_overlay", "jit",
            "jit_assemble"} <= set(core.__all__)
    sig = (((4,), torch.float32, None),)
    k = cache_key("dot", sig)
    assert k.startswith("dot:") and k == cache_key("dot", sig)
    assert k != cache_key("dot", sig, placement_desc="pins") != cache_key("dot", sig, extra="x")


# ---------------------------------------------------------------------------
# build_step_graph
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "gemma2-27b", "mamba2-130m"])
def test_step_graph_is_bit_identical_to_forward(name):
    """The stages land contiguously on an all-LARGE fabric (the reference's
    test does the same, ``tests/test_integration.py:50``) and the assembled
    step's logits are the eager forward's, bit for bit.  gemma2 runs at
    window 8 on 16 tokens, so its local layers mask keys."""
    cfg = smoke_config(name)
    if name == "gemma2-27b":
        cfg = cfg.scaled(sliding_window=8)
    params = tparams.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    g = tmodel.build_step_graph(cfg, (2, 16), "cpu")
    assert [n.name for n in g.op_nodes()] == [f"{name}/embed", f"{name}/g0", f"{name}/head"]
    assert all(n.op.tile_class is TileClass.LARGE for n in g.op_nodes())
    ov = Overlay(3, 3, large_fraction=1.0)
    acc = ov.assemble(g)
    assert acc.placement.total_passthrough == 0
    h, _ = tfm.forward(params, cfg, toks)
    want = tfm.unembed(params, h, cfg)
    got = acc(params, toks)
    assert got.shape == (2, 16, cfg.vocab_size) and torch.equal(got, want)
    ov.assemble(g)
    assert ov.cache.stats.hits >= 1


def test_step_graph_has_one_stage_per_group():
    cfg = smoke_config("phi3-mini-3.8b").scaled(blocks=((("dense",), 1), (("dense",), 2)))
    g = tmodel.build_step_graph(cfg, (1, 8), "cpu")
    assert [n.name.split("/")[1] for n in g.op_nodes()] == ["embed", "g0", "g1", "head"]
    params = tparams.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.arange(8, dtype=torch.int32)[None]
    h, _ = tfm.forward(params, cfg, toks)
    assert torch.equal(g.evaluate(params, toks), tfm.unembed(params, h, cfg))


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "gemma2-27b"])
def test_step_graph_matches_the_jax_step_graph(name):
    """The port's step graph and the reference's, assembled on their own
    overlays from the same float32 numpy weights: the same stage names and
    logits within 1e-4 (float32 throughout, no cache)."""
    over = dict(dtype="float32")
    if name == "gemma2-27b":
        over["sliding_window"] = 8
    jcfg, tcfg = jax_smoke_config(name).scaled(**over), smoke_config(name).scaled(**over)
    rng = np.random.default_rng(0)

    def leaf(spec):
        if spec.init == "ones":
            return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return (fan_in ** -0.5 * rng.standard_normal(spec.shape)).astype(np.float32)

    tree = jax.tree.map(leaf, jax_model_spec(jcfg), is_leaf=jparams.is_spec)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    jg = jmodel.build_step_graph(jcfg, (2, 16))
    want = JOverlay(3, 3, large_fraction=1.0).assemble(jg, jit=False)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks))
    tg = tmodel.build_step_graph(tcfg, (2, 16), "cpu")
    assert [n.name for n in tg.op_nodes()] == [n.name for n in jg.op_nodes()]
    tp = tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32)
    got = Overlay(3, 3, large_fraction=1.0).assemble(tg)(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
