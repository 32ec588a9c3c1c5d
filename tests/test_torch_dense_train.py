"""gemma2's training path against the JAX package, and what the ``"dots"``
remat policy saves.

The model is a gemma2-27b config cut to d_model 128 (so the flash
attention and rmsnorm kernels are on the JAX path, in interpret mode),
head dim 32, 4 heads over 2 kv heads, ``query_pre_attn_scalar`` 32, one
(local, global) unit, at seq 128 against a sliding window of 32: the local
layer's window drops pairs.  Weights and batches are made from a seed with
numpy and fed to both packages; everything is float32.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.archs import smoke_config as jax_smoke_config
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models.transformer import model_spec as jax_model_spec
from repro_torch.configs import smoke_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams

SMALL = dict(d_model=128, head_dim=32, num_heads=4, num_kv_heads=2,
             query_pre_attn_scalar=32.0, sliding_window=32,
             blocks=((("local", "global"), 1),), dtype="float32")
SEQ = 128


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _configs(remat="full"):
    return (jax_smoke_config("gemma2-27b").scaled(remat=remat, **SMALL),
            smoke_config("gemma2-27b").scaled(remat=remat, **SMALL))


def _numpy_params(jcfg, seed=0):
    """The JAX parameter tree's structure, filled with numpy draws."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        if spec.init == "ones":
            return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None else fan_in ** -0.5
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    return jax.tree.map(leaf, jax_model_spec(jcfg), is_leaf=jparams.is_spec)


def _f32_params(tcfg, seed=0):
    return pytree.tree_map(lambda t: t.float(),
                           tparams.init(tcfg, torch.Generator().manual_seed(seed), "cpu"))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_gemma2_loss_and_grads_match_jax(remat):
    """Loss, accuracy and every gradient against ``jax.value_and_grad(
    loss_fn)`` under the same remat policy on both sides (the reference's
    ``"dots"`` is ``dots_with_no_batch_dims_saveable``).  Tolerances as
    the phi3 test's (``tests/test_torch_train.py``): loss rtol 1e-5,
    gradients rtol 1e-4 with an absolute floor of 1e-4 of each leaf's
    largest gradient (f32 sums in other orders through the backward)."""
    jcfg, tcfg = _configs(remat)
    tree = _numpy_params(jcfg)
    batch = jpipe.make_batch(jcfg, 2, SEQ, step=3, seed=1)
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), batch, jcfg)
    tp = tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, metrics, grads, spec = train_cli._loss_and_grads(tcfg, tp, tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["acc"].item(), float(jm["acc"]), rtol=1e-6)
    want = tparams.from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                  dtype=torch.float32)
    got = pytree.tree_unflatten(grads, spec)
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def test_the_window_acts_on_the_loss():
    """At seq 128 the local layer's window of 32 drops pairs: without it
    the loss is another."""
    _, tcfg = _configs()
    tp = _f32_params(tcfg)
    batch = tpipe.make_batch(tcfg, 2, SEQ, step=3, seed=1, device="cpu")
    windowed = train_cli._loss_and_grads(tcfg, tp, batch)[0]
    unwindowed = train_cli._loss_and_grads(tcfg.scaled(sliding_window=None), tp, batch)[0]
    assert abs(windowed.item() - unwindowed.item()) > 1e-4


class _Ops(TorchDispatchMode):
    """Counts the aten and custom ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] += 1
        return func(*args, **(kwargs or {}))


OPS = ("aten.mm.default", "repro_torch.attention.default", "repro_torch.rmsnorm.default")


def _forward_and_backward(tcfg, params, batch):
    """The ops of the loss's forward and of its backward, and the shapes
    autograd packs (``saved_tensors_hooks``) in the forward."""
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    packed = []

    def pack(t):
        packed.append((tuple(t.shape), t.dtype))
        return t

    fwd, bwd = _Ops(), _Ops()
    with torch.enable_grad():
        with fwd, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = tmodel.loss_fn(pytree.tree_unflatten(leaves, spec), batch, tcfg)
        with bwd:
            torch.autograd.grad(loss, leaves)
    return ({k: fwd.n[k] for k in OPS}, {k: bwd.n[k] for k in OPS}, packed)


def test_dots_saves_the_products_and_recomputes_the_rest():
    """Under ``"dots"`` each layer's checkpoint keeps its ``aten.mm``
    outputs: the backward recomputes the layer's attention and norms, as
    under ``"full"``, but none of its 2-D products, whose outputs it reads
    from the forward.  What autograd packs inside a layer is only the
    layer's input (the hidden state and the positions), under both
    policies: no attention output (B, H, S, D) and no product, which
    ``"none"`` packs."""
    tcfg = _configs()[1].scaled(d_ff=192)           # no shape of d_model or SEQ
    tp = _f32_params(tcfg)
    batch = tpipe.make_batch(tcfg, 1, SEQ, device="cpu")
    runs = {r: _forward_and_backward(tcfg.scaled(remat=r), tp, batch)
            for r in ("full", "dots", "none")}
    layers = tcfg.num_layers
    mm_a_layer = 7                                  # q, k, v, o and the MLP's three
    fwd = runs["none"][0]
    assert fwd == {"aten.mm.default": mm_a_layer * layers + 1,    # + the unembed
                   "repro_torch.attention.default": layers,
                   "repro_torch.rmsnorm.default": 4 * layers + 1}
    assert runs["full"][0] == runs["dots"][0] == fwd
    full, dots, none = (runs[r][1] for r in ("full", "dots", "none"))
    assert full["aten.mm.default"] - dots["aten.mm.default"] == mm_a_layer * layers
    assert dots["aten.mm.default"] == none["aten.mm.default"]
    for op, n in (("repro_torch.attention.default", layers),
                  ("repro_torch.rmsnorm.default", 4 * layers)):
        assert full[op] == dots[op] == none[op] + n
    f32, d, hd = torch.float32, tcfg.d_model, tcfg.resolved_head_dim
    inner = {((1, h, SEQ, hd), f32) for h in (tcfg.num_heads, tcfg.num_kv_heads)}
    inner.add(((SEQ, tcfg.d_ff), f32))              # an MLP product
    for remat in ("full", "dots"):
        packed = runs[remat][2]
        assert packed.count(((SEQ,), torch.int64)) == layers    # each layer's positions
        assert not inner & set(packed)
    assert inner <= set(runs["none"][2])
