"""Training the encoder-decoder family in the port against the JAX package:
seamless-m4t's loss, which runs the encoder on the batch's audio frames
(the stub's ``frontend_proj``, the ``enc`` layers, ``enc_norm``) and the
decoder, whose ``dec`` layers cross-attend to the encoder's output
(``repro/models/model.py:51-60``), then the LM's cross-entropy; and its
gradients, under each remat policy.

The model is seamless-m4t-medium's smoke config (d_model 64, 4 heads of
16, 2 ``enc`` + 2 ``dec`` layers, untied vocab 256, frames of 32 features)
in float32.  Parameters are numpy draws from a seed, fed to the port
through ``params.from_jax_numpy``; tokens and labels come from each
package's ``data.pipeline.make_batch`` (batch 2 x 24 tokens, the same
tokens); the frames are a numpy draw of 40 frames a row, rounded to bf16
on both sides, so the cross-attention has 24 queries over 40 keys (Sq !=
Sk); the reference's loss and gradients are ``jax.value_and_grad(loss_fn,
has_aux=True)``.

Tolerances: the loss, ``ce`` and ``acc`` within 1e-4 (relative; float32
sums in other orders); every gradient leaf within ``_close_normwise``
1e-4 (|got - want| <= 1e-4 * max|want|: the backward's products sum in
other orders).  The remat policies against one another, the overlay-traced
step against the eager one, are held exactly.
"""

import ast
import inspect
import os
import textwrap

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
from repro.models import transformer as jtfm
from repro_torch.configs import smoke_config
from repro_torch.core import Overlay
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.optim import adamw_init, cosine

ARCH = "seamless-m4t-medium"
B, S, FRAMES = 2, 24, 40
TOL = 1e-4
REMATS = ("none", "full", "dots")
# the gradient's subtrees: (name, test of a leaf's path), every leaf in one
SUBTREES = (
    ("frontend_proj", lambda p: p == "frontend_proj"),
    ("enc_layers", lambda p: p.startswith("enc_layers/")),
    ("enc_norm", lambda p: p == "enc_norm"),
    *((f"layers/{i}/{part}", lambda p, i=i, part=part: p.startswith(f"layers/{i}/{part}/"))
      for i in range(2) for part in ("attn", "cross", "ffn")),
    *((f"layers/{i}/norms", lambda p, i=i: p.startswith(f"layers/{i}/")
       and p.split("/")[2] in ("ln1", "ln_cross", "ln2")) for i in range(2)),
    ("embed", lambda p: p == "embed"),
    ("lm_head", lambda p: p == "lm_head"),
    ("final_norm", lambda p: p == "final_norm"),
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close_normwise(got, want, rtol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _leaf(rng, spec):
    if spec.init == "ones":
        return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    return (scale * rng.standard_normal(spec.shape)).astype(np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _frames(seed, n=FRAMES):
    """(B, n, frontend_dim) frames, a numpy draw: bf16 on both sides."""
    cfg = jax_smoke_config(ARCH)
    return np.random.default_rng(seed).standard_normal((B, n, cfg.frontend_dim)).astype(
        np.float32)


_BASE = {}
_GRADS = {}


def _base():
    """Both packages' configs, weights and batch (the same numpy draws) and
    the reference's loss, metrics and gradients as the port's tree."""
    if not _BASE:
        jcfg = jax_smoke_config(ARCH).scaled(dtype="float32")
        tcfg = smoke_config(ARCH).scaled(dtype="float32")
        rng = np.random.default_rng(0)
        tree = jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(jcfg),
                            is_leaf=jparams.is_spec)
        jp = jax.tree.map(jnp.asarray, tree)
        frames = _frames(7)
        jbatch = dict(jpipe.make_batch(jcfg, B, S, step=0, seed=0),
                      frames=jnp.asarray(frames, jnp.bfloat16))
        tbatch = tpipe.make_batch(tcfg, B, S, step=0, seed=0, device="cpu")
        assert np.array_equal(tbatch["tokens"].numpy(), np.asarray(jbatch["tokens"]))
        assert np.array_equal(tbatch["labels"].numpy(), np.asarray(jbatch["labels"]))
        tbatch["frames"] = torch.from_numpy(frames).to(torch.bfloat16)
        assert tbatch["tokens"].shape[1] == S != FRAMES == tbatch["frames"].shape[1]
        (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(jp, jbatch, jcfg)
        want = tparams.from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                      dtype=torch.float32)
        _BASE.update(jcfg=jcfg, tcfg=tcfg, jp=jp, jbatch=jbatch, tbatch=tbatch,
                     tp=tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32),
                     want=(float(jloss), {k: float(v) for k, v in jm.items()}, _flat(want)))
    return _BASE


def _grads(remat):
    """The port's (loss, metrics, gradients by path) under ``remat``."""
    if remat not in _GRADS:
        base = _base()
        loss, metrics, grads, spec = train_cli._loss_and_grads(
            base["tcfg"].scaled(remat=remat), base["tp"], base["tbatch"])
        _GRADS[remat] = (loss, metrics, _flat(pytree.tree_unflatten(grads, spec)))
    return _GRADS[remat]


# ---------------------------------------------------------------------------
# the loss and its gradients against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", REMATS)
def test_loss_ce_and_acc_match_jax(remat):
    """The loss equals ``ce`` (aux 0: no router) and the reference's, under
    every remat policy; the metrics keep the reference's three keys."""
    jloss, jm, _ = _base()["want"]
    loss, metrics, _ = _grads(remat)
    assert sorted(metrics) == ["acc", "aux", "ce"] == sorted(jm)
    np.testing.assert_allclose(loss.item(), jloss, rtol=TOL)
    np.testing.assert_allclose(metrics["ce"].item(), jm["ce"], rtol=TOL)
    np.testing.assert_allclose(metrics["acc"].item(), jm["acc"], rtol=TOL, atol=TOL)
    assert metrics["aux"].item() == 0.0 and torch.equal(loss, metrics["ce"])


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("subtree", [name for name, _ in SUBTREES])
def test_every_gradient_leaf_matches_jax(subtree, remat):
    """Each gradient leaf of the subtree within 1e-4 normwise of
    ``jax.value_and_grad``'s and nonzero: the encoder's and the stub's
    reach the loss only through the ``dec`` layers' cross-attention."""
    test = dict(SUBTREES)[subtree]
    want = _base()["want"][2]
    got = {p: g for p, g in _grads(remat)[2].items() if test(p)}
    assert got and got.keys() == {p for p in want if test(p)}
    for name, g in got.items():
        assert float(want[name].abs().max()) > 0 and float(g.abs().max()) > 0, name
        _close_normwise(g.numpy(), want[name].numpy(), TOL, name)


def test_the_subtrees_cover_every_leaf_once():
    names = list(_base()["want"][2])
    assert all(sum(test(p) for _, test in SUBTREES) == 1 for p in names)


def test_remat_policies_give_the_same_bits():
    """``"full"`` and ``"dots"`` recompute the same ops from the same
    inputs as ``"none"`` keeps: the same loss and gradients bit for bit."""
    loss, _, grads = _grads("none")
    for remat in ("full", "dots"):
        other_loss, _, other = _grads(remat)
        assert torch.equal(loss, other_loss)
        assert all(torch.equal(g, other[p]) for p, g in grads.items()), remat


def test_the_loss_moves_with_the_frames():
    """Other frames under the same tokens move the loss, on both sides
    alike: the decoder reads the encoder."""
    base = _base()
    frames = _frames(8)
    jloss, _ = jmodel.loss_fn(base["jp"], dict(base["jbatch"],
                                               frames=jnp.asarray(frames, jnp.bfloat16)),
                              base["jcfg"])
    with torch.no_grad():
        loss, _ = tmodel.loss_fn(base["tp"], dict(base["tbatch"],
                                                  frames=torch.from_numpy(frames).to(
                                                      torch.bfloat16)), base["tcfg"])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    assert abs(loss.item() - _grads("none")[0].item()) > 1e-3


# ---------------------------------------------------------------------------
# the code itself
# ---------------------------------------------------------------------------
def test_encdec_loss_products_are_one_mm_each():
    """No ``@``, ``torch.matmul`` or ``torch.einsum`` in the loss (they pick
    a decomposition from strides, which the tracer's fake tensors and eager
    CUDA tensors may disagree on), and each 2-D weight of the stub, the
    encoder and the cross-attention is read by exactly one op in the
    forward, an ``aten.mm``."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(tmodel.loss_fn)))
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult))
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("matmul", "einsum")
    base = _base()
    weights = {p: t for p, t in _flat(base["tp"]).items() if t.dim() == 2
               and (p == "frontend_proj" or p.startswith("enc_layers/") or "/cross/" in p)}
    seen = {p: [] for p in weights}

    class Products(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for p, w in weights.items():
                if any(isinstance(a, torch.Tensor) and a.shape == w.shape
                       and a.data_ptr() == w.data_ptr() for a in args):
                    seen[p].append(func)
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Products():
        tmodel.loss_fn(base["tp"], base["tbatch"], base["tcfg"])
    assert len(weights) == 1 + 2 * (4 + 3) + 2 * 4     # the stub, q k v o + a gated MLP, q k v o
    assert all(funcs == [torch.ops.aten.mm.default] for funcs in seen.values()), seen


# ---------------------------------------------------------------------------
# the traced step, the launcher
# ---------------------------------------------------------------------------
def test_overlay_train_step_equals_eager_step():
    """Two seamless steps (bf16, d_model 128 so the rmsnorm and attention
    ops are kernel nodes) through ``Overlay.jit``, functional and traced
    with the backward and the optimizer, the state donated, and eagerly in
    place from the same state: losses, grad norms and every state leaf
    bit-identical; each returned leaf is the tensor donated to it.  The
    graph holds two attention nodes for each encoder self-attention, each
    decoder self-attention and each cross-attention (the forward and the
    recompute), two rmsnorm nodes for each layer norm and one each for
    ``enc_norm`` and the final norm, and the frames as an input."""
    tcfg = smoke_config(ARCH).scaled(dtype="bfloat16", d_model=128, head_dim=32)
    n_enc, n_dec = 2, 2
    sched = cosine(3e-3, warmup=1, total=4)
    ov = Overlay(3, 3)
    traced = train_cli.make_step(tcfg, sched, overlay=ov)
    eager = train_cli.make_step(tcfg, sched)
    params = tparams.init(tcfg, torch.Generator().manual_seed(2), "cpu")
    s_ov = params, adamw_init(params)
    copy = pytree.tree_map(lambda t: t.clone(), params)
    s_eg = copy, adamw_init(copy)
    ptrs = [t.data_ptr() for t in pytree.tree_leaves(s_ov)]
    for step in range(2):
        batch = tpipe.make_batch(tcfg, 2, 32, step=step, device="cpu")
        assert tuple(batch["frames"].shape) == (2, 32, tcfg.frontend_dim)
        s_ov, m_ov = traced(s_ov, batch)
        s_eg, m_eg = eager(s_eg, batch)
        for key in ("loss", "ce", "acc", "grad_norm"):
            assert torch.equal(m_ov[key], m_eg[key]), key
        assert [t.data_ptr() for t in pytree.tree_leaves(s_ov)] == ptrs
    for a, b in zip(pytree.tree_leaves(s_ov), pytree.tree_leaves(s_eg)):
        assert torch.equal(a, b)
    assert ov.stats.traces == 1 and ov.stats.downloads == 1
    lowered = traced.lower(s_ov, batch)
    names = [n.name for n in lowered.graph.op_nodes()]
    assert names.count("kernels/attention") == 2 * (n_enc + 2 * n_dec)
    assert names.count("kernels/rmsnorm") == 2 * (2 * n_enc + 3 * n_dec) + 2
    shapes = [tuple(a.shape) for a in lowered.graph.input_avals()]
    assert (2, 32, tcfg.frontend_dim) in shapes


def test_train_launcher_restarts_seamless_after_failure(tmp_path, capsys):
    rc = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
                         "--seq", "32", "--ckpt-every", "2", "--fail-at", "3",
                         "--log-every", "1", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "restarts=1" in out and "4 steps" in out and "4 layers" in out
    losses = [float(line.split("loss")[1].split()[0]) for line in out.splitlines()
              if line.strip().startswith("step")]
    assert len(losses) >= 4 and all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path))[-1] == "step_0000000004"
