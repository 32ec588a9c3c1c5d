"""Training deepseek-v3 in the port against the JAX package: its loss
``ce + 0.01 * aux + 0.3 * ce2``, where ``ce2`` is the multi-token
prediction's cross-entropy: the ``mtp`` module sees ``[h_t ; emb(label_t)]``
through ``proj``, one ``dense`` layer and its norm, and predicts
``label_{t+1}`` (``repro/models/model.py:73-85``); and its gradients.

The model is deepseek-v3-671b's smoke config (d_model 64, 2 ``mla_dense``
and 2 ``mla_moe`` layers, 4 heads, MLA latents 32 and 16, 4 experts top-2,
sigmoid scoring, untied vocab 256, ``mtp_depth`` 1, the MTP layer at 4
heads of 16) in float32.  Parameters are numpy draws from a seed, fed to
the port through ``params.from_jax_numpy``; batches come from each
package's ``data.pipeline.make_batch`` (batch 2 x 32 tokens, the same
tokens); the reference's loss and gradients are ``jax.value_and_grad(
loss_fn, has_aux=True)``.

Tolerances: the loss, ``ce`` and ``aux`` within a relative 1e-5, ``acc``
within 1e-6 (float32 sums in other orders); the MTP term ``loss - ce -
0.01 * aux`` within a relative 1e-5 of 0.3 x the reference's ``ce2``
computed apart (the subtraction adds a few f32 ulps of the loss); every
gradient leaf within ``_close_normwise`` 1e-4 (|got - want| <= 1e-4 *
max|want|: the backward's products sum in other orders).  A caller's mask
leaves the MTP term within 1e-6 absolute (the same term, rounded in other
sums).  The overlay-traced step against the eager one and the serving
graphs are held exactly.
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
from repro_torch.core.trace import trace_to_graph
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.optim import adamw_init, cosine

ARCH = "deepseek-v3-671b"
B, S = 2, 32
GRAD_TOL = 1e-4
MTP_WEIGHT = 0.3
# op nodes of the traced prefill (batch 2, prompt 8, max_len 32) and decode
# of the smoke config, as the port traced them before the loss ran the MTP
# module
SERVING_OP_NODES = (861, 856)
# the top-level subtrees of the gradient
SUBTREES = ("embed", "lm_head", "final_norm", "layers", "mtp")


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


_RUN = {}


def _run():
    """Both packages' loss and gradients on one numpy draw of the weights
    and one batch: the configs, the weights and batches of each, the
    reference's (loss, metrics, gradients as the port's tree) and the
    port's."""
    if not _RUN:
        jcfg = jax_smoke_config(ARCH).scaled(dtype="float32")
        tcfg = smoke_config(ARCH).scaled(dtype="float32")
        rng = np.random.default_rng(0)
        tree = jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(jcfg),
                            is_leaf=jparams.is_spec)
        jp = jax.tree.map(jnp.asarray, tree)
        jbatch = jpipe.make_batch(jcfg, B, S, step=0, seed=0)
        (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(jp, jbatch, jcfg)
        tp = tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32)
        tbatch = tpipe.make_batch(tcfg, B, S, step=0, seed=0, device="cpu")
        assert np.array_equal(tbatch["tokens"].numpy(), np.asarray(jbatch["tokens"]))
        assert np.array_equal(tbatch["labels"].numpy(), np.asarray(jbatch["labels"]))
        loss, metrics, grads, spec = train_cli._loss_and_grads(tcfg, tp, tbatch)
        want = tparams.from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                      dtype=torch.float32)
        _RUN.update(
            jcfg=jcfg, tcfg=tcfg, jp=jp, jbatch=jbatch, tp=tp, tbatch=tbatch,
            want=(float(jloss), {k: float(v) for k, v in jm.items()}, want),
            got=(loss, metrics, grads, spec))
    return _RUN


def _jax_ce2(jp, jbatch, jcfg) -> float:
    """The reference's ``ce2`` alone: its lines :73-84 on the decoder's
    output."""
    h, _, _ = jtfm.forward(jp, jcfg, jbatch["tokens"])
    mtp = jp["mtp"]
    lbl_emb = jtfm.embed_tokens(jp, jbatch["labels"], jcfg)
    h_in = jnp.concatenate([h[:, :-1], lbl_emb[:, :-1]], axis=-1).astype(
        lbl_emb.dtype) @ mtp["proj"]
    h2, _, _ = jtfm.layer_fwd(mtp["layer"], h_in, "dense", jcfg,
                              positions=jnp.arange(h_in.shape[1]))
    h2 = jtfm.rmsnorm_fwd(mtp["norm"], h2, jcfg.norm_eps)
    ce2, _ = jmodel.cross_entropy(jtfm.unembed(jp, h2, jcfg), jbatch["labels"][:, 1:], None)
    return float(ce2)


def _mtp_term(loss, metrics) -> float:
    return loss.item() - metrics["ce"].item() - 0.01 * metrics["aux"].item()


# ---------------------------------------------------------------------------
# the loss and its gradients against the reference
# ---------------------------------------------------------------------------
def test_loss_ce_acc_and_aux_match_jax():
    """The loss ``ce + 0.01 * aux + 0.3 * ce2`` as the reference's; the
    metrics keep the reference's three keys; aux > 0 (two ``mla_moe``
    layers route)."""
    run = _run()
    (jloss, jm, _), (loss, metrics, _, _) = run["want"], run["got"]
    assert sorted(metrics) == ["acc", "aux", "ce"] == sorted(jm)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), jm["ce"], rtol=1e-5)
    np.testing.assert_allclose(metrics["aux"].item(), jm["aux"], rtol=1e-5)
    np.testing.assert_allclose(metrics["acc"].item(), jm["acc"], rtol=1e-6)
    assert metrics["aux"].item() > 0 and np.isfinite(loss.item())


@pytest.mark.parametrize("subtree", SUBTREES)
def test_every_gradient_leaf_matches_jax(subtree):
    """Each gradient leaf of the subtree within 1e-4 normwise of
    ``jax.value_and_grad``'s, every leaf nonzero: the ``mtp`` module's
    (``proj``, its layer, its norm) and ``embed``'s, which also takes the
    MTP term's gradient through the label embeddings."""
    run = _run()
    got = _flat(pytree.tree_unflatten(run["got"][2], run["got"][3])[subtree], f"{subtree}/")
    want = _flat(run["want"][2][subtree], f"{subtree}/")
    assert got.keys() == want.keys() and got
    for name, g in got.items():
        assert float(want[name].abs().max()) > 0 and float(g.abs().max()) > 0, name
        _close_normwise(g.numpy(), want[name].numpy(), GRAD_TOL, name)


def test_the_mtp_term_is_point_three_of_the_references_ce2():
    """``loss - ce - 0.01 * aux`` is 0.3 x the reference's ``ce2``,
    computed apart from its loss, within a relative 1e-5; ce2 is near
    ln 256 with random weights."""
    run = _run()
    ce2 = _jax_ce2(run["jp"], run["jbatch"], run["jcfg"])
    assert 0.5 * np.log(256) < ce2 < 2 * np.log(256)
    np.testing.assert_allclose(_mtp_term(*run["got"][:2]), MTP_WEIGHT * ce2, rtol=1e-5)


def test_a_callers_mask_moves_ce_only():
    """``ce2`` takes no mask, not even the batch's own: with a caller's
    ``mask`` the loss, ``ce`` and ``acc`` follow the reference given the
    same mask, ``ce`` moves, and the MTP term stays as it was within 1e-6."""
    run = _run()
    mask = (np.random.default_rng(5).random((B, S)) > 0.3).astype(np.float32)
    jloss, jm = jmodel.loss_fn(run["jp"], dict(run["jbatch"], mask=jnp.asarray(mask)),
                               run["jcfg"])
    tbatch = dict(run["tbatch"], mask=torch.from_numpy(mask))
    with torch.no_grad():
        loss, metrics = tmodel.loss_fn(run["tp"], tbatch, run["tcfg"])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["acc"].item(), float(jm["acc"]), rtol=1e-6)
    base_loss, base_metrics = run["got"][:2]
    assert abs(metrics["ce"].item() - base_metrics["ce"].item()) > 1e-3
    np.testing.assert_allclose(_mtp_term(loss, metrics), _mtp_term(base_loss, base_metrics),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the code itself
# ---------------------------------------------------------------------------
def test_mtp_proj_runs_as_one_mm():
    """No ``@``, ``torch.matmul`` or ``torch.einsum`` in the loss code
    (they pick a decomposition from strides, which the tracer's fake
    tensors and eager CUDA tensors may disagree on), and ``proj`` (2d, d)
    is read by exactly one op in the forward, an ``aten.mm``."""
    for fn in (tmodel.loss_fn, tmodel._mtp_ce):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        for node in ast.walk(tree):
            assert not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult))
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("matmul", "einsum")
    run = _run()
    proj = run["tp"]["mtp"]["proj"]
    seen = []

    class Products(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(isinstance(a, torch.Tensor) and a.shape == proj.shape
                   and a.data_ptr() == proj.data_ptr() for a in args):
                seen.append(func)
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Products():
        tmodel.loss_fn(run["tp"], run["tbatch"], run["tcfg"])
    assert seen == [torch.ops.aten.mm.default]


# ---------------------------------------------------------------------------
# the traced step, the launcher, serving
# ---------------------------------------------------------------------------
def test_overlay_train_step_equals_eager_step():
    """Two deepseek steps (bf16, d_model and both latents 128 so every
    rmsnorm is a kernel node) through ``Overlay.jit``, functional and
    traced with the backward and the optimizer, the state donated, and
    eagerly in place from the same state: losses, aux, grad norms and every
    state leaf bit-identical; each returned leaf is the tensor donated to
    it.  The graph holds one attention node, the MTP layer's (MLA's
    attention is plain code; that layer is not rematerialized), and the
    rmsnorm nodes of 4 norms a layer twice, the final norm and the MTP
    layer's three."""
    tcfg = smoke_config(ARCH).scaled(d_model=128, q_lora_rank=128, kv_lora_rank=128)
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
        s_ov, m_ov = traced(s_ov, batch)
        s_eg, m_eg = eager(s_eg, batch)
        for key in ("loss", "aux", "ce", "grad_norm"):
            assert torch.equal(m_ov[key], m_eg[key]), key
        assert [t.data_ptr() for t in pytree.tree_leaves(s_ov)] == ptrs
    for a, b in zip(pytree.tree_leaves(s_ov), pytree.tree_leaves(s_eg)):
        assert torch.equal(a, b)
    assert ov.stats.traces == 1 and ov.stats.downloads == 1
    names = [n.name for n in traced.lower(s_ov, batch).graph.op_nodes()]
    assert names.count("kernels/attention") == 1
    assert names.count("kernels/rmsnorm") == 2 * 4 * tcfg.num_layers + 1 + 3


def test_train_launcher_restarts_deepseek_after_failure(tmp_path, capsys):
    rc = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
                         "--seq", "32", "--ckpt-every", "2", "--fail-at", "3",
                         "--log-every", "1", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "restarts=1" in out and "4 steps" in out and "4 layers" in out
    losses = [float(line.split("loss")[1].split()[0]) for line in out.splitlines()
              if line.strip().startswith("step")]
    assert len(losses) >= 4 and all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path))[-1] == "step_0000000004"


def test_serving_graphs_keep_their_op_node_counts():
    """Serving runs no MTP module: deepseek's traced prefill and decode
    hold the op nodes they held before the loss ran it."""
    tcfg = smoke_config(ARCH)
    tp = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    cache = tmodel.init_cache(tcfg, 2, 32, "cpu")
    toks = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]], dtype=torch.int32)
    prefill = trace_to_graph(lambda p, t, c: tmodel.prefill(p, tcfg, t, c), tp, toks, cache,
                             name="deepseek.prefill")
    decode = trace_to_graph(lambda p, t, c: tmodel.decode_step(p, tcfg, t, c), tp, toks[:, :1],
                            cache, name="deepseek.decode")
    assert (len(prefill.graph.op_nodes()), len(decode.graph.op_nodes())) == SERVING_OP_NODES
