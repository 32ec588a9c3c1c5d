"""Training the vlm family in the port against the JAX package: pixtral's
loss, which runs the vision stub's ``frontend_proj`` over the leading
token slots and masks those patch positions out of the cross-entropy
(``repro/models/model.py:49-72``), and its gradients.

The model is pixtral-12b's smoke config (d_model 64, 4 heads of 16, 2
``dense`` layers, untied vocab 256, patches of 32 features) in
float32.  Parameters are numpy draws from a seed, fed to the port through
``params.from_jax_numpy``; batches come from each package's
``data.pipeline.make_batch`` (batch 2 x 32 tokens, 16 patches: the same
tokens and patches); the reference's loss and gradients are
``jax.value_and_grad(loss_fn, has_aux=True)``.

Tolerances: the loss and ``ce`` within a relative 1e-5, ``acc`` within
1e-6 (float32 sums in other orders); every gradient leaf within
``_close_normwise`` 1e-4 (|got - want| <= 1e-4 * max|want|: the backward's
products sum in other orders).  The mask checks, the overlay-traced step
against the eager one and the serving graphs are held exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

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
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_init, cosine

ARCH = "pixtral-12b"
B, S, NPATCH = 2, 32, 16
GRAD_TOL = 1e-4
# op nodes of the traced prefill as text, the prefill under 4 patches (batch
# 2, prompt 8, max_len 32) and the decode of the smoke config, as the
# serving-only port traced them before the loss took the patches
SERVING_OP_NODES = (289, 294, 284)


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
        assert np.array_equal(tbatch["patch_embeds"].float().numpy(),
                              np.asarray(jbatch["patch_embeds"], np.float32))
        loss, metrics, grads, spec = train_cli._loss_and_grads(tcfg, tp, tbatch)
        want = tparams.from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                      dtype=torch.float32)
        _RUN.update(
            jcfg=jcfg, tcfg=tcfg, jp=jp, jbatch=jbatch, tp=tp, tbatch=tbatch,
            want=(float(jloss), {k: float(v) for k, v in jm.items()}, want),
            got=(loss, metrics, grads, spec))
    return _RUN


def _replaced(batch, key, value):
    """A copy of ``batch`` whose ``key`` has ``value`` under the patches."""
    out = dict(batch)
    out[key] = batch[key].clone()
    out[key][:, :NPATCH] = value
    return out


# ---------------------------------------------------------------------------
# the loss and its gradients against the reference
# ---------------------------------------------------------------------------
def test_loss_ce_and_acc_match_jax():
    """The loss over the 16 text positions of each row as the reference's;
    a dense config's aux is 0, so the loss is ``ce`` bit for bit."""
    run = _run()
    (jloss, jm, _), (loss, metrics, _, _) = run["want"], run["got"]
    assert tuple(run["tbatch"]["patch_embeds"].shape) == (B, NPATCH, run["tcfg"].frontend_dim)
    assert sorted(metrics) == ["acc", "aux", "ce"] == sorted(jm)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), jm["ce"], rtol=1e-5)
    np.testing.assert_allclose(metrics["acc"].item(), jm["acc"], rtol=1e-6)
    assert metrics["aux"].item() == 0.0 == jm["aux"]
    assert torch.equal(loss, metrics["ce"]) and np.isfinite(loss.item())


def test_every_gradient_leaf_matches_jax():
    """Each gradient leaf of the port's tree within 1e-4 normwise of
    ``jax.value_and_grad``'s; the vision stub's ``frontend_proj`` gets a
    gradient, and so do the untied head and every layer."""
    run = _run()
    got = _flat(pytree.tree_unflatten(run["got"][2], run["got"][3]))
    want = _flat(run["want"][2])
    assert got.keys() == want.keys()
    assert "frontend_proj" in got
    for name in ("frontend_proj", "lm_head", "embed", "layers/0/attn/wq", "layers/1/ffn/w_down"):
        assert float(want[name].abs().max()) > 0 and float(got[name].abs().max()) > 0, name
    for name, g in got.items():
        _close_normwise(g.numpy(), want[name].numpy(), GRAD_TOL, name)


# ---------------------------------------------------------------------------
# the patch positions
# ---------------------------------------------------------------------------
def test_labels_under_the_patches_change_no_bit():
    """Other labels under the 16 patches: the loss, ``acc`` and every
    gradient leaf are bit-identical (the mask keeps those positions out of
    the sums), on both packages."""
    run = _run()
    tcfg, tbatch = run["tcfg"], run["tbatch"]
    other = _replaced(tbatch, "labels", 0)
    assert not torch.equal(other["labels"], tbatch["labels"])
    loss, metrics, grads, _ = train_cli._loss_and_grads(tcfg, run["tp"], other)
    base_loss, base_metrics, base_grads, _ = run["got"]
    assert torch.equal(loss, base_loss) and torch.equal(metrics["acc"], base_metrics["acc"])
    assert all(torch.equal(a, b) for a, b in zip(grads, base_grads))
    jbatch = dict(run["jbatch"], labels=jnp.asarray(other["labels"].numpy()))
    jloss, _ = jmodel.loss_fn(run["jp"], jbatch, run["jcfg"])
    assert float(jloss) == run["want"][0]


def test_loss_is_the_cross_entropy_over_the_text_positions():
    """The loss equals the mean next-token cross-entropy over positions >=
    npatch, computed here from the logits by ``log_softmax``; ``acc``
    counts the same positions."""
    run = _run()
    tcfg, tp, tbatch = run["tcfg"], run["tp"], run["tbatch"]
    with torch.no_grad():
        h, _ = tfm.forward(tp, tcfg, tbatch["tokens"], patch_embeds=tbatch["patch_embeds"])
        logits = tfm.unembed(tp, h, tcfg).float()
    text = slice(NPATCH, S)
    logp = torch.log_softmax(logits[:, text], -1)
    labels = tbatch["labels"][:, text].long()
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    np.testing.assert_allclose(run["got"][0].item(), nll.mean().item(), rtol=1e-6)
    acc = (logits[:, text].argmax(-1) == labels).float().mean()
    np.testing.assert_allclose(run["got"][1]["acc"].item(), acc.item(), rtol=1e-6)


def test_embed_rows_under_the_patches_get_no_gradient():
    """The patches own their slots: token ids under them change no bit of
    the loss or of any gradient, and an id that appears only there leaves
    its ``embed`` row's gradient exactly 0."""
    run = _run()
    tcfg, tbatch = run["tcfg"], run["tbatch"]
    unused = int(np.setdiff1d(np.arange(tcfg.vocab_size),
                              tbatch["tokens"][:, NPATCH:].numpy()).max())
    other = _replaced(tbatch, "tokens", unused)
    loss, _, grads, spec = train_cli._loss_and_grads(tcfg, run["tp"], other)
    assert torch.equal(loss, run["got"][0])
    assert all(torch.equal(a, b) for a, b in zip(grads, run["got"][2]))
    embed = pytree.tree_unflatten(grads, spec)["embed"]
    assert torch.count_nonzero(embed[unused]) == 0
    assert torch.count_nonzero(embed) > 0


def test_a_callers_mask_wins_over_the_patches():
    """A batch with a ``mask`` of its own is held to the reference given
    the same mask, which then ignores the patch positions: the loss,
    ``ce``, ``acc`` and the stub's gradient; the mask reaches positions
    under the patches, so the loss differs from the patch-masked one."""
    run = _run()
    mask = (np.random.default_rng(5).random((B, S)) > 0.3).astype(np.float32)
    assert mask[:, :NPATCH].sum() > 0
    jbatch = dict(run["jbatch"], mask=jnp.asarray(mask))
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        run["jp"], jbatch, run["jcfg"])
    tbatch = dict(run["tbatch"], mask=torch.from_numpy(mask))
    loss, metrics, grads, spec = train_cli._loss_and_grads(run["tcfg"], run["tp"], tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["acc"].item(), float(jm["acc"]), rtol=1e-6)
    _close_normwise(pytree.tree_unflatten(grads, spec)["frontend_proj"].numpy(),
                    np.asarray(jgrads["frontend_proj"]), GRAD_TOL, "frontend_proj")
    assert abs(loss.item() - run["got"][0].item()) > 1e-3


# ---------------------------------------------------------------------------
# the traced step, the launcher, serving
# ---------------------------------------------------------------------------
def test_overlay_train_step_equals_eager_step():
    """Two pixtral steps (bf16, d_model 128 so the rmsnorm and attention
    ops are kernel nodes; 32 patches under 64 tokens) through
    ``Overlay.jit``, functional and traced with the backward and the
    optimizer, the state donated, and eagerly in place from the same
    state: losses, grad norms and every state leaf bit-identical; each
    returned leaf is the tensor donated to it; the graph holds the stub's
    patches as an input."""
    tcfg = smoke_config(ARCH).scaled(dtype="bfloat16", d_model=128, head_dim=32)
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
        batch = tpipe.make_batch(tcfg, 2, 64, step=step, device="cpu")
        assert tuple(batch["patch_embeds"].shape) == (2, 32, tcfg.frontend_dim)
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
    assert names.count("kernels/attention") == 2 * tcfg.num_layers
    assert names.count("kernels/rmsnorm") == 4 * tcfg.num_layers + 1
    shapes = [tuple(a.shape) for a in lowered.graph.input_avals()]
    assert (2, 32, tcfg.frontend_dim) in shapes


def test_train_launcher_restarts_pixtral_after_failure(tmp_path, capsys):
    rc = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
                         "--seq", "32", "--ckpt-every", "2", "--fail-at", "3",
                         "--log-every", "1", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "restarts=1" in out and "4 steps" in out and "2 layers" in out
    losses = [float(line.split("loss")[1].split()[0]) for line in out.splitlines()
              if line.strip().startswith("step")]
    assert len(losses) >= 4 and all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path))[-1] == "step_0000000004"


def test_serving_graphs_keep_their_op_node_counts():
    """Serving reads no mask: pixtral's traced prefill as text, the
    prefill under 4 patches and the decode hold the op nodes they held
    before the loss took the patches."""
    tcfg = smoke_config(ARCH)
    tp = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    cache = tmodel.init_cache(tcfg, 2, 32, "cpu")
    toks = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]], dtype=torch.int32)
    patches = torch.randn(2, 4, tcfg.frontend_dim, generator=torch.Generator().manual_seed(1))
    text = trace_to_graph(lambda p, t, c: tmodel.prefill(p, tcfg, t, c), tp, toks, cache,
                          name="pixtral.prefill")
    with_patches = trace_to_graph(
        lambda p, t, c, e: tmodel.prefill(p, tcfg, t, c, patch_embeds=e), tp, toks, cache,
        patches.bfloat16(), name="pixtral.prefill_patches")
    decode = trace_to_graph(lambda p, t, c: tmodel.decode_step(p, tcfg, t, c), tp, toks[:, :1],
                            cache, name="pixtral.decode")
    assert tuple(len(g.graph.op_nodes()) for g in (text, with_patches, decode)) == \
        SERVING_OP_NODES
