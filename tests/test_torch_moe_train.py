"""Training the mixture-of-experts family in the port against the JAX
package: the loss ``ce + 0.01 * aux`` (``aux`` the routers' load-balance
loss summed over the layers) and its gradients through the sort-based
dispatch of ``models/moe.py``.

The model is granite-moe-1b-a400m's smoke config (d_model 64, 4 heads of
16, 2 ``moe`` layers, vocab 256) in float32, as it is (4 experts, top-2,
capacity factor 4.0: no slot dropped) and with the full config's routing
(32 experts, top-8, capacity factor 1.25: at batch 2 x 16 the capacity is
11 slots an expert, and slots drop).  Parameters are numpy draws from a
seed, fed to the port through ``params.from_jax_numpy``; batches come from
each package's ``data.pipeline.make_batch`` (the same tokens); the
reference's loss and gradients are ``jax.value_and_grad(loss_fn,
has_aux=True)``.  The module (``moe_fwd``) is also held alone, at 24 flat
tokens of width 64, under the capacity factors where slots drop.

Tolerances: the loss and ``ce`` within a relative 1e-5, ``aux`` and
``acc`` within 1e-6 (float32 sums in other orders); every gradient leaf
within ``_close_normwise`` 1e-4 (|got - want| <= 1e-4 * max|want|: the
backward's products sum in other orders).  Repeated steps and the
overlay-traced step are held to the eager step bit for bit (granite's
remat policies: ``tests/test_torch_train.py``).
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
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro_torch.configs import smoke_config
from repro_torch.core import Overlay
from repro_torch.core.trace import trace_to_graph
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_init, cosine

ARCH = "granite-moe-1b-a400m"
FULL_ROUTING = dict(num_experts=32, experts_per_token=8, capacity_factor=1.25)
ROUTINGS = ["smoke", "full"]
B, S = 2, 16
GRAD_TOL = 1e-4
# op nodes of the traced prefill and decode (batch 2, prompt 5, max_len
# 32) of the smoke config by routing, as the serving-only port traced them
# before the loss carried the routers' aux
SERVING_OP_NODES = {"smoke": (408, 403), "full": (432, 427)}


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


def _configs(routing: str, dtype="float32"):
    over = dict(dtype=dtype, **(FULL_ROUTING if routing == "full" else {}))
    return jax_smoke_config(ARCH).scaled(**over), smoke_config(ARCH).scaled(**over)


def _leaf(rng, spec):
    if spec.init == "ones":
        return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    return (scale * rng.standard_normal(spec.shape)).astype(np.float32)


_RUNS = {}


def _run(routing):
    """Both packages' loss and gradients on one numpy draw of the weights
    and one batch: the configs, the weights and batches of each, the
    reference's (loss, metrics, gradients as the port's tree) and the
    port's."""
    if routing not in _RUNS:
        jcfg, tcfg = _configs(routing)
        rng = np.random.default_rng(0)
        tree = jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(jcfg),
                            is_leaf=jparams.is_spec)
        jp = jax.tree.map(jnp.asarray, tree)
        jbatch = jpipe.make_batch(jcfg, B, S, step=0, seed=0)
        (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(jp, jbatch, jcfg)
        tp = tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32)
        tbatch = tpipe.make_batch(tcfg, B, S, step=0, seed=0, device="cpu")
        assert np.array_equal(tbatch["tokens"].numpy(), np.asarray(jbatch["tokens"]))
        loss, metrics, grads, spec = train_cli._loss_and_grads(tcfg, tp, tbatch)
        want = tparams.from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                      dtype=torch.float32)
        _RUNS[routing] = dict(
            jcfg=jcfg, tcfg=tcfg, jp=jp, jbatch=jbatch, tp=tp, tbatch=tbatch,
            want=(float(jloss), {k: float(v) for k, v in jm.items()}, want),
            got=(loss, metrics, pytree.tree_unflatten(grads, spec)))
    return _RUNS[routing]


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


# ---------------------------------------------------------------------------
# the loss and its gradients against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("routing", ROUTINGS)
def test_loss_aux_ce_and_acc_match_jax(routing):
    """``loss = ce + 0.01 * aux`` as the reference's, ``aux`` one
    Switch-style term a layer (about 1 each at a near-uniform router)."""
    run = _run(routing)
    (jloss, jm, _), (loss, metrics, _) = run["want"], run["got"]
    assert sorted(metrics) == ["acc", "aux", "ce"] == sorted(jm)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    np.testing.assert_allclose(metrics["aux"].item(), jm["aux"], rtol=1e-6)
    np.testing.assert_allclose(metrics["ce"].item(), jm["ce"], rtol=1e-5)
    np.testing.assert_allclose(metrics["acc"].item(), jm["acc"], rtol=1e-6)
    assert metrics["aux"].dtype == torch.float32 and metrics["aux"].shape == ()
    layers = run["tcfg"].num_layers
    assert 0.5 * layers < metrics["aux"].item() < 2 * layers
    assert torch.equal(loss, metrics["ce"] + 0.01 * metrics["aux"])


@pytest.mark.parametrize("routing", ROUTINGS)
def test_every_gradient_leaf_matches_jax(routing):
    """Each gradient leaf of the port's tree, the routers and the stacked
    experts included, within 1e-4 normwise of ``jax.value_and_grad``'s."""
    run = _run(routing)
    got, want = _flat(run["got"][2]), _flat(run["want"][2])
    assert got.keys() == want.keys()
    for name in ("layers/0/ffn/router", "layers/1/ffn/w_gate", "layers/1/ffn/w_up",
                 "layers/0/ffn/w_down", "embed"):
        assert float(want[name].abs().max()) > 0, name
    for name, g in got.items():
        _close_normwise(g.numpy(), want[name].numpy(), GRAD_TOL, name)


def test_full_routing_drops_slots_in_every_layer(monkeypatch):
    """At batch 2 x 16 the full config's routing keeps 11 slots an expert:
    each layer's router sends more than that to some expert, so the
    gradients above pass through dropped slots."""
    run = _run("full")
    tcfg = run["tcfg"]
    routed = []
    topk = tmoe.router_topk

    def recording(logits, cfg):
        out = topk(logits, cfg)
        routed.append(np.bincount(out[1].reshape(-1).numpy(), minlength=cfg.num_experts))
        return out

    monkeypatch.setattr(tmoe, "router_topk", recording)
    with torch.no_grad():
        tmodel.loss_fn(run["tp"], run["tbatch"], tcfg)
    cap = int(B * S * tcfg.experts_per_token / tcfg.num_experts * tcfg.capacity_factor) + 1
    assert cap == 11 and len(routed) == tcfg.num_layers
    assert all(counts.max() > cap for counts in routed), routed


@pytest.mark.parametrize("aux_weight", [0.0, 0.5])
def test_aux_weight_scales_the_aux_term_as_in_the_reference(aux_weight):
    run = _run("full")
    jloss, _ = jmodel.loss_fn(run["jp"], run["jbatch"], run["jcfg"], aux_weight=aux_weight)
    with torch.no_grad():
        loss, m = tmodel.loss_fn(run["tp"], run["tbatch"], run["tcfg"], aux_weight=aux_weight)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert torch.equal(loss, m["ce"] + aux_weight * m["aux"])


MODULE_CASES = [(32, 8, 0.5), (32, 8, 1.25), (4, 2, 1.0), (4, 2, 4.0)]


@pytest.mark.parametrize("e,k,cf", MODULE_CASES,
                         ids=[f"e{e}k{k}-cf{cf}" for e, k, cf in MODULE_CASES])
def test_moe_fwd_gradients_match_jax(e, k, cf):
    """The backward of ``moe_fwd`` alone against ``jax.grad`` of the
    reference's ``_moe_fwd_local``: the gradient of ``sum(y * r) + 0.3 *
    aux`` with respect to the tokens, the router and the three expert
    stacks.  The gates get theirs through the stable sort's values, the
    tokens theirs from each of their k slots (``x[tok]``'s backward), the
    expert buffers through the dispatch's ``index_put`` and the combine's
    gather, and ``aux`` only through ``router_prob`` (``density`` counts
    integers)."""
    d, f, t = 64, 32, 24
    over = dict(d_model=d, num_experts=e, experts_per_token=k, moe_d_ff=f,
                capacity_factor=cf, num_shared_experts=0, dtype="float32")
    jcfg = jax_smoke_config(ARCH).scaled(**over)
    tcfg = smoke_config(ARCH).scaled(**over)
    rng = np.random.default_rng(e * 10 + k)
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    p = {n: a.astype(np.float32) for n, a in p.items()}
    x = rng.standard_normal((t, d)).astype(np.float32)
    r = rng.standard_normal((t, d)).astype(np.float32)

    def jfn(jp, jx):
        y, aux = jmoe._moe_fwd_local(jp, jx, jcfg)
        return jnp.sum(y * r) + 0.3 * aux

    jgp, jgx = jax.grad(jfn, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {n: torch.from_numpy(a).requires_grad_() for n, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_fwd(tp, tx, tcfg)
    (torch.sum(y * torch.from_numpy(r)) + 0.3 * aux).backward()
    _close_normwise(tx.grad.numpy(), jgx, GRAD_TOL, "x")
    for n in p:
        _close_normwise(tp[n].grad.numpy(), jgp[n], GRAD_TOL, n)
    cap = int(t * k / e * cf) + 1
    idx = tmoe.router_topk(torch.from_numpy(x @ p["router"]), tcfg)[1].numpy()
    dropped = np.maximum(np.bincount(idx.reshape(-1), minlength=e) - cap, 0).sum()
    assert (dropped > 0) == (cf < 4.0)


def test_aux_gradient_reaches_the_router_through_router_prob_only():
    """``aux = E * sum(density * router_prob) / k``: its gradient with
    respect to the router logits is that of ``router_prob`` with
    ``density`` held constant (the reference's one-hot mean has no
    gradient), and it equals the reference's."""
    e, k, t = 32, 8, 24
    jcfg = jax_smoke_config(ARCH).scaled(num_experts=e, experts_per_token=k)
    tcfg = smoke_config(ARCH).scaled(num_experts=e, experts_per_token=k)
    logits = np.random.default_rng(9).standard_normal((t, e)).astype(np.float32)
    jg = jax.grad(lambda z: jmoe.router_topk(z, jcfg)[2])(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    _, idx, aux = tmoe.router_topk(z, tcfg)
    aux.backward()
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-8)
    density = torch.from_numpy(np.bincount(idx.reshape(-1).numpy(), minlength=e)
                               .astype(np.float32)) / t
    z2 = torch.from_numpy(logits).requires_grad_()
    (e * torch.sum(density * torch.softmax(z2, -1).mean(0)) / k).backward()
    assert torch.equal(z.grad, z2.grad)


# ---------------------------------------------------------------------------
# repeatable, policy-independent, traced
# ---------------------------------------------------------------------------
def _bf16_small(routing):
    over = dict(dtype="bfloat16", d_model=128, head_dim=32,
                **(FULL_ROUTING if routing == "full" else {}))
    return smoke_config(ARCH).scaled(**over)


@pytest.mark.parametrize("routing", ROUTINGS)
def test_a_repeated_step_gives_the_same_bits(routing):
    """The loss, aux and every gradient of two calls on the same weights
    and batch are bit-identical: nothing on the path sums in an order that
    varies (the dispatch's kept slots are unique, the combine adds in slot
    order, the sorts are stable)."""
    tcfg = _bf16_small(routing)
    params = tparams.init(tcfg, torch.Generator().manual_seed(3), "cpu")
    batch = tpipe.make_batch(tcfg, 2, 64, device="cpu")
    a, b = (train_cli._loss_and_grads(tcfg, params, batch) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1]["aux"], b[1]["aux"])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


def test_overlay_train_step_equals_eager_step():
    """Two granite steps (the full config's routing, d_model 128 so the
    rmsnorm and attention ops are kernel nodes) through ``Overlay.jit``,
    functional and traced with the backward and the optimizer, the state
    donated, and eagerly in place from the same state: losses, aux, grad
    norms and every state leaf bit-identical; each returned leaf is the
    tensor donated to it; the graph recomputes each layer under remat
    ``"full"``."""
    tcfg = _bf16_small("full")
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
        s_ov, m_ov = traced(s_ov, batch)
        s_eg, m_eg = eager(s_eg, batch)
        for key in ("loss", "aux", "ce", "grad_norm"):
            assert torch.equal(m_ov[key], m_eg[key]), key
        assert [t.data_ptr() for t in pytree.tree_leaves(s_ov)] == ptrs
    for a, b in zip(pytree.tree_leaves(s_ov), pytree.tree_leaves(s_eg)):
        assert torch.equal(a, b)
    assert ov.stats.traces == 1 and ov.stats.downloads == 1
    names = [n.name for n in traced.lower(s_ov, batch).graph.op_nodes()]
    assert names.count("kernels/attention") == 2 * tcfg.num_layers
    assert names.count("kernels/rmsnorm") == 4 * tcfg.num_layers + 1


def test_train_launcher_restarts_granite_after_failure(tmp_path, capsys):
    rc = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
                         "--seq", "32", "--ckpt-every", "2", "--fail-at", "3",
                         "--log-every", "1", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "restarts=1" in out and "4 steps" in out and "2 layers" in out
    losses = [float(line.split("loss")[1].split()[0]) for line in out.splitlines()
              if line.strip().startswith("step")]
    assert len(losses) >= 4 and all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path))[-1] == "step_0000000004"


# ---------------------------------------------------------------------------
# what stays as it was
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("routing", ROUTINGS)
def test_serving_graphs_keep_their_op_node_counts(routing):
    """Serving reads no aux: granite's traced prefill and decode hold the
    op nodes they held before the loss took it."""
    tcfg = smoke_config(ARCH).scaled(**(FULL_ROUTING if routing == "full" else {}))
    tp = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    cache = tmodel.init_cache(tcfg, 2, 32, "cpu")
    toks = torch.tensor([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], dtype=torch.int32)
    prefill = trace_to_graph(lambda p, t, c: tmodel.prefill(p, tcfg, t, c), tp, toks, cache,
                             name="granite.prefill")
    decode = trace_to_graph(lambda p, t, c: tmodel.decode_step(p, tcfg, t, c), tp, toks[:, :1],
                            cache, name="granite.decode")
    assert (len(prefill.graph.op_nodes()), len(decode.graph.op_nodes())) == \
        SERVING_OP_NODES[routing]


def test_a_dense_config_reports_aux_zero():
    """A config without experts: aux is 0 and the loss is the
    cross-entropy, bit for bit."""
    cfg = smoke_config("phi3-mini-3.8b")
    params = tparams.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = tpipe.make_batch(cfg, 1, 16, device="cpu")
    with torch.no_grad():
        loss, m = tmodel.loss_fn(params, batch, cfg)
        assert tfm.forward_with_aux(params, cfg, batch["tokens"])[1] is None
    assert m["aux"].item() == 0.0 and torch.equal(loss, m["ce"])

