"""The port's twin of ``tests/test_archs_smoke.py``: all ten architectures,
held against the JAX package.

For each arch: the registry, the full and the smoke config field by field,
the layer count, the analytic parameter counts; for every decoder arch
(pixtral with its patches) prefill(8) + decode(1) against prefill(9) in
the port; the encoder-decoder's prefill and decode; zamba2's shared set
held once and gemma2's local/global alternation; the training loss and one
AdamW step for each of the ten archs (seamless's on its frames), the loss
against the reference's on the same weights and batch.

Everything runs at the smoke config in float32 (``cfg.scaled(dtype=
"float32")`` on both packages), weights drawn from a seed with numpy and
fed to the port through ``params.from_jax_numpy``; batches from each
package's ``data.pipeline.make_batch`` (the same tokens).  Tolerances: the
prefill/decode logits within 2e-3 (``test_torch_archs``': the KV caches are
bf16, so a key written by the decode and the same key written by the
longer prefill can round to neighbouring bf16 values); the loss within a
relative 1e-4 of the reference's (float32 sums in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs.archs import smoke_config as jax_smoke_config
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.optim import adamw_init, adamw_update

ARCHS = list_archs()
B, S = 2, 32
LAYERS = {"zamba2-7b": 81, "mistral-large-123b": 88, "phi3-mini-3.8b": 32, "gemma2-27b": 46,
          "minicpm-2b": 40, "mamba2-130m": 24, "granite-moe-1b-a400m": 24,
          "deepseek-v3-671b": 61, "seamless-m4t-medium": 24, "pixtral-12b": 40}
TRAINED = ("phi3-mini-3.8b", "mamba2-130m", "gemma2-27b", "minicpm-2b",
           "mistral-large-123b", "zamba2-7b", "granite-moe-1b-a400m", "pixtral-12b",
           "deepseek-v3-671b", "seamless-m4t-medium")
DECODER_ARCHS = [a for a in ARCHS if not get_config(a).is_encdec]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _leaf(rng, spec):
    if spec.init == "ones":
        return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    if spec.init == "ssm_a":
        return np.log(1 + 15 * rng.random(spec.shape)).astype(np.float32)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    return (scale * rng.standard_normal(spec.shape)).astype(np.float32)


_MODELS = {}


def _models(arch):
    """(jax cfg, port cfg, jax params, port params): the smoke config in
    float32, one numpy draw of the reference's tree for both packages."""
    if arch not in _MODELS:
        jcfg = jax_smoke_config(arch).scaled(dtype="float32")
        tcfg = smoke_config(arch).scaled(dtype="float32")
        rng = np.random.default_rng(0)
        tree = jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(jcfg),
                            is_leaf=jparams.is_spec)
        _MODELS[arch] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                         tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32))
    return _MODELS[arch]


# ---------------------------------------------------------------------------
# the registry, the configs, the counts
# ---------------------------------------------------------------------------
def test_all_ten_archs_are_registered_as_in_the_reference():
    assert ARCHS == jax_list_archs() == sorted([
        "zamba2-7b", "mistral-large-123b", "phi3-mini-3.8b", "gemma2-27b",
        "minicpm-2b", "mamba2-130m", "granite-moe-1b-a400m",
        "deepseek-v3-671b", "seamless-m4t-medium", "pixtral-12b"])


@pytest.mark.parametrize("arch", ARCHS)
def test_full_and_smoke_configs_are_the_references(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(jax_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_layer_count(arch):
    cfg = get_config(arch)
    assert cfg.num_layers == jax_get_config(arch).num_layers == LAYERS[arch]
    assert len(tparams.layer_kinds(cfg)) + len(tparams.encoder_kinds(cfg)) == LAYERS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_are_the_references(arch):
    """``param_count()`` and ``active_param_count()`` equal the reference's
    exactly; deepseek's active count is about 37 B of its 671 B."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    if arch == "deepseek-v3-671b":
        assert 30e9 < cfg.active_param_count() < 45e9 < cfg.param_count()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_prefill_decode_consistency(arch):
    """Logits of prefill(8) + decode(1) equal those of prefill(9), within
    2e-3; pixtral's prompts carry the same 4 patches."""
    _, cfg, _, params = _models(arch)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 9)).astype(np.int32))
    kw = {}
    if cfg.frontend == "vision":
        kw["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((1, 4, cfg.frontend_dim)).astype(np.float32))
    with torch.no_grad():
        _, c1 = tmodel.prefill(params, cfg, toks[:, :8], tmodel.init_cache(cfg, 1, 32, "cpu"),
                               **kw)
        logits_b, _ = tmodel.decode_step(params, cfg, toks[:, 8:9], c1)
        logits_full, _ = tmodel.prefill(params, cfg, toks,
                                        tmodel.init_cache(cfg, 1, 32, "cpu"), **kw)
    assert bool(torch.isfinite(logits_full).all())
    np.testing.assert_allclose(logits_b.numpy(), logits_full.numpy(), rtol=2e-3, atol=2e-3)


def test_encdec_prefill_and_decode_run():
    _, cfg, _, params = _models("seamless-m4t-medium")
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.standard_normal((1, 16, cfg.frontend_dim)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 4)).astype(np.int32))
    with torch.no_grad():
        logits, caches = tmodel.prefill(params, cfg, toks, tmodel.init_cache(cfg, 1, 32, "cpu"),
                                        enc_in=frames)
        assert logits.shape == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all())
        nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
        logits2, _ = tmodel.decode_step(params, cfg, nxt, caches)
    assert bool(torch.isfinite(logits2).all())


def test_zamba2_shared_attention_is_held_once():
    """zamba2's shared_attn weights appear once per group, not per
    occurrence: one 2-D ``wq`` in ``spec["shared"]["g1"]``, read by all 13
    occurrences of the full config, and the 68 mamba layers own the rest."""
    spec = tparams.model_spec(smoke_config("zamba2-7b"))
    assert list(spec["shared"]) == ["g1"]
    assert len(spec["shared"]["g1"]["attn"]["wq"].shape) == 2
    full = get_config("zamba2-7b")
    plan = tparams.layer_plan(full)
    assert [w for k, w in plan if k == "shared_attn"] == ["g1"] * 13
    assert len(tparams.model_spec(full)["layers"]) == 68


def test_gemma2_local_global_alternation():
    cfg = get_config("gemma2-27b")
    assert cfg.blocks == ((("local", "global"), 23),)
    assert cfg.sliding_window == 4096
    assert cfg.attn_softcap == 50.0 and cfg.final_softcap == 30.0
    assert tparams.layer_kinds(cfg) == ["local", "global"] * 23


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", TRAINED)
def test_loss_matches_jax_and_one_adamw_step_updates_finitely(arch):
    """The loss on the same weights and batch equals the reference's
    within 1e-4 and is finite; one AdamW step changes a parameter and
    leaves every one finite."""
    jcfg, tcfg, jp, tp = _models(arch)
    jbatch = jpipeline.make_batch(jcfg, B, S, step=0, seed=0)
    batch = tpipeline.make_batch(tcfg, B, S, step=0, seed=0, device="cpu")
    jloss, _ = jmodel.loss_fn(jp, jbatch, jcfg)
    loss, metrics, grads, spec = train_cli._loss_and_grads(tcfg, tp, batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert bool(torch.isfinite(metrics["acc"]))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    new, _, m = adamw_update(tp, pytree.tree_unflatten(grads, spec), adamw_init(tp), lr=1e-3)
    assert bool(torch.isfinite(m["grad_norm"]))
    changed = False
    for a, b in zip(pytree.tree_leaves(tp), pytree.tree_leaves(new)):
        assert bool(torch.isfinite(b).all())
        changed |= not torch.equal(a, b)
    assert changed
