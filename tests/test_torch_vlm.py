"""The vlm pixtral-12b in the port against the JAX package: the vision
stub's patch embeddings over the leading token slots (``forward(
patch_embeds=)``, ``prefill(patch_embeds=)``), the stub's batch, the
overlay's traced prefill, and the engines, the launcher and the step graph
serving pixtral as a text model, as the reference's do.

Everything runs at the smoke config (d_model 64, 4 heads of 16, 2 ``dense``
layers, patches of 32 features) in float32 unless a test says otherwise;
parameters and inputs are numpy draws from a seed, fed to the port through
``params.from_jax_numpy``.  A cache-free forward of 128 tokens makes the
reference's dispatcher send attention to its Pallas flash kernel in
interpret mode (``repro/models/layers.py:242-247``); at 24 tokens it takes
its plain path.

Tolerances: ``_close_normwise`` (|got - want| <= rtol * max|want|) at 1e-5
for the cache-free forward, where both sides are float32 but sum in other
orders; the cached model's logits within ``test_torch_archs``' rtol = atol
= 2e-3, the KV caches being bf16 in both packages; token streams,
traced-vs-eager outputs and the stub checks exactly.
"""

import ast
import dataclasses
import inspect
import json
import math
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.configs.archs import smoke_config as jax_smoke_config
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import Overlay
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.loop import EventLoopEngine

ARCH = "pixtral-12b"
MAX_LEN = 48
TOL = 1e-5
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close_normwise(got, want, rtol, what=""):
    """|got - want| <= rtol * max|want|, elementwise: the error of an f32
    sum in another order scales with the size of the terms."""
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


def _configs(dtype="float32"):
    return (jax_smoke_config(ARCH).scaled(dtype=dtype),
            smoke_config(ARCH).scaled(dtype=dtype))


_MODELS = {}


def _models():
    if not _MODELS:
        jcfg, tcfg = _configs()
        rng = np.random.default_rng(0)
        tree = jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(jcfg),
                            is_leaf=jparams.is_spec)
        _MODELS["m"] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                        tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32))
    return _MODELS["m"]


def _patches(cfg, npatch, seed=3, b=2):
    return np.random.default_rng(seed).standard_normal((b, npatch, cfg.frontend_dim)).astype(
        np.float32)


def _tokens(cfg, s, seed=4, b=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# the config, the parameters and the batch
# ---------------------------------------------------------------------------
def test_config_and_param_count_are_the_references():
    """pixtral-12b field by field, 40 ``dense`` kinds, 12,247,782,400
    parameters by ``param_count()``; the spec trees' sizes agree (both add
    the stub's ``frontend_proj``, 1024 x 5120, which ``param_count()``
    leaves out), 24.5 GB in bf16; the KV cache takes 163,840 B a token."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert tparams.layer_kinds(cfg) == ["dense"] * 40
    assert cfg.param_count() == jcfg.param_count() == 12_247_782_400
    spec = tparams.model_spec(cfg)
    leaves = pytree.tree_leaves(spec)
    n = sum(math.prod(s.shape) for s in leaves)
    assert n == jparams.count(jtfm.model_spec(jcfg)) == cfg.param_count() + 1024 * 5120
    assert round(sum(math.prod(s.shape) * s.dtype.itemsize for s in leaves) / 1e9, 1) == 24.5
    assert spec["frontend_proj"].shape == (1024, 5120)
    assert spec["frontend_proj"].dtype == torch.bfloat16
    assert list(spec) == ["embed", "frontend_proj", "layers", "final_norm", "lm_head"]
    caches = tmodel.init_cache(smoke_config(ARCH), 1, 8, "cpu")
    assert len(caches) == 2 and sorted(caches[0]) == ["index", "k", "v"]
    assert 40 * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2 == 163_840


def test_from_jax_numpy_carries_every_leaf():
    """The reference's bf16 tree: each ``dense`` layer unstacked from
    ``g0``, ``frontend_proj`` carried exactly, nothing aliased, as many
    parameters as the reference's tree."""
    jcfg, tcfg = _configs("bfloat16")
    jtree = jparams.init(jtfm.model_spec(jcfg), jax.random.PRNGKey(0))
    as_f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), jtree)
    tp = tparams.from_jax_numpy(as_f32, tcfg, "cpu")
    stack = as_f32["g0"]["layers"]["0:dense"]
    assert len(tp["layers"]) == 2
    for r, layer in enumerate(tp["layers"]):
        want, got = _flat(stack), _flat(layer)
        assert got.keys() == want.keys()
        for key, t in got.items():
            np.testing.assert_array_equal(t.float().numpy(), want[key][r], err_msg=f"{r} {key}")
    for key in ("frontend_proj", "embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(tp[key].float().numpy(), as_f32[key], err_msg=key)
    assert tp["frontend_proj"].dtype == torch.bfloat16
    leaves = pytree.tree_leaves(tp)
    assert len({t.data_ptr() for t in leaves}) == len(leaves)
    assert tparams.count(tp) == sum(a.size for a in jax.tree.leaves(as_f32))


@pytest.mark.parametrize("seq", [9, 40, 600])
def test_make_batch_patches_are_the_references(seq):
    """The vision stub's ``patch_embeds``: min(256, seq // 2) patches, the
    reference's numpy draws after the tokens rounded to bf16, bit for bit,
    beside the same tokens; ``batch_specs`` gives their shapes and
    dtypes."""
    jcfg, tcfg = _configs()
    for step in (0, 3):
        want = jpipeline.make_batch(jcfg, 2, seq, step=step, seed=5)
        got = tpipeline.make_batch(tcfg, 2, seq, step=step, seed=5, device="cpu")
        assert sorted(got) == sorted(want) == ["labels", "patch_embeds", "tokens"]
        assert got["patch_embeds"].dtype == torch.bfloat16
        assert tuple(got["patch_embeds"].shape) == (2, min(256, seq // 2), 32)
        np.testing.assert_array_equal(got["patch_embeds"].float().numpy(),
                                      np.asarray(want["patch_embeds"], np.float32))
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    specs = tpipeline.batch_specs(tcfg, 2, seq, device="cpu")
    jspecs = jpipeline.batch_specs(jcfg, 2, seq)
    assert {k: tuple(s.shape) for k, s in specs.items()} == \
        {k: tuple(s.shape) for k, s in jspecs.items()}
    assert specs["patch_embeds"].dtype == torch.bfloat16
    assert specs["tokens"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq,npatch", [(24, 8), (128, 64)])
def test_cache_free_forward_logits_match_jax(seq, npatch):
    """``forward(patch_embeds=)`` + ``unembed`` within 1e-5 normwise of the
    reference's, at 24 tokens under 8 patches and 128 under 64 (the
    reference's Pallas flash, interpret mode)."""
    jcfg, tcfg, jp, tp = _models()
    toks, pe = _tokens(jcfg, seq), _patches(jcfg, npatch)
    jh, _, _ = jtfm.forward(jp, jcfg, jnp.asarray(toks), patch_embeds=jnp.asarray(pe))
    with torch.no_grad():
        th, caches = tfm.forward(tp, tcfg, torch.from_numpy(toks),
                                 patch_embeds=torch.from_numpy(pe))
        got = tfm.unembed(tp, th, tcfg)
    assert caches is None and got.shape == (2, seq, jcfg.vocab_size)
    _close_normwise(got.numpy(), jtfm.unembed(jp, jh, jcfg), TOL)


def test_prefill_and_decode_logits_match_jax():
    """``prefill(patch_embeds=)`` of a 20-token prompt under 8 patches at
    batch 2, three uniform decodes (positions 20-22: the decode goes on at
    S, patches included) and a ragged decode (rows at 22 and 13), logits
    against ``repro.models.model`` within 2e-3."""
    jcfg, tcfg, jp, tp = _models()
    toks, pe = _tokens(jcfg, 20), _patches(jcfg, 8)
    jl, jc = jmodel.prefill(jp, jcfg, jnp.asarray(toks), jmodel.init_cache(jcfg, 2, MAX_LEN),
                            patch_embeds=jnp.asarray(pe))
    with torch.no_grad():
        tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks),
                                tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu"),
                                patch_embeds=torch.from_numpy(pe))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **LOGIT_TOL)
    assert int(tmodel._current_index(tcfg, tc)) == 20
    rng = np.random.default_rng(8)
    for i in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
        jd, jc = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        with torch.no_grad():
            td, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), err_msg=f"decode {i}",
                                   **LOGIT_TOL)
    assert int(tmodel._current_index(tcfg, tc)) == 23
    pos = np.array([22, 13], np.int32)
    jr, _ = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc, positions=jnp.asarray(pos))
    with torch.no_grad():
        tr, _ = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                   positions=torch.from_numpy(pos))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), err_msg="ragged decode", **LOGIT_TOL)


@pytest.mark.parametrize("path", ["cached", "cache_free"])
def test_the_patches_act_and_the_tokens_under_them_do_not(path):
    """The stub acts: the same prompt without patches gives other logits;
    and the patches own their slots: other token ids under the 8 patches
    give bit-identical logits."""
    _, tcfg, _, tp = _models()
    toks, pe = torch.from_numpy(_tokens(tcfg, 20)), torch.from_numpy(_patches(tcfg, 8))
    other = toks.clone()
    other[:, :8] = (toks[:, :8] + 1 + torch.arange(8)) % tcfg.vocab_size
    assert not torch.equal(other, toks)

    def run(t, p):
        with torch.no_grad():
            if path == "cached":
                return tmodel.prefill(tp, tcfg, t, tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu"),
                                      patch_embeds=p)[0]
            return tfm.unembed(tp, tfm.forward(tp, tcfg, t, patch_embeds=p)[0], tcfg)

    with_patches = run(toks, pe)
    assert (with_patches - run(toks, None)).abs().max().item() > 1e-2
    assert torch.equal(run(other, pe), with_patches)


def test_a_prompt_shorter_than_its_patches_raises():
    """8 tokens under 16 patches: ``ValueError`` that says so (the
    reference's concatenate gives 16 rows against 8 positions and fails
    later, in RoPE, on the shapes)."""
    _, tcfg, _, tp = _models()
    toks, pe = torch.from_numpy(_tokens(tcfg, 8)), torch.from_numpy(_patches(tcfg, 16))
    with pytest.raises(ValueError, match="16 patches do not fit a prompt of 8 tokens"):
        tfm.forward(tp, tcfg, toks, patch_embeds=pe)
    with pytest.raises(ValueError, match="do not fit"):
        tmodel.prefill(tp, tcfg, toks, tmodel.init_cache(tcfg, 2, 16, "cpu"), patch_embeds=pe)
    # as many patches as tokens is a prompt of patches only
    with torch.no_grad():
        tfm.forward(tp, tcfg, toks, patch_embeds=pe[:, :8])


# ---------------------------------------------------------------------------
# the overlay
# ---------------------------------------------------------------------------
def _greedy(prefill, decode, params, toks, patches, cfg, new=4):
    caches = tmodel.init_cache(cfg, toks.shape[0], 32, "cpu")
    logits, caches = prefill(params, toks, caches, patches)
    out, steps = [logits], [torch.argmax(logits, -1)]
    for _ in range(new):
        tok = steps[-1][:, None].to(torch.int32)
        logits, caches = decode(params, tok, caches)
        out.append(logits)
        steps.append(torch.argmax(logits, -1))
    return torch.stack(steps, 1), out


def test_greedy_loop_through_the_overlay_equals_plain():
    """A greedy loop — prefill of 12 tokens under 6 patches, then 4 decodes
    — through ``Overlay(3, 3).jit`` of the two steps equals the plain loop
    token for token and logit for logit (bf16 weights); the traced prefill
    takes the patches as an input of their own."""
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, tcfg.vocab_size, (2, 12), generator=gen).to(torch.int32)
    patches = torch.randn(2, 6, tcfg.frontend_dim, generator=gen).bfloat16()
    pf = lambda p, t, c, pe: tmodel.prefill(p, tcfg, t, c, patch_embeds=pe)
    dec = lambda p, t, c: tmodel.decode_step(p, tcfg, t, c)
    with torch.no_grad():
        want_toks, want = _greedy(pf, dec, params, toks, patches, tcfg)
    ov = Overlay(3, 3)
    budget = max(1, ov.grid.num_tiles // 4)
    jpf = ov.jit(pf, name=f"{ARCH}.prefill", tile_budget=budget)
    jdec = ov.jit(dec, name=f"{ARCH}.decode", tile_budget=budget)
    got_toks, got = _greedy(jpf, jdec, params, toks, patches, tcfg)
    assert torch.equal(got_toks, want_toks)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    (entry,) = jpf._entries.values()
    shapes = [tuple(a.shape) for a in entry.lowered.graph.input_avals()]
    assert (2, 6, tcfg.frontend_dim) in shapes


def test_traced_patch_prefill_equals_eager_bit_for_bit():
    """``prefill(patch_embeds=)`` traced by ``Overlay.jit`` gives the same
    bits as the eager call in every output leaf (logits and each layer's
    caches), bf16 weights: 16 tokens under 8 patches, then 20 under 10 (a
    second signature)."""
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(2), "cpu")
    gen = torch.Generator().manual_seed(3)
    ov = Overlay(3, 3)
    fn = lambda p, t, c, pe: tmodel.prefill(p, tcfg, t, c, patch_embeds=pe)
    jf = ov.jit(fn, name=f"{ARCH}.prefill")
    for s in (16, 20):
        toks = torch.randint(0, tcfg.vocab_size, (2, s), generator=gen).to(torch.int32)
        patches = torch.randn(2, s // 2, tcfg.frontend_dim, generator=gen).bfloat16()
        caches = tmodel.init_cache(tcfg, 2, 32, "cpu")
        got = jf(params, toks, caches, patches)
        with torch.no_grad():
            want = fn(params, toks, caches, patches)
        gl, wl = pytree.tree_leaves(got), pytree.tree_leaves(want)
        assert len(gl) == len(wl) == 1 + 2 * 3
        for g, w in zip(gl, wl):
            assert g.dtype == w.dtype and torch.equal(g, w), s
    assert len(jf._entries) == 2


# ---------------------------------------------------------------------------
# serving as a text model, as the reference does
# ---------------------------------------------------------------------------
def _prompts(vocab, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).tolist() for n in (5, 12, 9)]


def _streams(engine, request_cls, prompts, max_new=4):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_new_tokens=max_new))
    done = engine.run_until_drained()
    return [r.out for r in sorted(done, key=lambda r: r.rid)]


def test_engines_serve_pixtral_as_text_equal_to_jax():
    """Greedy streams, token for token: the JAX ``ServeEngine`` (which
    passes no patches), the port's ``ServeEngine`` plainly and through
    ``Overlay(3, 3)``, and the port's ``EventLoopEngine`` (chunks of 4)."""
    jcfg, tcfg, jp, tp = _models()
    prompts = _prompts(jcfg.vocab_size)
    want = _streams(JServeEngine(jp, jcfg, batch=2, max_len=32), JRequest, prompts)
    plain = _streams(ServeEngine(tp, tcfg, batch=2, max_len=32, device="cpu"), Request, prompts)
    through = _streams(ServeEngine(tp, tcfg, batch=2, max_len=32, overlay=Overlay(3, 3),
                                   device="cpu"), Request, prompts)
    loop = _streams(EventLoopEngine(tp, tcfg, batch=2, max_len=32, chunk=4, device="cpu"),
                    Request, prompts)
    assert plain == want and through == want and loop == want
    assert all(len(s) == 5 for s in want)


def test_serve_launcher_serves_pixtral_as_text(capsys):
    """``--arch pixtral-12b --smoke``, plainly and with ``--overlay``: equal
    streams, and equal to the port's ``ServeEngine`` on the launcher's
    weights (``params.init`` from the seed) and prompts."""
    args = ["--arch", ARCH, "--smoke", "--requests", "3", "--batch", "2", "--max-new", "3",
            "--prompt-lens", "5,12", "--device", "cpu", "--seed", "0"]
    out = {}
    for name, extra in (("plain", []), ("overlay", ["--overlay"])):
        assert serve_cli.main(args + extra) == 0
        out[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["plain"]["arch"] == ARCH
    assert out["plain"]["streams"] == out["overlay"]["streams"]
    tcfg = smoke_config(ARCH)
    params = tparams.init(tcfg, torch.Generator("cpu").manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, size=(n,)).tolist() for n in (5, 12, 5)]
    want = _streams(ServeEngine(params, tcfg, batch=2, max_len=128, device="cpu"), Request,
                    prompts, max_new=3)
    assert [out["plain"]["streams"][str(r)] for r in range(3)] == want
    assert out["overlay"]["downloads"] == 3            # prompts of 5 and 12, decode


def test_step_graph_matches_forward():
    """``build_step_graph`` (embed -> g0 -> head, tokens only, as the
    reference's) on an all-LARGE overlay, bf16: bit-identical to the port's
    forward + unembed; ``frontend_proj`` is an input no stage reads."""
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(4), "cpu")
    toks = torch.from_numpy(_tokens(tcfg, 16, seed=5))
    g = tmodel.build_step_graph(tcfg, (2, 16), "cpu")
    assert [n.name for n in g.op_nodes()] == [f"{ARCH}/embed", f"{ARCH}/g0", f"{ARCH}/head"]
    got = Overlay(3, 3, large_fraction=1.0).assemble(g)(params, toks)
    with torch.no_grad():
        h, _ = tfm.forward(params, tcfg, toks)
        want = tfm.unembed(params, h, tcfg)
    assert got.shape == (2, 16, tcfg.vocab_size) and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the code itself
# ---------------------------------------------------------------------------
CODE = ((tfm, "_with_patches"), (tfm, "forward"), (tmodel, "prefill"),
        (tpipeline, "make_batch"))


@pytest.mark.parametrize("module,name", CODE, ids=[n for _, n in CODE])
def test_vlm_products_are_mm_only(module, name):
    """No ``@``, ``torch.matmul`` or ``torch.einsum`` in the stub's code:
    the projection of the patches is one ``mm`` (``layers.linear``)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(getattr(module, name))))
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult)), name
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("matmul", "einsum"), name
