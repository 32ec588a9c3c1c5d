"""The encoder-decoder seamless-m4t-medium in the port against the JAX
package: the ``enc`` and ``dec`` kinds, cross-attention cache-free and over
the cross cache filled once at prefill, the encoder stack on the audio
stub's frames and on tokens, the model's prefill and decodes, the engines'
and the launcher's refusals.

Everything runs at the smoke config (d_model 64, 4 heads of 16, 2 ``enc`` +
2 ``dec`` layers, frames of 32 features) in float32 unless a test says
otherwise; parameters and inputs are numpy draws from a seed, fed to the
port through ``params.from_jax_numpy``.  Encoders of 128 frames make the
reference's dispatcher send the encoder's self-attention to its Pallas
flash kernel in interpret mode (``repro/models/layers.py:242-247``), so the
non-causal kernel path is the one compared there; at 20 frames it takes
its plain einsum path.

Tolerances: ``_close_normwise`` (|got - want| <= rtol * max|want|) at 1e-5
for a layer, the encoder and the cache-free forward, where both sides are
float32 but sum in other orders; at 2^-8 where a layer attends over a bf16
cache its own keys and values were written into (a value an f32 ulp apart
can round to the neighbouring bf16); the model's logits within
``test_torch_archs``' rtol = atol = 2e-3, the caches being bf16 in both
packages; token streams, traced-vs-eager outputs and reloaded operators
exactly.
"""

import ast
import dataclasses
import inspect
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
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import Overlay
from repro_torch.core import interpreter as interp
from repro_torch.core.placement import PlacementPolicy, TileGrid, place
from repro_torch.core.store import BitstreamStore
from repro_torch.core.trace import trace_to_graph
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.loop import EventLoopEngine

ARCH = "seamless-m4t-medium"
MAX_LEN = 160
TOL = 1e-5
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
FRAMES = (20, 128)          # the reference's plain path, its Pallas flash


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


def _bf16_values(a):
    """``a`` rounded to bf16, as float32 numpy."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


_MODELS = {}


def _models():
    if not _MODELS:
        jcfg, tcfg = _configs()
        rng = np.random.default_rng(0)
        tree = jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(jcfg),
                            is_leaf=jparams.is_spec)
        _MODELS["m"] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                        tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32), tree)
    return _MODELS["m"]


def _frames(cfg, s, seed=3, b=2):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.frontend_dim)).astype(
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
# the config and the parameters
# ---------------------------------------------------------------------------
def test_config_and_param_count_are_the_references():
    """seamless-m4t-medium field by field, 12 ``enc`` + 12 ``dec`` kinds,
    977,757,184 parameters by ``param_count()``; the spec trees' sizes
    agree (both add the stub's ``frontend_proj`` and ``enc_norm``, which
    ``param_count()`` leaves out), 1.96 GB in bf16."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert tparams.encoder_kinds(cfg) == ["enc"] * 12
    assert tparams.layer_kinds(cfg) == ["dec"] * 12
    assert cfg.param_count() == jcfg.param_count() == 977_757_184
    spec = tparams.model_spec(cfg)
    leaves = pytree.tree_leaves(spec)
    n = sum(math.prod(s.shape) for s in leaves)
    assert n == jparams.count(jtfm.model_spec(jcfg)) == \
        cfg.param_count() + cfg.frontend_dim * cfg.d_model + cfg.d_model
    assert round(sum(math.prod(s.shape) * s.dtype.itemsize for s in leaves) / 1e9, 2) == 1.96
    assert spec["frontend_proj"].shape == (1024, 1024)
    assert len(spec["enc_layers"]) == 12 and len(spec["layers"]) == 12
    dec = spec["layers"][0]
    assert list(dec) == ["ln1", "attn", "ln_cross", "cross", "ln2", "ffn"]
    assert list(dec) == list(jtfm.layer_spec(jcfg, "dec"))
    assert {k: v.shape for k, v in dec["cross"].items()} == {
        "wq": (1024, 1024), "wk": (1024, 1024), "wv": (1024, 1024), "wo": (1024, 1024)}
    assert list(spec["enc_layers"][0]) == list(jtfm.layer_spec(jcfg, "enc"))


def test_from_jax_numpy_carries_every_leaf():
    """The reference's bf16 tree: each encoder layer unstacked from
    ``enc0``, each ``dec`` layer with its ``ln_cross`` and ``cross``,
    ``frontend_proj`` and ``enc_norm`` carried exactly, nothing aliased, as
    many parameters as the reference's tree."""
    jcfg, tcfg = _configs("bfloat16")
    jtree = jparams.init(jtfm.model_spec(jcfg), jax.random.PRNGKey(0))
    as_f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), jtree)
    tp = tparams.from_jax_numpy(as_f32, tcfg, "cpu")
    for name, stack, layers in (("enc", as_f32["enc0"]["layers"]["0:enc"], tp["enc_layers"]),
                                ("dec", as_f32["g0"]["layers"]["0:dec"], tp["layers"])):
        assert len(layers) == 2
        for r, layer in enumerate(layers):
            want, got = _flat(stack), _flat(layer)
            assert got.keys() == want.keys(), name
            for key, t in got.items():
                norm = key.split("/")[-1] in ("ln1", "ln2", "ln_cross")
                assert t.dtype == (torch.float32 if norm else torch.bfloat16), key
                np.testing.assert_array_equal(t.float().numpy(), want[key][r],
                                              err_msg=f"{name} {r} {key}")
    for key in ("frontend_proj", "enc_norm", "embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(tp[key].float().numpy(), as_f32[key], err_msg=key)
    leaves = pytree.tree_leaves(tp)
    assert len({t.data_ptr() for t in leaves}) == len(leaves)
    assert tparams.count(tp) == sum(a.size for a in jax.tree.leaves(as_f32))


def test_init_cache_is_the_references():
    """A ``dec`` layer's cache is ``{"self", "cross"}``, two bf16 KV caches
    of max_len and an int32 index each, as the reference's
    ``layer_cache_spec``; the encoder keeps none."""
    jcfg, tcfg = _configs()
    caches = tmodel.init_cache(tcfg, 2, 24, "cpu")
    want = jtfm.layer_cache_spec(jcfg, "dec", 2, 24)
    assert len(caches) == 2
    for c in caches:
        assert sorted(c) == ["cross", "self"]
        for part in ("self", "cross"):
            assert sorted(c[part]) == sorted(want[part]) == ["index", "k", "v"]
            for key in ("k", "v"):
                assert tuple(c[part][key].shape) == want[part][key].shape == (2, 4, 24, 16)
                assert c[part][key].dtype == torch.bfloat16
            assert c[part]["index"].dtype == torch.int32 and c[part]["index"].dim() == 0
        assert c["self"]["k"].data_ptr() != c["cross"]["k"].data_ptr()


# ---------------------------------------------------------------------------
# the layers against the reference
# ---------------------------------------------------------------------------
def _attn_params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: _leaf(rng, s), jlayers.attn_spec(jcfg),
                        is_leaf=jparams.is_spec)


def _cross_cache(cfg, b, smax, index, seed=6):
    """A cross cache whose first ``index`` positions hold bf16-representable
    keys and values and whose slots past it hold other values, which the
    mask must keep out."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.num_kv_heads, smax, cfg.resolved_head_dim)
    k = _bf16_values(rng.standard_normal(shape))
    v = _bf16_values(rng.standard_normal(shape))
    return k, v, index


@pytest.mark.parametrize("case", ["enc", "cross_free", "cross_cached"])
def test_attn_fwd_matches_jax(case):
    """``attn_fwd`` of the ``enc`` kind (non-causal self-attention with
    RoPE), of ``cross`` cache-free (keys and values from an encoder output
    of 13 positions against 7 queries, no RoPE) and of ``cross`` over a
    cache of 24 slots filled to 9, against the reference's on one input,
    within 1e-5 normwise."""
    jcfg, tcfg = _configs()
    p = _attn_params(jcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
    kw_j = dict(positions=jnp.arange(7))
    kw_t = dict(positions=torch.arange(7))
    if case == "enc":
        kind, jc, tc = "enc", None, None
    elif case == "cross_free":
        kind, jc, tc = "cross", None, None
        kw_j["x_kv"], kw_t["x_kv"] = jnp.asarray(enc), torch.from_numpy(enc)
    else:
        kind = "cross"
        k, v, idx = _cross_cache(jcfg, 2, 24, 9)
        jc = {"k": jnp.asarray(k, jnp.bfloat16), "v": jnp.asarray(v, jnp.bfloat16),
              "index": jnp.asarray(idx, jnp.int32)}
        tc = {"k": torch.from_numpy(k).bfloat16(), "v": torch.from_numpy(v).bfloat16(),
              "index": torch.tensor(idx, dtype=torch.int32)}
    jy, jnew = jlayers.attn_fwd(p, jnp.asarray(x), jcfg, kind=kind, cache=jc, **kw_j)
    with torch.no_grad():
        ty, tnew = tlayers.attn_fwd(tp, torch.from_numpy(x), tcfg, kind=kind, cache=tc, **kw_t)
    _close_normwise(ty.numpy(), jy, TOL, case)
    if case == "cross_cached":
        assert tnew is tc                      # a cross cache is read, never written
    else:
        assert tnew is None and jnew is None


def test_attn_fwd_enc_is_not_causal_and_cross_takes_no_rope():
    """The ``enc`` kind's first query sees the last key (changing it moves
    the output), a ``dense`` layer's does not; a cache-free cross-attention
    gives the same output at any query positions (no RoPE)."""
    _, tcfg = _configs()
    p = {k: torch.from_numpy(v) for k, v in _attn_params(_configs()[0]).items()}
    x = torch.randn(1, 6, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    x2 = x.clone()
    x2[:, -1] += 1.0
    pos = torch.arange(6)
    with torch.no_grad():
        for kind, moves in (("enc", True), ("dense", False)):
            a, _ = tlayers.attn_fwd(p, x, tcfg, kind=kind, positions=pos, cache=None)
            b, _ = tlayers.attn_fwd(p, x2, tcfg, kind=kind, positions=pos, cache=None)
            assert (not torch.equal(a[:, 0], b[:, 0])) == moves, kind
        enc = torch.randn(1, 9, tcfg.d_model, generator=torch.Generator().manual_seed(1))
        a, _ = tlayers.attn_fwd(p, x, tcfg, kind="cross", positions=pos, cache=None, x_kv=enc)
        b, _ = tlayers.attn_fwd(p, x, tcfg, kind="cross", positions=pos + 40, cache=None,
                                x_kv=enc)
        assert torch.equal(a, b)


@pytest.mark.parametrize("branch", ["scalar", "ragged"])
def test_non_causal_attention_matches_jax(branch):
    """``_attention(causal=False)`` against ``_attention_xla(causal=False)``
    on the scalar branch (q_offset 3, kv_len 11 of 16 slots) and on the
    ragged one (per-row offsets and lengths), within 1e-5 normwise; the
    mask is only ``kpos < kv_len`` (the slots past it hold other values)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 3, 16)).astype(np.float32)
    k = _bf16_values(rng.standard_normal((2, 2, 16, 16)))
    v = _bf16_values(rng.standard_normal((2, 2, 16, 16)))
    if branch == "scalar":
        qo, kl = 3, 11
        jqo, jkl, tqo, tkl = qo, jnp.asarray(kl), qo, torch.tensor(kl)
    else:
        qo, kl = np.array([3, 9], np.int32), np.array([5, 13], np.int32)
        jqo, jkl, tqo, tkl = (jnp.asarray(qo), jnp.asarray(kl), torch.from_numpy(qo),
                              torch.from_numpy(kl))
    want = jlayers._attention_xla(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                                  jnp.asarray(v, jnp.bfloat16), causal=False, window=None,
                                  softcap=None, scale=0.25, q_offset=jqo, kv_len=jkl)
    got = tlayers._attention(torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
                             torch.from_numpy(v).bfloat16(), causal=False, window=None,
                             softcap=None, scale=0.25, q_offset=tqo, kv_len=tkl)
    _close_normwise(got.numpy(), np.asarray(want, np.float32), TOL, branch)
    # the keys past kv_len are out, whatever they hold
    k2 = torch.from_numpy(k).bfloat16().clone()
    k2[:, :, 13:] = 7.0
    again = tlayers._attention(torch.from_numpy(q), k2, torch.from_numpy(v).bfloat16(),
                               causal=False, window=None, softcap=None, scale=0.25,
                               q_offset=tqo, kv_len=tkl)
    assert torch.equal(again, got)


@pytest.mark.parametrize("frames", FRAMES)
@pytest.mark.parametrize("source", ["frames", "tokens"])
def test_encode_matches_jax(source, frames):
    """``encode`` on (2, S, 32) frames through ``frontend_proj`` (rounded to
    bf16 first, as the reference does) and on (2, S) tokens, at S = 20 and
    128 (the reference's Pallas flash, non-causal), within 1e-5
    normwise."""
    jcfg, tcfg, jp, tp, _ = _models()
    enc_in = _frames(jcfg, frames) if source == "frames" else _tokens(jcfg, frames)
    want = jtfm.encode(jp, jcfg, jnp.asarray(enc_in))
    with torch.no_grad():
        got = tfm.encode(tp, tcfg, torch.from_numpy(enc_in))
    assert got.shape == (2, frames, jcfg.d_model)
    _close_normwise(got.numpy(), want, TOL, source)


@pytest.mark.parametrize("cached", [False, True], ids=["cache_free", "cached"])
def test_dec_layer_matches_jax(cached):
    """One ``dec`` layer (self-attention, ``ln_cross`` and cross-attention,
    the GELU-gated MLP) against the reference's ``layer_fwd``: cache-free
    over an encoder output of 13 positions (1e-5 normwise), and over an
    empty self cache and a cross cache filled from it (2^-8 normwise: the
    layer's own keys and values are rounded to the bf16 self cache before
    they are attended)."""
    jcfg, tcfg, jp, tp, tree = _models()
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["g0"]["layers"]["0:dec"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
    pos = np.arange(7)
    if cached:
        jc = jax.tree.map(lambda a: a[0],
                          jmodel._fill_cross_caches(jp, jcfg, jnp.asarray(enc),
                                                    jmodel.init_cache(jcfg, 2, 24))["g0"]["0:dec"])
        tc = tmodel._fill_cross_caches(tp, tcfg, torch.from_numpy(enc),
                                       tmodel.init_cache(tcfg, 2, 24, "cpu"))[0]
        jy, jnew, _ = jtfm.layer_fwd(jl, jnp.asarray(x), "dec", jcfg, positions=jnp.asarray(pos),
                                     cache=jc)
        with torch.no_grad():
            ty, tnew, _ = tfm.layer_fwd(tp["layers"][0], torch.from_numpy(x), "dec", tcfg,
                                        positions=torch.from_numpy(pos), cache=tc)
        _close_normwise(ty.numpy(), jy, 2 ** -8, "cached")
        assert sorted(tnew) == ["cross", "self"] and tnew["cross"] is tc["cross"]
        assert int(tnew["self"]["index"]) == 7 and int(tnew["cross"]["index"]) == 13
        np.testing.assert_allclose(tnew["self"]["k"].float().numpy(),
                                   np.asarray(jnew["self"]["k"], np.float32), rtol=2 ** -7,
                                   atol=1e-6)
    else:
        jy, jnew, _ = jtfm.layer_fwd(jl, jnp.asarray(x), "dec", jcfg, positions=jnp.asarray(pos),
                                     enc_out=jnp.asarray(enc))
        with torch.no_grad():
            ty, tnew, _ = tfm.layer_fwd(tp["layers"][0], torch.from_numpy(x), "dec", tcfg,
                                        positions=torch.from_numpy(pos), cache=None,
                                        enc_out=torch.from_numpy(enc))
        _close_normwise(ty.numpy(), jy, TOL, "cache-free")
        assert tnew is None


def test_fill_cross_caches_matches_jax_leaf_by_leaf():
    """Each ``dec`` layer's cross cache after ``_fill_cross_caches`` of a
    13-position encoder output into 24 slots: keys and values within one
    bf16 step of the reference's (both round f32 products to the bf16
    cache), exactly zero past 13, the index 13; the self caches untouched."""
    jcfg, tcfg, jp, tp, _ = _models()
    enc = np.random.default_rng(7).standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
    want = jmodel._fill_cross_caches(jp, jcfg, jnp.asarray(enc),
                                     jmodel.init_cache(jcfg, 2, 24))["g0"]["0:dec"]
    before = tmodel.init_cache(tcfg, 2, 24, "cpu")
    got = tmodel._fill_cross_caches(tp, tcfg, torch.from_numpy(enc), before)
    assert len(got) == 2
    for r, c in enumerate(got):
        assert c["self"] is before[r]["self"]
        for key in ("k", "v"):
            t = c["cross"][key]
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == (2, 4, 24, 16)
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(want["cross"][key][r], np.float32),
                                       rtol=2 ** -7, atol=1e-6, err_msg=f"layer {r} {key}")
            assert t[:, :, 13:].abs().max() == 0
            assert before[r]["cross"][key].abs().max() == 0      # not written in place
        assert int(c["cross"]["index"]) == int(want["cross"]["index"][r]) == 13
        assert c["cross"]["index"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("frames", FRAMES)
def test_prefill_and_decode_logits_match_jax(frames):
    """``prefill(enc_in=frames)`` of a 5-token prompt at batch 2, three
    uniform decodes and a ragged decode (rows at 9 and 6), logits against
    ``repro.models.model`` within 2e-3."""
    jcfg, tcfg, jp, tp, _ = _models()
    enc_in, toks = _frames(jcfg, frames), _tokens(jcfg, 5)
    jl, jc = jmodel.prefill(jp, jcfg, jnp.asarray(toks), jmodel.init_cache(jcfg, 2, MAX_LEN),
                            enc_in=jnp.asarray(enc_in))
    with torch.no_grad():
        tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks),
                                tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu"),
                                enc_in=torch.from_numpy(enc_in))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **LOGIT_TOL)
    assert all(int(c["cross"]["index"]) == frames for c in tc)
    rng = np.random.default_rng(8)
    for i in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
        jd, jc = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        with torch.no_grad():
            td, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), err_msg=f"decode {i}",
                                   **LOGIT_TOL)
    assert int(tmodel._current_index(tcfg, tc)) == 8
    pos = np.array([9, 6], np.int32)
    jr, _ = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc, positions=jnp.asarray(pos))
    with torch.no_grad():
        tr, _ = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                   positions=torch.from_numpy(pos))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), err_msg="ragged decode", **LOGIT_TOL)


@pytest.mark.parametrize("frames,tokens", [(20, 5), (128, 128)])
def test_cache_free_forward_logits_match_jax(frames, tokens):
    """``forward(enc_out=encode(frames))`` + ``unembed`` within 1e-5
    normwise of the reference's: the decoder's cross-attention cache-free
    (7 queries over 20 keys, and 128 over 128, which the reference sends
    to its Pallas flash, non-causal)."""
    jcfg, tcfg, jp, tp, _ = _models()
    enc_in, toks = _frames(jcfg, frames), _tokens(jcfg, tokens)
    je = jtfm.encode(jp, jcfg, jnp.asarray(enc_in))
    jh, _, _ = jtfm.forward(jp, jcfg, jnp.asarray(toks), enc_out=je)
    with torch.no_grad():
        te = tfm.encode(tp, tcfg, torch.from_numpy(enc_in))
        th, caches = tfm.forward(tp, tcfg, torch.from_numpy(toks), enc_out=te)
        got = tfm.unembed(tp, th, tcfg)
    assert caches is None
    _close_normwise(got.numpy(), jtfm.unembed(jp, jh, jcfg), TOL)


def _greedy(prefill, decode, params, toks, frames, cfg, new=4):
    caches = tmodel.init_cache(cfg, toks.shape[0], 48, "cpu")
    logits, caches = prefill(params, toks, caches, frames)
    out, steps = [logits], [torch.argmax(logits, -1)]
    for _ in range(new):
        tok = steps[-1][:, None].to(torch.int32)
        logits, caches = decode(params, tok, caches)
        out.append(logits)
        steps.append(torch.argmax(logits, -1))
    return torch.stack(steps, 1), out


def test_greedy_loop_through_the_overlay_equals_plain():
    """A greedy loop — prefill on 40 frames and a 3-token prompt, then 4
    decodes — through ``Overlay(3, 3).jit`` of the two steps equals the
    plain loop token for token and logit for logit (bf16 weights); the
    traced prefill holds one ``kernels/attention`` node per encoder layer
    (the decoder's self- and cross-attention read caches: plain code), the
    traced decode none."""
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, tcfg.vocab_size, (2, 3), generator=gen).to(torch.int32)
    frames = torch.randn(2, 40, tcfg.frontend_dim, generator=gen).bfloat16()
    pf = lambda p, t, c, f: tmodel.prefill(p, tcfg, t, c, enc_in=f)
    dec = lambda p, t, c: tmodel.decode_step(p, tcfg, t, c)
    with torch.no_grad():
        want_toks, want = _greedy(pf, dec, params, toks, frames, tcfg)
    ov = Overlay(3, 3)
    budget = max(1, ov.grid.num_tiles // 4)
    jpf = ov.jit(pf, name=f"{ARCH}.prefill", tile_budget=budget)
    jdec = ov.jit(dec, name=f"{ARCH}.decode", tile_budget=budget)
    got_toks, got = _greedy(jpf, jdec, params, toks, frames, tcfg)
    assert torch.equal(got_toks, want_toks)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    (pentry,) = jpf._entries.values()
    names = [nd.name for nd in pentry.lowered.graph.op_nodes()]
    assert names.count("kernels/attention") == len(tparams.encoder_kinds(tcfg))
    (dentry,) = jdec._entries.values()
    assert [nd.name for nd in dentry.lowered.graph.op_nodes()].count("kernels/attention") == 0


def test_traced_prefill_equals_eager_bit_for_bit():
    """``prefill(enc_in=frames)`` traced by ``Overlay.jit`` gives the same
    bits as the eager call in every output leaf (logits and each layer's
    self and cross caches), bf16 weights, on 24 frames and a 5-token
    prompt, then on 30 frames (a second signature)."""
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(2), "cpu")
    gen = torch.Generator().manual_seed(3)
    ov = Overlay(3, 3)
    fn = lambda p, t, c, f: tmodel.prefill(p, tcfg, t, c, enc_in=f)
    jf = ov.jit(fn, name=f"{ARCH}.prefill")
    for s in (24, 30):
        toks = torch.randint(0, tcfg.vocab_size, (2, 5), generator=gen).to(torch.int32)
        frames = torch.randn(2, s, tcfg.frontend_dim, generator=gen).bfloat16()
        caches = tmodel.init_cache(tcfg, 2, 32, "cpu")
        got = jf(params, toks, caches, frames)
        with torch.no_grad():
            want = fn(params, toks, caches, frames)
        gl, wl = pytree.tree_leaves(got), pytree.tree_leaves(want)
        assert len(gl) == len(wl) == 1 + 2 * 6
        for g, w in zip(gl, wl):
            assert g.dtype == w.dtype and torch.equal(g, w), s
    assert len(jf._entries) == 2


def test_encdec_operators_round_trip_through_the_store_bit_identically():
    """The traced prefill (encoder, cross caches, decoder) and the decode
    of the smoke model: every operator rebuilt from its serial form
    (through the store's pack and unpack) gives the same bits as the traced
    one."""
    _, tcfg, _, tp, _ = _models()
    cache = tmodel.init_cache(tcfg, 2, 32, "cpu")
    toks = torch.tensor([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], dtype=torch.int32)
    frames = torch.from_numpy(_frames(tcfg, 12))
    with torch.no_grad():
        _, filled = tmodel.prefill(tp, tcfg, toks, cache, enc_in=frames)
    cases = (("prefill", lambda p, t, c, f: tmodel.prefill(p, tcfg, t, c, enc_in=f),
              (tp, toks, cache, frames)),
             ("decode", lambda p, t, c: tmodel.decode_step(p, tcfg, t, c),
              (tp, toks[:, :1], filled)))
    targets = set()
    for name, fn, args in cases:
        lowered = trace_to_graph(fn, *args, name=f"seamless.{name}")
        kernel = interp.build_kernel(lowered.graph)
        program, _ = kernel.serial_form()
        targets |= {op.get("target") for op in program["ops"]}
        loaded = BitstreamStore.unpack_kernel(BitstreamStore.pack_kernel(kernel))
        routes = interp.route_vector(lowered.graph,
                                     place(lowered.graph, TileGrid(3, 3), PlacementPolicy.DYNAMIC))
        leaves = tuple(pytree.tree_leaves(args))
        want, got = kernel(routes, *leaves), loaded(routes, *leaves)
        for w, g in zip(pytree.tree_leaves(want), pytree.tree_leaves(got)):
            assert torch.equal(w, g), f"{name}: reloaded kernel differs"
    assert {"aten.bmm.default", "aten.index_copy.default", "aten._softmax.default"} <= targets


def test_make_batch_frames_are_the_references():
    """The audio stub's ``frames``: the reference's numpy draws rounded to
    bf16, bit for bit, beside the same tokens; ``batch_specs`` gives their
    shapes and dtypes."""
    jcfg, tcfg = _configs()
    for step in (0, 3):
        want = jpipeline.make_batch(jcfg, 2, 9, step=step, seed=5)
        got = tpipeline.make_batch(tcfg, 2, 9, step=step, seed=5, device="cpu")
        assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
        assert got["frames"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["frames"].float().numpy(),
                                      np.asarray(want["frames"], np.float32))
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    specs = tpipeline.batch_specs(tcfg, 2, 9, device="cpu")
    jspecs = jpipeline.batch_specs(jcfg, 2, 9)
    assert {k: tuple(s.shape) for k, s in specs.items()} == \
        {k: tuple(s.shape) for k, s in jspecs.items()}
    assert specs["frames"].dtype == torch.bfloat16 and specs["tokens"].dtype == torch.int32


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def test_engines_refuse_an_encoder_decoder():
    """The reference's ``ServeEngine`` passes no encoder input; the event
    loop's chunked prefill runs no encoder and would serve from an empty
    cross cache.  Both refuse, naming the model API to use instead."""
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="no encoder input"):
        ServeEngine(params, tcfg, batch=2, max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="empty cross cache"):
        EventLoopEngine(params, tcfg, batch=2, max_len=16, device="cpu")


def test_serve_launcher_refuses_an_encoder_decoder():
    with pytest.raises(SystemExit, match="serve launcher targets decoder LMs"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_build_step_graph_refuses_an_encoder_decoder():
    _, tcfg = _configs("bfloat16")
    with pytest.raises(NotImplementedError, match="carry no encoder output"):
        tmodel.build_step_graph(tcfg, (2, 8), "cpu")


def test_a_dec_layer_needs_a_cache_or_the_encoder_output():
    _, tcfg, _, tp, _ = _models()
    x = torch.zeros(2, 3, tcfg.d_model)
    with pytest.raises(ValueError, match="cross-attends to the encoder"):
        tfm.layer_fwd(tp["layers"][0], x, "dec", tcfg, positions=torch.arange(3), cache=None)
    with pytest.raises(ValueError, match="cross-attends to the encoder"):
        tfm.forward(tp, tcfg, torch.zeros((2, 3), dtype=torch.int32))


def test_prefill_refuses_a_missing_or_too_long_encoder_input():
    _, tcfg, _, tp, _ = _models()
    toks = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs the encoder's input"):
        tmodel.prefill(tp, tcfg, toks, tmodel.init_cache(tcfg, 2, 16, "cpu"))
    with pytest.raises(ValueError, match="more than the cross cache's max_len 16"):
        tmodel.prefill(tp, tcfg, toks, tmodel.init_cache(tcfg, 2, 16, "cpu"),
                       enc_in=torch.from_numpy(_frames(tcfg, 17)))


# ---------------------------------------------------------------------------
# the code itself
# ---------------------------------------------------------------------------
CODE = ((tlayers, "attn_fwd"), (tlayers, "_attention"), (tfm, "encode"),
        (tfm, "layer_fwd"), (tmodel, "_fill_cross_caches"), (tmodel, "prefill"))


@pytest.mark.parametrize("module,name", CODE, ids=[n for _, n in CODE])
def test_encdec_products_are_mm_and_bmm_only(module, name):
    """No ``@``, ``torch.matmul`` or ``torch.einsum`` in the attention,
    encoder and cross-cache code: those pick a decomposition from strides,
    which the tracer's fake tensors and eager CUDA tensors may disagree on
    for size-1 dims (the cached cross-attention's single decode query)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(getattr(module, name))))
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult)), name
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("matmul", "einsum"), name
