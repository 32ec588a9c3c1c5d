"""Multi-head Latent Attention (MLA) and deepseek-v3-671b in the port
against the JAX package.

The layer (``models/layers.py::mla_fwd``) runs at the smoke config's MLA
widths (d_model 64, 4 heads, q_lora 32, kv_lora 16, nope 16, rope 8, v 16)
and at wider ones (8 heads, q_lora 128, kv_lora 128, nope 32, rope 16, v
24), on its three branches: cache-free (per-head keys and values
materialized, attended with the plain ``_attention`` at q/k width nope +
rope, v width v_head_dim), absorbed over the latent cache with the scalar
index (cached prefill), and absorbed with per-row positions (ragged
decode).  The model runs at deepseek's smoke config (2 ``mla_dense`` + 2
``mla_moe`` layers, 4 experts, top-2, sigmoid scoring, a shared expert,
the MTP module carried in the tree).  Everything is float32 unless a test
says otherwise; parameters and inputs are numpy draws from a seed, fed to
the port through ``params.from_jax_numpy``.

Tolerances: ``_close_normwise`` (|got - want| <= rtol * max|want|) at 1e-5
for the layer and for each kind's layer, where both sides are float32 but
sum in other orders (the reference's einsums, the port's bmms), at 2^-8
for a whole layer over the bf16 latent cache (see that test); the
model's logits within ``test_torch_archs``' rtol = atol = 2e-3, because
the latent cache is bf16 in both packages and a latent an f32 ulp apart
can round to the neighbouring bf16; token streams, traced-vs-eager outputs
and reloaded operators exactly.
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
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import cut_layers, get_config, smoke_config
from repro_torch.core import Overlay
from repro_torch.core import interpreter as interp
from repro_torch.core.placement import PlacementPolicy, TileGrid, place
from repro_torch.core.store import BitstreamStore
from repro_torch.core.trace import trace_to_graph
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Request, ServeEngine

ARCH = "deepseek-v3-671b"
MAX_LEN = 32
TOL = 1e-5
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
# MLA widths past the smoke config's: 8 heads, latents of 128 (wide
# enough for the rmsnorm kernel's op), and nope != v
WIDE = dict(num_heads=8, num_kv_heads=8, q_lora_rank=128, kv_lora_rank=128,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=24)
WIDTHS = {"smoke": {}, "wide": WIDE}


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


def _configs(widths="smoke", dtype="float32"):
    over = dict(dtype=dtype, **WIDTHS[widths])
    return jax_smoke_config(ARCH).scaled(**over), smoke_config(ARCH).scaled(**over)


def _to_torch(tree):
    return pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_config_kinds_and_counts_are_the_references():
    """deepseek-v3-671b field by field, its 61 kinds, 671.0 B parameters by
    ``param_count()``, the spec trees' sizes (the MTP module's 0.705 B on
    top in both packages)."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert tparams.layer_kinds(cfg) == ["mla_dense"] * 3 + ["mla_moe"] * 58
    assert cfg.param_count() == jcfg.param_count()
    assert round(cfg.param_count() / 1e9, 1) == 671.0
    assert cfg.active_param_count() == jcfg.active_param_count()
    spec = tparams.model_spec(cfg)
    sizes = lambda tree: sum(math.prod(s.shape) for s in pytree.tree_leaves(tree))
    mtp = sizes(spec["mtp"])
    assert mtp == jparams.count(jtfm.model_spec(jcfg)["mtp"]) == 704_664_576
    # ``param_count()`` leaves out the two latent norms of each layer, in
    # both packages
    latent_norms = (cfg.q_lora_rank + cfg.kv_lora_rank) * cfg.num_layers
    assert sizes(spec) == jparams.count(jtfm.model_spec(jcfg)) == \
        cfg.param_count() + mtp + latent_norms
    attn = spec["layers"][0]["attn"]
    assert {k: v.shape for k, v in attn.items()} == {
        "wq_a": (7168, 1536), "q_norm": (1536,), "wq_b": (1536, 128 * 192),
        "wkv_a": (7168, 576), "kv_norm": (512,), "wkv_b": (512, 128 * 256),
        "wo": (128 * 128, 7168)}
    assert list(attn) == list(jlayers.mla_spec(jcfg))
    assert sorted(spec["mtp"]["layer"]) == ["attn", "ffn", "ln1", "ln2"]
    assert spec["mtp"]["layer"]["attn"]["wq"].shape == (7168, 128 * 56)


def test_cut_to_four_layers_keeps_full_width():
    """``cut_layers(cfg, 4)``: the 3 ``mla_dense`` layers and the first
    ``mla_moe`` one at full width; 15.111 B parameters by ``param_count()``,
    15.816 B (31.6 GB in bf16) with the MTP module."""
    cfg = cut_layers(get_config(ARCH), 4)
    assert cfg.blocks == ((("mla_dense",), 3), (("mla_moe",), 1))
    assert tparams.layer_kinds(cfg) == ["mla_dense"] * 3 + ["mla_moe"]
    assert (cfg.d_model, cfg.num_heads, cfg.num_experts, cfg.experts_per_token) == \
        (7168, 128, 256, 8)
    assert cfg.param_count() == 15_111_093_248
    leaves = pytree.tree_leaves(tparams.model_spec(cfg))
    assert sum(math.prod(s.shape) for s in leaves) == 15_815_766_016
    assert round(sum(math.prod(s.shape) * s.dtype.itemsize for s in leaves) / 1e9, 1) == 31.6


def test_latent_cache_holds_1152_bytes_a_token_a_layer():
    """The MLA cache is the reference's ``mla_cache_spec``: bf16 ``c_kv``
    (B, Smax, 512) and ``k_rope`` (B, Smax, 64), and an int32 index."""
    cfg = cut_layers(get_config(ARCH), 4)
    caches = tmodel.init_cache(cfg, 2, 3, "cpu")
    assert len(caches) == 4
    for c, jc in zip(caches, [jlayers.mla_cache_spec(cfg, 2, 3)] * 4):
        assert sorted(c) == ["c_kv", "index", "k_rope"]
        assert tuple(c["c_kv"].shape) == jc["c_kv"].shape == (2, 3, 512)
        assert tuple(c["k_rope"].shape) == jc["k_rope"].shape == (2, 3, 64)
        assert c["c_kv"].dtype == c["k_rope"].dtype == torch.bfloat16
        assert c["index"].dtype == torch.int32 and c["index"].dim() == 0
        per_token = sum(c[k][0, 0].numel() * c[k].element_size() for k in ("c_kv", "k_rope"))
        assert per_token == 1152


# ---------------------------------------------------------------------------
# the layer against the reference
# ---------------------------------------------------------------------------
def _mla_case(widths, seed=0):
    jcfg, tcfg = _configs(widths)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda s: _leaf(rng, s), jlayers.mla_spec(jcfg), is_leaf=jparams.is_spec)
    return jcfg, tcfg, tree


def _filled_cache(cfg, b, smax, index, seed):
    """A latent cache whose first ``index`` positions hold earlier tokens'
    (bf16-representable) latents and rope keys."""
    rng = np.random.default_rng(seed)
    c_kv = rng.standard_normal((b, smax, cfg.kv_lora_rank)).astype(np.float32)
    k_rope = rng.standard_normal((b, smax, cfg.qk_rope_head_dim)).astype(np.float32)
    c_kv[:, index:] = 0
    k_rope[:, index:] = 0
    c_kv = np.array(jnp.asarray(c_kv, jnp.bfloat16).astype(jnp.float32))
    k_rope = np.array(jnp.asarray(k_rope, jnp.bfloat16).astype(jnp.float32))
    return c_kv, k_rope


BRANCHES = ["cache_free", "prefill", "cached_prefill", "decode", "ragged"]


@pytest.mark.parametrize("widths", list(WIDTHS))
@pytest.mark.parametrize("branch", BRANCHES)
def test_mla_fwd_matches_jax(branch, widths):
    """``mla_fwd`` against ``repro.models.layers.mla_fwd`` on one input:
    cache-free over 12 tokens; absorbed with the scalar index over an empty
    cache (prefill of 12), over a cache holding 7 tokens (5 more), and one
    decode token at index 9; absorbed with per-row positions (one token a
    row at 9 and 4).  The output and every cache leaf."""
    jcfg, tcfg, tree = _mla_case(widths)
    b, smax = 2, 20
    s, index, pos = {"cache_free": (12, 0, None), "prefill": (12, 0, None),
                     "cached_prefill": (5, 7, None), "decode": (1, 9, None),
                     "ragged": (1, 10, np.array([[9], [4]], np.int32))}[branch]
    x = np.random.default_rng(3).standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    positions = pos if pos is not None else np.arange(index, index + s, dtype=np.int32)
    jp, tp = jax.tree.map(jnp.asarray, tree), _to_torch(tree)
    if branch == "cache_free":
        jc = tc = None
    else:
        c_kv, k_rope = _filled_cache(jcfg, b, smax, index, seed=4)
        jc = {"c_kv": jnp.asarray(c_kv, jnp.bfloat16), "k_rope": jnp.asarray(k_rope, jnp.bfloat16),
              "index": jnp.asarray(index, jnp.int32)}
        tc = {"c_kv": torch.from_numpy(c_kv).bfloat16(),
              "k_rope": torch.from_numpy(k_rope).bfloat16(),
              "index": torch.tensor(index, dtype=torch.int32)}
    jy, jnew = jlayers.mla_fwd(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(positions),
                               cache=jc)
    with torch.no_grad():
        ty, tnew = tlayers.mla_fwd(tp, torch.from_numpy(x), tcfg,
                                   positions=torch.from_numpy(positions), cache=tc)
    _close_normwise(ty.numpy(), jy, TOL, f"{branch} output")
    if branch == "cache_free":
        assert jnew is None and tnew is None
        return
    assert int(tnew["index"]) == int(jnew["index"]) == index + s
    for key in ("c_kv", "k_rope"):
        assert tnew[key].dtype == torch.bfloat16
        got, want = tnew[key].float().numpy(), np.asarray(jnew[key], np.float32)
        # the new entries are bf16 roundings of f32 values that may differ
        # by an ulp: equal up to one bf16 step, every other entry exactly
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6, err_msg=key)
        written = np.abs(got - c_kv if key == "c_kv" else got - k_rope).max(axis=-1) > 0
        assert written.sum() == b * s, key


@pytest.mark.parametrize("kind", ["mla_dense", "mla_moe"])
@pytest.mark.parametrize("cached", [False, True], ids=["cache_free", "cached"])
def test_each_kind_matches_the_reference_layer(kind, cached):
    """One layer of each MLA kind (norms, MLA, residuals, the MLP or the
    mixture-of-experts FFN with its shared expert) against the reference's
    ``layer_fwd`` on the same (2, 11, d) input, cache-free and over an
    empty latent cache.  Cache-free within 1e-5 normwise; over the cache
    within 2^-8 normwise, one bf16 step: the latent is rounded to the bf16
    cache before it is attended, and an f32 ulp between the packages can
    round it to the neighbouring bf16."""
    jcfg, tcfg, jp, tp, tree = _models()
    g, li = ("g0", 0) if kind == "mla_dense" else ("g1", 2)
    stack = tree[g]["layers"][f"0:{kind}"]
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), stack)
    x = np.random.default_rng(5).standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    jc = jmodel.init_cache(jcfg, 2, MAX_LEN)[g][f"0:{kind}"] if cached else None
    if jc is not None:
        jc = jax.tree.map(lambda a: a[0], jc)
    tc = tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu")[li] if cached else None
    jy, jnew, _ = jtfm.layer_fwd(jl, jnp.asarray(x), kind, jcfg, positions=jnp.arange(11),
                                 cache=jc)
    with torch.no_grad():
        ty, tnew, _ = tfm.layer_fwd(tp["layers"][li], torch.from_numpy(x), kind, tcfg,
                                    positions=torch.arange(11), cache=tc)
    _close_normwise(ty.numpy(), jy, 2 ** -8 if cached else TOL, kind)
    assert (tnew is None) == (not cached)
    if cached:
        np.testing.assert_allclose(tnew["c_kv"].float().numpy(),
                                   np.asarray(jnew["c_kv"], np.float32), rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------------------------------
# the model at the smoke config
# ---------------------------------------------------------------------------
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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_from_jax_numpy_carries_every_leaf():
    """The reference's bf16 tree: each MLA layer's projections and latent
    norms and each ``mla_moe`` layer's experts unstacked exactly, the
    ``mtp`` module carried whole, nothing aliased, as many parameters as
    the reference's tree."""
    jcfg, tcfg = _configs(dtype="bfloat16")
    jtree = jparams.init(jtfm.model_spec(jcfg), jax.random.PRNGKey(0))
    as_f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), jtree)
    tp = tparams.from_jax_numpy(as_f32, tcfg, "cpu")
    assert len(tp["layers"]) == 4
    layers = [(as_f32["g0"]["layers"]["0:mla_dense"], r) for r in range(2)] + \
        [(as_f32["g1"]["layers"]["0:mla_moe"], r) for r in range(2)]
    for li, (stack, r) in enumerate(layers):
        want, got = _flat(stack), _flat(tp["layers"][li])
        assert got.keys() == want.keys()
        for key, t in got.items():
            norm = key.split("/")[-1] in ("ln1", "ln2", "q_norm", "kv_norm")
            assert t.dtype == (torch.float32 if norm else torch.bfloat16), key
            np.testing.assert_array_equal(t.float().numpy(), want[key][r], err_msg=key)
    want, got = _flat(as_f32["mtp"]), _flat(tp["mtp"])
    assert got.keys() == want.keys() and "layer/attn/wq" in got
    for key, t in got.items():
        np.testing.assert_array_equal(t.float().numpy(), want[key], err_msg=f"mtp/{key}")
    leaves = pytree.tree_leaves(tp)
    assert len({t.data_ptr() for t in leaves}) == len(leaves)
    assert tparams.count(tp) == sum(a.size for a in jax.tree.leaves(as_f32))


def test_cache_free_forward_logits_match_jax():
    jcfg, tcfg, jp, tp, _ = _models()
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 21)).astype(np.int32)
    jh, _, _ = jtfm.forward(jp, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        th, _ = tfm.forward(tp, tcfg, torch.from_numpy(toks))
        got = tfm.unembed(tp, th, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtfm.unembed(jp, jh, jcfg)), **LOGIT_TOL)


def test_prefill_and_decode_logits_match_jax():
    """A 20-token prefill of batch 2, three uniform decodes over the latent
    cache, and a ragged decode (rows at 22 and 13)."""
    jcfg, tcfg, jp, tp, _ = _models()
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 20)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, jcfg, jnp.asarray(toks), jmodel.init_cache(jcfg, 2, MAX_LEN))
    with torch.no_grad():
        tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks),
                                tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **LOGIT_TOL)
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


def _prompts(vocab, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).tolist() for n in (5, 12, 9)]


def _streams(engine, request_cls, prompts, max_new=4):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_new_tokens=max_new))
    done = engine.run_until_drained()
    return [r.out for r in sorted(done, key=lambda r: r.rid)]


def test_engine_greedy_streams_match_jax_plain_and_through_the_overlay():
    """``ServeEngine`` greedy streams, token for token: the JAX engine, the
    port's plainly and through the port's ``Overlay(3, 3)`` (ragged decode
    over the latent caches)."""
    jcfg, tcfg, jp, tp, _ = _models()
    prompts = _prompts(jcfg.vocab_size)
    want = _streams(JServeEngine(jp, jcfg, batch=2, max_len=MAX_LEN), JRequest, prompts)
    plain = _streams(ServeEngine(tp, tcfg, batch=2, max_len=MAX_LEN, device="cpu"),
                     Request, prompts)
    through = _streams(ServeEngine(tp, tcfg, batch=2, max_len=MAX_LEN, overlay=Overlay(3, 3),
                                   device="cpu"), Request, prompts)
    assert plain == want and through == want
    assert all(len(s) == 5 for s in want)


def test_engine_moves_every_latent_leaf_with_the_batch():
    """A prompt prefilled into slot 1 lands in row 1 of every layer's
    ``c_kv`` and ``k_rope`` (the engine's install moves each cache leaf
    along axis 0), equal to a batch-1 prefill of it; row 0 keeps its own
    prompt's latents; the scalar index is the larger prompt length."""
    _, tcfg, _, tp, _ = _models()
    prompts = _prompts(tcfg.vocab_size)[:2]
    engine = ServeEngine(tp, tcfg, batch=2, max_len=MAX_LEN, device="cpu")
    for rid, p in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=2))
    with torch.no_grad():
        engine._admit()
        for slot, p in enumerate(prompts):
            _, c1 = tmodel.prefill(tp, tcfg, torch.tensor([p], dtype=torch.int32),
                                   tmodel.init_cache(tcfg, 1, MAX_LEN, "cpu"))
            for pooled, one in zip(engine.caches, c1):
                for key in ("c_kv", "k_rope"):
                    assert torch.equal(pooled[key][slot], one[key][0]), (slot, key)
                    assert pooled[key][slot, len(p):].abs().max() == 0
    assert all(int(c["index"]) == max(map(len, prompts)) for c in engine.caches)


def test_traced_mla_layers_equal_eager_bit_for_bit():
    """Each bf16 MLA kind through the port's ``Overlay.jit`` on both
    branches — cache-free, and over a latent cache with per-row positions
    (the engine's decode) — gives the same bits as the eager call, the
    absorbed products left as ``bmm`` residue nodes."""
    _, tcfg = _configs("wide", "bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 9, tcfg.d_model, generator=gen).bfloat16()
    x1 = torch.randn(2, 1, tcfg.d_model, generator=gen).bfloat16()
    ov = Overlay(3, 3)
    for li, kind in ((0, "mla_dense"), (2, "mla_moe")):
        layer = params["layers"][li]

        def free(p, h, _kind=kind):
            return tfm.layer_fwd(p, h, _kind, tcfg, positions=torch.arange(h.shape[1]),
                                 cache=None)[0]

        def cached(p, h, c, pos, _kind=kind):
            return tfm.layer_fwd(p, h, _kind, tcfg, positions=pos[:, None], cache=c)[:2]

        with torch.no_grad():
            _, cache, _ = tfm.layer_fwd(layer, x, kind, tcfg, positions=torch.arange(9),
                                        cache=tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu")[li])
        pos = torch.tensor([9, 5], dtype=torch.int32)
        for name, fn, args in (("free", free, (layer, x)),
                               ("cached", cached, (layer, x1, cache, pos))):
            f = ov.jit(fn, name=f"{kind}_{name}")
            got = f(*args)
            with torch.no_grad():
                want = fn(*args)
            for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
                assert g.dtype == w.dtype and torch.equal(g, w), (kind, name)
            (entry,) = f._entries.values()
            assert "bmm.default" in set(entry.lowered.unmapped)


def test_mla_operators_round_trip_through_the_store_bit_identically():
    """The traced prefill and ragged decode of the smoke model: every
    operator rebuilt from its serial form (through the store's pack and
    unpack) gives the same bits as the traced one."""
    _, tcfg, _, tp, _ = _models()
    cache = tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu")
    toks = torch.tensor([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], dtype=torch.int32)
    pos = torch.tensor([5, 3], dtype=torch.int32)
    cases = (("prefill", lambda p, t, c: tmodel.prefill(p, tcfg, t, c), (tp, toks, cache)),
             ("decode", lambda p, t, c, q: tmodel.decode_step(p, tcfg, t, c, positions=q),
              (tp, toks[:, :1], cache, pos)))
    targets = set()
    for name, fn, args in cases:
        lowered = trace_to_graph(fn, *args, name=f"deepseek.{name}")
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
    assert {"aten.bmm.default", "aten.index_copy.default", "aten._softmax.default",
            "aten.sort.stable"} <= targets


def test_step_graph_matches_forward():
    """``build_step_graph`` (embed -> g0 -> g1 -> head) on an all-LARGE
    overlay, bf16: bit-identical to the port's forward + unembed (its
    cache-free MLA branch), the MTP module an input no stage reads."""
    jcfg, tcfg = _configs(dtype="bfloat16")
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(jcfg), is_leaf=jparams.is_spec)
    tp = tparams.from_jax_numpy(tree, tcfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, size=(2, 16)).astype(np.int32))
    g = tmodel.build_step_graph(tcfg, (2, 16), "cpu")
    assert [n.name for n in g.op_nodes()] == [f"{ARCH}/embed", f"{ARCH}/g0", f"{ARCH}/g1",
                                              f"{ARCH}/head"]
    got = Overlay(3, 3, large_fraction=1.0).assemble(g)(tp, toks)
    with torch.no_grad():
        h, _ = tfm.forward(tp, tcfg, toks)
        want = tfm.unembed(tp, h, tcfg)
    assert got.shape == (2, 16, tcfg.vocab_size) and torch.equal(got, want)


def test_serve_launcher_gives_equal_tokens_with_and_without_the_overlay(capsys):
    args = ["--arch", ARCH, "--smoke", "--requests", "3", "--batch", "2", "--max-new", "3",
            "--prompt-lens", "5,12", "--device", "cpu"]
    out = {}
    for name, extra in (("plain", []), ("overlay", ["--overlay"])):
        assert serve_cli.main(args + extra) == 0
        out[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["plain"]["arch"] == ARCH
    assert out["plain"]["streams"] == out["overlay"]["streams"]
    assert all(len(s) == 4 for s in out["plain"]["streams"].values())
    assert out["overlay"]["downloads"] == 3            # prompts of 5 and 12, decode


# ---------------------------------------------------------------------------
# the code itself
# ---------------------------------------------------------------------------
MLA_CODE = ("mla_spec", "mla_cache", "mla_fwd", "_heads_first", "_batch_first")


@pytest.mark.parametrize("name", MLA_CODE)
def test_mla_products_are_mm_and_bmm_only(name):
    """No ``@``, ``torch.matmul`` or ``torch.einsum`` in the MLA code: those
    pick a decomposition from strides, which the tracer's fake tensors and
    eager CUDA tensors may disagree on for size-1 dims."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(getattr(tlayers, name))))
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult)), name
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("matmul", "einsum"), name
    if name == "mla_fwd":
        calls = {n.func.attr for n in ast.walk(tree)
                 if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
        assert "bmm" in calls


@pytest.mark.parametrize("branch", ["cache_free", "cached"])
def test_latent_norm_gets_contiguous_rows(monkeypatch, branch):
    """The latent ``kv_a[..., :kv_lora_rank]`` is a strided slice; the
    tensor that reaches the rmsnorm op (whose CUDA kernel takes contiguous
    rows only) must be contiguous, the query latent's too."""
    _, tcfg, tree = _mla_case("wide")
    seen = []
    real = tlayers.kops.rmsnorm

    def spy(x, w, eps=1e-6):
        seen.append((x.shape[-1], x.is_contiguous()))
        return real(x, w, eps)

    monkeypatch.setattr(tlayers.kops, "rmsnorm", spy)
    x = torch.randn(2, 6, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    cache = None
    if branch == "cached":
        cache = tmodel.init_cache(tcfg.scaled(blocks=((("mla_dense",), 1),)), 2, 8, "cpu")[0]
    with torch.no_grad():
        tlayers.mla_fwd(_to_torch(tree), x, tcfg, positions=torch.arange(6), cache=cache)
    assert sorted(seen) == [(tcfg.kv_lora_rank, True), (tcfg.q_lora_rank, True)]
