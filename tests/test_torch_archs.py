"""The dense family in the port — gemma2-27b, minicpm-2b, mistral-large-123b —
against the JAX package.

Each arch runs at its smoke config (d_model 64, 4 heads of 16, two repeats
of its unit), float32 weights made from a seed with numpy and fed to both
packages through ``params.from_jax_numpy``.  gemma2's sliding window is cut
to 8 on BOTH packages (``cfg.scaled(sliding_window=8)``): at the smoke
config's 4096 no local layer would ever mask a key.  The prompts (20
tokens), the decode positions (20-22, and 22 / 13 ragged) and the
cache-free forward (24 tokens) all reach past it, so dropping the window
from any branch of ``layers.attn_fwd`` moves the logits far outside the
tolerance (``test_the_window_acts_at_these_lengths`` shows by how much).

Logit tolerance: everything is float32 except the KV cache, which is bf16
in both packages; a key or value an f32 ulp apart can round to the
neighbouring bf16 (2^-8 relative) and move a logit by ~1e-3 through the
softmax (as in ``test_torch_serving.py``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs.archs import smoke_config as jax_smoke_config
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro_torch.configs import ArchConfig, cut_layers, get_config, smoke_config
from repro_torch.core import Overlay
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Request, ServeEngine

ARCHS = ("gemma2-27b", "minicpm-2b", "mistral-large-123b")
WINDOW = 8
PROMPT, FREE_SEQ, MAX_LEN = 20, 24, 32
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _configs(name, dtype="float32", window=WINDOW):
    over = dict(dtype=dtype)
    if name == "gemma2-27b":
        over["sliding_window"] = window
    return jax_smoke_config(name).scaled(**over), smoke_config(name).scaled(**over)


def _numpy_params(jcfg, seed=0):
    """The JAX parameter tree's structure, filled with numpy draws (norm
    scales near 1, so a dropped or doubled norm shows)."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        if spec.init == "ones":
            return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None else fan_in ** -0.5
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    return jax.tree.map(leaf, jtfm.model_spec(jcfg), is_leaf=jparams.is_spec)


_MODELS = {}


def _models(name):
    if name not in _MODELS:
        jcfg, tcfg = _configs(name)
        tree = _numpy_params(jcfg)
        _MODELS[name] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                         tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32))
    return _MODELS[name]


def _flat(tree, prefix=""):
    """A nested dict as {"attn/wq": leaf, ...}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _close(got: torch.Tensor, want, what: str):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **LOGIT_TOL)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_configs_are_the_references(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))
    assert dataclasses.asdict(smoke_config(name)) == dataclasses.asdict(jax_smoke_config(name))


def test_layer_kinds_of_the_dense_family():
    assert tparams.layer_kinds(get_config("gemma2-27b")) == ["local", "global"] * 23
    assert tparams.layer_kinds(get_config("minicpm-2b")) == ["dense"] * 40
    assert tparams.layer_kinds(get_config("mistral-large-123b")) == ["dense"] * 88
    assert tparams.layer_kinds(smoke_config("gemma2-27b")) == ["local", "global"] * 2


@pytest.mark.parametrize("name", sorted(jax_list_archs()))
def test_every_reference_config_is_served(name):
    """Each of the reference's ten configs, copied field by field into the
    port's schema, passes ``layer_kinds`` and ``model_spec``: the kinds
    and the spec's parameters are the reference's tree's."""
    cfg = ArchConfig(**dataclasses.asdict(jax_get_config(name)))
    kinds = tparams.layer_kinds(cfg)
    assert kinds == [k for unit, rep in cfg.blocks for _ in range(rep) for k in unit]
    spec = tparams.model_spec(cfg)
    n = sum(math.prod(s.shape) for s in pytree.tree_leaves(spec))
    assert n == jparams.count(jtfm.model_spec(jax_get_config(name)))


@pytest.mark.parametrize("name", ARCHS)
def test_from_jax_numpy_carries_every_leaf(name):
    """Every leaf of the reference's tree lands in the port's, unstacked in
    execution order (gemma2: local, global, local, global), post norms
    included, and as many parameters as the reference's tree holds (its
    analytic ``param_count`` leaves out gemma2's post norms, 2 x d_model a
    layer)."""
    jcfg, tcfg, _, tp = _models(name)
    tree = _numpy_params(jcfg)
    assert tparams.count(tp) == sum(a.size for a in jax.tree.leaves(tree))
    post = 2 * jcfg.d_model * jcfg.num_layers if jcfg.post_norms else 0
    assert tparams.count(tp) == jcfg.param_count() + post
    unit, rep = jcfg.blocks[0]
    stacks = tree["g0"]["layers"]
    for li, layer in enumerate(tp["layers"]):
        r, j = divmod(li, len(unit))
        src = _flat(stacks[f"{j}:{unit[j]}"])
        got = _flat(layer)
        assert sorted(got) == sorted(src)
        for key, v in got.items():
            np.testing.assert_array_equal(v.numpy(), src[key][r], err_msg=f"{li} {key}")
    assert ("post_ln1" in tp["layers"][0]) == (name == "gemma2-27b")


def test_cut_layers_keeps_the_width():
    cfg = cut_layers(get_config("mistral-large-123b"), 8)
    assert cfg.num_layers == 8 and cfg.d_model == 12288 and cfg.blocks == ((("dense",), 8),)
    assert cut_layers(get_config("gemma2-27b"), 4).blocks == ((("local", "global"), 2),)
    with pytest.raises(ValueError, match="whole number"):
        cut_layers(get_config("gemma2-27b"), 3)
    with pytest.raises(ValueError):
        cut_layers(get_config("minicpm-2b"), 41)


# ---------------------------------------------------------------------------
# logits against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_logits_match_jax(name):
    """Prefill of 20 tokens, three uniform decodes (positions 20-22) and a
    ragged decode (rows at 22 and 13), logits every call."""
    jcfg, tcfg, jp, tp = _models(name)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, PROMPT)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, jcfg, jnp.asarray(toks), jmodel.init_cache(jcfg, 2, MAX_LEN))
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks),
                            tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu"))
    _close(tl, jl, "prefill")
    for i in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
        jd, jc = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        td, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        _close(td, jd, f"decode {i}")
    pos = np.array([22, 13], np.int32)
    jr, _ = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc, positions=jnp.asarray(pos))
    tr, _ = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                               positions=torch.from_numpy(pos))
    _close(tr, jr, "ragged decode")


@pytest.mark.parametrize("name", ARCHS)
def test_cache_free_forward_logits_match_jax(name):
    """The cache-free forward (the port's attention op; the reference's
    plain masked attention at a length that is not a multiple of 128) and
    the tied or untied head with gemma2's final softcap."""
    jcfg, tcfg, jp, tp = _models(name)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                             size=(2, FREE_SEQ)).astype(np.int32)
    jh, _, _ = jtfm.forward(jp, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        th, _ = tfm.forward(tp, tcfg, torch.from_numpy(toks))
        logits = tfm.unembed(tp, th, tcfg)
    _close(logits, jtfm.unembed(jp, jh, jcfg), "cache-free forward")


def test_the_window_acts_at_these_lengths():
    """At window 8 the parity tests' lengths mask keys: without the window
    (global attention on every layer) the same weights give logits far
    outside the parity tolerance, on prefill, uniform decode and the
    cache-free forward alike."""
    _, tcfg, _, tp = _models("gemma2-27b")
    wide = tcfg.scaled(sliding_window=None)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(2, PROMPT)).astype(np.int32))
    with torch.no_grad():
        out = {}
        for tag, cfg in (("window", tcfg), ("none", wide)):
            lp, c = tmodel.prefill(tp, cfg, toks, tmodel.init_cache(cfg, 2, MAX_LEN, "cpu"))
            ld, _ = tmodel.decode_step(tp, cfg, toks[:, :1], c)
            h, _ = tfm.forward(tp, cfg, toks)
            out[tag] = (lp, ld, tfm.unembed(tp, h, cfg))
    for a, b in zip(out["window"], out["none"]):
        assert (a - b).abs().max().item() > 50 * LOGIT_TOL["atol"]


def test_geglu_is_the_tanh_gelu():
    """gemma2's GeGLU uses ``jax.nn.gelu``'s default, the tanh form: the
    port's MLP matches the reference's and not the exact (erf) gelu."""
    jcfg, tcfg, jp, tp = _models("gemma2-27b")
    assert tcfg.act == "gelu"
    x = np.random.default_rng(3).standard_normal((2, 5, tcfg.d_model)).astype(np.float32) * 3
    ffn_t = tp["layers"][0]["ffn"]
    ffn_j = jax.tree.map(lambda a: a[0], jp["g0"]["layers"]["0:local"]["ffn"])
    got = tlayers.mlp_fwd(ffn_t, torch.from_numpy(x), tcfg)
    want = np.asarray(jlayers.mlp_fwd(ffn_j, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    xt = torch.from_numpy(x)
    h = torch.nn.functional.gelu(tlayers.linear(xt, ffn_t["w_gate"])) * \
        tlayers.linear(xt, ffn_t["w_up"])
    exact = tlayers.linear(h, ffn_t["w_down"])
    assert (exact - got).abs().max().item() > 1e-4


def test_post_norms_apply_to_both_sublayers():
    """Scaling a post norm's weight moves the output; a config without
    post norms has no such leaves."""
    _, tcfg, _, tp = _models("gemma2-27b")
    toks = torch.from_numpy(np.arange(10, dtype=np.int32)[None])
    with torch.no_grad():
        base, _ = tfm.forward(tp, tcfg, toks)
        for key in ("post_ln1", "post_ln2"):
            moved = {**tp, "layers": [dict(lp) for lp in tp["layers"]]}
            moved["layers"][0][key] = tp["layers"][0][key] * 2
            h, _ = tfm.forward(moved, tcfg, toks)
            assert (h - base).abs().max().item() > 1e-3, key
    assert "post_ln1" not in tparams.layer_spec(smoke_config("minicpm-2b"), "dense")


# ---------------------------------------------------------------------------
# serving through the overlay
# ---------------------------------------------------------------------------
class _Logits:
    """A serving step that keeps the logits of every call."""

    def __init__(self, fn):
        self.fn, self.logits = fn, []

    def __call__(self, *args):
        out = self.fn(*args)
        self.logits.append(out[0].clone())
        return out


@pytest.mark.parametrize("name", ARCHS)
def test_overlay_and_plain_engines_agree_on_logits(name):
    """bf16 weights, prompts of 5 and 20 tokens (past gemma2's window 8):
    the overlay-served engine's logits equal plain serving's on every call,
    and so do the greedy streams."""
    _, tcfg = _configs(name, "bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, size=(n,)).tolist() for n in (5, PROMPT, 5)]
    runs = {}
    for tag, overlay in (("overlay", Overlay(3, 3)), ("plain", None)):
        engine = ServeEngine(params, tcfg, batch=2, max_len=MAX_LEN, overlay=overlay,
                             device="cpu")
        engine._prefill, engine._decode = _Logits(engine._prefill), _Logits(engine._decode)
        for rid, p in enumerate(prompts):
            engine.submit(Request(rid=rid, prompt=p, max_new_tokens=6))
        done = engine.run_until_drained()
        runs[tag] = ([r.out for r in sorted(done, key=lambda r: r.rid)],
                     engine._prefill.logits + engine._decode.logits)
    (s_ov, l_ov), (s_pl, l_pl) = runs["overlay"], runs["plain"]
    assert s_ov == s_pl and all(len(s) == 7 for s in s_ov)
    assert len(l_ov) == len(l_pl) == 3 + 12
    for a, b in zip(l_ov, l_pl):
        assert torch.equal(a, b)


def test_serve_launcher_cuts_depth_at_full_width(capsys):
    """``--layers N`` serves the first N layers of a config (here the smoke
    mistral, 1 of its 2), through the overlay, on the CPU."""
    from repro_torch.launch import serve as serve_cli

    assert serve_cli.main(["--arch", "mistral-large-123b", "--smoke", "--layers", "1",
                           "--overlay", "--requests", "2", "--batch", "2", "--max-new", "3",
                           "--prompt-len", "6", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2/2 requests" in out and "'downloads': 2" in out
    with pytest.raises(ValueError, match="whole number"):
        serve_cli.main(["--arch", "gemma2-27b", "--smoke", "--layers", "3", "--device", "cpu"])
