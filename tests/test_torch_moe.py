"""The mixture-of-experts FFN and granite-moe-1b-a400m in the port against
the JAX package.

The module (``models/moe.py``) runs on 24 flat tokens at d_model 64:
``router_topk`` with softmax and sigmoid scoring, and ``moe_fwd`` against
the reference's ``_moe_fwd_local`` at capacity factors 0.5, 1.0, 1.25 and
4.0 (so slots are dropped), with the full config's routing (32 experts,
top-8) and the smoke config's (4 experts, top-2), with and without a shared
expert, and with a zeroed router (every score equal: the reference picks
experts 0..k-1, so must the port).  The model runs at granite's smoke
config (d_model 64, 4 heads of 16, 2 ``moe`` layers, vocab 256), as it is
(4 experts, top-2, capacity factor 4.0) and with the full config's routing
(32 experts, top-8, capacity factor 1.25: at a decode of batch 2 the
capacity is 1, and a row loses every expert the other row also chose).
Everything is float32 unless a test says otherwise; parameters and inputs
are numpy draws from a seed, fed to the model through
``params.from_jax_numpy``.

Tolerances: ``_close_normwise`` (|got - want| <= rtol * max|want|) at 1e-5
where both sides are float32 throughout (other orders of f32 sums in the
products and the softmax); gates and the load-balance loss within rtol
1e-6; expert indices, token streams and traced-vs-eager outputs exactly.
The model's KV caches are bf16 in both packages: a key or value an f32 ulp
apart can round to the neighbouring bf16 (2^-8 relative) and move a logit
by ~1e-3, which the cached paths' tolerance (rtol = atol = 2e-3) allows
for.
"""

import dataclasses
import json
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
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core import Overlay
from repro_torch.core import interpreter as interp
from repro_torch.core.placement import PlacementPolicy, TileGrid, place
from repro_torch.core.store import BitstreamStore
from repro_torch.core.trace import trace_to_graph
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Request, ServeEngine

ARCH = "granite-moe-1b-a400m"
TOKENS, D = 24, 64
# the full config's routing at the smoke config's widths
FULL_ROUTING = dict(num_experts=32, experts_per_token=8, capacity_factor=1.25)
MAX_LEN = 32
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
    sum in another order scales with the size of the terms, not with each
    (possibly cancelled) result."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _module_cfg(e, k, cf, shared=0, scoring="softmax"):
    over = dict(d_model=D, num_experts=e, experts_per_token=k, moe_d_ff=32,
                capacity_factor=cf, num_shared_experts=shared, router_scoring=scoring,
                dtype="float32")
    return jax_get_config(ARCH).scaled(**over), get_config(ARCH).scaled(**over)


def _moe_params(cfg, seed, zero_router=False):
    """numpy draws for ``moe_spec(cfg)``: N(0, 1/fan_in) weights."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff

    def w(*shape):
        return (rng.standard_normal(shape) / math.sqrt(shape[-2])).astype(np.float32)

    p = {"router": np.zeros((d, e), np.float32) if zero_router else w(d, e),
         "w_gate": w(e, d, f), "w_up": w(e, d, f), "w_down": w(e, f, d)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs), "w_down": w(fs, d)}
    return p


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree))


def _tokens(seed=1, t=TOKENS, d=D):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)


def _dropped(idx: np.ndarray, e: int, cap: int) -> int:
    """Slots past the capacity: every expert keeps its first ``cap``."""
    counts = np.bincount(idx.reshape(-1), minlength=e)
    return int(np.maximum(counts - cap, 0).sum())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(list_archs()))
def test_configs_and_param_counts_are_the_references(name):
    """Every config the port registers, field by field, and the analytic
    total and active parameter counts (``configs/base.py``'s helpers)."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(smoke_config(name)) == dataclasses.asdict(jax_smoke_config(name))
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert set(list_archs()) <= set(jax_list_archs())


def test_granite_config_kinds_and_counts():
    """24 ``moe`` layers; 1.335 B parameters, 0.429 B active per token, and
    the port's spec tree holds as many as the reference's (which the
    analytic count equals for this family)."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert tparams.layer_kinds(cfg) == ["moe"] * 24
    assert tparams.layer_kinds(smoke_config(ARCH)) == ["moe"] * 2
    assert cfg.param_count() == 1_334_628_352
    assert cfg.active_param_count() == 428_658_688
    spec = tparams.model_spec(cfg)
    shapes = []
    tparams._map_spec(spec, lambda s: shapes.append((s.shape, s.dtype)))
    assert sum(math.prod(s) for s, _ in shapes) == jparams.count(jtfm.model_spec(jcfg)) == \
        cfg.param_count()
    ffn = spec["layers"][0]["ffn"]
    assert {k: v.shape for k, v in ffn.items()} == {
        "router": (1024, 32), "w_gate": (32, 1024, 512), "w_up": (32, 1024, 512),
        "w_down": (32, 512, 1024)}
    assert all(v.dtype == torch.bfloat16 for v in ffn.values())
    assert sorted(spec["layers"][0]) == ["attn", "ffn", "ln1", "ln2"]


# ---------------------------------------------------------------------------
# the module against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_router_topk_matches_jax(scoring):
    jcfg, tcfg = _module_cfg(32, 8, 1.25, scoring=scoring)
    logits = np.random.default_rng(3).standard_normal((TOKENS, 32)).astype(np.float32)
    jg, ji, ja = jmoe.router_topk(jnp.asarray(logits), jcfg)
    tg, ti, ta = tmoe.router_topk(torch.from_numpy(logits), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    assert tg.dtype == torch.float32 and tuple(ti.shape) == (TOKENS, 8)


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
def test_zeroed_router_picks_the_lowest_experts(scoring):
    """Every score equal: ``jax.lax.top_k`` takes experts 0..k-1 in order,
    and so does the port (``torch.topk`` promises no order for ties)."""
    jcfg, tcfg = _module_cfg(32, 8, 1.25, scoring=scoring)
    zeros = np.zeros((TOKENS, 32), np.float32)
    _, ji, ja = jmoe.router_topk(jnp.asarray(zeros), jcfg)
    tg, ti, ta = tmoe.router_topk(torch.from_numpy(zeros), tcfg)
    assert (np.asarray(ji) == np.arange(8)).all()
    assert (ti.numpy() == np.arange(8)).all()
    assert torch.equal(tg, torch.full((TOKENS, 8), 1 / 8))
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)


MOE_CASES = [(e, k, cf, shared) for e, k in ((32, 8), (4, 2))
             for cf in (0.5, 1.0, 1.25, 4.0) for shared in (0, 1)]


@pytest.mark.parametrize("e,k,cf,shared", MOE_CASES,
                         ids=[f"e{e}k{k}-cf{cf}-shared{s}" for e, k, cf, s in MOE_CASES])
def test_moe_fwd_matches_jax(e, k, cf, shared):
    """y and the load-balance loss of ``moe_fwd`` against the reference's
    ``_moe_fwd_local``; below capacity factor 4 slots are dropped."""
    jcfg, tcfg = _module_cfg(e, k, cf, shared)
    tree = _moe_params(jcfg, seed=e + k)
    jp, tp = _both(tree)
    x = _tokens()
    jy, ja = jmoe._moe_fwd_local(jp, jnp.asarray(x), jcfg)
    ty, ta = tmoe.moe_fwd(tp, torch.from_numpy(x), tcfg)
    _close_normwise(ty.numpy(), jy, TOL)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    idx = tmoe.router_topk(torch.from_numpy(x @ tree["router"]), tcfg)[1].numpy()
    dropped = _dropped(idx, e, int(TOKENS * k / e * cf) + 1)
    if cf <= 1.0:
        assert dropped > 0
    if cf == 4.0:
        assert dropped == 0


@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_fwd_with_a_zeroed_router_matches_jax(cf):
    """All scores tie: every token goes to experts 0..7, whose first
    ``cap`` slots (in token order) are kept; the rest drop."""
    jcfg, tcfg = _module_cfg(32, 8, cf)
    jp, tp = _both(_moe_params(jcfg, seed=7, zero_router=True))
    x = _tokens(seed=2)
    jy, _ = jmoe._moe_fwd_local(jp, jnp.asarray(x), jcfg)
    ty, _ = tmoe.moe_fwd(tp, torch.from_numpy(x), tcfg)
    _close_normwise(ty.numpy(), jy, TOL)
    cap = int(TOKENS * 8 / 32 * cf) + 1
    assert bool(ty[:cap].abs().amax(dim=1).gt(0).all())
    if cap < TOKENS:               # the later tokens have no expert left
        assert not ty[cap:].any()


def test_moe_fwd_combines_in_slot_order_in_bf16():
    """bf16 activations and weights: each token's k contributions are added
    from zeros one at a time, in slot order, each add rounded to bf16 — the
    sum the reference's scatter-add makes — so repeated calls agree bit for
    bit, and the port stays within one bf16 ulp of the reference's largest
    output."""
    jcfg, tcfg = _module_cfg(32, 8, 1.25)
    jcfg, tcfg = jcfg.scaled(dtype="bfloat16"), tcfg.scaled(dtype="bfloat16")
    tree = _moe_params(jcfg, seed=11)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    tp = pytree.tree_map(lambda a: torch.from_numpy(a).bfloat16(), tree)
    x = _tokens(seed=4)
    jy, _ = jmoe._moe_fwd_local(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    tx = torch.from_numpy(x).bfloat16()
    ty, _ = tmoe.moe_fwd(tp, tx, tcfg)
    assert ty.dtype == torch.bfloat16
    assert torch.equal(ty, tmoe.moe_fwd(tp, tx.clone(), tcfg)[0])
    _close_normwise(ty.float().numpy(), np.asarray(jy, np.float32), 2 ** -7)


# ---------------------------------------------------------------------------
# the model at the smoke config
# ---------------------------------------------------------------------------
def _configs(routing: str, dtype="float32"):
    over = dict(dtype=dtype, **(FULL_ROUTING if routing == "full" else {}))
    return jax_smoke_config(ARCH).scaled(**over), smoke_config(ARCH).scaled(**over)


def _leaf(rng, spec):
    if spec.init == "ones":
        return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    return (scale * rng.standard_normal(spec.shape)).astype(np.float32)


_MODELS = {}


def _models(routing):
    if routing not in _MODELS:
        jcfg, tcfg = _configs(routing)
        rng = np.random.default_rng(0)
        tree = jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(jcfg),
                            is_leaf=jparams.is_spec)
        _MODELS[routing] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                            tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32),
                            tree)
    return _MODELS[routing]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


ROUTINGS = ["smoke", "full"]


def test_from_jax_numpy_carries_every_leaf():
    """The reference's bf16 tree: each layer's router (d, E) and stacked
    experts (E, d, f) unstacked from (2, ...) exactly, in bf16, and no
    leaf aliased."""
    jcfg, tcfg = _configs("full", "bfloat16")
    jtree = jparams.init(jtfm.model_spec(jcfg), jax.random.PRNGKey(0))
    as_f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), jtree)
    tp = tparams.from_jax_numpy(as_f32, tcfg, "cpu")
    stack = as_f32["g0"]["layers"]["0:moe"]
    assert stack["ffn"]["w_gate"].shape == (2, 32, 64, 32)
    assert len(tp["layers"]) == 2
    for r, layer in enumerate(tp["layers"]):
        want, got = _flat(stack), _flat(layer)
        assert got.keys() == want.keys()
        for key, t in got.items():
            assert t.dtype == (torch.float32 if key.startswith("ln") else torch.bfloat16), key
            np.testing.assert_array_equal(t.float().numpy(), want[key][r], err_msg=key)
    leaves = pytree.tree_leaves(tp)
    assert len(leaves) == 2 * 10 + 2
    assert len({t.data_ptr() for t in leaves}) == len(leaves)
    assert tparams.count(tp) == sum(a.size for a in jax.tree.leaves(as_f32)) == \
        tcfg.param_count()


@pytest.mark.parametrize("routing", ROUTINGS)
def test_each_layer_matches_jax(routing):
    """Each ``moe`` layer alone, cache-free, on the same (2, 20, d) input:
    attention + the MoE FFN (its (B*S, d) flattening included)."""
    jcfg, tcfg, _, tp, tree = _models(routing)
    x = np.random.default_rng(5).standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    for li in range(2):
        jp = jax.tree.map(lambda a: jnp.asarray(a[li]), tree["g0"]["layers"]["0:moe"])
        jy, _, jaux = jtfm.layer_fwd(jp, jnp.asarray(x), "moe", jcfg, positions=jnp.arange(20))
        with torch.no_grad():
            ty, _, taux = tfm.layer_fwd(tp["layers"][li], torch.from_numpy(x), "moe", tcfg,
                                        positions=torch.arange(20), cache=None)
        _close_normwise(ty.numpy(), jy, TOL, f"layer {li}")
        np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("routing", ROUTINGS)
def test_cache_free_forward_logits_match_jax(routing):
    jcfg, tcfg, jp, tp, _ = _models(routing)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 21)).astype(np.int32)
    jh, _, _ = jtfm.forward(jp, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        th, _ = tfm.forward(tp, tcfg, torch.from_numpy(toks))
        got = tfm.unembed(tp, th, tcfg)
    _close_normwise(got.numpy(), jtfm.unembed(jp, jh, jcfg), 5e-5)


@pytest.mark.parametrize("routing", ROUTINGS)
def test_prefill_and_decode_logits_match_jax(routing):
    """A 20-token prefill of batch 2 (T = 40), then three uniform decodes
    and a ragged one at batch 2 (T = 2: with the full config's routing the
    capacity is 1, and the second row loses each expert the first also
    chose)."""
    jcfg, tcfg, jp, tp, _ = _models(routing)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 20)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, jcfg, jnp.asarray(toks), jmodel.init_cache(jcfg, 2, MAX_LEN))
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks),
                            tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **LOGIT_TOL)
    for i in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
        jd, jc = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        td, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), err_msg=f"decode {i}",
                                   **LOGIT_TOL)
    pos = np.array([22, 13], np.int32)
    jr, _ = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc, positions=jnp.asarray(pos))
    tr, _ = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                               positions=torch.from_numpy(pos))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), err_msg="ragged decode", **LOGIT_TOL)


def test_decode_capacity_drops_act_as_in_the_reference():
    """With the full config's routing a batch-2 decode has capacity
    int(2 * 8 / 32 * 1.25) + 1 = 1: both packages' decode logits move when
    the capacity factor is raised to 4 (nothing dropped), by as much."""
    jcfg, tcfg, jp, tp, _ = _models("full")
    assert int(2 * 8 / 32 * tcfg.capacity_factor) + 1 == 1
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    out = {}
    for cf in (1.25, 4.0):
        jc_, tc_ = jcfg.scaled(capacity_factor=cf), tcfg.scaled(capacity_factor=cf)
        _, jc = jmodel.prefill(jp, jc_, jnp.asarray(toks), jmodel.init_cache(jc_, 2, MAX_LEN))
        _, tc = tmodel.prefill(tp, tc_, torch.from_numpy(toks),
                               tmodel.init_cache(tc_, 2, MAX_LEN, "cpu"))
        nxt = toks[:, -1:]
        jd, _ = jmodel.decode_step(jp, jc_, jnp.asarray(nxt), jc)
        td, _ = tmodel.decode_step(tp, tc_, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), err_msg=f"cf {cf}", **LOGIT_TOL)
        out[cf] = (td.numpy(), np.asarray(jd))
    moved_t = np.abs(out[1.25][0] - out[4.0][0]).max()
    moved_j = np.abs(out[1.25][1] - out[4.0][1]).max()
    assert moved_t > 1e-2 and moved_j > 1e-2
    np.testing.assert_allclose(moved_t, moved_j, rtol=1e-2)


def _prompts(vocab, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).tolist() for n in (5, 12, 9)]


def _streams(engine, request_cls, prompts, max_new=4):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_new_tokens=max_new))
    done = engine.run_until_drained()
    return [r.out for r in sorted(done, key=lambda r: r.rid)]


@pytest.mark.parametrize("routing", ROUTINGS)
def test_engine_greedy_streams_match_jax_plain_and_through_the_overlay(routing):
    """``ServeEngine`` greedy streams, token for token: the JAX engine, the
    port's plainly and through the port's ``Overlay(3, 3)`` (every decode
    tick runs both slots, a dead one included, as the reference's does)."""
    jcfg, tcfg, jp, tp, _ = _models(routing)
    prompts = _prompts(jcfg.vocab_size)
    want = _streams(JServeEngine(jp, jcfg, batch=2, max_len=MAX_LEN), JRequest, prompts)
    plain = _streams(ServeEngine(tp, tcfg, batch=2, max_len=MAX_LEN, device="cpu"),
                     Request, prompts)
    ov = Overlay(3, 3)
    through = _streams(ServeEngine(tp, tcfg, batch=2, max_len=MAX_LEN, overlay=ov,
                                   device="cpu"), Request, prompts)
    assert plain == want and through == want
    assert all(len(s) == 5 for s in want)


@pytest.mark.parametrize("routing", ROUTINGS)
def test_traced_moe_layer_equals_eager_bit_for_bit(routing):
    """One bf16 ``moe`` layer through the port's ``Overlay.jit``: the same
    bits as the eager call, with the dispatch's sort, scatter and gather
    left as residue nodes."""
    _, tcfg = _configs(routing, "bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    layer = params["layers"][0]
    x = torch.randn(2, 9, tcfg.d_model, generator=torch.Generator().manual_seed(1)).bfloat16()

    def fn(p, h):
        return tfm.layer_fwd(p, h, "moe", tcfg, positions=torch.arange(h.shape[1]),
                             cache=None)[0]

    ov = Overlay(3, 3)
    f = ov.jit(fn, name="moe_layer")
    got = f(layer, x)
    with torch.no_grad():
        want = fn(layer, x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    (entry,) = f._entries.values()
    unmapped = set(entry.lowered.unmapped)
    assert {"sort.stable", "index_put.default", "index_add.default",
            "index_copy.default", "cumsum.default", "bmm.default"} <= unmapped


def test_moe_operators_round_trip_through_the_store_bit_identically():
    """The traced prefill and decode of the full-routing smoke model: every
    operator rebuilt from its serial form (``operator_from_desc`` through
    the store's pack and unpack) gives the same bits as the traced one."""
    _, tcfg, _, tp, _ = _models("full")
    cache = tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu")
    toks = torch.tensor([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], dtype=torch.int32)
    pos = torch.tensor([5, 5], dtype=torch.int32)
    cases = (("prefill", lambda p, t, c: tmodel.prefill(p, tcfg, t, c), (tp, toks, cache)),
             ("decode", lambda p, t, c, q: tmodel.decode_step(p, tcfg, t, c, positions=q),
              (tp, toks[:, :1], cache, pos)))
    targets = set()
    for name, fn, args in cases:
        lowered = trace_to_graph(fn, *args, name=f"granite.{name}")
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
    assert {"aten.sort.stable", "aten.index_put.default", "aten.index_add.default",
            "aten.index_copy.default", "aten.cumsum.default"} <= targets


def test_step_graph_matches_forward():
    """``build_step_graph`` (embed -> g0 -> head) on an all-LARGE overlay,
    at the dtype its abstract parameters take (bf16 weights, bf16
    activations): bit-identical to the port's forward + unembed, which the
    tests above hold to the JAX forward in float32."""
    jcfg, tcfg = _configs("full", "bfloat16")
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(jcfg), is_leaf=jparams.is_spec)
    tp = tparams.from_jax_numpy(tree, tcfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, size=(2, 16)).astype(np.int32))
    g = tmodel.build_step_graph(tcfg, (2, 16), "cpu")
    assert [n.name for n in g.op_nodes()] == [f"{ARCH}/embed", f"{ARCH}/g0", f"{ARCH}/head"]
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
