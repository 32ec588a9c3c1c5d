"""The hybrid zamba2-7b in the port against the JAX package: 68 mamba layers
at state 64 and 13 occurrences of ONE shared attention+MLP weight set, each
occurrence with its own KV cache.

The model is zamba2's smoke config (3 mamba layers, then (5 x mamba,
shared_attn) x 2: 15 layers, two occurrences of the shared set) at d_model
128 with its full config's state 64 and head dim 64 (4 heads), float32
unless a test says otherwise.  Parameters and inputs are numpy draws from a
seed fed to both packages (``params.from_jax_numpy``); the JAX side runs its
Pallas ``ssd_chunk`` and ``rmsnorm`` in interpret mode, as the JAX suite
does on the CPU, the port the kernels' plain versions.

Tolerances: ``_close_normwise`` (|got - want| <= rtol * max|want|, from
``test_torch_ssm.py``) where both sides are float32 throughout, and exact
equality for token streams.  The KV caches and the mamba conv caches are
bf16 in both packages: a value an f32 ulp apart can round to the
neighbouring bf16 (2^-8 relative), which the cached paths' tolerances
allow for.
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

from repro.configs.archs import smoke_config as jax_smoke_config
from repro.configs.base import get_config as jax_get_config
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import Overlay
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.loop import EventLoopEngine

ARCH = "zamba2-7b"
SMALL = dict(d_model=128, ssm_state=64, ssm_head_dim=64)
MAX_LEN = 24
SMOKE_KINDS = ["mamba"] * 3 + (["mamba"] * 5 + ["shared_attn"]) * 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _configs(dtype="float32"):
    return (jax_smoke_config(ARCH).scaled(dtype=dtype, **SMALL),
            smoke_config(ARCH).scaled(dtype=dtype, **SMALL))


def _leaf(rng, spec):
    """A numpy draw for one JAX ParamSpec: norm scales near 1, Mamba's
    ``a_log`` the log of U[1, 16], the zero-initialized biases small normal
    draws so that they are exercised."""
    if spec.init == "ones":
        return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    if spec.init == "ssm_a":
        return np.log(rng.uniform(1.0, 16.0, spec.shape)).astype(np.float32)
    if spec.init == "zeros":
        return (0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    return (scale * rng.standard_normal(spec.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def f32_models():
    jcfg, tcfg = _configs("float32")
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(jcfg),
                        is_leaf=jparams.is_spec)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32)
    return jcfg, tcfg, jp, tp, tree


def _close_normwise(got, want, rtol, what=""):
    """|got - want| <= rtol * max|want|, elementwise: the error of an f32
    sum in another order scales with the size of the terms, not with each
    (possibly cancelled) result."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _jax_caches(jcfg, caches):
    """The reference's stacked caches (``g<i>["<j>:<kind>"]``, one slice per
    repeat) as one numpy f32 tree per layer, in execution order."""
    out = []
    for gi, (unit, rep) in enumerate(jcfg.blocks):
        for r in range(rep):
            for j, kind in enumerate(unit):
                out.append(jax.tree.map(lambda a: np.asarray(a[r], np.float32),
                                        caches[f"g{gi}"][f"{j}:{kind}"]))
    return out


def _unstacked_leaves(jcfg, tree):
    """The leaves of the reference's tree with each stacked leaf counted
    once per repeat (a shared set once)."""
    def n(t):
        return len(jax.tree.leaves(t, is_leaf=jparams.is_spec))
    groups = [f"g{gi}" for gi in range(len(jcfg.blocks))]
    return (sum(n(v) for k, v in tree.items() if k not in groups)
            + sum(rep * n(tree[g]["layers"]) + n(tree[g].get("shared", {}))
                  for g, (_, rep) in zip(groups, jcfg.blocks)))


def _flat(tree, prefix=""):
    """A nested dict as {"attn/wq": leaf, ...}."""
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
def test_config_is_the_references():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == dataclasses.asdict(jax_smoke_config(ARCH))
    assert tparams.layer_kinds(get_config(ARCH)) == \
        ["mamba"] * 3 + (["mamba"] * 5 + ["shared_attn"]) * 13
    assert tparams.layer_kinds(_configs()[1]) == SMOKE_KINDS


def test_layer_plan_points_every_occurrence_at_its_groups_set():
    plan = tparams.layer_plan(get_config(ARCH))
    assert len(plan) == 81
    assert [w for k, w in plan if k == "shared_attn"] == ["g1"] * 13
    assert [w for k, w in plan if k == "mamba"] == list(range(68))
    assert [i for i, (k, _) in enumerate(plan) if k == "shared_attn"] == \
        [3 + 6 * r + 5 for r in range(13)]


def test_full_config_param_count_equals_the_reference_tree():
    """The shared set is held once: 5,622,728,000 parameters, the JAX tree's
    count.  The reference's analytic ``param_count`` leaves out each mamba
    layer's conv biases, ``dt_bias`` and gate norm, and nothing else."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    spec = tparams.model_spec(cfg)
    assert len(spec["layers"]) == 68 and list(spec["shared"]) == ["g1"]
    shapes = []
    tparams._map_spec(spec, lambda s: shapes.append(s.shape))
    n = sum(math.prod(s) for s in shapes)
    assert n == jparams.count(jtfm.model_spec(jcfg)) == 5_622_728_000
    d_inner = cfg.ssm_expand * cfg.d_model
    per_mamba = (d_inner + 2 * cfg.ssm_state) + d_inner // cfg.ssm_head_dim + d_inner
    assert per_mamba == 14_576
    assert n - jcfg.param_count() == 68 * per_mamba
    # the traced step's parameter inputs: each mamba layer's 17 leaves, the
    # shared set's 9 once, the embedding and the final norm
    assert len(pytree.tree_leaves(tparams.abstract(spec, "cpu"))) == 68 * 17 + 9 + 2 == \
        _unstacked_leaves(jcfg, jtfm.model_spec(jcfg))


def test_from_jax_numpy_carries_every_leaf_and_the_shared_set_once():
    jcfg, tcfg = _configs("bfloat16")
    jtree = jparams.init(jtfm.model_spec(jcfg), jax.random.PRNGKey(0))
    as_f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), jtree)
    tp = tparams.from_jax_numpy(as_f32, tcfg, "cpu")
    assert len(tp["layers"]) == 13 and list(tp["shared"]) == ["g1"]
    li = 0
    for gi, (unit, rep) in enumerate(tcfg.blocks):
        for r in range(rep):
            for j, kind in enumerate(unit):
                if kind == "shared_attn":
                    continue
                want = _flat(as_f32[f"g{gi}"]["layers"][f"{j}:{kind}"])
                got = _flat(tp["layers"][li])
                assert got.keys() == want.keys()
                for key, t in got.items():
                    np.testing.assert_array_equal(t.float().numpy(), want[key][r], err_msg=key)
                li += 1
    want = _flat(as_f32["g1"]["shared"]["shared_attn"])
    got = _flat(tp["shared"]["g1"])
    assert got.keys() == want.keys() and "g0" not in tp["shared"]
    for key, t in got.items():
        assert t.dtype == (torch.float32 if key.startswith("ln") else torch.bfloat16)
        np.testing.assert_array_equal(t.float().numpy(), want[key], err_msg=key)
    leaves = pytree.tree_leaves(tp)
    assert len(leaves) == _unstacked_leaves(jcfg, jtree) == 13 * 17 + 9 + 2
    assert len({t.data_ptr() for t in leaves}) == len(leaves)     # no aliases in the tree
    assert tparams.count(tp) == jparams.count(jtfm.model_spec(jcfg))


def test_occurrences_read_one_storage_and_keep_their_own_caches(monkeypatch):
    """Both occurrences of the smoke config read the shared set's own
    tensors (one ``data_ptr`` per weight), and after a prefill each has a
    KV cache of its own storage with its own contents."""
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    layer_fwd = tfm.layer_fwd

    def spy(p, x, kind, cfg, **kw):
        if kind == "shared_attn":
            seen.append({k: t.data_ptr() for k, t in _flat(p).items()})
        return layer_fwd(p, x, kind, cfg, **kw)

    monkeypatch.setattr(tfm, "layer_fwd", spy)
    shared = {k: t.data_ptr() for k, t in _flat(params["shared"]["g1"]).items()}
    toks = torch.randint(0, tcfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    caches = tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu")
    _, caches = tmodel.prefill(params, tcfg, toks, caches)
    with torch.no_grad():
        tfm.forward(params, tcfg, toks)
    assert seen == [shared] * 4                   # 2 occurrences x (prefill, cache-free)
    kv = [c for kind, c in zip(SMOKE_KINDS, caches) if kind == "shared_attn"]
    assert len(kv) == 2 and kv[0] is not kv[1]
    assert kv[0]["k"].data_ptr() != kv[1]["k"].data_ptr()
    assert all(int(c["index"]) == 9 for c in kv)
    assert not torch.equal(kv[0]["k"][:, :, :9], kv[1]["k"][:, :, :9])
    assert not kv[0]["k"][:, :, 9:].any() and not kv[1]["v"][:, :, 9:].any()


def test_perturbing_the_shared_set_moves_every_occurrence():
    """Doubling the shared ``wq`` changes each occurrence's attention output
    on the same input: every occurrence reads the perturbed tensor."""
    _, tcfg = _configs("float32")
    params = tparams.init(tcfg, torch.Generator().manual_seed(2), "cpu")
    params = pytree.tree_map(lambda t: t.float(), params)
    x = torch.randn(2, 9, tcfg.d_model, generator=torch.Generator().manual_seed(3))
    pos = torch.arange(9)
    plan = tparams.layer_plan(tcfg)
    occ = [where for kind, where in plan if kind == "shared_attn"]

    def outs(p):
        return [tfm.layer_fwd(tparams.layer_params(p, w), x, "shared_attn", tcfg,
                              positions=pos, cache=None)[0] for w in occ]

    before = outs(params)
    moved = dict(params, shared={"g1": dict(params["shared"]["g1"])})
    moved["shared"]["g1"]["attn"] = dict(params["shared"]["g1"]["attn"])
    moved["shared"]["g1"]["attn"]["wq"] = params["shared"]["g1"]["attn"]["wq"] * 2
    after = outs(moved)
    assert len(before) == 2 and torch.equal(before[0], before[1])
    assert all(not torch.allclose(a, b) for a, b in zip(before, after))


def test_current_index_is_the_first_shared_attn_occurrence():
    """The shared decode position is layer 8's cache index (the first
    attention layer; mamba layers keep none)."""
    _, tcfg = _configs("bfloat16")
    caches = tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu")
    assert [i for i, c in enumerate(caches) if "index" in c] == [8, 14]
    caches[8]["index"] = torch.tensor(5, dtype=torch.int32)
    caches[14]["index"] = torch.tensor(7, dtype=torch.int32)
    assert int(tmodel._current_index(tcfg, caches)) == 5
    full = tmodel.init_cache(get_config(ARCH).scaled(d_model=128, d_ff=128, num_heads=4,
                                                     num_kv_heads=4, head_dim=32),
                             1, 8, "cpu")
    assert [i for i, c in enumerate(full) if "index" in c] == [3 + 6 * r + 5 for r in range(13)]
    assert len({id(c) for c in full}) == 81


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
# cache-free forward, f32 throughout (no cache): other orders of f32 sums,
# compounded through 15 layers (the largest seen is 1.4e-5 of the largest
# logit; 1e-5 held for mamba2's 2 layers)
FREE_TOL = 5e-5
# cached paths: the bf16 KV and conv caches may round an f32-ulp difference
# to the neighbouring bf16 (2^-8 relative), in both packages
CACHE_TOL = 2 ** -8
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)


def test_cache_free_forward_logits_match_jax(f32_models):
    """21 tokens: two full chunks of 8 and a padded one in every mamba
    layer, the flash op's plain version in both shared_attn occurrences."""
    jcfg, tcfg, jp, tp, _ = f32_models
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 21)).astype(np.int32)
    jh, _, _ = jtfm.forward(jp, jcfg, jnp.asarray(toks))
    want = jtfm.unembed(jp, jh, jcfg)
    with torch.no_grad():
        th, none = tfm.forward(tp, tcfg, torch.from_numpy(toks))
        got = tfm.unembed(tp, th, tcfg)
    assert none is None
    _close_normwise(got.numpy(), want, FREE_TOL)


def test_prefill_caches_and_decodes_match_jax(f32_models):
    """A 13-token prefill (a chunk and a padded one): its logits and every
    cache — each occurrence's KV, each mamba layer's conv windows and SSD
    state — then three decode steps."""
    jcfg, tcfg, jp, tp, _ = f32_models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, jcfg, jnp.asarray(toks), jmodel.init_cache(jcfg, 2, MAX_LEN))
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks),
                            tmodel.init_cache(tcfg, 2, MAX_LEN, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    want = _jax_caches(jcfg, jc)
    assert len(want) == len(tc) == len(SMOKE_KINDS)
    for li, (kind, got, w) in enumerate(zip(SMOKE_KINDS, tc, want)):
        if kind == "shared_attn":
            assert int(got["index"]) == int(w["index"]) == 13
            for key in ("k", "v"):
                assert got[key].dtype == torch.bfloat16
                _close_normwise(got[key].float().numpy(), w[key], CACHE_TOL, f"layer {li} {key}")
        else:
            for key in ("x", "b", "c"):
                _close_normwise(got["conv"][key].float().numpy(), w["conv"][key], CACHE_TOL,
                                f"layer {li} conv {key}")
            _close_normwise(got["ssm"].numpy(), w["ssm"], CACHE_TOL, f"layer {li} ssm")
    for step in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
        jd, jc = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        td, tc = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), err_msg=f"decode {step}",
                                   **LOGIT_TOL)
    assert all(int(c["index"]) == 16 for kind, c in zip(SMOKE_KINDS, tc) if kind != "mamba")


def test_loss_and_grads_match_jax(f32_models):
    """The cache-free forward under autograd (each layer rematerialized):
    the loss within rtol 1e-5, and every gradient — the shared set's is the
    sum over both occurrences in both packages — within 2e-3 of each leaf's
    largest.  The backward's f32 sums in other orders compound through the
    layers above a leaf: mamba2's 2 layers hold 1e-4, here the shared set
    holds 1.2e-4 and the first layers' B/C projections, under 12 more
    layers, 9e-4."""
    jcfg, tcfg, _, _, tree = f32_models
    batch = jpipe.make_batch(jcfg, 2, 16, step=3, seed=1)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), batch, jcfg)
    tp = tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, _, grads, spec = train_cli._loss_and_grads(tcfg, tp, tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = tparams.from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                  dtype=torch.float32)
    got = pytree.tree_unflatten(grads, spec)
    assert got["shared"]["g1"]["attn"]["wq"].abs().max() > 0
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        _close_normwise(g.numpy(), w.numpy(), 2e-3)


def _prompts(vocab, seed=2):
    rng = np.random.default_rng(seed)
    # a ragged chunk (5), one chunk plus a padded tail (12), two chunks (16)
    return [rng.integers(0, vocab, size=(n,)).tolist() for n in (5, 12, 16)]


def _streams(engine, request_cls, prompts, max_new=4):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_new_tokens=max_new))
    done = engine.run_until_drained()
    return [r.out for r in sorted(done, key=lambda r: r.rid)]


def test_engine_greedy_streams_match_jax_plain_and_through_the_overlay(f32_models):
    """``ServeEngine`` greedy streams, token for token: the JAX engine, the
    port's plainly and through the port's ``Overlay(3, 3)``."""
    jcfg, tcfg, jp, tp, _ = f32_models
    prompts = _prompts(jcfg.vocab_size)
    want = _streams(JServeEngine(jp, jcfg, batch=2, max_len=MAX_LEN), JRequest, prompts)
    plain = _streams(ServeEngine(tp, tcfg, batch=2, max_len=MAX_LEN, device="cpu"),
                     Request, prompts)
    ov = Overlay(3, 3)
    through = _streams(ServeEngine(tp, tcfg, batch=2, max_len=MAX_LEN, overlay=ov,
                                   device="cpu"), Request, prompts)
    assert plain == want and through == want
    assert all(len(s) == 5 for s in want)


def test_traced_decode_takes_the_shared_set_once():
    """The overlay's traced decode step has one graph input per parameter
    leaf — the shared set's tensors once, not once per occurrence — and
    both occurrences' products read those inputs."""
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    ov = Overlay(3, 3)
    engine = ServeEngine(params, tcfg, batch=2, max_len=MAX_LEN, overlay=ov, device="cpu")
    _streams(engine, Request, _prompts(tcfg.vocab_size, seed=4)[:1], max_new=2)
    (entry,) = engine._decode._entries.values()
    graph = entry.lowered.graph
    n_params = len(pytree.tree_leaves(params))
    assert n_params == len(pytree.tree_leaves(tparams.model_spec(tcfg)))
    wq = next(i for i, t in enumerate(pytree.tree_leaves(params))
              if t is params["shared"]["g1"]["attn"]["wq"])
    caches = pytree.tree_leaves(engine.caches)
    # inputs: the parameters, the tokens, the caches, the positions
    assert len(graph.input_ids) == n_params + 1 + len(caches) + 1
    assert graph.nodes[graph.input_ids[wq]].aval.shape == (tcfg.d_model, 4 * 16)
    readers = [nd.name for nd in graph.nodes if graph.input_ids[wq] in nd.inputs]
    assert readers == ["aten[mm.default]"] * 2


def test_step_graph_matches_jax_forward(f32_models):
    """``build_step_graph`` (embed -> g0 -> g1 -> head) assembled on an
    all-LARGE overlay: bit-identical to the port's forward + unembed, and
    within the cache-free tolerance of the JAX forward's logits."""
    jcfg, tcfg, jp, tp, _ = f32_models
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    g = tmodel.build_step_graph(tcfg, (2, 16), "cpu")
    assert [n.name for n in g.op_nodes()] == [f"{ARCH}/embed", f"{ARCH}/g0", f"{ARCH}/g1",
                                              f"{ARCH}/head"]
    acc = Overlay(3, 3, large_fraction=1.0).assemble(g)
    got = acc(tp, torch.from_numpy(toks))
    with torch.no_grad():
        h, _ = tfm.forward(tp, tcfg, torch.from_numpy(toks))
        assert torch.equal(got, tfm.unembed(tp, h, tcfg))
    jh, _, _ = jtfm.forward(jp, jcfg, jnp.asarray(toks))
    _close_normwise(got.numpy(), jtfm.unembed(jp, jh, jcfg), FREE_TOL)


def test_event_loop_refuses_zamba2():
    """The reference's padded-chunk fault (ROADMAP queue 3 item 1): the
    padded tokens would advance the mamba layers' state, so the event loop
    refuses zamba2 as it refuses every config with mamba layers."""
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="mamba"):
        EventLoopEngine(params, tcfg, batch=2, max_len=MAX_LEN, device="cpu")


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
