"""The sharded serve steps (``launch/steps.py``: ``shard_serve_state``,
``make_sharded_prefill_step``, ``make_sharded_serve_step``) and what they
run on DTensors (``models/layers.py``: the cached attention per shard, the
sequence-sharded cache's split softmax; ``set_attn_impl`` with the chunked
attention), against the port's single-device steps and the JAX package's.

The steps: on gloo ranks on the CPU (``tests/torch_ranks.py``), the dense
family's smoke configs (phi3, minicpm, gemma2, mistral) with float32
weights and bf16 caches, a prefill of 10 tokens into caches of 16, then 3
decodes, batch 4, on ``(data 2, model 2)`` (4 ranks) and ``(pod 2, data
2, model 2)`` (8 ranks; phi3), under ``DEFAULT_RULES``, ``NO_FSDP_RULES``
and ``SERVE_RULES``.  Two odd configs (phi3 and gemma2 with 6 query heads
over 3 kv heads, gemma2's window 4) have kv heads that divide no model
axis of 2, so ``SERVE_RULES`` shards the caches' ``seq`` dim: the prompt
crosses the two slices, the decodes write into the second.  Held to the
port's single-device ``make_prefill_step``/``make_serve_step`` on the same
numpy-seeded weights and tokens, and to the JAX package's unsharded ones.

Tolerances (a sharded contraction sums in another order; a k or v entry
then rounds to bf16 across a step now and then, and the probabilities are
rounded to bf16 as the reference does):
* logits of every call: within 1e-3 of the call's largest |logit| (the
  sharded steps against the single-device ones; seen up to 2.4e-4) and
  within 2e-3 (the port against the JAX package);
* caches: every k and v entry within one bf16 step at the leaf's largest
  |entry| (2^-7 of it: an entry feeds on the rounded probabilities of the
  layers below it), the index exactly;
* the split softmax directly, and the chunked attention against the JAX
  package's: within 2^-7 of the largest |output| (bf16 outputs), the
  written caches exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs.archs import smoke_config as jax_smoke_config
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro_torch import sharding as shd
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import steps
from repro_torch.models import layers
from tests.torch_ranks import (ODD, SERVE_BATCH, SERVE_MAX_LEN, SERVE_RULE_SETS, SPLIT_CASES,
                               serve_ranks, serve_tokens, spawn)

DENSE = ("phi3-mini-3.8b", "minicpm-2b", "gemma2-27b", "mistral-large-123b")
REFUSED = {"granite-moe-1b-a400m": "MoE", "deepseek-v3-671b": "MLA",
           "mamba2-130m": "mamba/hybrid", "zamba2-7b": "mamba/hybrid",
           "seamless-m4t-medium": "encoder-decoder", "pixtral-12b": "vlm"}
FOUR = [(arch, False) for arch in DENSE] + [("phi3-mini-3.8b", True), ("gemma2-27b", True)]
EIGHT = [("phi3-mini-3.8b", False), ("phi3-mini-3.8b", True)]
LOGITS_TOL, JAX_LOGITS_TOL = 1e-3, 2e-3
BF16_STEP = 2.0 ** -7


def _leaf(rng, spec):
    if spec.init == "ones":
        return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    return (scale * rng.standard_normal(spec.shape)).astype(np.float32)


def _jax_cfg(arch: str, odd: bool):
    cfg = jax_smoke_config(arch).scaled(dtype="float32")
    return cfg.scaled(**ODD) if odd else cfg


def _tree(arch: str, odd: bool) -> dict:
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(_jax_cfg(arch, odd)),
                        is_leaf=jparams.is_spec)


def _split_arrays() -> list:
    """q, new k/v and the cache's k/v of each split case, bf16 values."""
    rng = np.random.default_rng(2)
    bf16 = lambda *s: np.asarray(torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).bfloat16().float())
    return [(bf16(2, 4, sq, 16), bf16(2, 2, sq, 16), bf16(2, 2, sq, 16),
             bf16(2, 2, smax, 16), bf16(2, 2, smax, 16))
            for sq, smax, *_ in SPLIT_CASES]


def _grad_arrays() -> tuple:
    """q, k and v projections (B 2, S 1024, H * 16), 4 query heads over 2
    kv heads, float32."""
    rng = np.random.default_rng(6)
    return tuple(rng.standard_normal((2, 1024, h * 16)).astype(np.float32) for h in (4, 2, 2))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    cases = [(a, odd, _tree(a, odd)) for a, odd in FOUR]
    return spawn(4, serve_ranks, tmp_path_factory.mktemp("four"), (2, 2), ("data", "model"),
                 cases, _split_arrays(), _grad_arrays(), time_limit=300)


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    cases = [(a, odd, _tree(a, odd)) for a, odd in EIGHT]
    return spawn(8, serve_ranks, tmp_path_factory.mktemp("eight"), (2, 2, 2),
                 ("pod", "data", "model"), cases, time_limit=300)


def _jax_layers(caches, jcfg) -> list:
    """The reference's cache tree (``g<i>["<j>:<kind>"]`` stacks) as the
    port's leaves: each layer's k, v and index, in execution order."""
    out = []
    for gi, (unit, rep) in enumerate(jcfg.blocks):
        for r in range(rep):
            for j, kind in enumerate(unit):
                c = caches[f"g{gi}"][f"{j}:{kind}"]
                out += [np.asarray(c[n][r].astype(jnp.float32)) for n in ("k", "v", "index")]
    return out


@pytest.fixture(scope="module")
def jax_serve():
    """The JAX package's unsharded prefill and decodes per case: each
    call's logits and caches as the port's leaves."""
    out = {}
    for arch, odd in FOUR:
        jcfg = _jax_cfg(arch, odd)
        params = jax.tree.map(jnp.asarray, _tree(arch, odd))
        prompt, nxt = serve_tokens(jcfg.vocab_size)
        caches = jmodel.init_cache(jcfg, SERVE_BATCH, SERVE_MAX_LEN)
        calls = [jsteps.make_prefill_step(jcfg)(params, jnp.asarray(prompt), caches, {})]
        serve = jsteps.make_serve_step(jcfg)
        for tok in nxt:
            calls.append(serve(params, jnp.asarray(tok), calls[-1][1]))
        out[(arch, odd)] = [(np.asarray(lg, np.float32), _jax_layers(c, jcfg))
                            for lg, c in calls]
    return out


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _hold(got: list, want: list, logits_tol: float, what: str) -> None:
    """Each call's logits and cache leaves (k, v, index a layer) within the
    stated tolerances."""
    assert len(got) == len(want) == 4, what
    for i, ((lg, cg), (lw, cw)) in enumerate(zip(got, want)):
        lg, lw = _np(lg), _np(lw)
        assert lg.shape == lw.shape, what
        np.testing.assert_allclose(lg, lw, rtol=0, atol=logits_tol * np.abs(lw).max(),
                                   err_msg=f"{what} call {i} logits")
        assert len(cg) == len(cw), what
        for j, (a, b) in enumerate(zip(cg, cw)):
            a, b = _np(a), _np(b)
            if j % 3 == 2:
                assert a == b, f"{what} call {i} layer {j // 3} index"
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=BF16_STEP * np.abs(b).max(),
                                           err_msg=f"{what} call {i} leaf {j}")


def _case(results, arch, odd, rules) -> dict:
    return results[0]["serve"][(arch, odd, rules)]


@pytest.mark.parametrize("rules", SERVE_RULE_SETS)
@pytest.mark.parametrize("arch,odd", FOUR)
def test_sharded_serve_matches_single_device_on_four_ranks(four_ranks, arch, odd, rules):
    c = _case(four_ranks, arch, odd, rules)
    _hold(c["sharded"], c["single"], LOGITS_TOL, f"{arch} odd={odd} {rules}")


@pytest.mark.parametrize("rules", SERVE_RULE_SETS)
@pytest.mark.parametrize("arch,odd", EIGHT)
def test_sharded_serve_matches_single_device_on_eight_ranks(eight_ranks, arch, odd, rules):
    c = _case(eight_ranks, arch, odd, rules)
    _hold(c["sharded"], c["single"], LOGITS_TOL, f"{arch} odd={odd} {rules}")


@pytest.mark.parametrize("arch,odd", FOUR)
def test_single_device_serve_matches_the_jax_steps(four_ranks, jax_serve, arch, odd):
    """The port's single-device prefill and decodes against the JAX
    package's ``make_prefill_step``/``make_serve_step``."""
    _hold(_case(four_ranks, arch, odd, "default")["single"], jax_serve[(arch, odd)],
          JAX_LOGITS_TOL, arch)


@pytest.mark.parametrize("rules", SERVE_RULE_SETS)
@pytest.mark.parametrize("arch,odd", FOUR)
def test_sharded_serve_matches_the_jax_steps(four_ranks, jax_serve, arch, odd, rules):
    _hold(_case(four_ranks, arch, odd, rules)["sharded"], jax_serve[(arch, odd)],
          JAX_LOGITS_TOL, f"{arch} odd={odd} {rules}")


@pytest.mark.parametrize("rules", SERVE_RULE_SETS)
@pytest.mark.parametrize("arch,odd", EIGHT)
def test_eight_rank_serve_matches_the_jax_steps(eight_ranks, jax_serve, arch, odd, rules):
    _hold(_case(eight_ranks, arch, odd, rules)["sharded"], jax_serve[(arch, odd)],
          JAX_LOGITS_TOL, f"{arch} odd={odd} {rules}")


@pytest.mark.parametrize("ranks", ["four_ranks", "eight_ranks"])
def test_every_leaf_stays_at_its_cell_placement(request, ranks):
    """On every rank, after ``shard_serve_state`` and after every call,
    every cache leaf is a DTensor on the mesh at its ``serve_shardings``
    placement, and the logits are at the cell's out-sharding."""
    results = request.getfixturevalue(ranks)
    for rank in results:
        for key, case in rank["serve"].items():
            assert case["placed"] == [True] * 5, key
            assert case["logits_placed"], key
            # each step builds its shardings once, not on every call
            assert case["built"] == ["prefill", "decode"], key


@pytest.mark.parametrize("ranks", ["four_ranks", "eight_ranks"])
def test_serve_rules_shard_the_cache_seq_where_kv_heads_do_not_divide(request, ranks):
    """The odd configs' 3 kv heads divide no model axis of 2: under
    ``SERVE_RULES`` the caches' seq dim takes ``model``; under the other
    rule sets it stays whole.  The smoke configs' 4 kv heads take it."""
    for (arch, odd, rules), case in request.getfixturevalue(ranks)[0]["serve"].items():
        k = case["placements"][0]           # the first layer's k; "model" is the last mesh dim
        if odd:
            assert k[-1] == str(Shard(2) if rules == "serve" else Replicate()), (arch, rules, k)
        else:
            assert k[-1] == str(Shard(1)), (arch, rules, k)
        assert all(p == str(Shard(0)) for p in k[:-1]), (arch, rules, k)


@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_split_softmax_on_a_seq_sharded_cache(four_ranks, case):
    """``_sharded_cached_attention`` with each rank holding half the keys
    (``SPLIT_CASES``: a decode, a windowed and softcapped prefill across
    the slices, and the chunked prefill with and without them) against
    the single-device write and attention on the whole tensors."""
    r = four_ranks[0]["split"][case]
    assert r["placements"] == (str(Shard(0)), str(Shard(2)))
    (o, k, v), (wo, wk, wv) = r["got"], r["want"]
    assert torch.equal(k, wk) and torch.equal(v, wv)
    torch.testing.assert_close(o.float(), wo.float(), rtol=0,
                               atol=BF16_STEP * wo.float().abs().max().item())


@pytest.mark.parametrize("mode", ["plain", "chunked"])
def test_cache_free_attention_per_shard_with_one_kv_head_a_rank(four_ranks, mode):
    """``multihead_attention`` under ``"plain"`` and ``"chunked"`` on
    DTensors with one kv head a rank, from head-split projections as the
    model makes them: the output and every projection's gradient within
    1e-5 of the largest |entry| of the single-device ones (float32)."""
    r = four_ranks[0]["grads"][mode]
    for got, want, what in zip(r["got"], r["want"], ("out", "dq", "dk", "dv")):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item(),
                                   msg=what)


# ---------------------------------------------------------------------------
# the attention implementations against the JAX package's
# ---------------------------------------------------------------------------
def _qkv(seed: int, b: int, hq: int, hkv: int, sq: int, sk: int, d: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


OPTS = [dict(causal=True, window=None, softcap=None), dict(causal=True, window=300, softcap=30.0),
        dict(causal=False, window=None, softcap=None)]


@pytest.mark.parametrize("opts", range(len(OPTS)))
@pytest.mark.parametrize("impl,jimpl", [("chunked", "xla_chunked"), ("plain", "xla")])
def test_multihead_attention_matches_the_jax_dispatcher(impl, jimpl, opts):
    """``multihead_attention`` under ``set_attn_impl(impl)`` against the
    JAX package's under ``set_attn_impl(jimpl)``, bf16 q/k/v of 1024 keys
    (the chunked gate), 4 query heads over 2 kv heads; the JAX module's
    mode is put back in a ``finally`` (xdist workers share it)."""
    arrays = _qkv(3, 1, 4, 2, 1024, 1024, 16)
    kw = dict(OPTS[opts], scale=0.25)
    before_port, before_jax = layers.ATTN_IMPL, jlayers.ATTN_IMPL
    try:
        layers.set_attn_impl(impl)
        jlayers.set_attn_impl(jimpl)
        got = layers.multihead_attention(*(torch.from_numpy(a).bfloat16() for a in arrays), **kw)
        want = jlayers.multihead_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrays), **kw)
    finally:
        layers.set_attn_impl(before_port)
        jlayers.set_attn_impl(before_jax)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_STEP * np.abs(want).max())


@pytest.mark.parametrize("opts", range(len(OPTS)))
def test_chunked_attention_matches_the_jax_scan(opts):
    """``_attention_chunked`` against ``_attention_xla_chunked`` at key
    blocks of 16: cache-free, and a cached prefill of 24 queries at
    position 40 of 96 keys (``q_offset``/``kv_len``)."""
    kw = dict(OPTS[opts], scale=0.25, block=16)
    for q_offset, kv_len, (sq, sk) in ((0, None, (64, 64)), (40, 64, (24, 96))):
        arrays = _qkv(4, 2, 4, 2, sq, sk, 16)
        got = layers._attention_chunked(*(torch.from_numpy(a).bfloat16() for a in arrays),
                                        q_offset=q_offset, kv_len=kv_len, **kw)
        want = jlayers._attention_xla_chunked(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                                              q_offset=q_offset, kv_len=kv_len, **kw)
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=BF16_STEP * np.abs(want).max())


def test_set_attn_impl_takes_the_ports_names_only():
    for name in ("pallas", "xla", "xla_chunked", "dense"):
        with pytest.raises(ValueError, match="flash"):
            layers.set_attn_impl(name)
    assert layers.ATTN_IMPL == "flash"


def test_chunked_mode_takes_the_cached_prefill_where_the_cache_is_chunk_long():
    """Under ``"chunked"`` a cached prefill (S > 1) over a cache whose
    length is a multiple of 1024 runs the chunked attention, a decode and
    a shorter cache the plain one, as the reference's gate
    (``repro/models/layers.py:338-346``)."""
    cfg = smoke_config("phi3-mini-3.8b")
    from repro_torch.models import model as tmodel
    from repro_torch.models import params as pm
    params = pm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 9), generator=torch.Generator().manual_seed(1))
    calls = []
    real = layers._attention_chunked

    def counted(*args, **kwargs):
        calls.append(args[1].shape[2])
        return real(*args, **kwargs)

    before = layers.ATTN_IMPL
    layers._attention_chunked = counted
    try:
        layers.set_attn_impl("chunked")
        for max_len in (1024, 1000):
            _, c = tmodel.prefill(params, cfg, toks, tmodel.init_cache(cfg, 1, max_len, "cpu"))
            tmodel.decode_step(params, cfg, toks[:, :1], c)
    finally:
        layers._attention_chunked = real
        layers.set_attn_impl(before)
    assert calls == [1024] * cfg.num_layers


# ---------------------------------------------------------------------------
# the refusals and the shardings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(REFUSED))
def test_sharded_serve_steps_refuse_the_other_families(arch):
    """MoE, MLA, mamba/hybrid, the encoder-decoder and the vlm are refused
    by name by every sharded serve entry, before any mesh is read."""
    cfg = smoke_config(arch)
    for build in (lambda: steps.make_sharded_prefill_step(cfg, mesh=None),
                  lambda: steps.make_sharded_serve_step(cfg, mesh=None),
                  lambda: steps.shard_serve_state(cfg, {}, [], None)):
        with pytest.raises(NotImplementedError, match="sharded steps") as err:
            build()
        assert REFUSED[arch] in str(err.value)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_shardings_are_the_cells(arch):
    """``serve_shardings`` at a cell's batch and length is ``cell_shardings``
    of the prefill and decode cells."""
    cfg = get_config(arch)
    sizes = {"data": 16, "model": 16}
    for shape in ("prefill_32k", "decode_32k"):
        info = steps.SHAPES[shape]
        assert steps.serve_shardings(cfg, info["kind"], info["batch"], info["seq"], sizes,
                                     shd.SERVE_RULES) == \
            steps.cell_shardings(cfg, shape, sizes, shd.SERVE_RULES)
