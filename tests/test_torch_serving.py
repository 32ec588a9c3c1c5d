"""The port's dense model and serving engine against the JAX package.

A phi3-mini config cut to d_model 128 (so the rmsnorm kernel path is taken
on both sides: ``repro/models/layers.py:74``), 2 layers, 4 heads of 32.
Parameters and prompts are made from a seed with numpy and fed to both
packages; the JAX side runs its Pallas rmsnorm in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models.transformer import model_spec as jax_model_spec
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.core import Overlay
from repro_torch.kernels import rmsnorm as trn
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as tfm
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.serving.engine import Request, ServeEngine

SMALL = dict(d_model=128, head_dim=32)
NORMS_PER_CALL = 2 * 2 + 1          # ln1 + ln2 per layer, plus final_norm


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _configs(dtype="float32"):
    return (jax_smoke_config("phi3-mini-3.8b").scaled(dtype=dtype, **SMALL),
            smoke_config("phi3-mini-3.8b").scaled(dtype=dtype, **SMALL))


def _numpy_params(jcfg, seed=0):
    """The JAX parameter tree's structure, filled with numpy draws."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        if spec.init == "ones":
            return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None else fan_in ** -0.5
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    return jax.tree.map(leaf, jax_model_spec(jcfg), is_leaf=jparams.is_spec)


@pytest.fixture(scope="module")
def f32_models():
    jcfg, tcfg = _configs("float32")
    tree = _numpy_params(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32)
    return jcfg, tcfg, jp, tp


# Logit tolerance, float32 models: everything is f32 except the KV cache,
# which is bf16 in both packages.  A key or value that differs by an f32 ulp
# can round to the neighbouring bf16 (2^-8 relative); through the softmax
# that moves a logit by ~1e-3 at these widths.
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)


def test_prefill_and_decode_logits_match_jax(f32_models):
    jcfg, tcfg, jp, tp = f32_models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, jcfg, jnp.asarray(toks), jmodel.init_cache(jcfg, 2, 24))
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks),
                            tmodel.init_cache(tcfg, 2, 24, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    nxt = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
    # uniform decode (shared cache index) and ragged decode (per-row positions)
    jd, _ = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
    td, _ = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **LOGIT_TOL)
    pos = np.array([9, 4], np.int32)
    jr, _ = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc, positions=jnp.asarray(pos))
    tr, _ = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                               positions=torch.from_numpy(pos))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **LOGIT_TOL)


def _prompts(vocab, seed=2):
    rng = np.random.default_rng(seed)
    # ragged prompt lengths: co-resident slots decode at their own positions
    return [rng.integers(0, vocab, size=(n,)).tolist() for n in (5, 9, 7)]


def _streams(engine, request_cls, prompts, max_new=4):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_new_tokens=max_new))
    done = engine.run_until_drained()
    return [r.out for r in sorted(done, key=lambda r: r.rid)]


def test_engine_greedy_streams_match_jax(f32_models):
    jcfg, tcfg, jp, tp = f32_models
    prompts = _prompts(jcfg.vocab_size)
    want = _streams(JServeEngine(jp, jcfg, batch=2, max_len=24), JRequest, prompts)
    plain = _streams(ServeEngine(tp, tcfg, batch=2, max_len=24, device="cpu"),
                     Request, prompts)
    served = _streams(ServeEngine(tp, tcfg, batch=2, max_len=24, overlay=Overlay(3, 3),
                                  device="cpu"), Request, prompts)
    assert plain == want
    assert served == want


class _Calls:
    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *args):
        self.n += 1
        return self.fn(*args)


def test_overlay_and_plain_engine_streams_match(monkeypatch):
    """The port's counterpart of the reference's ``--overlay`` cross-check:
    overlay-served and plain-served greedy streams are identical (bf16
    weights), and the rmsnorm custom op runs once per norm call — the
    overlay's trace sees it as one node and never runs it."""
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    calls = {"n": 0}
    plain_rms = trn.plain

    def counted(x, w, *, eps=1e-6):
        calls["n"] += 1
        return plain_rms(x, w, eps=eps)

    monkeypatch.setattr(trn, "plain", counted)
    prompts = _prompts(tcfg.vocab_size, seed=3)
    streams = {}
    for name, overlay in (("overlay", Overlay(3, 3)), ("plain", None)):
        engine = ServeEngine(params, tcfg, batch=2, max_len=24, overlay=overlay,
                             device="cpu")
        engine._prefill, engine._decode = _Calls(engine._prefill), _Calls(engine._decode)
        calls["n"] = 0
        streams[name] = _streams(engine, Request, prompts, max_new=5)
        steps = engine._prefill.n + engine._decode.n
        assert calls["n"] == NORMS_PER_CALL * steps, name
        if overlay is not None:
            desc = overlay.describe()
            assert desc["traces"] == desc["downloads"] == 4   # 3 prompt lengths + decode
            routes = [r.routes for r in overlay.fabric.residents.values()]
            assert any(int(r.max()) >= 2 for r in routes)          # copy passes ran
    assert streams["overlay"] == streams["plain"]
    assert all(len(s) == 6 for s in streams["plain"])


def test_from_jax_numpy_round_trips_bf16_exactly():
    jcfg, tcfg = _configs("bfloat16")
    jtree = jparams.init(jax_model_spec(jcfg), jax.random.PRNGKey(0))
    as_f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), jtree)
    tp = tparams.from_jax_numpy(as_f32, tcfg, "cpu")
    layer0 = jax.tree.map(lambda x: x[1], as_f32["g0"]["layers"]["0:dense"])
    assert tp["layers"][1]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["layers"][1]["ln1"].dtype == torch.float32
    np.testing.assert_array_equal(tp["layers"][1]["attn"]["wq"].float().numpy(),
                                  layer0["attn"]["wq"])
    np.testing.assert_array_equal(tp["embed"].float().numpy(), as_f32["embed"])
    assert tparams.count(tp) == jcfg.param_count()


def test_init_is_seeded_and_typed():
    _, tcfg = _configs("bfloat16")
    a = tparams.init(tcfg, torch.Generator().manual_seed(5), "cpu")
    b = tparams.init(tcfg, torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(a["layers"][0]["ffn"]["w_up"], b["layers"][0]["ffn"]["w_up"])
    assert a["embed"].dtype == torch.bfloat16 and a["final_norm"].dtype == torch.float32


def test_entry_points_default_to_cuda():
    _, tcfg = _configs()
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only failure mode")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_cache(tcfg, 1, 8)
    with pytest.raises(RuntimeError):
        serve_cli.main(["--arch", "phi3-mini-3.8b", "--smoke"])


@pytest.mark.parametrize("seq", [128, 20])
def test_cache_free_forward_matches_cached_prefill(f32_models, seq):
    """The cache-free forward (the attention op, at a length that is a
    multiple of its 128 blocks and at a ragged one) against the cached
    prefill on the same f32 weights.
    Tolerance 2e-2: the cached path stores k and v in the bf16 cache and
    rounds the probabilities to bf16 before the value product (2^-8
    relative each); the cache-free path keeps both in f32."""
    _, tcfg, _, tp = f32_models
    toks = torch.from_numpy(np.random.default_rng(seq).integers(
        0, tcfg.vocab_size, size=(2, seq)).astype(np.int32))
    with torch.no_grad():
        free, none = tfm.forward(tp, tcfg, toks)
        cached, _ = tfm.forward(tp, tcfg, toks, caches=tmodel.init_cache(tcfg, 2, seq, "cpu"))
    assert none is None and free.shape == cached.shape == (2, seq, tcfg.d_model)
    torch.testing.assert_close(free, cached, rtol=2e-2, atol=2e-2)


def test_serve_launcher_on_cpu(capsys):
    assert serve_cli.main(["--arch", "phi3-mini-3.8b", "--smoke", "--overlay",
                           "--requests", "2", "--batch", "2", "--max-new", "3",
                           "--prompt-len", "6", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2/2 requests" in out and "'downloads': 2" in out
