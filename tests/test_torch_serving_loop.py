"""The port's event-loop engine against the JAX package's.

The same phi3-mini smoke config as ``tests/test_torch_serving.py`` (d_model
128, 2 layers, 4 heads of 32), float32 parameters made from a seed with
numpy and fed to both packages (``models/params.py::from_jax_numpy``).  The
JAX side runs its Pallas rmsnorm in interpret mode.  Greedy token streams
are compared exactly: the port's loop against JAX's loop and against the
port's synchronous engine; ``prefill_chunk`` logits and caches within the
tolerance of the serving tests; the bucket set; shed lists under one fake
clock; the loop on an asynchronous overlay against the plain loop; and a
config with mamba layers refused.
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
from repro.serving.loop import EventLoopEngine as JEventLoopEngine
from repro_torch.configs import smoke_config
from repro_torch.core import FaultPlan, Overlay
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.loop import EventLoopEngine

SMALL = dict(d_model=128, head_dim=32)
# Logit tolerance, float32 models: everything is f32 except the KV cache,
# which is bf16 in both packages; a key or value an f32 ulp apart can round
# to the neighbouring bf16 (2^-8 relative), which moves a logit by ~1e-3 at
# these widths (as in tests/test_torch_serving.py)
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
PROMPTS = ([7] * 5, [3] * 2, list(range(1, 10)), [11] * 13, [5])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("phi3-mini-3.8b").scaled(dtype="float32", **SMALL)
    tcfg = smoke_config("phi3-mini-3.8b").scaled(dtype="float32", **SMALL)
    rng = np.random.default_rng(0)

    def leaf(spec):
        if spec.init == "ones":
            return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None else fan_in ** -0.5
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    tree = jax.tree.map(leaf, jax_model_spec(jcfg), is_leaf=jparams.is_spec)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32))


def _streams(engine, request_cls, prompts=PROMPTS, max_new=3, **fields):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=list(p), max_new_tokens=max_new,
                                  **fields.get(rid, {})))
    return {r.rid: r.out for r in engine.run_until_drained()}


def test_loop_streams_equal_jax_loop_and_the_sync_engine(models):
    jcfg, tcfg, jp, tp = models
    want = _streams(JEventLoopEngine(jp, jcfg, batch=2, max_len=32, chunk=4), JRequest)
    got = _streams(EventLoopEngine(tp, tcfg, batch=2, max_len=32, chunk=4,
                                   device="cpu"), Request)
    sync = _streams(ServeEngine(tp, tcfg, batch=2, max_len=32, device="cpu"), Request)
    assert got == want
    assert got == sync
    assert all(len(s) == 4 for s in got.values())


@pytest.mark.parametrize("size, last", [(4, 3), (4, 1), (2, 0)])
def test_prefill_chunk_matches_jax(models, size, last):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(size + last)
    first = rng.integers(0, jcfg.vocab_size, size=(1, 4)).astype(np.int32)
    toks = rng.integers(0, jcfg.vocab_size, size=(1, size)).astype(np.int32)
    # a full chunk first, so the second starts at a non-zero cache index
    _, jc = jmodel.prefill_chunk(jp, jcfg, jnp.asarray(first), jmodel.init_cache(jcfg, 1, 16),
                                 jnp.asarray(3, jnp.int32))
    _, tc = tmodel.prefill_chunk(tp, tcfg, torch.from_numpy(first),
                                 tmodel.init_cache(tcfg, 1, 16, "cpu"),
                                 torch.tensor(3, dtype=torch.int32))
    jl, jc = jmodel.prefill_chunk(jp, jcfg, jnp.asarray(toks), jc, jnp.asarray(last, jnp.int32))
    tl, tc = tmodel.prefill_chunk(tp, tcfg, torch.from_numpy(toks), tc,
                                  torch.tensor(last, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jlayers = jc["g0"]["0:dense"]
    for i, layer in enumerate(tc):
        assert int(layer["index"]) == int(jlayers["index"][i]) == 4 + size
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name].float().numpy(),
                                       np.asarray(jlayers[name][i], np.float32),
                                       **LOGIT_TOL)


def test_prefill_chunk_sizes_stay_in_the_bucket_set(models):
    _, tcfg, _, tp = models
    engine = EventLoopEngine(tp, tcfg, batch=2, max_len=32, chunk=4, device="cpu")
    assert [engine._chunk_size(n) for n in range(1, 10)] == [1, 2, 4, 4, 4, 4, 4, 4, 4]
    sizes = []
    inner = engine._prefill_chunk

    def recording(params, toks, c, last):
        sizes.append(toks.shape[1])
        return inner(params, toks, c, last)

    engine._prefill_chunk = recording
    for rid, n in enumerate([1, 2, 3, 5, 6, 7, 9, 12, 13]):
        engine.submit(Request(rid=rid, prompt=list(range(1, n + 1)), max_new_tokens=2))
    engine.run_until_drained()
    assert set(sizes) == {1, 2, 4}
    with pytest.raises(ValueError, match="power of two"):
        EventLoopEngine(tp, tcfg, batch=2, max_len=32, chunk=6, device="cpu")


def _shed_run(module, params, cfg, request_cls, **kw):
    """A fixed script against a fake clock; the shed ledger and the order
    the admitted requests finish in."""
    now = [0.0]
    device = {} if module == "jax" else {"device": "cpu"}
    cls = JEventLoopEngine if module == "jax" else EventLoopEngine
    engine = cls(params, cfg, batch=1, max_len=32, chunk=4, clock=lambda: now[0],
                 **kw, **device)
    accepted = [engine.submit(request_cls(rid=rid, prompt=[rid + 1, 2, 3],
                                          max_new_tokens=2, priority=rid % 2))
                for rid in range(6)]
    engine.step()
    now[0] = 0.4
    engine.step()
    now[0] = 2.0
    done = engine.run_until_drained()
    engine.tick_hist.record(3_000_000)          # measured ticks of 3 s
    late = engine.submit(request_cls(rid=9, prompt=[1, 2], max_new_tokens=1))
    m = engine.metrics()
    return (accepted, late, [(r.rid, r.shed_reason) for r in engine.shed],
            [r.rid for r in done], m["shed"], m["shed_reasons"], m["queued"])


@pytest.mark.parametrize("kw", [dict(max_queue=3), dict(max_queue_delay=0.5),
                                dict(max_queue=4, max_queue_delay=1.0)])
def test_shed_ledger_equals_jax_under_a_fake_clock(models, kw):
    jcfg, tcfg, jp, tp = models
    want = _shed_run("jax", jp, jcfg, JRequest, **kw)
    got = _shed_run("torch", tp, tcfg, Request, **kw)
    assert got == want
    assert got[2]                               # something was shed


@pytest.mark.parametrize("faults", [None, dict(download_failure_rate=0.5,
                                               dispatch_failure_rate=0.1,
                                               resident_loss_rate=0.1)])
def test_loop_on_an_async_overlay_equals_the_plain_loop(models, faults):
    _, tcfg, _, tp = models
    plain = _streams(EventLoopEngine(tp, tcfg, batch=2, max_len=32, chunk=4,
                                     device="cpu"), Request)
    ov = Overlay(3, 3, async_downloads=True,
                 faults=FaultPlan(0, **faults) if faults else None)
    engine = EventLoopEngine(tp, tcfg, batch=2, max_len=32, chunk=4, overlay=ov,
                             device="cpu")
    with pytest.warns(RuntimeWarning) if faults else _nothing():
        served = _streams(engine, Request)
    ov.drain(30.0)
    assert served == plain
    assert ov.stats.fallback_calls >= 3         # the first call of each signature
    names = {r.name for r in ov.fabric.residents.values()}
    assert f"{tcfg.name}.decode" in names
    m = engine.metrics()
    assert m["ttft_us"]["count"] == len(PROMPTS) and m["failures"] == ov.failure_ledger()
    if faults:
        assert ov.failure_ledger()["download_failures"] >= 1
    ov.close()


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_mamba_configs_are_refused(models):
    cfg = smoke_config("mamba2-130m")
    with pytest.raises(NotImplementedError, match="mamba"):
        EventLoopEngine({}, cfg, batch=1, max_len=16, device="cpu")
