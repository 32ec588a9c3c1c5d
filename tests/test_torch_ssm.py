"""The port's Mamba-2 path against the JAX package: the ``ssd_chunk``
kernel's plain version, the ``ssd`` op and its backward, the decode step,
``ssm_fwd``, a small mamba2 model (prefill, decode, loss and gradients), the
serving engine, the overlay and the launchers.

Inputs and parameters are numpy draws from a seed, fed to both packages; the
JAX side runs its Pallas ``ssd_chunk`` and ``rmsnorm`` in interpret mode, as
the JAX suite runs them on the CPU.  The model is mamba2-130m's smoke config
(2 layers, state 16, head dim 16, chunk 8) at d_model 128, so the rmsnorm
kernel is on the JAX path (``repro/models/layers.py:74``); everything is
float32 unless a test says otherwise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.archs import smoke_config as jax_smoke_config
from repro.configs.base import get_config as jax_get_config
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro.models.transformer import model_spec as jax_model_spec
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import Overlay
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.serving.engine import Request, ServeEngine

ARCH = "mamba2-130m"
SMALL = dict(d_model=128)


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
    ``a_log`` the log of U[1, 16], and the zero-initialized biases small
    normal draws so that they are exercised."""
    if spec.init == "ones":
        return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    if spec.init == "ssm_a":
        return np.log(rng.uniform(1.0, 16.0, spec.shape)).astype(np.float32)
    if spec.init == "zeros":
        return (0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    return (scale * rng.standard_normal(spec.shape)).astype(np.float32)


def _numpy_tree(spec_tree, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: _leaf(rng, s), spec_tree, is_leaf=jparams.is_spec)


@pytest.fixture(scope="module")
def f32_models():
    jcfg, tcfg = _configs("float32")
    tree = _numpy_tree(jax_model_spec(jcfg))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32)
    return jcfg, tcfg, jp, tp, tree


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close_normwise(got, want, rtol):
    """|got - want| <= rtol * max|want|, elementwise: the error of an f32
    sum in another order scales with the size of the terms, not with each
    (possibly cancelled) result."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


def _ssd_inputs(seed, shape5, n, *, decay=0.2):
    """x (b, s, h, p), a (b, s, h) <= 0, b/c (b, s, h, n), as numpy f32."""
    rng = np.random.default_rng(seed)
    bsz, s, h, p = shape5
    x = (0.5 * rng.standard_normal((bsz, s, h, p))).astype(np.float32)
    a = (-decay * rng.random((bsz, s, h))).astype(np.float32)
    bm = (0.5 * rng.standard_normal((bsz, s, h, n))).astype(np.float32)
    cm = (0.5 * rng.standard_normal((bsz, s, h, n))).astype(np.float32)
    return x, a, bm, cm


# ---------------------------------------------------------------------------
# the chunk kernel's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,n", [(16, 16), (16, 64), (64, 16), (64, 64)])
@pytest.mark.parametrize("L", [8, 37, 64])
def test_plain_chunk_matches_jax_kernel(L, p, n, dtype):
    """``ssd_scan.plain`` against the Pallas ``ssd_chunk`` (interpret mode)
    on the same inputs, rounded to ``dtype`` on both sides; a_cum spans
    about -2..0 per chunk.  Both compute in f32 and differ only in the order
    of their sums: normwise rtol 1e-5."""
    rng = np.random.default_rng(L * 1000 + p * 10 + n)
    bh, nc = 3, 2
    x = rng.standard_normal((bh, nc, L, p)).astype(np.float32)
    a = (-(4.0 / L) * rng.random((bh, nc, L))).astype(np.float32)
    b = rng.standard_normal((bh, nc, L, n)).astype(np.float32)
    c = rng.standard_normal((bh, nc, L, n)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jssd.ssd_chunk(*(jnp.asarray(t, jdt) for t in (x, a, b, c)), chunk=L,
                          interpret=True)
    got = ssd_scan.plain(*(torch.from_numpy(t).to(tdt) for t in (x, a, b, c)), chunk=L)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close_normwise(g.numpy(), w, 1e-5)


def test_chunk_op_dispatches_by_device_and_checks_shapes():
    """The kernel wrapper checks shapes first and refuses CPU tensors (it has
    no plain fallback); the shared memory it needs is reckoned in Python."""
    x = torch.zeros(2, 1, 8, 4)
    a, b = torch.zeros(2, 1, 8), torch.zeros(2, 1, 8, 3)
    with pytest.raises(ValueError, match="chunk mismatch"):
        ssd_scan.ssd_chunk(x, a, b, b, chunk=16)
    with pytest.raises(ValueError, match="expect x"):
        ssd_scan.ssd_chunk(x, a, b[..., :2, :], b, chunk=8)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan.ssd_chunk(x, a, b, b, chunk=8)
    assert ssd_scan.launches.count == 0
    assert ssd_scan.smem_bytes(64, 64, 128) == 99_584       # the path's shape fits
    assert ssd_scan.smem_bytes(64, 256, 320) > ssd_scan.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# the full scan, the decode step, the backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["op", "scan"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "initial_state"])
def test_ssd_matches_jax_and_naive(impl, with_state, monkeypatch):
    """The ``ssd`` op on the CPU (``ref.ssd_chunked``) and ``ssd_scan.ssd``
    (the op's CUDA implementation) with the plain version in place of its
    kernel, against JAX's ``ssd_scan.ssd`` (Pallas in interpret mode) — the
    same chunked algorithm, f32 sums in other orders: normwise rtol 1e-5 —
    and against the reference's sequential ``ref.ssd_naive``, another order
    of the whole sum: the reference's own 2e-4 (``tests/test_kernels.py:132``)."""
    monkeypatch.setattr(ssd_scan, "ssd_chunk", ssd_scan.plain)
    x, a, bm, cm = _ssd_inputs(7, (2, 48, 3, 16), 8)
    init = np.random.default_rng(8).standard_normal((2, 3, 8, 16)).astype(np.float32)
    jinit = jnp.asarray(init) if with_state else None
    tinit = _t(init) if with_state else None
    jy, jf = jssd.ssd(*(jnp.asarray(t) for t in (x, a, bm, cm)), chunk=16,
                      interpret=True, initial_state=jinit)
    ny, nf = jref.ssd_naive(*(jnp.asarray(t) for t in (x, a, bm, cm)), initial_state=jinit)
    fn = ops.ssd_with_state if impl == "op" else ssd_scan.ssd
    ty, tf = fn(*(_t(t) for t in (x, a, bm, cm)), chunk=16, initial_state=tinit)
    _close_normwise(ty.numpy(), jy, 1e-5)
    _close_normwise(tf.numpy(), jf, 1e-5)
    np.testing.assert_allclose(ty.numpy(), ny, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tf.numpy(), nf, rtol=2e-4, atol=2e-4)
    if impl == "op":
        assert ty.is_contiguous()          # as the op's fake result is


def test_naive_matches_jax_naive():
    x, a, bm, cm = _ssd_inputs(9, (1, 13, 2, 4), 3)
    init = np.random.default_rng(10).standard_normal((1, 2, 3, 4)).astype(np.float32)
    jy, jf = jref.ssd_naive(*(jnp.asarray(t) for t in (x, a, bm, cm)),
                            initial_state=jnp.asarray(init))
    ty, tf = ref.ssd_naive(*(_t(t) for t in (x, a, bm, cm)), initial_state=_t(init))
    np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-5, atol=1e-6)


def test_ssd_decode_step_matches_jax():
    """One decode step: an exact outer product and a sum over n in another
    order: rtol 1e-6, atol 1e-6."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 4, 16)).astype(np.float32)
    a = (-rng.random((3, 4))).astype(np.float32)
    bm, cm = (rng.standard_normal((3, 4, 8)).astype(np.float32) for _ in range(2))
    state = rng.standard_normal((3, 4, 8, 16)).astype(np.float32)
    jy, js = jops.ssd_decode_step(*(jnp.asarray(t) for t in (x, a, bm, cm, state)))
    ty, ts = ops.ssd_decode_step(*(_t(t) for t in (x, a, bm, cm, state)))
    np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=1e-6)


def test_ssd_backward_matches_jax_vjp():
    """y and the four input gradients of ``ops.ssd`` against ``jax.vjp`` of
    ``repro.kernels.ops.ssd`` (both backwards are the VJP of the chunked
    plain version): f32 sums in other orders through the backward's
    products, rtol 1e-4 of each gradient's largest entry."""
    x, a, bm, cm = _ssd_inputs(12, (2, 32, 2, 8), 4)
    g = np.random.default_rng(13).standard_normal(x.shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda *t: jops.ssd(*t, chunk=8), *(jnp.asarray(t) for t in (x, a, bm, cm)))
    jgrads = vjp(jnp.asarray(g))
    ins = [_t(t).requires_grad_() for t in (x, a, bm, cm)]
    ty = ops.ssd(*ins, chunk=8)
    tgrads = torch.autograd.grad(ty, ins, _t(g))
    _close_normwise(ty.detach().numpy(), jy, 1e-5)
    for tg, jg in zip(tgrads, jgrads):
        assert np.isfinite(tg.numpy()).all()
        _close_normwise(tg.numpy(), jg, 1e-4)


def test_ssd_backward_is_finite_under_steep_decay():
    """The mask is applied before the exp: with a_cum spanning -60..0 the
    entries above the diagonal would overflow and make the backward 0*inf."""
    x, a, bm, cm = _ssd_inputs(14, (1, 16, 2, 4), 4, decay=7.5)
    ins = [_t(t).requires_grad_() for t in (x, a, bm, cm)]
    grads = torch.autograd.grad(ops.ssd(*ins, chunk=16).sum(), ins)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ---------------------------------------------------------------------------
# the inter-chunk recurrence in closed form (ref.chunk_states)
# ---------------------------------------------------------------------------
CF_CHUNK = 4                                  # small chunks, so 64 chunks stay small


@pytest.mark.parametrize("impl", ["op", "scan"])
@pytest.mark.parametrize("decay", [0.2, 7.5], ids=["mild", "steep"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "initial_state"])
@pytest.mark.parametrize("nc", [1, 3, 16, 64])
def test_closed_form_scan_matches_jax_across_chunks(nc, with_state, decay, impl, monkeypatch):
    """The op on the CPU (``ref.ssd_chunked``) and ``ssd_scan.ssd`` with the
    plain version in place of its kernel, both computing the inter-chunk
    recurrence as one product over a segment sum, against JAX's
    ``ssd_scan.ssd`` (a ``lax.scan`` over chunks, Pallas in interpret mode)
    at 1 to 64 chunks, mild and steep decay (a_cum spans ~15 a chunk of 4):
    normwise rtol 1e-5, and against the sequential ``ref.ssd_naive`` at the
    reference's 2e-4 (the tolerances of ``test_ssd_matches_jax_and_naive``)."""
    monkeypatch.setattr(ssd_scan, "ssd_chunk", ssd_scan.plain)
    x, a, bm, cm = _ssd_inputs(100 + nc, (2, nc * CF_CHUNK, 2, 8), 4, decay=decay)
    init = np.random.default_rng(200 + nc).standard_normal((2, 2, 4, 8)).astype(np.float32)
    jinit = jnp.asarray(init) if with_state else None
    jy, jf = jssd.ssd(*(jnp.asarray(t) for t in (x, a, bm, cm)), chunk=CF_CHUNK,
                      interpret=True, initial_state=jinit)
    ny, nf = jref.ssd_naive(*(jnp.asarray(t) for t in (x, a, bm, cm)), initial_state=jinit)
    fn = ops.ssd_with_state if impl == "op" else ssd_scan.ssd
    ty, tf = fn(*(_t(t) for t in (x, a, bm, cm)), chunk=CF_CHUNK,
                initial_state=_t(init) if with_state else None)
    assert ty.dtype == tf.dtype == torch.float32
    assert tuple(ty.shape) == x.shape and tuple(tf.shape) == (2, 2, 4, 8)
    _close_normwise(ty.numpy(), jy, 1e-5)
    _close_normwise(tf.numpy(), jf, 1e-5)
    np.testing.assert_allclose(ty.numpy(), ny, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tf.numpy(), nf, rtol=2e-4, atol=2e-4)


def test_chunk_states_is_the_recurrence():
    """``ref.chunk_states`` against the recurrence it replaces, written out
    as a loop here: row c is the state entering chunk c, the last the final
    state; with leading batch dims kept, f32 sums in another order (1e-6
    normwise), and an a_cum of -60 a chunk gives finite zeros, not NaN."""
    rng = np.random.default_rng(21)
    states = _t(rng.standard_normal((2, 3, 7, 4, 5)))
    init = _t(rng.standard_normal((2, 3, 4, 5)))
    for a_tot in (_t(-rng.random((2, 3, 7))), _t(-60.0 * (1 + rng.random((2, 3, 7))))):
        prev, final = ref.chunk_states(states, a_tot, init)
        carry, want = init, []
        for ci in range(7):
            want.append(carry)
            carry = carry * torch.exp(a_tot[..., ci])[..., None, None] + states[:, :, ci]
        assert prev.shape == (2, 3, 7, 4, 5) and final.shape == (2, 3, 4, 5)
        assert bool(torch.isfinite(prev).all() and torch.isfinite(final).all())
        _close_normwise(prev.numpy(), torch.stack(want, dim=2).numpy(), 1e-6)
        _close_normwise(final.numpy(), carry.numpy(), 1e-6)
    zero_init, _ = ref.chunk_states(states, a_tot, None)
    assert not zero_init[:, :, 0].any()


def test_segsum_sums_each_segment_from_its_start():
    """``ref.segsum``: out[i, j] = v[j+1] + ... + v[i] below the diagonal, 0
    on it, -inf above; each segment summed from its own start, so a short
    segment far down a long steep row keeps its few-ulp accuracy instead of
    the rounding of a running total in the hundreds."""
    v = torch.tensor([0.0, -1.5, -2.25, -0.5])
    want = torch.tensor([[0.0, -np.inf, -np.inf, -np.inf],
                         [-1.5, 0.0, -np.inf, -np.inf],
                         [-3.75, -2.25, 0.0, -np.inf],
                         [-4.25, -2.75, -0.5, 0.0]])
    assert torch.equal(ref.segsum(v), want)
    rng = np.random.default_rng(22)
    steep = -60.0 * rng.random(64).astype(np.float32)
    got = ref.segsum(torch.from_numpy(steep)).numpy()
    exact = np.cumsum(steep.astype(np.float64))
    seg = exact[:, None] - exact[None, :]
    for i, j in ((63, 62), (63, 60), (40, 38)):
        assert abs(got[i, j] - seg[i, j]) <= 4 * np.finfo(np.float32).eps * abs(seg[i, j])


def test_ssd_backward_matches_jax_vjp_at_16_chunks():
    """y and the four input gradients of ``ops.ssd`` at 16 chunks against
    ``jax.vjp`` of ``repro.kernels.ops.ssd`` (whose recurrence is a
    ``lax.scan``; the port's backward is the VJP of the closed form): f32
    sums in other orders, normwise rtol 1e-5 for y and 1e-4 for each
    gradient, as ``test_ssd_backward_matches_jax_vjp``."""
    x, a, bm, cm = _ssd_inputs(23, (2, 16 * CF_CHUNK, 2, 8), 4)
    g = np.random.default_rng(24).standard_normal(x.shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda *t: jops.ssd(*t, chunk=CF_CHUNK),
                      *(jnp.asarray(t) for t in (x, a, bm, cm)))
    jgrads = vjp(jnp.asarray(g))
    ins = [_t(t).requires_grad_() for t in (x, a, bm, cm)]
    ty = ops.ssd(*ins, chunk=CF_CHUNK)
    tgrads = torch.autograd.grad(ty, ins, _t(g))
    _close_normwise(ty.detach().numpy(), jy, 1e-5)
    for tg, jg in zip(tgrads, jgrads):
        assert np.isfinite(tg.numpy()).all()
        _close_normwise(tg.numpy(), jg, 1e-4)


def test_ssd_backward_is_finite_under_steep_decay_across_64_chunks():
    """a_cum spans ~60 in each of 64 chunks: the segment sums of the closed
    form reach +3800 above the diagonal, masked before their exp, so the
    backward has no 0 * inf."""
    x, a, bm, cm = _ssd_inputs(25, (1, 64 * 16, 2, 4), 4, decay=7.5)
    ins = [_t(t).requires_grad_() for t in (x, a, bm, cm)]
    grads = torch.autograd.grad(ops.ssd(*ins, chunk=16).sum(), ins)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


class _AtenOps(TorchDispatchMode):
    """Counts the aten ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "initial_state"])
@pytest.mark.parametrize("fn", ["scan", "chunked", "chunked_backward"])
def test_inter_chunk_scan_issues_the_same_ops_at_any_length(fn, with_state, monkeypatch):
    """No loop over chunks: ``ssd_scan.ssd`` (the plain version in place of
    its kernel), ``ref.ssd_chunked`` and its backward issue as many aten ops
    at 64 chunks as at 4."""
    monkeypatch.setattr(ssd_scan, "ssd_chunk", ssd_scan.plain)
    counts = []
    for nc in (4, 64):
        x, a, bm, cm = (_t(t) for t in _ssd_inputs(26, (1, nc * CF_CHUNK, 2, 8), 4))
        init = torch.ones((1, 2, 4, 8)) if with_state else None
        mode = _AtenOps()
        if fn == "chunked_backward":
            ins = [t.requires_grad_() for t in (x, a, bm, cm)]
            y = ref.ssd_chunked(*ins, chunk=CF_CHUNK, initial_state=init)
            with mode:
                torch.autograd.grad(y.sum(), ins)
        else:
            call = ssd_scan.ssd if fn == "scan" else ref.ssd_chunked
            with mode:
                call(x, a, bm, cm, chunk=CF_CHUNK, initial_state=init)
        counts.append(mode.n)
    assert counts[0] == counts[1] > 0, counts


# ---------------------------------------------------------------------------
# the mixer and the model
# ---------------------------------------------------------------------------
def _mixer_inputs(jcfg, seed, s, batch=2):
    """Mixer parameters, an input and a non-zero decode cache, as numpy."""
    rng = np.random.default_rng(seed)
    ptree = _numpy_tree(jssm.ssm_spec(jcfg), seed)
    x = rng.standard_normal((batch, s, jcfg.d_model)).astype(np.float32)
    cache = jax.tree.map(
        lambda sp: np.asarray(jnp.asarray(0.5 * rng.standard_normal(sp.shape), sp.dtype),
                              np.float32),
        jssm.ssm_cache_spec(jcfg, batch), is_leaf=jparams.is_spec)
    return ptree, x, cache


def _torch_cache(cache):
    return {"conv": {k: _t(v).bfloat16() for k, v in cache["conv"].items()},
            "ssm": _t(cache["ssm"])}


# f32 everywhere: five products, the conv, the scan and the gated norm sum in
# other orders; softplus and exp may round differently by an ulp.
MIXER_TOL = 1e-5


@pytest.mark.parametrize("s", [20, 1, 8], ids=["padded_prefill", "decode", "one_chunk"])
@pytest.mark.parametrize("cached", [False, True], ids=["cache_free", "cached"])
def test_ssm_fwd_matches_jax(s, cached):
    """``ssm_fwd`` at a prompt of 20 (padded to 24 with chunk 8), at one
    token (the decode step with a cache, a chunk of 1 without) and at one
    whole chunk, with and without a (non-zero) cache."""
    jcfg, tcfg = _configs()
    ptree, x, cache = _mixer_inputs(jcfg, 20 + s, s)
    jout, jnew = jssm.ssm_fwd(jax.tree.map(jnp.asarray, ptree), jnp.asarray(x), jcfg,
                              cache=jax.tree.map(jnp.asarray, cache) if cached else None)
    tp = pytree.tree_map(_t, ptree)
    tout, tnew = tssm.ssm_fwd(tp, _t(x), tcfg, cache=_torch_cache(cache) if cached else None)
    _close_normwise(tout.numpy(), jout, MIXER_TOL)
    if not cached:
        assert tnew is None and jnew is None
        return
    for k in ("x", "b", "c"):                  # the last inputs of each conv
        assert tnew["conv"][k].dtype == torch.float32
        _close_normwise(tnew["conv"][k].numpy(), jnew["conv"][k], MIXER_TOL)
    _close_normwise(tnew["ssm"].numpy(), jnew["ssm"], MIXER_TOL)


# Logit tolerance of the float32 model: f32 everywhere except the bf16 conv
# cache the decode step reads, in which a value an f32 ulp apart can round
# to the neighbouring bf16 (2^-8 relative).
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)


def test_prefill_and_decode_logits_match_jax(f32_models):
    jcfg, tcfg, jp, tp, _ = f32_models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, jcfg, jnp.asarray(toks), jmodel.init_cache(jcfg, 2, 24))
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks),
                            tmodel.init_cache(tcfg, 2, 24, "cpu"))
    _close_normwise(tl.numpy(), jl, 1e-5)
    nxt = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
    jd, _ = jmodel.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
    td, _ = tmodel.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **LOGIT_TOL)


def test_cache_free_forward_matches_jax(f32_models):
    """The cache-free forward (``kops.ssd`` in every layer) at a ragged
    length: one chunk-padded sequence of 21 tokens."""
    jcfg, tcfg, jp, tp, _ = f32_models
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 21)).astype(np.int32)
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as ttfm
    jh, _, _ = jtfm.forward(jp, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        th, none = ttfm.forward(tp, tcfg, torch.from_numpy(toks))
    assert none is None
    _close_normwise(th.numpy(), jh, 1e-5)


def test_loss_and_grads_match_jax(f32_models):
    """Loss and every gradient of the 2-layer f32 mamba2 at seq 32 against
    ``jax.value_and_grad(loss_fn)`` (Pallas ssd_chunk and rmsnorm in
    interpret mode on the JAX side, plain versions on the port's).  Loss
    rtol 1e-5; gradients within 1e-4 of each leaf's largest: f32 sums in
    other orders through the backward's products."""
    jcfg, tcfg, _, _, tree = f32_models
    batch = jpipe.make_batch(jcfg, 2, 32, step=3, seed=1)
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), batch, jcfg)
    tp = tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, metrics, grads, spec = train_cli._loss_and_grads(tcfg, tp, tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["acc"].item(), float(jm["acc"]), rtol=1e-6)
    want = tparams.from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                  dtype=torch.float32)
    got = pytree.tree_unflatten(grads, spec)
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        _close_normwise(g.numpy(), w.numpy(), 1e-4)


# ---------------------------------------------------------------------------
# parameters and the guard for kinds still unported
# ---------------------------------------------------------------------------
def test_from_jax_numpy_carries_mamba_stacks_exactly():
    jcfg, tcfg = _configs("bfloat16")
    jtree = jparams.init(jax_model_spec(jcfg), jax.random.PRNGKey(0))
    as_f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), jtree)
    tp = tparams.from_jax_numpy(as_f32, tcfg, "cpu")
    layer1 = jax.tree.map(lambda x: x[1], as_f32["g0"]["layers"]["0:mamba"])
    mixer = tp["layers"][1]["mixer"]
    assert mixer["w_x"].dtype == torch.bfloat16 and mixer["conv_bias_x"].dtype == torch.bfloat16
    for name in ("a_log", "d_skip", "dt_bias", "gate_norm"):
        assert mixer[name].dtype == torch.float32
    for name in ("w_x", "conv_c", "a_log", "out_proj"):
        np.testing.assert_array_equal(mixer[name].float().numpy(), layer1["mixer"][name])
    assert tparams.count(tp) == jparams.count(jax_model_spec(jcfg))


def test_init_draws_mamba_leaves_from_the_generator():
    _, tcfg = _configs("bfloat16")
    a = tparams.init(tcfg, torch.Generator().manual_seed(5), "cpu")
    b = tparams.init(tcfg, torch.Generator().manual_seed(5), "cpu")
    m = a["layers"][0]["mixer"]
    assert torch.equal(m["a_log"], b["layers"][0]["mixer"]["a_log"])
    assert bool((m["a_log"] >= 0).all() and (m["a_log"] <= math.log(16.0)).all())
    assert m["a_log"].dtype == torch.float32 and not m["dt_bias"].any()
    assert not m["conv_bias_b"].any() and bool((m["d_skip"] == 1).all())


def test_full_config_param_count_equals_the_jax_spec():
    cfg = get_config(ARCH)
    spec = tparams.model_spec(cfg)
    shapes = []
    tparams._map_spec(spec, lambda s: shapes.append(s.shape))
    n = sum(math.prod(s) for s in shapes)
    assert n == jparams.count(jax_model_spec(jax_get_config(ARCH)))
    assert abs(n - 130e6) / 130e6 < 0.05
    assert tparams.layer_kinds(cfg) == ["mamba"] * 24


@pytest.mark.parametrize("over", [
    dict(blocks=((("dense", "conv"), 2),)),
    dict(blocks=((("dense",), 2),), frontend="video", frontend_dim=32),
], ids=["unknown_kind", "unknown_frontend"])
def test_unported_kinds_still_raise(over):
    cfg = get_config(ARCH).scaled(**over)
    with pytest.raises(NotImplementedError, match="the port serves layers of kinds"):
        tparams.layer_kinds(cfg)
    with pytest.raises(NotImplementedError, match="and the frontends"):
        tparams.init(cfg, torch.Generator().manual_seed(0), "cpu")


# ---------------------------------------------------------------------------
# serving, the overlay, the launchers
# ---------------------------------------------------------------------------
def _prompts(vocab, seed=2):
    rng = np.random.default_rng(seed)
    # a ragged chunk (5), one chunk plus a padded tail (12), two chunks (16)
    return [rng.integers(0, vocab, size=(n,)).tolist() for n in (5, 12, 16)]


def _streams(engine, request_cls, prompts, max_new=4):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_new_tokens=max_new))
    done = engine.run_until_drained()
    return [r.out for r in sorted(done, key=lambda r: r.rid)]


def test_engine_greedy_streams_match_jax(f32_models):
    jcfg, tcfg, jp, tp, _ = f32_models
    prompts = _prompts(jcfg.vocab_size)
    want = _streams(JServeEngine(jp, jcfg, batch=2, max_len=24), JRequest, prompts)
    plain = _streams(ServeEngine(tp, tcfg, batch=2, max_len=24, device="cpu"),
                     Request, prompts)
    assert plain == want


class _Calls:
    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *args):
        self.n += 1
        return self.fn(*args)


def test_overlay_and_plain_engine_streams_match(monkeypatch):
    """Overlay-served and plain-served greedy streams on a bf16 mamba2 are
    identical; the ssd op runs once per mamba layer in each prefill and
    never in decode, and each traced prefill holds one ``kernels/ssd`` node
    per layer (with the initial state as its fifth input)."""
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    calls = {"n": 0}
    chunked = ref.ssd_chunked

    def counted(*args, **kw):
        calls["n"] += 1
        return chunked(*args, **kw)

    monkeypatch.setattr(ref, "ssd_chunked", counted)
    prompts = _prompts(tcfg.vocab_size, seed=3)
    streams = {}
    for name, overlay in (("overlay", Overlay(3, 3)), ("plain", None)):
        engine = ServeEngine(params, tcfg, batch=2, max_len=24, overlay=overlay,
                             device="cpu")
        engine._prefill, engine._decode = _Calls(engine._prefill), _Calls(engine._decode)
        calls["n"] = 0
        streams[name] = _streams(engine, Request, prompts, max_new=5)
        assert calls["n"] == tcfg.num_layers * engine._prefill.n, name
        if overlay is not None:
            desc = overlay.describe()
            assert desc["traces"] == desc["downloads"] == 4   # 3 prompt lengths + decode
            for entry in engine._prefill.fn._entries.values():
                ssd = [nd for nd in entry.lowered.graph.op_nodes() if nd.name == "kernels/ssd"]
                assert len(ssd) == tcfg.num_layers
                assert all(len(nd.inputs) == 5 for nd in ssd)
    assert streams["overlay"] == streams["plain"]
    assert all(len(s) == 6 for s in streams["plain"])


def test_traced_cache_free_forward_has_one_four_input_ssd_node_per_layer():
    _, tcfg = _configs("bfloat16")
    params = tparams.init(tcfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.zeros((1, 16), dtype=torch.int32)
    from repro_torch.core.trace import trace_to_graph
    from repro_torch.models import transformer as ttfm
    lowered = trace_to_graph(lambda p, t: ttfm.forward(p, tcfg, t)[0], params, toks)
    ssd = [nd for nd in lowered.graph.op_nodes() if nd.name == "kernels/ssd"]
    assert len(ssd) == tcfg.num_layers and all(len(nd.inputs) == 4 for nd in ssd)


def test_serve_launcher_on_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--overlay", "--requests", "2",
                           "--batch", "2", "--max-new", "3", "--prompt-len", "11",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2/2 requests" in out and "'downloads': 2" in out


def test_train_launcher_on_cpu_restarts_after_failure(tmp_path, capsys):
    rc = train_cli.main(["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
                         "--seq", "32", "--ckpt-every", "2", "--fail-at", "3",
                         "--log-every", "1", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "restarts=1" in out and "4 steps" in out
