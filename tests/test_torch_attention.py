"""The port's attention: the plain version and the ``repro_torch::attention``
custom op against the JAX package's Pallas flash_attention (interpret mode,
as the JAX suite runs it on the CPU) and its ``ref.attention``; the autograd
backward against ``jax.vjp`` of ``repro.kernels.ops.attention``; the
model's cache-free attention (``layers.attn_fwd``), which takes the op at
every length, and the overlay's LARGE node.

Every comparison feeds the same numpy arrays, made from a seed, to both
sides.  Tolerances: in float32 the two sides differ only in summation order
and in where ``scale`` is applied (the Pallas kernel scales q before the
product, the plain versions scale the scores), a few f32 ulps of the
output's scale: rtol = atol = 1e-5.  In bfloat16 both compute in f32 and
round the output once, so they may land one bf16 ulp apart: rtol 2^-7 with
an absolute floor of 1e-5 for outputs near 0.  The tensor-core kernel also
rounds the probabilities to bf16 before P V; its bound,
``flash_attention.tolerance``, adds 2^-8 max|v| and is checked here on a
plain emulation of that kernel's numerics.  Tests that need the card carry
the ``cuda`` marker and skip where there is none; the JAX side is imported
in a fixture, so they also collect where JAX is missing.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import Overlay
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.models import params as tparams

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)

# (hq, hkv, seq, head dim, dtype, options): causal, GQA, window, softcap +
# scale, non-causal, float32 and bfloat16
CASES = [
    (4, 4, 128, 32, "float32", {}),
    (8, 2, 256, 64, "float32", {}),
    (4, 2, 256, 96, "bfloat16", {}),
    (4, 1, 256, 32, "float32", dict(window=48)),
    (4, 2, 128, 64, "float32", dict(softcap=30.0, scale=0.1)),
    (2, 2, 128, 32, "float32", dict(causal=False)),
    (4, 2, 128, 64, "bfloat16", dict(window=20, softcap=5.0)),
]
IDS = [f"h{c[0]}-{c[1]}_s{c[2]}_d{c[3]}_{c[4]}_{'-'.join(c[5]) or 'causal'}"
       for c in CASES]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the parity tests."""
    jax = pytest.importorskip("jax")
    from repro.kernels import flash_attention as jfa
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import layers as jlayers
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, fa=jfa, ops=jops,
                                 ref=jref, layers=jlayers)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python -m pytest -m cuda)")
    return torch.device("cuda")


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _jax(jx, arrs, dtype):
    return [jx.jnp.asarray(a, dtype=getattr(jx.jnp, dtype)) for a in arrs]


def _f32(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


@pytest.mark.parametrize("hq,hkv,s,d,dtype,kw", CASES, ids=IDS)
def test_attention_matches_pallas_and_jax_ref(jx, hq, hkv, s, d, dtype, kw):
    arrs = _qkv(s + d + hq, 2, hq, hkv, s, d)
    q, k, v = _torch(arrs, dtype)
    jq, jk, jv = _jax(jx, arrs, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    plain = ref.attention(q, k, v, **kw)
    op = ops.attention(q, k, v, **kw)            # the custom op's CPU path
    assert plain.dtype == op.dtype == q.dtype and plain.shape == q.shape
    assert torch.equal(plain, op)
    np.testing.assert_allclose(_f32(plain), _f32(jx.ref.attention(jq, jk, jv, **kw)), **tol)
    pallas = jx.fa.flash_attention(jq, jk, jv, interpret=True, **kw)
    np.testing.assert_allclose(_f32(plain), _f32(pallas), **tol)


def test_fully_masked_rows_are_zero(jx):
    """A window of 0 masks every key: the plain version turns the NaN rows
    into 0, as the Pallas kernel's guard does."""
    arrs = _qkv(11, 1, 2, 2, 128, 32)
    q, k, v = _torch(arrs, "float32")
    out = ref.attention(q, k, v, window=0)
    assert torch.equal(out, torch.zeros_like(out))
    pallas = jx.fa.flash_attention(*_jax(jx, arrs, "float32"), window=0, interpret=True)
    np.testing.assert_array_equal(_f32(pallas), 0.0)


@pytest.mark.parametrize("kw", [{}, dict(window=40, softcap=20.0)],
                         ids=["causal", "window-softcap"])
def test_attention_grad_matches_jax_vjp(jx, kw):
    """The autograd backward (the plain version's VJP, recomputed) against
    ``jax.vjp`` of the reference's ``ops.attention`` (Pallas forward, the
    reference VJP backward), GQA 8/2.  f32: rtol = atol = 1e-4, the same
    products summed in other orders through two more products."""
    arrs = _qkv(5, 1, 8, 2, 128, 32)
    g = np.random.default_rng(6).standard_normal((1, 8, 128, 32)).astype(np.float32)
    tq, tk, tv = (t.requires_grad_() for t in _torch(arrs, "float32"))
    ops.attention(tq, tk, tv, **kw).backward(torch.from_numpy(g))
    out, vjp = jx.jax.vjp(lambda *t: jx.ops.attention(*t, **kw), *_jax(jx, arrs, "float32"))
    for got, want in zip((tq.grad, tk.grad, tv.grad), vjp(jx.jnp.asarray(g))):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)


def test_attention_grad_is_vjp_of_plain_version():
    arrs = _qkv(9, 2, 4, 2, 128, 16)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 4, 128, 16), np.float32))
    a = [t.requires_grad_() for t in _torch(arrs, "float32")]
    b = [t.requires_grad_() for t in _torch(arrs, "float32")]
    ops.attention(*a, softcap=10.0).backward(g)
    ref.attention(*b, softcap=10.0).backward(g)
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)


@pytest.mark.parametrize("s", [128, 20])
def test_multihead_attention_matches_jax_dispatch(jx, s):
    """The port's cache-free attention takes the op at every length.  At
    128 the JAX package's dispatch takes its kernel too; at 20 it takes its
    plain path, which rounds the probabilities to bf16 before the value
    product, so there the port is held to the function of the kernel, the
    JAX ``ref.attention``."""
    arrs = _qkv(s, 2, 4, 2, s, 32)
    q, k, v = _torch(arrs, "bfloat16")
    jq, jk, jv = _jax(jx, arrs, "bfloat16")
    want = (jx.layers.multihead_attention(jq, jk, jv, softcap=30.0) if s % 128 == 0
            else jx.ref.attention(jq, jk, jv, softcap=30.0))
    np.testing.assert_allclose(_f32(ops.attention(q, k, v, softcap=30.0)), _f32(want),
                               **BF16_TOL)


@pytest.mark.parametrize("s", [128, 20])
def test_cache_free_attn_fwd_takes_the_kernel_at_any_length(s):
    """A traced cache-free attention layer holds one ``kernels/attention``
    LARGE node whether or not S is a multiple of 128, and runs it to the
    same bits as eager."""
    cfg = smoke_config("phi3-mini-3.8b").scaled(num_kv_heads=2)
    p = tparams.init(cfg, torch.Generator().manual_seed(s), "cpu")["layers"][0]["attn"]
    x = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (1, s, cfg.d_model), np.float32)).to(torch.bfloat16)

    def fn(x):
        return layers.attn_fwd(p, x, cfg, kind="dense", positions=torch.arange(s),
                               cache=None)[0]

    jitted = Overlay(3, 3).jit(fn)
    names = [n.name for n in jitted.lower(x).graph.op_nodes()]
    assert [n for n in names if n.startswith("kernels/")] == ["kernels/attention"]
    torch.testing.assert_close(jitted(x), fn(x), rtol=0, atol=0)


def test_attention_traces_to_one_large_node():
    q, k, v = _torch(_qkv(2, 1, 4, 2, 128, 32), "float32")
    jitted = Overlay(3, 3).jit(lambda q, k, v: ops.attention(q, k, v, window=64))
    graph = jitted.lower(q, k, v).graph
    assert [n.name for n in graph.op_nodes()] == ["kernels/attention"]
    assert graph.op_nodes()[0].op.tile_class.value == "large"
    assert torch.equal(jitted(q, k, v), ref.attention(q, k, v, window=64))


def test_attention_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ops.attention(torch.ones(1, 3, 8, 4), torch.ones(1, 2, 8, 4), torch.ones(1, 2, 8, 4))
    with pytest.raises(ValueError):
        ops.attention(torch.ones(1, 2, 8, 4), torch.ones(1, 2, 8, 4), torch.ones(1, 2, 9, 4))
    with pytest.raises(ValueError):
        ops.attention(torch.ones(2, 8, 4), torch.ones(2, 8, 4), torch.ones(2, 8, 4))


def test_flash_wrapper_rejects_cpu_tensors_without_launching():
    before = tfa.launches.count
    t = torch.ones(1, 2, 128, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(t, t, t)
    ops.attention(t, t, t)                       # CPU: the plain version
    assert tfa.launches.count == before


def emulate_wgmma(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """The tensor-core kernel's numerics in plain PyTorch: f32 scores, scaled
    (and capped) in log2 units, online softmax over 128-key tiles with the
    row sums taken from the f32 probabilities, P rounded to bf16 before
    P V, the output normalized after the last tile and rounded to bf16."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    log2e = 1.4426950408889634
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    m = torch.full((b, hq, sq, 1), -torch.inf)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[2], 128):
        kt, vt = kf[:, :, k0:k0 + 128], vf[:, :, k0:k0 + 128]
        s = q.float() @ kt.transpose(-1, -2)
        s = (torch.tanh(s * (scale / softcap)) * (softcap * log2e) if softcap is not None
             else s * (scale * log2e))
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones_like(s, dtype=torch.bool)
        if causal:
            ok = ok & (kpos <= qpos)
        if window is not None:
            ok = ok & (qpos - kpos < window)
        s = torch.where(ok, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_sub = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha, p = torch.exp2(m - m_sub), torch.exp2(s - m_sub)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vt
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).bfloat16()


# the CASES in bf16, then d 96 (the training path's head dim) ragged,
# GQA, and with a window and a soft cap
EMULATED = [(hq, hkv, s, d, kw) for hq, hkv, s, d, _, kw in CASES] + [
    (4, 4, 200, 96, {}),
    (4, 4, 77, 96, dict(causal=False)),
    (8, 2, 256, 96, {}),
    (4, 2, 384, 96, dict(window=100, softcap=30.0)),
]


@pytest.mark.parametrize("hq,hkv,s,d,kw", EMULATED,
                         ids=[f"h{c[0]}-{c[1]}_s{c[2]}_d{c[3]}_{'-'.join(c[4]) or 'causal'}"
                              for c in EMULATED])
def test_wgmma_numerics_within_tolerance(jx, hq, hkv, s, d, kw):
    """The tensor-core kernel's numerics, emulated, stay within
    ``tolerance(..., "wgmma")`` of the plain version and of the JAX
    package's ``ref.attention`` on the same bf16 inputs."""
    arrs = _qkv(3 * s + d, 2, hq, hkv, s, d)
    q, k, v = _torch(arrs, "bfloat16")
    got = emulate_wgmma(q, k, v, **kw).float()
    for want in (ref.attention(q, k, v, **kw),
                 torch.from_numpy(_f32(jx.ref.attention(*_jax(jx, arrs, "bfloat16"), **kw)))):
        err = (got - want.float()).abs()
        assert bool((err <= tfa.tolerance(want, v, "wgmma")).all()), err.max().item()


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 48, "wgmma"), (torch.bfloat16, 96, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 40, "simt"), (torch.bfloat16, 8, "simt"),
    (torch.float32, 96, "simt"), (torch.float32, 64, "simt")])
def test_flash_variant_choice(dtype, d, want):
    assert tfa.variant(dtype, d) == want


def test_flash_wrapper_refuses_wgmma_where_it_does_not_apply():
    t = torch.ones(1, 2, 128, 96)                # float32: the CUDA-core kernel only
    before = dict(tfa.launches.by_variant)
    for kernel in ("wgmma", "tensor"):
        with pytest.raises(ValueError, match="does not take"):
            tfa.flash_attention(t, t, t, kernel=kernel)
    assert tfa.launches.by_variant == before


def test_flash_tolerance_per_variant():
    """float32 keeps 1e-5 (1 + |plain|), bf16 on the CUDA cores one bf16 ulp,
    and the tensor-core kernel adds 2^-8 max|v| of each row's kv head, per
    column (kv head h serves q heads 2h and 2h + 1 here)."""
    plain = torch.full((1, 4, 3, 2), -2.0)
    v = torch.zeros(1, 2, 3, 2)
    v[0, 0, 1] = torch.tensor([4.0, -8.0])
    v[0, 1, 2, 0] = 16.0
    assert torch.equal(tfa.tolerance(plain, v, "simt"), 1e-5 * (1 + plain.abs()))
    vb = v.bfloat16()
    base = 2 ** -7 * 2.0 + 1e-5
    assert torch.equal(tfa.tolerance(plain, vb, "simt"), torch.full_like(plain, base))
    tol = tfa.tolerance(plain, vb, "wgmma")
    want = torch.tensor([[4.0, 8.0], [4.0, 8.0], [16.0, 0.0], [16.0, 0.0]])[None, :, None]
    assert torch.equal(tol, base + 2 ** -8 * want.expand(1, 4, 3, 2))


# ---------------------------------------------------------------------------
# on the card (run there: python -m pytest -m cuda tests/test_torch_attention.py)
# ---------------------------------------------------------------------------
# CASES, then bf16 at every head dim the tensor-core kernel is built for,
# each run on every kernel that takes it
CARD_CASES = CASES + [(4, 2, 256, d, "bfloat16", {}) for d in (16, 64, 96, 128)]
CARD_RUNS = [(*c, kernel) for c in CARD_CASES for kernel in tfa.VARIANTS
             if kernel == "simt" or tfa.variant(getattr(torch, c[4]), c[3]) == kernel]


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,s,d,dtype,kw,kernel", CARD_RUNS,
                         ids=[f"h{c[0]}-{c[1]}_s{c[2]}_d{c[3]}_{c[4]}_"
                              f"{'-'.join(c[5]) or 'causal'}_{c[6]}" for c in CARD_RUNS])
def test_flash_kernel_matches_plain_on_card(cuda, hq, hkv, s, d, dtype, kw, kernel):
    q, k, v = (t.to(cuda) for t in _torch(_qkv(s + d, 2, hq, hkv, s, d), dtype))
    before = dict(tfa.launches.by_variant)
    k1 = tfa.flash_attention(q, k, v, kernel=kernel, **kw)
    k2 = tfa.flash_attention(q, k, v, kernel=kernel, **kw)
    assert tfa.launches.by_variant[kernel] == before[kernel] + 2
    assert torch.equal(k1, k2)                   # no atomics: same bits
    plain = ref.attention(q, k, v, **kw)
    assert bool(((k1.float() - plain.float()).abs() <= tfa.tolerance(plain, v, kernel)).all())
    if kernel == tfa.variant(q.dtype, d):       # the op launches the chosen kernel
        n = tfa.launches.count
        assert torch.equal(ops.attention(q, k, v, **kw), k1)
        assert tfa.launches.count == n + 1


@pytest.mark.cuda
def test_flash_kernel_ragged_lengths_on_card(cuda):
    """Lengths that are not multiples of the kernels' query and key tiles
    (64 on the CUDA cores, 128 on the tensor cores) are masked in the
    kernel; repeated launches give the same bits."""
    runs = [(200, 16, "float32"), (77, 128, "float32"), (1, 8, "float32"),
            (77, 96, "bfloat16"), (200, 16, "bfloat16"), (1, 64, "bfloat16")]
    for s, d, dtype in runs:
        q, k, v = (t.to(cuda) for t in _torch(_qkv(s, 1, 4, 2, s, d), dtype))
        for kernel in ("simt", tfa.variant(q.dtype, d)):
            out = tfa.flash_attention(q, k, v, kernel=kernel)
            assert torch.equal(out, tfa.flash_attention(q, k, v, kernel=kernel))
            plain = ref.attention(q, k, v)
            assert bool(((out.float() - plain.float()).abs()
                         <= tfa.tolerance(plain, v, kernel)).all()), (s, d, dtype, kernel)


@pytest.mark.cuda
def test_flash_simt_at_head_dim_56_and_a_ragged_length_on_card(cuda):
    """deepseek-v3's multi-token-prediction layer in training: bf16, 128
    heads of 56 (not a multiple of 16, so the wrapper picks the CUDA-core
    kernel), causal over 2047 positions (the last query and key tiles
    ragged); within ``tolerance(plain, v, "simt")`` of the plain version
    (one bf16 ulp of the output, 2^-7 |plain| + 1e-5), the same bits on a
    repeat, one launch a call on ``simt``."""
    q, k, v = (t.to(cuda) for t in _torch(_qkv(56, 1, 128, 128, 2047, 56), "bfloat16"))
    assert tfa.variant(q.dtype, 56) == "simt"
    before = tfa.launches.by_variant["simt"]
    out = tfa.flash_attention(q, k, v)
    assert torch.equal(out, tfa.flash_attention(q, k, v))
    assert tfa.launches.by_variant["simt"] == before + 2
    plain = ref.attention(q, k, v)
    assert bool(((out.float() - plain.float()).abs()
                 <= tfa.tolerance(plain, v, "simt")).all())


@pytest.mark.cuda
def test_flash_kernel_rejects_misaligned_views_on_card(cuda):
    """TMA needs 16-byte aligned tensors: a contiguous view one element into
    its storage is refused, not read wrongly."""
    q = torch.randn(1, 2, 128, 64, device=cuda).bfloat16()
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view_as(q)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention(shifted, q, q)
    assert torch.equal(tfa.flash_attention(shifted, q, q, kernel="simt"),
                       tfa.flash_attention(q, q, q, kernel="simt"))


@pytest.mark.cuda
def test_attention_grad_on_card_matches_cpu(cuda):
    arrs = _qkv(3, 1, 4, 2, 256, 64)
    g = np.random.default_rng(4).standard_normal((1, 4, 256, 64)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda):
        t = [x.to(dev).requires_grad_() for x in _torch(arrs, "float32")]
        ops.attention(*t, window=100).backward(torch.from_numpy(g).to(dev))
        grads.append([x.grad.cpu() for x in t])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
