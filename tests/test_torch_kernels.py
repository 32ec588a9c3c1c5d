"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode, as the JAX suite runs them on the CPU) and its
``kernels/ref.py``; the custom-op wrappers' dispatch and input checks.

Every comparison feeds the same numpy arrays, made from a seed, to both
sides.  Tests that need the card carry the ``cuda`` marker and skip where
there is none.  The JAX side is imported in a fixture, so the ``cuda`` tests
also collect on a machine that has the card but no JAX:
``python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import ssd_scan
from repro_torch.kernels import vmul_reduce as tvr


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the parity tests."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels import rmsnorm as jrn
    from repro.kernels import vmul_reduce as jvr
    return types.SimpleNamespace(jnp=jnp, ref=jref, rmsnorm=jrn, vmul_reduce=jvr)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python -m pytest -m cuda)")
    return torch.device("cuda")


def _as(jx, x: np.ndarray, dtype: str):
    """The same numpy values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jx.jnp.asarray(x, dtype=getattr(jx.jnp, dtype))
    return t, j


def _f32(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


# ---------------------------------------------------------------------------
# vmul_reduce
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 4096, 5000, 1000003])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vmul_reduce_plain_matches_pallas_and_jax_ref(jx, n, dtype):
    rng = np.random.default_rng(n)
    (a, ja), (b, jb) = (_as(jx, rng.standard_normal(n, np.float32), dtype)
                        for _ in range(2))
    got = _f32(ops.vmul_reduce(a, b))
    assert ops.vmul_reduce(a, b).dtype == a.dtype
    # f32 sums of n products in different orders: |err| <= 1e-5 * sum|a*b|;
    # bf16 outputs differ by at most one bf16 rounding of the result (2^-8)
    scale = float(np.sum(np.abs(_f32(a) * _f32(b))))
    tol = 1e-5 * scale + (2 ** -8 * abs(float(got)) if dtype == "bfloat16" else 0)
    jax_ref = _f32(jx.ref.vmul_reduce(ja, jb))
    np.testing.assert_allclose(got, jax_ref, rtol=0, atol=tol)
    if n <= 5000:      # the Pallas kernel in interpret mode (slow at 1e6)
        pallas = _f32(jx.vmul_reduce.vmul_reduce(ja, jb, interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)


def test_vmul_reduce_paper_size_ragged_pallas(jx):
    """The paper's 16 KB workload and a length that is not a multiple of the
    Pallas block (the TPU kernel pads; the port masks)."""
    rng = np.random.default_rng(7)
    for n in (16 * 1024 // 4, 128 * 256 + 77):
        (a, ja), (b, jb) = (_as(jx, rng.standard_normal(n, np.float32), "float32")
                            for _ in range(2))
        np.testing.assert_allclose(_f32(ops.vmul_reduce(a, b)),
                                   _f32(jx.vmul_reduce.vmul_reduce(ja, jb, interpret=True)),
                                   rtol=1e-5, atol=1e-4)


def test_vmul_reduce_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ops.vmul_reduce(torch.ones(3), torch.ones(4))
    with pytest.raises(ValueError):
        ops.vmul_reduce(torch.ones(2, 3), torch.ones(2, 3))


def test_vmul_reduce_cuda_wrapper_rejects_cpu_tensors_without_launching():
    before = tvr.launches.count
    with pytest.raises(ValueError):
        tvr.vmul_reduce_cuda(torch.ones(8), torch.ones(8))
    with pytest.raises(ValueError):
        tvr.vmul_reduce_cuda(torch.ones(8), torch.ones(9))
    assert tvr.launches.count == before
    # the CPU path of the custom op is the plain version, not a launch
    ops.vmul_reduce(torch.ones(8), torch.ones(8))
    assert tvr.launches.count == before


@pytest.mark.parametrize("n,blocks", [(0, 1), (1, 1), (8192, 1), (8193, 2),
                                      (1 << 26, 1024)])
def test_vmul_reduce_grid_depends_on_n_only(n, blocks):
    assert tvr.num_blocks(n) == blocks


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 128), (4, 17, 256), (130, 3072)])
@pytest.mark.parametrize("dtype,wdtype", [("float32", "float32"),
                                          ("bfloat16", "float32"),
                                          ("bfloat16", "bfloat16")])
def test_rmsnorm_plain_matches_pallas_and_jax_ref(jx, shape, dtype, wdtype):
    """Rows that are not a multiple of the Pallas block (128) included."""
    rng = np.random.default_rng(sum(shape))
    x, jxx = _as(jx, rng.standard_normal(shape, np.float32), dtype)
    w, jw = _as(jx, 1 + 0.1 * rng.standard_normal(shape[-1]).astype(np.float32), wdtype)
    got = ops.rmsnorm(x, w)
    assert got.dtype == x.dtype and got.shape == x.shape
    # same f32 expression per element; summation order and rsqrt differ by
    # ulps; a bf16 output may land one bf16 ulp (2^-8 relative) apart
    tol = dict(rtol=2 ** -7, atol=2 ** -7) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(got), _f32(jx.ref.rmsnorm(jxx, jw)), **tol)
    np.testing.assert_allclose(_f32(got), _f32(jx.rmsnorm.rmsnorm(jxx, jw, interpret=True)),
                               **tol)


def test_rmsnorm_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.ones(2, 8), torch.ones(7))
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.ones(2, 8), torch.ones(2, 8))
    with pytest.raises(ValueError):
        trn.rmsnorm_cuda(torch.ones(2, 8), torch.ones(8))   # CPU tensors


def test_rmsnorm_grad_is_vjp_of_plain_version():
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.standard_normal((3, 5, 128), np.float32))
    w0 = torch.from_numpy(1 + 0.1 * rng.standard_normal(128).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 5, 128), np.float32))
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    ops.rmsnorm(x, w).backward(g)
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    ref.rmsnorm(xr, wr).backward(g)
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(w.grad, wr.grad, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# on the card (run there: python -m pytest -m cuda tests/test_torch_kernels.py)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 1000003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vmul_reduce_kernel_matches_plain_on_card(cuda, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(n, generator=g, device=cuda).to(dtype)
    b = torch.randn(n, generator=g, device=cuda).to(dtype)
    before = tvr.launches.count
    k1, k2 = ops.vmul_reduce(a, b), ops.vmul_reduce(a, b)
    assert tvr.launches.count == before + 2
    assert torch.equal(k1, k2)                      # no atomics: same bits
    p = ref.vmul_reduce(a, b).float()
    tol = 1e-5 * (a.float() * b.float()).abs().sum() + 2 ** -8 * p.abs()
    assert (k1.float() - p).abs() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3072, 768])           # phi3's and mamba2's d_model
@pytest.mark.parametrize("rows", [2, 16, 130])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, rows, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(rows, d, generator=g, device=cuda).bfloat16()
    w = 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    before = trn.launches.count
    y = ops.rmsnorm(x, w)
    assert trn.launches.count == before + 1
    torch.testing.assert_close(y.float(), ref.rmsnorm(x, w).float(),
                               rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,span", [
    ((24, 4, 64, 64, 128), torch.bfloat16, 1.0),      # the path's shape, 4 chunks
    ((6, 1, 37, 64, 128), torch.bfloat16, 1.0),       # a ragged chunk
    ((6, 3, 64, 64, 128), torch.float32, 1.0),
    ((16, 3, 8, 16, 16), torch.float32, 1.0),         # the smoke shape
    ((4, 2, 64, 64, 128), torch.bfloat16, 60.0),      # a_cum spans -60..0
])
def test_kernel_matches_plain_on_the_card(cuda, shape, dtype, span):
    """All three outputs within rtol 1e-5 of the largest plain value (f32 on
    both sides from the same inputs, sums in other orders); repeated launches
    bit-identical; one launch counted per call."""
    bh, nc, L, p, n = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(bh, nc, L, p, generator=g, device=cuda).to(dtype)
    b = torch.randn(bh, nc, L, n, generator=g, device=cuda).to(dtype)
    c = torch.randn(bh, nc, L, n, generator=g, device=cuda).to(dtype)
    a = -torch.rand(bh, nc, L, generator=g, device=cuda) * (2 * span / L)
    before = ssd_scan.launches.count
    k1 = ssd_scan.ssd_chunk(x, a, b, c, chunk=L)
    k2 = ssd_scan.ssd_chunk(x, a, b, c, chunk=L)
    want = ssd_scan.plain(x, a, b, c, chunk=L)
    assert ssd_scan.launches.count == before + 2
    for u, v, w in zip(k1, k2, want):
        assert torch.equal(u, v)
        assert float((u - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.cuda
def test_ssd_with_state_matches_naive_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x, bm, cm = (0.5 * torch.randn(2, 96, 3, 16, generator=g, device=cuda) for _ in range(3))
    a = -0.2 * torch.rand(2, 96, 3, generator=g, device=cuda)
    init = torch.randn(2, 3, 16, 16, generator=g, device=cuda)
    y, f = ops.ssd_with_state(x, a, bm, cm, chunk=32, initial_state=init)
    yn, fn = ref.ssd_naive(x, a, bm, cm, init)
    torch.testing.assert_close(y, yn, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(f, fn, rtol=2e-4, atol=2e-4)
