"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode, as the JAX suite runs them on the CPU) and its
``kernels/ref.py``; the custom-op wrappers' dispatch and input checks.

Every comparison feeds the same numpy arrays, made from a seed, to both
sides.  Tests that need the card carry the ``cuda`` marker and skip where
there is none.  The JAX side is imported in a fixture, so the ``cuda`` tests
also collect on a machine that has the card but no JAX:
``python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""

import re
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import native, ops, ref
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
    from repro.kernels import ssd_scan as jssd
    from repro.kernels import vmul_reduce as jvr
    return types.SimpleNamespace(jnp=jnp, ref=jref, rmsnorm=jrn, ssd_scan=jssd, vmul_reduce=jvr)


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


_C = tvr.CLUSTER_MAX_N


@pytest.mark.parametrize("n,want", [
    (0, (True, 8)), (1, (True, 8)), (4096, (True, 8)), (_C, (True, 8)),
    (_C + 1, (False, -(-(_C + 1) // 4096))), (1 << 20, (False, 256)),
    (528 * 4096, (False, 528)), (528 * 4096 + 1, (False, 528)), (1 << 26, (False, 528))])
def test_vmul_reduce_grid_depends_on_n_only(n, want):
    """The launch plan -- one cluster of 8 CTAs or a grid of blocks, and how
    many -- is a function of n alone (so are the summation order and the
    bits); the cluster takes every n up to CLUSTER_MAX_N."""
    assert tvr.plan(n) == tvr.Plan(*want)
    assert _C >= 4096                      # the paper's 16 KB takes the cluster


def test_vmul_reduce_workspace_is_keyed_by_device_and_stream(monkeypatch):
    """The grid variant's ticket and partials: one zeroed buffer per
    (device, stream), reused by that stream's later calls, never shared by
    two streams."""
    monkeypatch.setattr(tvr, "_workspaces", {})
    cpu = torch.device("cpu")
    w1, w2 = tvr.workspace(cpu, 1), tvr.workspace(cpu, 2)
    assert w1 is tvr.workspace(cpu, 1) and w2 is tvr.workspace(cpu, 2)
    assert w1.data_ptr() != w2.data_ptr()
    assert w1.shape == (1 + tvr.MAX_BLOCKS,) and w1.dtype == torch.int32
    assert not w1.any() and not w2.any()
    assert set(tvr._workspaces) == {(cpu, 1), (cpu, 2)}


# ---------------------------------------------------------------------------
# The CUDA kernels' orders of operations, emulated in f32 on the CPU.  Each
# step is one IEEE f32 operation (the kernels use __fmul_rn/__fadd_rn, never
# FMAs), so the vmul_reduce emulation gives the kernel's bits (the card test
# holds it to that) and both are held to the JAX package here.
# ---------------------------------------------------------------------------
def _halving_tree(v: np.ndarray) -> np.ndarray:
    """A warp's shuffle tree over the last axis (32 lanes): lane i adds lane
    i + off for off = 16, 8, ..., 1; lane 0's value."""
    v = np.concatenate([v, np.zeros(v.shape[:-1] + (32 - v.shape[-1],), np.float32)], -1)
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def _block_tree(v: np.ndarray) -> np.ndarray:
    """A block's sum over the last axis: each warp's tree, then a tree over
    the warps' sums."""
    warps = v.reshape(v.shape[:-1] + (v.shape[-1] // 32, 32))
    return _halving_tree(_halving_tree(warps))


def emulate_vmul_reduce(a: np.ndarray, b: np.ndarray, vec: int, plan) -> np.float32:
    """``csrc/vmul_reduce.cu``'s order for f32 values ``a``, ``b`` (bf16
    inputs widened; ``vec`` elements a 16-byte chunk): thread g of W sums
    chunks g, g + W, ... per chunk lane, the lanes in a halving tree, each
    block in its tree; then the cluster's rank 0 (one warp) or the last
    block (thread t takes partials t, t + 256, ..., then its tree)."""
    p = a.astype(np.float32) * b.astype(np.float32)
    threads = plan.blocks * tvr.THREADS
    iters = max(1, -(-(-(-len(p) // vec)) // threads))
    p = np.concatenate([p, np.zeros(iters * threads * vec - len(p), np.float32)])
    acc = np.zeros((threads, vec), np.float32)
    for chunk in p.reshape(iters, threads, vec):
        acc = acc + chunk
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    parts = _block_tree(acc[:, 0].reshape(plan.blocks, tvr.THREADS))
    if plan.cluster:
        return _halving_tree(parts)
    rounds = -(-plan.blocks // tvr.THREADS)
    parts = np.concatenate([parts, np.zeros(rounds * tvr.THREADS - plan.blocks, np.float32)])
    s = np.zeros(tvr.THREADS, np.float32)
    for r in parts.reshape(rounds, tvr.THREADS):
        s = s + r
    return _block_tree(s)


RMSNORM_BLOCK_THREADS = 128   # csrc/rmsnorm.cu's kThreads


def emulate_rmsnorm(x: np.ndarray, w: np.ndarray, vec: int, eps: float = 1e-6) -> np.ndarray:
    """``csrc/rmsnorm.cu``'s order, in f32, for rows ``x`` (rows, d) and
    ``w`` as f32 values.  The warp kernel (d a multiple of ``vec``, at most
    MAX_WARP_D): lane l sums the squares of its vectors l, l + 32, ... in
    order, the warp adds the lanes in a tree.  The block kernel (the rest):
    thread t sums elements t, t + 128, ..., then the block's tree.  Then
    r = rsqrt(ss / d + eps) (each step rounded once) and (x * r) * w."""
    rows, d = x.shape
    sq = x * x
    if d % vec == 0 and d <= trn.MAX_WARP_D:
        per_lane = -(-(d // vec) // 32)
        sq = np.concatenate([sq, np.zeros((rows, per_lane * 32 * vec - d), np.float32)], 1)
        sq = sq.reshape(rows, per_lane, 32, vec)
        ss = np.zeros((rows, 32), np.float32)
        for i in range(per_lane):
            for k in range(vec):
                ss = ss + sq[:, i, :, k]
        ss = _halving_tree(ss)
    else:
        t = RMSNORM_BLOCK_THREADS
        sq = np.concatenate([sq, np.zeros((rows, -(-d // t) * t - d), np.float32)], 1)
        acc = np.zeros((rows, t), np.float32)
        for step in sq.reshape(rows, -1, t).transpose(1, 0, 2):
            acc = acc + step
        ss = _block_tree(acc)
    ms = ss / np.float32(d) + np.float32(eps)
    r = (1.0 / np.sqrt(ms.astype(np.float64))).astype(np.float32)   # rsqrt, rounded once
    return (x * r[:, None]) * w[None, :]


def _bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (to nearest even), as f32 values."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


@pytest.mark.parametrize("n", [0, 1, 7, 4095, 4096, 4097, _C - 1, _C, _C + 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vmul_reduce_kernel_order_matches_jax(jx, n, dtype):
    """The emulated kernel order against the JAX reference (and the Pallas
    kernel in interpret mode at the paper's size), at the tolerance of
    test_vmul_reduce_plain_matches_pallas_and_jax_ref."""
    rng = np.random.default_rng(n + 11)
    (a, ja), (b, jb) = (_as(jx, rng.standard_normal(n, np.float32), dtype) for _ in range(2))
    af, bf = _f32(a), _f32(b)
    got = emulate_vmul_reduce(af, bf, 16 // a.element_size(), tvr.plan(n))
    got = float(torch.tensor(got).to(a.dtype).float())
    scale = float(np.sum(np.abs(af * bf)))
    tol = 1e-5 * scale + (2 ** -8 * abs(got) if dtype == "bfloat16" else 0)
    np.testing.assert_allclose(got, _f32(jx.ref.vmul_reduce(ja, jb)), rtol=0, atol=tol)
    if n == 4096:
        np.testing.assert_allclose(
            got, _f32(jx.vmul_reduce.vmul_reduce(ja, jb, interpret=True)), rtol=0, atol=tol)


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


@pytest.mark.parametrize("shape", [(3, 3072), (5, 768), (2, 3001)])
@pytest.mark.parametrize("dtype,wdtype", [("float32", "float32"), ("float32", "bfloat16"),
                                          ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_rmsnorm_kernel_order_matches_jax(jx, shape, dtype, wdtype):
    """The emulated order of the warp kernel (d 3072 and 768) and of the
    block kernel (the ragged d 3001) against the JAX reference, at the
    tolerance of test_rmsnorm_plain_matches_pallas_and_jax_ref."""
    rng = np.random.default_rng(sum(shape) + len(dtype) + len(wdtype))
    x, jxx = _as(jx, rng.standard_normal(shape, np.float32), dtype)
    w, jw = _as(jx, 1 + 0.1 * rng.standard_normal(shape[-1]).astype(np.float32), wdtype)
    assert trn.variant(x, x) == ("block" if shape[-1] == 3001 else "warp")
    got = emulate_rmsnorm(_f32(x), _f32(w), 16 // x.element_size())
    got = _bf16(got) if dtype == "bfloat16" else got
    tol = dict(rtol=2 ** -7, atol=2 ** -7) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _f32(jx.ref.rmsnorm(jxx, jw)), **tol)


def test_rmsnorm_variant_by_shape_and_alignment():
    """The warp kernel takes rows of whole 16-byte vectors up to MAX_WARP_D,
    16-byte aligned; everything else goes to the block kernel."""
    bf = torch.zeros(4, 3072, dtype=torch.bfloat16)
    assert trn.variant(bf, bf) == "warp"
    assert trn.variant(torch.zeros(4, 768), torch.zeros(4, 768)) == "warp"
    assert trn.variant(torch.zeros(2, 4096), torch.zeros(2, 4096)) == "warp"
    assert trn.variant(torch.zeros(2, 4100), torch.zeros(2, 4100)) == "block"   # too wide
    assert trn.variant(torch.zeros(2, 3001), torch.zeros(2, 3001)) == "block"   # ragged
    odd = torch.zeros(2 * 3072 + 8, dtype=torch.bfloat16)[1:1 + 2 * 3072].view(2, 3072)
    assert trn.variant(odd, bf[:2]) == "block"                                  # unaligned


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
# ssd_chunk: the tensor-core kernel's numerics, the variant choice
# ---------------------------------------------------------------------------
def _mma_parts() -> int:
    """The bf16 parts ``ssd_chunk_mma`` splits an f32 operand into, as the
    CUDA source sets them."""
    src = (native.csrc_dir() / "ssd_chunk.cu").read_text()
    return int(re.search(r"constexpr int kParts = (\d+);", src).group(1))


def _warp_scan(a: np.ndarray) -> np.ndarray:
    """a_cum as the kernels' warp 0 builds it, in f32: a shuffle scan
    (Hillis-Steele: offsets 1, 2, 4, 8, 16) of each 32 steps, plus the carry
    of the 32 before.  a: (..., 64), zero past L."""
    out = np.empty_like(a, dtype=np.float32)
    carry = np.zeros(a.shape[:-1], np.float32)
    for base in range(0, a.shape[-1], 32):
        v = a[..., base:base + 32].astype(np.float32)
        off = 1
        while off < 32:
            v = np.concatenate([v[..., :off], v[..., off:] + v[..., :-off]], axis=-1)
            off *= 2
        v = v + carry[..., None]
        out[..., base:base + 32] = v
        carry = v[..., -1]
    return out


def _bf16_parts(t: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """f32 ``t`` as ``parts`` bf16-valued tensors summing to it: each the
    remainder of the ones before rounded to bf16 (every subtraction exact)."""
    out = []
    for _ in range(parts):
        out.append(t.bfloat16().float())
        t = t - out[-1]
    return out


def emulate_ssd_mma(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """``ssd_chunk_mma``'s numerics on the CPU: a_cum by the warp scan; the
    scores C B^T from the bf16 inputs (products exact in f32, f32 sums); the
    decay taken under the mask; S x and b^T (w o x) with the f32 operand (S,
    w o x) split into the kernel's bf16 parts, one product each, summed in
    f32.  Returns (y_diag, states, a_cum) as the kernel does."""
    bh, nc, L, p = x.shape
    n = b.shape[-1]
    z = bh * nc
    xf, bf, cf = (t.float().reshape(z, L, -1) for t in (x, b, c))
    padded = np.zeros((z, 64), np.float32)
    padded[:, :L] = a.float().reshape(z, L).numpy()
    ac = torch.from_numpy(_warp_scan(padded)[:, :L])
    tri = torch.ones((L, L), dtype=torch.bool).tril()
    decay = torch.exp(torch.where(tri, ac[:, :, None] - ac[:, None, :], -torch.inf))
    scores = torch.bmm(cf, bf.transpose(1, 2)) * decay
    parts = _mma_parts()
    y = sum(torch.bmm(s, xf) for s in _bf16_parts(scores, parts))
    wx = torch.exp(ac[:, -1:] - ac)[:, :, None] * xf
    st = sum(torch.bmm(bf.transpose(1, 2), s) for s in _bf16_parts(wx, parts))
    return (y.reshape(bh, nc, L, p), st.reshape(bh, nc, n, p), ac.reshape(bh, nc, L))


@pytest.mark.parametrize("shape,span", [
    ((2, 64, 64, 64, 128), 2.0),        # the 4096-token path, cut to 2 heads
    ((3, 1, 37, 64, 128), 2.0),         # a 37-token prompt: one ragged chunk
    ((2, 4, 64, 64, 128), 60.0),        # a_cum spans -60..0 a chunk
], ids=["path_2_heads", "ragged_37", "span_60"])
def test_ssd_mma_numerics_within_tolerance(jx, shape, span):
    """The tensor-core kernel's numerics (:func:`emulate_ssd_mma`) against
    the plain version and against JAX's Pallas ``ssd_chunk`` (interpret
    mode) on the same bf16 x, b, c and f32 a: within the 1e-5 normwise bound
    that ``chip_smoke.py`` and the card tests hold the kernel to, for every
    output."""
    bh, nc, L, p, n = shape
    rng = np.random.default_rng(L + nc)
    x = rng.standard_normal((bh, nc, L, p)).astype(np.float32)
    b = rng.standard_normal((bh, nc, L, n)).astype(np.float32)
    c = rng.standard_normal((bh, nc, L, n)).astype(np.float32)
    a = (-(2 * span / L) * rng.random((bh, nc, L))).astype(np.float32)
    tx, tb, tc = (torch.from_numpy(t).bfloat16() for t in (x, b, c))
    ta = torch.from_numpy(a)
    assert ssd_scan.variant(tx, ta, tb, tc) == "mma"
    got = emulate_ssd_mma(tx, ta, tb, tc)
    plain = ssd_scan.plain(tx, ta, tb, tc, chunk=L)
    jx_, jb, jc = (jx.jnp.asarray(t, jx.jnp.bfloat16) for t in (x, b, c))
    jout = jx.ssd_scan.ssd_chunk(jx_, jx.jnp.asarray(a), jb, jc, chunk=L, interpret=True)
    for g, pl, jw in zip(got, plain, jout):
        for want in (pl.numpy(), np.asarray(jw, np.float32)):
            assert g.shape == want.shape
            err = float(np.abs(g.numpy() - want).max())
            assert err <= 1e-5 * float(np.abs(want).max()), err


def _chunk_inputs(dtype=torch.bfloat16, adtype=torch.float32, L=64, p=64, n=128):
    x = torch.zeros(2, 3, L, p, dtype=dtype)
    b = torch.zeros(2, 3, L, n, dtype=dtype)
    return x, torch.zeros(2, 3, L, dtype=adtype), b, b.clone()


@pytest.mark.parametrize("kw,want", [
    ({}, "mma"),                                            # the mamba2 paths
    (dict(L=37), "mma"),                                    # a ragged chunk
    (dict(L=1), "mma"),
    (dict(dtype=torch.float32), "simt"),
    (dict(adtype=torch.bfloat16), "simt"),
    (dict(p=32), "simt"),
    (dict(n=64), "simt"),
    (dict(p=16, n=16, L=8, dtype=torch.float32), "simt"),   # the smoke configs
])
def test_ssd_variant_choice(kw, want):
    assert ssd_scan.variant(*_chunk_inputs(**kw)) == want


def test_ssd_variant_needs_16_byte_aligned_tiles():
    """A view 2 bytes into its storage cannot be copied 16 bytes at a time:
    the CUDA-core kernel takes it."""
    x, a, b, c = _chunk_inputs()
    flat = torch.zeros(x.numel() + 8, dtype=torch.bfloat16)
    assert ssd_scan.variant(flat[1:1 + x.numel()].view(x.shape), a, b, c) == "simt"
    assert ssd_scan.variant(flat[8:8 + x.numel()].view(x.shape), a, b, c) == "mma"


@pytest.mark.parametrize("kernel", ["mma", "wgmma"])
def test_ssd_wrapper_refuses_a_kernel_that_does_not_take_the_inputs(kernel):
    """Asked for the tensor-core kernel on f32 inputs (or for no kernel at
    all), the wrapper raises before it looks at the device, and counts
    nothing."""
    before = dict(ssd_scan.launches.by_variant)
    with pytest.raises(ValueError, match="does not take"):
        ssd_scan.ssd_chunk(*_chunk_inputs(dtype=torch.float32), chunk=64, kernel=kernel)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan.ssd_chunk(*_chunk_inputs(), chunk=64, kernel="mma")
    assert ssd_scan.launches.by_variant == before


# ---------------------------------------------------------------------------
# on the card (run there: python -m pytest -m cuda tests/test_torch_kernels.py)
# ---------------------------------------------------------------------------
def _kernels_per_call(fn) -> list[str]:
    """The CUDA kernels one call of ``fn`` runs, by ``torch.profiler``.  The
    window opens and closes on an idle card, 20 ms from the call: a kernel
    launched right at an edge of the window is now and then left out of its
    record."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.02)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _vmul_tol(a, b, p):
    return 1e-5 * (a.float() * b.float()).abs().sum() + \
        (2 ** -8 * p.abs() if a.dtype == torch.bfloat16 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 7, 4095, 4096, 4097, _C - 1, _C, _C + 1, 1000003,
                               1 << 26])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vmul_reduce_kernel_matches_plain_on_card(cuda, n, dtype):
    """Within tolerance of plain, bit-identical on repeat and to the emulated
    order, one kernel a call."""
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(n, generator=g, device=cuda).to(dtype)
    b = torch.randn(n, generator=g, device=cuda).to(dtype)
    before = tvr.launches.count
    k1, k2 = ops.vmul_reduce(a, b), ops.vmul_reduce(a, b)
    assert tvr.launches.count == before + 2
    assert torch.equal(k1, k2)                      # no atomics: same bits
    p = ref.vmul_reduce(a, b).float()
    assert (k1.float() - p).abs() <= _vmul_tol(a, b, p)
    emulated = emulate_vmul_reduce(_f32(a.cpu()), _f32(b.cpu()), 16 // a.element_size(),
                                   tvr.plan(n))
    assert torch.equal(k1.cpu(), torch.tensor(emulated).to(dtype))
    kind = "cluster" if tvr.plan(n).cluster else "grid"
    names = _kernels_per_call(lambda: ops.vmul_reduce(a, b))
    assert len(names) == 1 and f"vmul_reduce_{kind}" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, _C + 1, 1000003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vmul_reduce_unaligned_views_on_card(cuda, n, dtype):
    """``a[1:]`` and ``b[1:]`` start off a 16-byte boundary: scalar loads of
    the same chunks in the same order, so the same bits as aligned copies."""
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(n + 1, generator=g, device=cuda).to(dtype)
    b = torch.randn(n + 1, generator=g, device=cuda).to(dtype)
    av, bv = a[1:], b[1:]
    assert av.data_ptr() % 16 and bv.data_ptr() % 16
    got = tvr.vmul_reduce_cuda(av, bv)
    assert torch.equal(got, tvr.vmul_reduce_cuda(av.clone(), bv.clone()))
    p = ref.vmul_reduce(av, bv).float()
    assert (got.float() - p).abs() <= _vmul_tol(av, bv, p)
    assert len(_kernels_per_call(lambda: tvr.vmul_reduce_cuda(av, bv))) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 1 << 20])
def test_vmul_reduce_two_streams_concurrently(cuda, n):
    """Calls issued in turns on two streams, each with its own workspace and
    ticket: every answer equals the one-stream answer, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(2)
    ins = [(torch.randn(n, generator=g, device=cuda), torch.randn(n, generator=g, device=cuda))
           for _ in range(2)]
    want = [tvr.vmul_reduce_cuda(a, b) for a, b in ins]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(50):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(tvr.vmul_reduce_cuda(*ins[i]))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(x, want[i]) for x in got[i])
    if not tvr.plan(n).cluster:
        keys = {(cuda.index or 0, s.cuda_stream) for s in streams}
        assert keys <= {(d.index, st) for d, st in tvr._workspaces}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 3072, 3000])      # mamba2's and phi3's d_model, ragged
@pytest.mark.parametrize("rows", [1, 2, 3, 16, 32, 130, 4096, 8192])
@pytest.mark.parametrize("dtype,wdtype", [(torch.bfloat16, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.float32, torch.float32),
                                          (torch.float32, torch.bfloat16)])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, rows, d, dtype, wdtype):
    """Within one bf16 ulp (2^-7, bf16 x) or 1e-5 (f32 x) of plain, on the
    warp kernel (every d here is whole 16-byte vectors), one kernel a call."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(rows, d, generator=g, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(d, generator=g, device=cuda)).to(wdtype)
    before = trn.launches.by_variant["warp"]
    y = ops.rmsnorm(x, w)
    assert trn.launches.by_variant["warp"] == before + 1
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), ref.rmsnorm(x, w).float(), rtol=tol, atol=tol)
    names = _kernels_per_call(lambda: ops.rmsnorm(x, w))
    assert len(names) == 1 and "rmsnorm_warp" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 3001), (2, 5000)])
def test_rmsnorm_block_kernel_on_card(cuda, shape):
    """Ragged and wide rows and an unaligned view go to the block kernel."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(*shape, generator=g, device=cuda).bfloat16()
    w = 1 + 0.1 * torch.randn(shape[-1], generator=g, device=cuda)
    flat = torch.randn(2 * 3072 + 8, generator=g, device=cuda).bfloat16()
    odd, w3 = flat[1:1 + 2 * 3072].view(2, 3072), torch.ones(3072, device=cuda)
    for xi, wi in ((x, w), (odd, w3)):
        before = trn.launches.by_variant["block"]
        y = trn.rmsnorm_cuda(xi, wi)
        assert trn.launches.by_variant["block"] == before + 1
        torch.testing.assert_close(y.float(), ref.rmsnorm(xi, wi).float(),
                                   rtol=2 ** -7, atol=2 ** -7)
        assert len(_kernels_per_call(lambda: trn.rmsnorm_cuda(xi, wi))) == 1


SSD_CARD_CASES = [   # (bh, nc, L, p, n), dtype of x/b/c, a_cum span per chunk
    ((24, 4, 64, 64, 128), torch.bfloat16, 1.0),      # the path's shape, 4 chunks
    ((24, 64, 64, 64, 128), torch.bfloat16, 2.0),     # a 4096-token row
    ((6, 1, 37, 64, 128), torch.bfloat16, 1.0),       # a ragged chunk
    ((3, 5, 1, 64, 128), torch.bfloat16, 1.0),        # one-step chunks
    ((2, 700, 64, 64, 128), torch.bfloat16, 2.0),     # more chunks than a wave of blocks
    ((6, 3, 64, 64, 128), torch.float32, 1.0),
    ((16, 3, 8, 16, 16), torch.float32, 1.0),         # the smoke shape
    ((4, 2, 64, 64, 128), torch.bfloat16, 60.0),      # a_cum spans -60..0
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,span,kernel", [
    (*case, kernel) for case in SSD_CARD_CASES
    for kernel in (ssd_scan.VARIANTS if case[1] == torch.bfloat16 else ("simt",))])
def test_kernel_matches_plain_on_the_card(cuda, shape, dtype, span, kernel):
    """All three outputs within rtol 1e-5 of the largest plain value (f32 on
    both sides from the same inputs, sums in other orders; the tensor-core
    kernel splits each f32 operand into bf16 parts that carry its 24 bits);
    repeated launches bit-identical; one launch counted per call, under its
    variant."""
    bh, nc, L, p, n = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(bh, nc, L, p, generator=g, device=cuda).to(dtype)
    b = torch.randn(bh, nc, L, n, generator=g, device=cuda).to(dtype)
    c = torch.randn(bh, nc, L, n, generator=g, device=cuda).to(dtype)
    a = -torch.rand(bh, nc, L, generator=g, device=cuda) * (2 * span / L)
    before = dict(ssd_scan.launches.by_variant)
    k1 = ssd_scan.ssd_chunk(x, a, b, c, chunk=L, kernel=kernel)
    k2 = ssd_scan.ssd_chunk(x, a, b, c, chunk=L, kernel=kernel)
    want = ssd_scan.plain(x, a, b, c, chunk=L)
    assert ssd_scan.launches.by_variant[kernel] == before[kernel] + 2
    for u, v, w in zip(k1, k2, want):
        assert torch.equal(u, v)
        assert float((u - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.cuda
def test_ssd_op_runs_the_tensor_core_kernel_on_the_card(cuda):
    """The ssd op on a mamba2-shaped bf16 prefill (24 heads of 64, state 128,
    two chunks of 64) launches the tensor-core kernel once; its final state
    (f32) is within 1e-5 normwise of the plain chunked scan on the same
    card, and y (bf16) within one bf16 rounding of it."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(1, 128, 24, 64, generator=g, device=cuda).bfloat16()
    b, c = (torch.randn(1, 128, 24, 128, generator=g, device=cuda).bfloat16() for _ in range(2))
    a = -0.05 * torch.rand(1, 128, 24, generator=g, device=cuda)
    init = torch.randn(1, 24, 128, 64, generator=g, device=cuda)
    before = dict(ssd_scan.launches.by_variant)
    y, final = ops.ssd_with_state(x, a, b, c, chunk=64, initial_state=init)
    assert ssd_scan.launches.by_variant == {**before, "mma": before["mma"] + 1}
    yw, fw = ref.ssd_chunked(x, a, b, c, chunk=64, initial_state=init, return_state=True)
    assert float((final - fw).abs().max()) <= 1e-5 * float(fw.abs().max())
    assert bool(((y.float() - yw.float()).abs()
                 <= 2 ** -7 * yw.float().abs() + 1e-5 * float(yw.float().abs().max())).all())


@pytest.mark.cuda
def test_ssd_misaligned_views_and_wrong_picks_on_the_card(cuda):
    """A view 2 bytes into its storage goes to the CUDA-core kernel (same
    bits as on an aligned copy); the wrapper refuses the tensor-core kernel
    for it, and the C entry point refuses a wrong pick by itself."""
    g = torch.Generator(device=cuda).manual_seed(3)
    flat = torch.randn(2 * 64 * 64 + 8, generator=g, device=cuda).bfloat16()
    x = flat[1:1 + 2 * 64 * 64].view(2, 1, 64, 64)
    b, c = (torch.randn(2, 1, 64, 128, generator=g, device=cuda).bfloat16() for _ in range(2))
    a = -0.05 * torch.rand(2, 1, 64, generator=g, device=cuda)
    assert ssd_scan.variant(x, a, b, c) == "simt"
    for u, v in zip(ssd_scan.ssd_chunk(x, a, b, c, chunk=64),
                    ssd_scan.ssd_chunk(x.clone(), a, b, c, chunk=64, kernel="simt")):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="does not take"):
        ssd_scan.ssd_chunk(x, a, b, c, chunk=64, kernel="mma")
    xf = torch.randn(2, 1, 64, 64, generator=g, device=cuda)
    outs = [torch.empty(2, 1, 64, 64, device=cuda), torch.empty(2, 1, 128, 64, device=cuda),
            torch.empty(2, 1, 64, device=cuda)]
    rc = ssd_scan._entry()(*(t.data_ptr() for t in (xf, a, b, c, *outs)), 2, 64, 64, 128,
                           0, 0, 1, 1, 1, torch.cuda.current_stream().cuda_stream)
    assert rc != 0                     # variant 1 on f32 x: cudaErrorInvalidValue


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


@pytest.mark.cuda
def test_concurrent_first_use_builds_each_library_once_on_card(cuda, tmp_path, monkeypatch):
    """Two threads reach the kernels at once, with nothing built: each
    library is compiled by one nvcc, once, and loaded once; both threads get
    the same libraries."""
    import threading

    popen = native.subprocess.Popen
    started = []

    def counting(cmd, *args, **kwargs):
        started.append(cmd[-1])
        return popen(cmd, *args, **kwargs)

    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(native.subprocess, "Popen", counting)
    native._load.cache_clear()
    try:
        got, barrier = [], threading.Barrier(2)

        def first_use():
            barrier.wait(60)
            got.append(native.libraries())

        threads = [threading.Thread(target=first_use) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        assert not any(t.is_alive() for t in threads)
        assert len(got) == 2 and got[0] is got[1] and set(got[0]) == set(native.SOURCES)
        assert sorted(started) == sorted(str(native.csrc_dir() / f"{n}.cu")
                                         for n in native.SOURCES)
    finally:
        native._load.cache_clear()
