"""flash_attention on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
kernel ``_kernel`` at :33, ``pallas_call`` at :115).  The kernels are bound
by operations; see the note at the top of the CUDA source for the design.
:func:`flash_attention` keeps the reference's signature and layout — q
``(B, Hq, S, D)``, k/v ``(B, Hkv, S, D)`` — checks its inputs, allocates the
output, launches on PyTorch's current stream and counts the launch in
:data:`launches`, under its variant (:func:`variant`): ``"wgmma"``, the
tensor-core kernel, for bfloat16 with a head dim that is a multiple of 16 up
to 128 (the training path); ``"simt"``, the CUDA-core kernel, for float32
and any other head dim.  It takes CUDA tensors only; :data:`plain` is the
plain version (:func:`repro_torch.kernels.ref.attention`), which the custom
op ``repro_torch::attention`` (:mod:`repro_torch.kernels.ops`) runs for CPU
tensors.  :func:`tolerance` is how far each variant's output may lie from
the plain version's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import native, ref

plain = ref.attention
VARIANTS = ("wgmma", "simt")
launches = native.LaunchCounter("flash_attention", VARIANTS)

MAX_HEAD_DIM = 128
_VARIANT_CODES = {"simt": 0, "wgmma": 1}


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that runs attention of this dtype and head dim."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= MAX_HEAD_DIM:
        return "wgmma"
    return "simt"


def tolerance(plain_out: torch.Tensor, v: torch.Tensor, kernel: str) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for one variant's output.

    Both variants take the scores and the softmax in f32.  In float32 they
    differ from the plain version in summation order, the online
    normalization and where ``scale`` is applied: 1e-5 * (1 + |plain|).  A
    bf16 output is rounded once from f32 values that close, so the CUDA-core
    kernel lands within one bf16 ulp: 2^-7 * |plain| + 1e-5.  The tensor-core
    kernel also rounds each probability p in [0, 1] to bf16 before P V, which
    moves it by at most 2^-9 p, so the output sum(p v) / l moves by at most
    2^-9 max_j |v_j|; with a margin of two it gets 2^-8 max_j |v_j| more,
    the max over the keys of the row's kv head, per column."""
    p = plain_out.float().abs()
    if v.dtype == torch.float32:
        return 1e-5 * (1 + p)
    tol = 2 ** -7 * p + 1e-5
    if kernel == "wgmma":
        vmax = v.float().abs().amax(dim=2, keepdim=True)          # (B, Hkv, 1, D)
        tol = tol + 2 ** -8 * vmax.repeat_interleave(p.shape[1] // v.shape[1], dim=1)
    return tol


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"expect q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")


@functools.cache
def _entry():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return native.c_function("flash_attention", "repro_flash_attention",
                             [p, p, p, p, i, i, i, i, i, i, f, i, i, i, i, f, i, i, p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None,
                    kernel: str | None = None) -> torch.Tensor:
    """Attention over (B, Hq, S, D) q and (B, Hkv, S, D) k/v, Hq % Hkv == 0.

    ``kernel`` names the variant to launch; by default :func:`variant`
    picks it.  ``"simt"`` takes every input; ``"wgmma"`` raises for inputs
    it does not take."""
    check_shapes(q, k, v)
    if q.dtype not in native.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims up to {MAX_HEAD_DIM}, got {d}")
    chosen = variant(q.dtype, d)
    kernel = chosen if kernel is None else kernel
    if kernel not in VARIANTS or (kernel == "wgmma" and chosen != "wgmma"):
        raise ValueError(f"flash_attention kernel {kernel!r} does not take {q.dtype} "
                         f"with head dim {d}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if kernel == "wgmma":
        if sk == 0:
            raise ValueError("the wgmma flash_attention kernel needs at least one key")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the wgmma flash_attention kernel needs 16-byte aligned q, k, "
                             "v (TMA); a view with a storage offset may not be")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out                         # nothing to launch
    with torch.cuda.device(q.device):
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      b, hq, hkv, sq, sk, d, float(scale), int(causal),
                      int(window is not None), int(window or 0),
                      int(softcap is not None), float(softcap or 0.0),
                      native.DTYPE_CODES[q.dtype], _VARIANT_CODES[kernel],
                      native.raw_stream(q.device.index))
    native.check_launch(rc, f"flash_attention ({kernel})")
    launches.add(kernel)
    return out
