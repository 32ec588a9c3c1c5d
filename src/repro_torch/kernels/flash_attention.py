"""flash_attention on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
kernel ``_kernel`` at :33, ``pallas_call`` at :115).  The kernel is bound by
operations; see the note at the top of the CUDA source for the design.
:func:`flash_attention` keeps the reference's signature and layout — q
``(B, Hq, S, D)``, k/v ``(B, Hkv, S, D)`` — checks its inputs, allocates the
output, launches one block per (64-row query tile, batch·head) on PyTorch's
current stream and counts the launch in :data:`launches`.  It takes CUDA
tensors only; :data:`plain` is the plain version
(:func:`repro_torch.kernels.ref.attention`), which the custom op
``repro_torch::attention`` (:mod:`repro_torch.kernels.ops`) runs for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import native, ref

plain = ref.attention
launches = native.LaunchCounter("flash_attention")

MAX_HEAD_DIM = 128


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
                             [p, p, p, p, i, i, i, i, i, i, f, i, i, i, i, f, i, p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention over (B, Hq, S, D) q and (B, Hkv, S, D) k/v, Hq % Hkv == 0."""
    check_shapes(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in native.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims up to {MAX_HEAD_DIM}, got {d}")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out                         # nothing to launch
    with torch.cuda.device(q.device):
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      b, hq, hkv, sq, sk, d, float(scale), int(causal),
                      int(window is not None), int(window or 0),
                      int(softcap is not None), float(softcap or 0.0),
                      native.DTYPE_CODES[q.dtype], native.stream_handle(q.device))
    native.check_launch(rc, "flash_attention")
    launches.count += 1
    return out
