"""rmsnorm on Hopper: the wrapper of ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (the Pallas kernel,
``pallas_call`` at :44).  The kernel is bound by bytes read and written; see
the note at the top of the CUDA source for the design.  :func:`rmsnorm_cuda`
checks its inputs, allocates the output, launches ONE kernel on PyTorch's
current stream -- the variant :func:`variant` picks: ``"warp"`` (a warp per
row, the row in registers) or ``"block"`` (a block per row, any d and
alignment) -- and counts the launch in :data:`launches`, by variant.
:data:`plain` is the plain version (:func:`repro_torch.kernels.ref.rmsnorm`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import native, ref

plain = ref.rmsnorm
VARIANTS = ("warp", "block")
launches = native.LaunchCounter("rmsnorm", VARIANTS)

MAX_WARP_D = 4096        # the warp kernel's widest row (32 lanes x 32 vectors of f32)
_VARIANT_CODES = {v: i for i, v in enumerate(VARIANTS)}


def check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if w.dim() != 1 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")


def variant(x: torch.Tensor, out: torch.Tensor) -> str:
    """``"warp"`` where the row fits a warp's registers in 16-byte vectors
    (d a multiple of 16 bytes of x, at most :data:`MAX_WARP_D`, x and the
    output 16-byte aligned), else ``"block"``."""
    d = x.shape[-1]
    vec = 16 // x.element_size()
    if d % vec == 0 and d <= MAX_WARP_D and (x.data_ptr() | out.data_ptr()) % 16 == 0:
        return "warp"
    return "block"


@functools.cache
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return native.c_function("rmsnorm", "repro_rmsnorm",
                             [p, p, p, ctypes.c_longlong, i, ctypes.c_float,
                              i, i, i, i, p])


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    check_shapes(x, w)
    device = x.device
    if device.type != "cuda" or w.device != device:
        raise ValueError(f"rmsnorm_cuda needs x and w on one CUDA device, got "
                         f"{device} and {w.device}")
    xcode, wcode = native.DTYPE_CODES.get(x.dtype), native.DTYPE_CODES.get(w.dtype)
    if xcode is None or wcode is None:
        raise TypeError(f"rmsnorm_cuda takes float32 or bfloat16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and w")
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out                         # nothing to launch
    kernel = variant(x, out)
    index = device.index
    rc = _entry()(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, eps, xcode,
                  wcode, _VARIANT_CODES[kernel], index, native.raw_stream(index))
    native.check_launch(rc, f"rmsnorm ({kernel})")
    launches.add(kernel)
    return out
