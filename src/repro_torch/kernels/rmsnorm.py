"""rmsnorm on Hopper: the wrapper of ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (the Pallas kernel,
``pallas_call`` at :44).  The kernel is bound by bytes read and written; see
the note at the top of the CUDA source for the design.  :func:`rmsnorm_cuda`
checks its inputs, allocates the output, launches one block per row on
PyTorch's current stream and counts the launch in :data:`launches`.
:data:`plain` is the plain version (:func:`repro_torch.kernels.ref.rmsnorm`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import native, ref

plain = ref.rmsnorm
launches = native.LaunchCounter("rmsnorm")


def check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if w.dim() != 1 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")


@functools.cache
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return native.c_function("rmsnorm", "repro_rmsnorm",
                             [p, p, p, ctypes.c_longlong, i, ctypes.c_float,
                              i, i, p])


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    check_shapes(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm_cuda needs x and w on one CUDA device, got "
                         f"{x.device} and {w.device}")
    if x.dtype not in native.DTYPE_CODES or w.dtype not in native.DTYPE_CODES:
        raise TypeError(f"rmsnorm_cuda takes float32 or bfloat16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and w")
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out                         # nothing to launch
    with torch.cuda.device(x.device):
        rc = _entry()(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                      float(eps), native.DTYPE_CODES[x.dtype],
                      native.DTYPE_CODES[w.dtype], native.stream_handle(x.device))
    native.check_launch(rc, "rmsnorm")
    launches.count += 1
    return out
