"""vmul_reduce on Hopper: the wrapper of ``csrc/vmul_reduce.cu``.

Replaces ``repro/kernels/vmul_reduce.py::vmul_reduce`` (the Pallas kernel,
``pallas_call`` at :63).  The kernel is bound by bytes read; see the note at
the top of the CUDA source for the design.  :func:`vmul_reduce_cuda` checks
its inputs, allocates the output and the per-block partials, launches on
PyTorch's current stream and counts the launch in :data:`launches`.
:data:`plain` is the plain version (:func:`repro_torch.kernels.ref.vmul_reduce`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import native, ref

plain = ref.vmul_reduce
launches = native.LaunchCounter("vmul_reduce")

ELEMS_PER_BLOCK = 8192   # pass-1 work per block; with MAX_BLOCKS, a function of n only
MAX_BLOCKS = 1024


def num_blocks(n: int) -> int:
    """Pass-1 grid size: depends on ``n`` only, never on the card, so the
    summation order (and the result's bits) is fixed for a given length."""
    return max(1, min(MAX_BLOCKS, -(-n // ELEMS_PER_BLOCK)))


def check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape or a.dim() != 1:
        raise ValueError(f"expect equal 1-D shapes, got {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")


@functools.cache
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return native.c_function("vmul_reduce", "repro_vmul_reduce",
                             [p, p, p, p, ctypes.c_longlong, i, i, p])


def vmul_reduce_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    check_shapes(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"vmul_reduce_cuda needs both inputs on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype not in native.DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"vmul_reduce_cuda takes float32 or bfloat16 inputs of "
                        f"one dtype, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("vmul_reduce_cuda needs contiguous inputs")
    n = a.shape[0]
    blocks = num_blocks(n)
    out = torch.empty((), dtype=a.dtype, device=a.device)
    partials = torch.empty(blocks, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                      partials.data_ptr(), n, blocks,
                      native.DTYPE_CODES[a.dtype], native.stream_handle(a.device))
    native.check_launch(rc, "vmul_reduce")
    launches.count += 1
    return out
