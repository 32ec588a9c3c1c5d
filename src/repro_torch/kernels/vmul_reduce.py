"""vmul_reduce on Hopper: the wrapper of ``csrc/vmul_reduce.cu``.

Replaces ``repro/kernels/vmul_reduce.py::vmul_reduce`` (the Pallas kernel,
``pallas_call`` at :63).  The kernel is bound by bytes read; see the note at
the top of the CUDA source for the design.  :func:`vmul_reduce_cuda` checks
its inputs, allocates the output (its only per-call allocation), launches ONE
kernel on PyTorch's current stream as :func:`plan` says, and counts the launch
in :data:`launches`, by variant (``"cluster"`` or ``"grid"``).  The grid
variant's partials and ticket live in a workspace allocated once per (device,
stream) by :func:`workspace`.  :data:`plain` is the plain version
(:func:`repro_torch.kernels.ref.vmul_reduce`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import native, ref

plain = ref.vmul_reduce
launches = native.LaunchCounter("vmul_reduce", ("cluster", "grid"))

THREADS = 256            # threads a block, both variants
CLUSTER = 8              # CTAs of the one cluster that takes n <= CLUSTER_MAX_N (portable size)
CLUSTER_MAX_N = 1 << 15  # measured on the H100: the cluster ties or wins up to here (PERF.md §6)
ELEMS_PER_BLOCK = 4096   # grid variant: elements a block, up to MAX_BLOCKS blocks
MAX_BLOCKS = 528         # 132 SMs x 4 resident blocks: one wave on an H100


class Plan(NamedTuple):
    """One launch: ``blocks`` blocks, forming one cluster when ``cluster``."""
    cluster: bool
    blocks: int


def plan(n: int) -> Plan:
    """The launch for length ``n``.  It depends on ``n`` only, never on the
    card or the stream, so the summation order (and the result's bits) is
    fixed for a given length."""
    if n <= CLUSTER_MAX_N:
        return Plan(True, CLUSTER)
    return Plan(False, min(MAX_BLOCKS, -(-n // ELEMS_PER_BLOCK)))


_workspaces: dict[tuple[torch.device, int], torch.Tensor] = {}


def workspace(device: torch.device, stream: int) -> torch.Tensor:
    """The grid variant's ticket (word 0, zero between launches) and
    partials, one per (device, stream): calls on one stream run in order,
    and two streams never share a ticket.  Allocated and zeroed at a
    stream's first call, on that stream."""
    key = (device, stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = torch.zeros(1 + MAX_BLOCKS, dtype=torch.int32, device=device)
    return ws


def check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape or a.dim() != 1:
        raise ValueError(f"expect equal 1-D shapes, got {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")


@functools.cache
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return native.c_function("vmul_reduce", "repro_vmul_reduce",
                             [p, p, p, p, ctypes.c_longlong, i, i, i, i, p])


def vmul_reduce_cuda(a: torch.Tensor, b: torch.Tensor, *,
                     launch_plan: Plan | None = None) -> torch.Tensor:
    """``sum(a * b)`` in a's dtype.  ``launch_plan`` overrides :func:`plan`
    (to time the variants against each other); the bits then follow it."""
    device = a.device
    if device.type != "cuda" or b.device != device:
        raise ValueError(f"vmul_reduce_cuda needs both inputs on one CUDA "
                         f"device, got {device} and {b.device}")
    code = native.DTYPE_CODES.get(a.dtype)
    if code is None or b.dtype != a.dtype:
        raise TypeError(f"vmul_reduce_cuda takes float32 or bfloat16 inputs of "
                        f"one dtype, got {a.dtype} and {b.dtype}")
    check_shapes(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("vmul_reduce_cuda needs contiguous inputs")
    n = a.shape[0]
    cluster, blocks = launch_plan or plan(n)
    index = device.index
    stream = native.raw_stream(index)
    ws = 0 if cluster else workspace(device, stream).data_ptr()
    out = torch.empty((), dtype=a.dtype, device=device)
    rc = _entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), ws, n,
                  blocks if cluster else 0, blocks, code, index, stream)
    native.check_launch(rc, "vmul_reduce")
    launches.add("cluster" if cluster else "grid")
    return out
