"""Public kernel wrappers, as PyTorch custom ops, and their registration as
the overlay's LARGE-tile bitstreams (``repro/kernels/ops.py:148-166``).

Each kernel is one ``torch.library.custom_op``:

* ``repro_torch::vmul_reduce(a, b)`` and ``repro_torch::rmsnorm(x, w, eps)``;
* the CUDA implementation is the hand-written kernel (it launches or raises;
  there is no fallback), the CPU implementation is the plain version — a
  wrapper takes the plain version only because its tensors lie on the CPU;
* a ``register_fake`` gives shapes, which is how the trace frontend
  (``make_fx`` in fake mode) sees a kernel call as ONE node — the port's
  counterpart of the reference's rule for registered calls
  (``repro/core/trace.py:17-21``).

rmsnorm's backward is the VJP of the plain version, recomputed from the
inputs inside a ``torch.autograd.Function`` (``repro/kernels/ops.py:42-45``).
"""

from __future__ import annotations

import torch

from repro_torch.core.patterns import Operator, TileClass, register_call
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import vmul_reduce as _vr


# ---------------------------------------------------------------------------
# vmul_reduce — forward-only pattern (the paper's benchmark op)
# ---------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::vmul_reduce", mutates_args=(),
                         device_types="cpu")
def _vmul_reduce_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _vr.check_shapes(a, b)
    return _vr.plain(a, b)


_vmul_reduce_op.register_kernel("cuda")(_vr.vmul_reduce_cuda)


@_vmul_reduce_op.register_fake
def _(a, b):
    _vr.check_shapes(a, b)
    return a.new_empty(())


def vmul_reduce(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused dot product of two equal 1-D vectors (f32 accumulation)."""
    return _vmul_reduce_op(a, b)


# ---------------------------------------------------------------------------
# rmsnorm — backward recomputes the plain version's VJP from the inputs
# ---------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=(),
                         device_types="cpu")
def _rmsnorm_op(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    _rn.check_shapes(x, w)
    return _rn.plain(x, w, eps=eps)


_rmsnorm_op.register_kernel("cuda")(_rn.rmsnorm_cuda)


@_rmsnorm_op.register_fake
def _(x, w, eps):
    _rn.check_shapes(x, w)
    return torch.empty_like(x)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_op(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            wd = w.detach().requires_grad_()
            gx, gw = torch.autograd.grad(ref.rmsnorm(xd, wd, eps=ctx.eps),
                                         (xd, wd), g)
        return (gx if ctx.needs_input_grad[0] else None,
                gw if ctx.needs_input_grad[1] else None, None)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis. x: (..., d), w: (d,)."""
    return _RMSNorm.apply(x, w, eps)


# ---------------------------------------------------------------------------
# Overlay registry: the custom ops are pre-synthesized LARGE-tile bitstreams.
# A traced function calling one of these wrappers lowers to a single LARGE
# node (named below) instead of being decomposed into scalar aten ops.
# ---------------------------------------------------------------------------
register_call("repro_torch::vmul_reduce",
              Operator("kernels/vmul_reduce", 2, vmul_reduce,
                       TileClass.LARGE, flops_per_elem=2.0), override=True)
register_call("repro_torch::rmsnorm",
              Operator("kernels/rmsnorm", 2, rmsnorm,
                       TileClass.LARGE, flops_per_elem=4.0), override=True)

LAUNCH_COUNTERS = (_vr.launches, _rn.launches)
