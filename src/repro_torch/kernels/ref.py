"""Plain PyTorch versions of the port's kernels — the correctness ground truth.

Each function computes what its TPU kernel computes, in the most obvious
dense formulation (copies of ``repro/kernels/ref.py:14,19``).  The custom
ops in :mod:`repro_torch.kernels.ops` run these on CPU tensors, the CPU tests
hold them against the JAX package, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.
"""

from __future__ import annotations

import torch


def vmul_reduce(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum = Σ A⃗·B⃗ (paper §III), accumulated in f32, returned in a's dtype."""
    return torch.sum(a.float() * b.float()).to(a.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)
