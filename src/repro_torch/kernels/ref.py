"""Plain PyTorch versions of the port's kernels — the correctness ground truth.

Each function computes what its TPU kernel computes, in the most obvious
dense formulation (copies of ``repro/kernels/ref.py:14,19,25``).  The custom
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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Dense attention with GQA/window/softcap, shapes as the kernel: q
    (B, Hq, Sq, D), k/v (B, Hkv, Sk, D).  Repeats the kv heads, takes the
    products in f32 (``bmm``, as the traced model code must), masks with
    -inf and turns the NaN of fully masked rows into 0."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    s = torch.bmm(q.float().reshape(b * hq, sq, d),
                  k.float().reshape(b * hq, sk, d).transpose(1, 2))
    s = s.reshape(b, hq, sq, sk) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap

    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)       # fully-masked rows
    o = torch.bmm(p.reshape(b * hq, sq, sk),
                  v.float().reshape(b * hq, sk, v.shape[-1]))
    return o.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)
