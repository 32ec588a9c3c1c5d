"""LR schedules: constant, cosine, and WSD (warmup-stable-decay, MiniCPM).

Port of ``repro/optim/schedules.py:8-37``: each schedule maps a step (an int
or an int tensor) to an f32 tensor on the step's device, with the
reference's arithmetic.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    def f(step):
        return torch.full((), lr, dtype=torch.float32, device=_f32(step).device)
    return f


def cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * \
            (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return f


def wsd(lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.01):
    """MiniCPM's warmup-stable-decay: linear warmup, long plateau,
    short exponential-ish (here linear) decay to final_frac*lr."""
    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        plateau = torch.full_like(step, lr)
        prog = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = lr * (final_frac ** prog)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable, plateau, dec))
    return f
