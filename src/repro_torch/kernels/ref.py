"""Plain PyTorch versions of the port's kernels — the correctness ground truth.

Each function computes what its TPU kernel computes, in the most obvious
dense formulation (copies of ``repro/kernels/ref.py:14,19,25,55,112``).  The custom
ops in :mod:`repro_torch.kernels.ops` run these on CPU tensors, the CPU tests
hold them against the JAX package, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                chunk: int = 64, initial_state: torch.Tensor | None = None,
                return_state: bool = False):
    """Chunked SSD in plain PyTorch, the same math as the kernel and
    autograd-friendly (the backward's residuals are per-chunk states, not
    per-step states).  Batch and heads stay separate dims, as in the
    reference.  Shapes as :func:`ssd_naive`.  Returns y, or
    (y, final_state (b, h, n, p)).  Products are ``bmm`` (this code is
    traced as the ssd op's backward)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    L = chunk
    z = bsz * h * nc

    def to5(t):   # (b, s, h, f?) -> (b, h, nc, L, f?)
        t = t.transpose(1, 2)
        return t.reshape(bsz, h, nc, L, *t.shape[3:]).float()

    xb, ab, bb, cb = to5(x), to5(a), to5(b), to5(c)

    a_cum = torch.cumsum(ab, dim=-1)                             # (b, h, nc, L)
    seg = a_cum[..., :, None] - a_cum[..., None, :]              # (b, h, nc, L, L)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: the j>i entries have seg>0 and can overflow to inf,
    # which turns the where()'s backward into 0*inf = NaN
    decay = torch.exp(torch.where(tri, seg, -torch.inf))
    scores = torch.bmm(cb.reshape(z, L, n), bb.reshape(z, L, n).transpose(1, 2))
    scores = scores.reshape(bsz, h, nc, L, L) * decay
    y_diag = torch.bmm(scores.reshape(z, L, L), xb.reshape(z, L, p))

    w = torch.exp(a_cum[..., -1:] - a_cum)                       # (b, h, nc, L)
    states = torch.bmm((bb * w[..., None]).reshape(z, L, n).transpose(1, 2),
                       xb.reshape(z, L, p)).reshape(bsz, h, nc, n, p)

    prev, final = chunk_states(states, a_cum[..., -1], initial_state)

    y_off = torch.bmm(cb.reshape(z, L, n), prev.reshape(z, n, p))
    y_off = y_off.reshape(bsz, h, nc, L, p) * torch.exp(a_cum)[..., None]
    y = (y_diag.reshape(bsz, h, nc, L, p) + y_off).reshape(bsz, h, s, p).transpose(1, 2)
    if return_state:
        return y.to(x.dtype), final
    return y.to(x.dtype)


def segsum(v: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): ``out[..., i, j] = v[j+1] + ... + v[i]`` for
    j <= i (0 on the diagonal) and -inf above it.  Each segment is summed
    from its own start (a masked cumsum of ``v`` repeated along a new axis),
    not as the difference of one running cumsum, whose rounding grows with
    the running total; the -inf is set before any exp, so nothing above the
    diagonal can overflow (Mamba-2's minimal SSD code, arXiv:2405.21060)."""
    t = v.shape[-1]
    rep = v[..., :, None].expand(*v.shape, t)                   # rep[..., i, j] = v[i]
    strict = torch.ones((t, t), dtype=torch.bool, device=v.device).tril(-1)
    seg = torch.cumsum(torch.where(strict, rep, 0.0), dim=-2)
    lower = torch.ones((t, t), dtype=torch.bool, device=v.device).tril()
    return torch.where(lower, seg, -torch.inf)


def chunk_states(states: torch.Tensor, a_tot: torch.Tensor,
                 initial_state: torch.Tensor | None):
    """The inter-chunk recurrence ``prev[0] = init``,
    ``prev[c+1] = e^{a_tot[c]} prev[c] + states[c]`` in closed form:
    ``prev[c] = e^{S[c,-1]} init + sum_{k<c} e^{S[c,k]} states[k]`` with
    ``S[c, k] = a_tot[k+1] + ... + a_tot[c-1]``, as ONE ``bmm`` of the
    (nc+1, nc+1) decays (:func:`segsum` of a_tot behind a leading 0, init
    being chunk -1) by the (nc+1) stacked states.  No loop over chunks, so
    the host issues the same few ops whatever the sequence length.

    states (..., nc, n, p) f32, a_tot (..., nc), initial_state None or of
    as many elements as (..., n, p).  Returns (prev (..., nc, n, p): the state entering each
    chunk, final (..., n, p)), f32."""
    *lead, nc, n, p = states.shape
    z = math.prod(lead)
    init = (torch.zeros((z, 1, n * p), dtype=torch.float32, device=states.device)
            if initial_state is None else initial_state.float().reshape(z, 1, n * p))
    stacked = torch.cat([init, states.reshape(z, nc, n * p)], dim=1)      # (z, nc+1, n*p)
    decay = torch.exp(segsum(F.pad(a_tot.float().reshape(z, nc), (1, 0))))  # (z, nc+1, nc+1)
    out = torch.bmm(decay, stacked)
    return (out[:, :nc].reshape(*lead, nc, n, p), out[:, nc].reshape(*lead, n, p))


def ssd_naive(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              initial_state: torch.Tensor | None = None):
    """Sequential SSD recurrence: h_t = e^{a_t} h_{t-1} + B_t⊗x_t; y_t = C_t·h_t.

    x: (batch, s, h, p); a: (batch, s, h); b, c: (batch, s, h, n).
    Returns y: (batch, s, h, p), final_state: (batch, h, n, p)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    hs = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
          if initial_state is None else initial_state.float())
    xf, af, bf, cf = x.float(), a.float(), b.float(), c.float()
    ys = []
    for t in range(s):
        hs = hs * torch.exp(af[:, t])[..., None, None] + bf[:, t, :, :, None] * xf[:, t, :, None, :]
        ys.append(torch.sum(cf[:, t, :, :, None] * hs, dim=-2))
    return torch.stack(ys, dim=1).to(x.dtype), hs
