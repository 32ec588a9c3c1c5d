"""Transformer layers: RoPE, RMSNorm, attention over a KV cache (full or
sliding-window, with gemma2's logit softcap and query scaling), the
SwiGLU / GeGLU MLP.

Every layer is a plain function of a parameter dict and tensors.  The
functions are functional (no in-place updates), so the overlay's tracer can
capture them.

Port of the dense subset of ``repro/models/layers.py``.  Attention over a
KV cache — cached prefill and decode, including the ragged per-row decode
branch (``layers.py:314-332``) — is plain tensor code in the reference
(``layers.py:304-351``) and plain PyTorch here.  Attention without a cache
(the training loss, the cache-free forward) runs the flash_attention
kernel through its custom op.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------
# ``torch.matmul`` and ``torch.einsum`` pick their aten decomposition (a 2-D
# mm on a folded view, or an expanded batched product) from the operands'
# strides, including the strides of size-1 dims.  The overlay's tracer sees
# fake tensors, whose size-1 strides need not match eager CUDA tensors', so a
# traced step could bake in another decomposition than eager runs — another
# cuBLAS call and other roundings.  The layers therefore call mm and bmm
# directly: those are single aten ops with nothing left to decide.
def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., d_in), w (d_in, d_out), as one 2-D mm."""
    return torch.mm(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., dim/2) f32."""
    freqs = torch.exp(-math.log(theta) *
                      torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=positions.device) / dim)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2)."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]   # (B, S, 1, D/2)
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Norm
# ---------------------------------------------------------------------------
def rmsnorm_fwd(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    # the kernel for big rows; plain tensor code for tiny (smoke) rows, as
    # the reference does (layers.py:72-75)
    if x.shape[-1] >= 128:
        return kops.rmsnorm(x, scale, eps=eps)
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
def _act(cfg: ArchConfig, x):
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


def mlp_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = _act(cfg, linear(x, p["w_gate"])) * linear(x, p["w_up"])
    return linear(h, p["w_down"])


def cache_update(cache: torch.Tensor, new: torch.Tensor, idx, *, axis: int):
    """Write ``new`` into ``cache`` at position ``idx`` along ``axis`` (the
    reference's dynamic_update_slice), out of place.  ``idx`` may be a
    tensor: the write positions are computed on the device, so a traced
    step never bakes the cache index in."""
    pos = torch.as_tensor(idx, device=cache.device).long() + \
        torch.arange(new.shape[axis], device=cache.device)
    return cache.index_copy(axis, pos, new.to(cache.dtype))


# ---------------------------------------------------------------------------
# Attention (GQA family) over a KV cache
# ---------------------------------------------------------------------------
def _attention(q, k, v, *, window, softcap, scale, q_offset, kv_len):
    """Causal masked attention (B,H,Sq,D)x(B,Hkv,Sk,D), scores in f32.

    ``q_offset`` positions queries within the kv sequence (decode);
    ``kv_len`` masks out unwritten cache slots.  Either may also be a (B,)
    tensor — ragged decode, every batch row at its own position.  ``window``
    (None for full attention) keeps only the keys less than ``window``
    positions behind each query, the row's own position on the ragged
    branch.  Mirrors ``repro/models/layers.py::_attention_xla``, including
    the rounding of the probabilities to the cache dtype before the value
    product."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    dev = q.device
    qf = q.reshape(b, hkv, group, sq, d).float().reshape(b * hkv, group * sq, d)
    kf = k.float().reshape(b * hkv, sk, d)
    s = torch.bmm(qf, kf.transpose(1, 2)).reshape(b, hkv, group, sq, sk) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    ragged = any(isinstance(t, torch.Tensor) and t.dim() >= 1
                 for t in (q_offset, kv_len))
    if ragged:
        qo = torch.as_tensor(q_offset, device=dev).to(torch.int32).reshape(-1)
        kl = torch.as_tensor(kv_len, device=dev).to(torch.int32).reshape(-1)
        qpos = qo[:, None, None] + torch.arange(sq, device=dev)[None, :, None]
        kpos = torch.arange(sk, device=dev)[None, None, :]
        mask = (qpos >= kpos) & (kpos < kl[:, None, None])
        if window is not None:
            mask = mask & ((qpos - kpos) < window)
        s = torch.where(mask[:, None, None], s, -1e30)
    else:
        qpos = q_offset + torch.arange(sq, device=dev)[:, None]
        kpos = torch.arange(sk, device=dev)[None, :]
        mask = (qpos >= kpos) & (kpos < kv_len)
        if window is not None:
            mask = mask & ((qpos - kpos) < window)
        s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    pf = p.to(v.dtype).float().reshape(b * hkv, group * sq, sk)
    o = torch.bmm(pf, v.float().reshape(b * hkv, sk, v.shape[-1]))
    return o.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def attn_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *, kind: str,
             positions: torch.Tensor, cache: dict | None):
    """Self-attention, over a KV cache or (``cache=None``) over the whole
    sequence.

    x: (B, S, D). kind: dense | local | global | shared_attn; a ``local``
    layer attends within ``cfg.sliding_window`` positions (gemma2), on every
    branch; the others attend causally with no window (a ``shared_attn``
    occurrence, zamba2's, as the reference's ``layers.py:279-281``).
    cache: None or {"k": (B, Hkv, Smax, hd), "v": ..., "index": ()}.
    ``positions`` is (S,) for a uniform batch, or (B, S) for ragged decode,
    where every row writes its KV entry at its own position.
    Returns (out, updated_cache); the cache is None without one.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q = linear(x, p["wq"]).reshape(b, s, hq, hd)
    k = linear(x, p["wk"]).reshape(b, s, hkv, hd)
    v = linear(x, p["wv"]).reshape(b, s, hkv, hd)
    window = cfg.sliding_window if kind == "local" else None
    if cfg.query_pre_attn_scalar is not None:
        scale = cfg.query_pre_attn_scalar ** -0.5
    else:
        scale = hd ** -0.5

    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    if cache is None:
        # the flash_attention op at every length: the CUDA kernel masks
        # ragged tiles itself, so the reference's gate to plain code where S
        # is not a multiple of its 128 blocks (repro/models/layers.py:237-255)
        # has nothing to route around here
        o = kops.attention(qt, kt, vt, causal=True, window=window,
                           softcap=cfg.attn_softcap, scale=scale)
        o = o.transpose(1, 2).reshape(b, s, hq * hd)
        return linear(o, p["wo"]), None

    idx = cache["index"]
    if positions.dim() >= 2:
        # ragged decode (s == 1): one-hot per-row KV writes, per-row extent;
        # the scalar cache "index" keeps ticking but the mask never reads it
        pos_b = positions[:, 0].to(torch.int32)                     # (B,)
        sel = torch.arange(cache["k"].shape[2], device=x.device)[None, :] \
            == pos_b[:, None]
        ck = torch.where(sel[:, None, :, None], kt.to(cache["k"].dtype), cache["k"])
        cv = torch.where(sel[:, None, :, None], vt.to(cache["v"].dtype), cache["v"])
        o = _attention(qt, ck, cv, window=window, softcap=cfg.attn_softcap,
                       scale=scale, q_offset=pos_b, kv_len=pos_b + s)
    else:
        ck = cache_update(cache["k"], kt, idx, axis=2)
        cv = cache_update(cache["v"], vt, idx, axis=2)
        o = _attention(qt, ck, cv, window=window, softcap=cfg.attn_softcap,
                       scale=scale, q_offset=idx, kv_len=idx + s)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return linear(o, p["wo"]), {"k": ck, "v": cv, "index": idx + s}
