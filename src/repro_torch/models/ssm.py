"""Mamba-2 (SSD) block — attention-free sequence mixing.

Port of ``repro/models/ssm.py``.  The reference's SPLIT input projections
(z / x / B / C / dt as separate weights, chosen there for sharding) are kept
so that parameters carry over leaf for leaf.

Pipeline: projections -> causal depthwise conv on [x|B|C] -> softplus dt ->
SSD scan (the ``ssd_chunk`` CUDA kernel through ``kops.ssd`` or
``kops.ssd_with_state``) -> D-skip -> gated RMSNorm -> out projection.
Decode keeps O(1) state: a rolling conv window plus the (h, n, p) SSD state,
updated by the plain ``kops.ssd_decode_step``.  Every product is one aten op
(``linear``, ``bmm``), as traced model code must be (ROADMAP queue 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import linear
from repro_torch.models.params import ParamSpec, dense, norm_scale, zeros


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads


def ssm_spec(cfg: ArchConfig) -> dict:
    d_inner, nheads = _dims(cfg)
    n, w = cfg.ssm_state, cfg.ssm_conv_width
    return {
        "w_z": dense(cfg.d_model, d_inner, "embed", "ssm_in"),
        "w_x": dense(cfg.d_model, d_inner, "embed", "ssm_in"),
        "w_b": dense(cfg.d_model, n, "embed", None),
        "w_c": dense(cfg.d_model, n, "embed", None),
        "w_dt": dense(cfg.d_model, nheads, "embed", None),
        "conv_x": ParamSpec((w, d_inner), (None, "ssm_in"), "normal", 0.5),
        "conv_b": ParamSpec((w, n), (None, None), "normal", 0.5),
        "conv_c": ParamSpec((w, n), (None, None), "normal", 0.5),
        "conv_bias_x": ParamSpec((d_inner,), ("ssm_in",), "zeros"),
        "conv_bias_b": ParamSpec((n,), (None,), "zeros"),
        "conv_bias_c": ParamSpec((n,), (None,), "zeros"),
        "a_log": ParamSpec((nheads,), (None,), "ssm_a", dtype=torch.float32),
        "d_skip": ParamSpec((nheads,), (None,), "ones", dtype=torch.float32),
        "dt_bias": ParamSpec((nheads,), (None,), "zeros", dtype=torch.float32),
        "gate_norm": norm_scale(d_inner),
        "out_proj": dense(d_inner, cfg.d_model, "ssm_in", "embed"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d. x: (B, S, C), w: (W, C), state: (B, W-1, C).

    Shifted slices summed in f32 in the reference's order
    (``repro/models/ssm.py:56-70``) rather than ``F.conv1d``, so the card
    and the CPU add the same terms in the same order.  Returns (out in x's
    dtype, new state = the last W-1 inputs)."""
    width = w.shape[0]
    s = x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
        full = torch.cat([pad, x], dim=1)
    else:
        full = torch.cat([state.to(x.dtype), x], dim=1)
    new_state = full[:, -(width - 1):] if width > 1 else None
    ff = full.float()
    out = w[0].float() * ff[:, 0:s]
    for i in range(1, width):
        out = out + w[i].float() * ff[:, i:i + s]
    return (out + b.float()).to(x.dtype), new_state


def ssm_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
            cache: dict | None = None):
    """x: (B, S, d_model) -> (same, updated cache or None)."""
    bsz, s, _ = x.shape
    d_inner, nheads = _dims(cfg)
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim

    z = linear(x, p["w_z"])
    xs = linear(x, p["w_x"])
    bmat = linear(x, p["w_b"])
    cmat = linear(x, p["w_c"])
    dt_raw = linear(x, p["w_dt"])

    cs = cache["conv"] if cache is not None else {"x": None, "b": None, "c": None}
    xs, ncx = _causal_conv(xs, p["conv_x"], p["conv_bias_x"], cs["x"])
    bmat, ncb = _causal_conv(bmat, p["conv_b"], p["conv_bias_b"], cs["b"])
    cmat, ncc = _causal_conv(cmat, p["conv_c"], p["conv_bias_c"], cs["c"])
    xs, bmat, cmat = F.silu(xs), F.silu(bmat), F.silu(cmat)
    new_conv = {"x": ncx, "b": ncb, "c": ncc}

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())      # (B, S, h)
    a = -torch.exp(p["a_log"].float())                          # (h,)
    a_full = a[None, None] * dt                                 # (B, S, h) <= 0

    xh = xs.reshape(bsz, s, nheads, pdim)
    x_in = (xh.float() * dt[..., None]).to(x.dtype)
    # materialized for every head, as the reference's broadcast_to is
    b_full = bmat[:, :, None, :].expand(bsz, s, nheads, n).contiguous()
    c_full = cmat[:, :, None, :].expand(bsz, s, nheads, n).contiguous()

    # pad the sequence up to a chunk multiple (padding has a=0, x=0: decay
    # e^0 = 1 passes state through, zero input adds nothing — the final
    # state and the real tokens' outputs are unaffected)
    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    if pad and s > 1:
        x_in, a_full, b_full, c_full = (
            F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x_in, a_full, b_full, c_full))

    if cache is None:
        y = kops.ssd(x_in, a_full, b_full, c_full, chunk=chunk)
        new_ssm = None
    elif s == 1:
        y, new_ssm = kops.ssd_decode_step(
            x_in[:, 0].float(), a_full[:, 0], b_full[:, 0].float(), c_full[:, 0].float(),
            cache["ssm"])
        y = y[:, None].to(x.dtype)
    else:  # chunked prefill carrying state
        y, new_ssm = kops.ssd_with_state(x_in, a_full, b_full, c_full, chunk=chunk,
                                         initial_state=cache["ssm"])
    if pad and s > 1:
        y = y[:, :s]

    y = y.reshape(bsz, s, nheads, pdim) + \
        p["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, d_inner).to(x.dtype)

    # gated RMSNorm (mamba2): norm(y * silu(z)), inline in f32 as in the
    # reference (ssm.py:136-141), not the rmsnorm kernel
    g = y * F.silu(z.float()).to(x.dtype)
    gf = g.float()
    ms = torch.mean(gf * gf, dim=-1, keepdim=True)
    g = (gf * torch.rsqrt(ms + cfg.norm_eps) * p["gate_norm"].float()).to(x.dtype)

    out = linear(g, p["out_proj"])
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "ssm": new_ssm}
    return out, new_cache


def ssm_cache_spec(cfg: ArchConfig, batch: int) -> dict:
    """The decode state of one mamba layer as specs with logical axes
    (``repro/models/ssm.py:150-165``): conv windows in bf16 whatever the
    parameter dtype, the SSD state in f32."""
    d_inner, nheads = _dims(cfg)
    w = cfg.ssm_conv_width
    bf16 = torch.bfloat16
    return {"conv": {"x": ParamSpec((batch, w - 1, d_inner), ("batch", None, "ssm_in"),
                                    "zeros", dtype=bf16),
                     "b": ParamSpec((batch, w - 1, cfg.ssm_state), ("batch", None, None),
                                    "zeros", dtype=bf16),
                     "c": ParamSpec((batch, w - 1, cfg.ssm_state), ("batch", None, None),
                                    "zeros", dtype=bf16)},
            "ssm": ParamSpec((batch, nheads, cfg.ssm_state, cfg.ssm_head_dim),
                             ("batch", None, None, None), "zeros", dtype=torch.float32)}


def ssm_cache(cfg: ArchConfig, batch: int,
              device: "str | torch.device | None" = None) -> dict:
    """Zeroed decode state of one mamba layer (:func:`ssm_cache_spec`)."""
    return zeros(ssm_cache_spec(cfg, batch), resolve_device(device))
