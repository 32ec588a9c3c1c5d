"""Transformer layers: RoPE, RMSNorm, attention over a KV cache (full or
sliding-window, with gemma2's logit softcap and query scaling), an
encoder's bidirectional self-attention and an encoder-decoder's
cross-attention, deepseek-v3's Multi-head Latent Attention (MLA) over a
latent cache, the SwiGLU / GeGLU MLP.

Every layer is a plain function of a parameter dict and tensors.  The
functions are functional (no in-place updates), so the overlay's tracer can
capture them.

Port of the dense, encoder-decoder and MLA subsets of
``repro/models/layers.py``.  Attention over a KV cache — cached prefill and
decode, including the ragged per-row decode branch (``layers.py:314-332``),
and cross-attention over the cache filled once from the encoder's output —
is plain tensor code in the reference (``layers.py:304-351``) and plain
PyTorch here.  Attention without a cache (the training loss, the
cache-free forward, the encoder, a cache-free cross-attention) runs the
flash_attention kernel through its custom op, causal or not, except MLA's, whose q/k width
(nope + rope) differs from its v width: the reference's dispatcher sends
that to plain code (``layers.py:241-247``), and so does the port.

:func:`set_attn_impl` picks how attention is computed, as the reference's
``ATTN_IMPL`` (``layers.py:29-43``): ``"flash"`` (the reference's
``"pallas"``, the default), ``"plain"`` (``"xla"``: masked attention with
the whole score matrix) or ``"chunked"`` (``"xla_chunked"``: an online
softmax over key blocks of :data:`CHUNK` under a checkpoint, the flash
schedule in plain PyTorch).  The dry run (``launch/dryrun.py``) sets
``"plain"`` before it counts (the flash op has no flop formula), and
``"chunked"`` under ``--attn chunked`` or ``--optimized``, as the
reference's does.  ``"chunked"`` is more than the dry run's, though: the
flash kernel covers only cache-free attention, so a cached prefill is
plain code in every mode, and only ``"chunked"`` keeps it from holding the
whole ``S x Smax`` score matrix of each head (at a 32k prompt into a 32k
cache, 2 GiB of f32 scores a head).  The reference also computes rmsnorm in
plain code outside ``"pallas"``, because its Pallas kernel cannot be
partitioned; the port's rmsnorm op has a DTensor strategy, so it runs the
kernel in every mode.

On DTensors (``launch/steps.py``'s sharded steps) attention runs on each
rank's own shard (:func:`_per_shard`, :func:`_sharded_cached_attention`):
flattening a sharded batch x heads dim into one ``bmm`` dim would make
DTensor search a plan for every op.  Where the KV cache's ``seq`` dim is
sharded (``SERVE_RULES`` when the kv heads do not divide the model axis)
each rank holds a slice of the keys: it writes the new entries that fall
in its slice, and the softmax takes its row max and row sum over all the
slices (two all-reduces) before the value products' partial sums are
all-reduced.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shd
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.params import ParamSpec, dense, norm_scale, zeros


# ---------------------------------------------------------------------------
# Attention implementation
# ---------------------------------------------------------------------------
ATTN_IMPLS = ("flash", "plain", "chunked")
ATTN_IMPL = "flash"
CHUNK = 1024          # the chunked attention's key block (the reference's block)
# the KV cache's logical axes, which its written leaves are pinned to
CACHE_AXES = ("batch", "kv_heads", "seq", None)


def set_attn_impl(impl: str) -> None:
    """``"flash"``, ``"plain"`` or ``"chunked"`` (the reference's
    ``set_attn_impl`` with ``"pallas"``, ``"xla"``, ``"xla_chunked"``)."""
    global ATTN_IMPL
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attention implementation {impl!r} is none of {ATTN_IMPLS}")
    ATTN_IMPL = impl


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
def attn_cache_spec(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """A bf16 KV cache ``{"k", "v", "index"}`` as specs
    (``repro/models/layers.py::attn_cache_spec``, :354): bf16 whatever the
    parameter dtype."""
    shape = (batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
    axes = ("batch", "kv_heads", "seq", "head_dim")
    return {"k": ParamSpec(shape, axes, "zeros", dtype=torch.bfloat16),
            "v": ParamSpec(shape, axes, "zeros", dtype=torch.bfloat16),
            "index": ParamSpec((), (), "zeros", dtype=torch.int32)}


def _key_positions(sk: int, dev, k_offset) -> torch.Tensor:
    """The positions of ``sk`` keys from ``k_offset`` (no op added at 0, so
    a traced step keeps its op nodes)."""
    kpos = torch.arange(sk, device=dev)
    return kpos + k_offset if k_offset else kpos


def _masked_scores(q, k, *, window, softcap, scale, q_offset, kv_len, causal, k_offset=0):
    """The scores (B, Hkv, group, Sq, Sk) in f32 of q (B, H, Sq, D) against
    k (B, Hkv, Sk, D), softcapped, with every key a query may not see at
    -1e30.  ``k_offset`` is the position of k's first key (a rank's slice
    of a sequence-sharded cache)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    dev = q.device
    qf = q.reshape(b, hkv, group, sq, d).float().reshape(b * hkv, group * sq, d)
    kf = k.float().reshape(b * hkv, sk, d)
    s = torch.bmm(qf, kf.transpose(1, 2)).reshape(b, hkv, group, sq, sk) * scale
    # the reference pins the scores to the KV layout (layers.py:148); on a
    # rank's shard this is a no-op
    s = shd.constrain_logical(s, ("batch", "kv_heads", None, None, "seq"))
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    ragged = any(isinstance(t, torch.Tensor) and t.dim() >= 1
                 for t in (q_offset, kv_len))
    if ragged:
        qo = torch.as_tensor(q_offset, device=dev).to(torch.int32).reshape(-1)
        kl = torch.as_tensor(kv_len, device=dev).to(torch.int32).reshape(-1)
        qpos = qo[:, None, None] + torch.arange(sq, device=dev)[None, :, None]
        kpos = _key_positions(sk, dev, k_offset)[None, None, :]
        mask = kpos < kl[:, None, None]
        if causal:
            mask = mask & (qpos >= kpos)
        if window is not None:
            mask = mask & ((qpos - kpos) < window)
        return torch.where(mask[:, None, None], s, -1e30)
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    kpos = _key_positions(sk, dev, k_offset)[None, :]
    mask = kpos < kv_len
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    return torch.where(mask[None, None, None], s, -1e30)


def _value_product(p, v, hq):
    """The probabilities (B, Hkv, group, Sq, Sk), rounded to the cache
    dtype as the reference does, times v (B, Hkv, Sk, Dv), in f32:
    (B, H, Sq, Dv)."""
    b, hkv, group, sq, sk = p.shape
    pf = p.to(v.dtype).float().reshape(b * hkv, group * sq, sk)
    o = torch.bmm(pf, v.float().reshape(b * hkv, sk, v.shape[-1]))
    return o.reshape(b, hq, sq, v.shape[-1])


def _attention(q, k, v, *, window, softcap, scale, q_offset, kv_len, causal=True):
    """Masked attention (B,H,Sq,D)x(B,Hkv,Sk,D), scores in f32.

    ``q_offset`` positions queries within the kv sequence (decode);
    ``kv_len`` masks out unwritten cache slots.  Either may also be a (B,)
    tensor — ragged decode, every batch row at its own position.  With
    ``causal`` a query sees no key past its own position; without it (the
    cached cross-attention) it sees every key below ``kv_len``.  ``window``
    (None for full attention) keeps only the keys less than ``window``
    positions behind each query, the row's own position on the ragged
    branch.  Mirrors ``repro/models/layers.py::_attention_xla``, including
    the rounding of the probabilities to the cache dtype before the value
    product."""
    s = _masked_scores(q, k, window=window, softcap=softcap, scale=scale, q_offset=q_offset,
                       kv_len=kv_len, causal=causal)
    return _value_product(torch.softmax(s, dim=-1), v, q.shape[1]).to(q.dtype)


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced (``"sum"`` or ``"max"``) over ``group``, out of place,
    through the functional collective (the op a dispatch mode sees)."""
    out = torch.ops._c10d_functional.all_reduce(t, op, group.group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


def _split_attention(q, k, v, group, *, k_offset, window, softcap, scale, q_offset, kv_len):
    """:func:`_attention` where k and v hold one slice of the keys (from
    position ``k_offset``) and ``group`` the other slices: the row max and
    the row sum are reduced over the group first, so every rank normalizes
    and rounds the same probabilities as one device would; the partial
    value products are summed over the group last (the only sum whose
    order differs from one device's)."""
    s = _masked_scores(q, k, window=window, softcap=softcap, scale=scale, q_offset=q_offset,
                       kv_len=kv_len, causal=True, k_offset=k_offset)
    m = _all_reduce(torch.amax(s, dim=-1, keepdim=True), "max", group)
    e = torch.exp(s - m)
    p = e / _all_reduce(torch.sum(e, dim=-1, keepdim=True), "sum", group)
    return _all_reduce(_value_product(p, v, q.shape[1]), "sum", group).to(q.dtype)


def _chunked_stats(q, k, v, *, causal, window, softcap, scale, block, q_offset, kv_len,
                   k_offset=0):
    """The online softmax over key blocks of ``block``
    (``repro/models/layers.py::_attention_xla_chunked``, :187-231): the
    running row max ``m``, row sum ``l`` (B, Hkv, group, Sq, 1) and
    unnormalized output ``acc`` (B, Hkv, group, Sq, Dv), all f32; peak
    score memory (B, H, Sq, block).  ``k_offset`` is the position of k's
    first key."""
    b, hq, sq, dqk = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = hq // hkv
    dev = q.device
    # the reference scales q in its own dtype, then casts
    qg = (q.reshape(b, hkv, group, sq, dqk) * scale).float().reshape(b * hkv, group * sq, dqk)
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    m = torch.full((b, hkv, group, sq, 1), -1e30, dtype=torch.float32, device=dev)
    lsum = torch.zeros((b, hkv, group, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, group, sq, dv), dtype=torch.float32, device=dev)
    for lo in range(0, sk, block):
        kb = k[:, :, lo:lo + block].float().reshape(b * hkv, block, dqk)
        vb = v[:, :, lo:lo + block].float().reshape(b * hkv, block, dv)
        s = torch.bmm(qg, kb.transpose(1, 2)).reshape(b, hkv, group, sq, block)
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        kpos = k_offset + lo + torch.arange(block, device=dev)[None, :]
        mask = torch.ones((sq, block), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (qpos >= kpos)
        if window is not None:
            mask = mask & ((qpos - kpos) < window)
        if kv_len is not None:
            mask = mask & (kpos < kv_len)
        s = torch.where(mask[None, None, None], s, -1e30)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.where(mask[None, None, None], torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        lsum = lsum * alpha + torch.sum(p, dim=-1, keepdim=True)
        pv = torch.bmm(p.reshape(b * hkv, group * sq, block), vb)
        acc = acc * alpha + pv.reshape(b, hkv, group, sq, dv)
        m = m_new
    return m, lsum, acc


def _chunked_out(lsum, acc, q):
    b, hq, sq, _ = q.shape
    o = acc / torch.where(lsum == 0.0, 1.0, lsum)
    return o.reshape(b, hq, sq, acc.shape[-1]).to(q.dtype)


def _attention_chunked(q, k, v, *, causal, window, softcap, scale, block=CHUNK, q_offset=0,
                       kv_len=None):
    """Online-softmax attention over key blocks of ``block`` (Sk a multiple
    of it): the flash schedule in plain PyTorch, the counterpart of
    ``_attention_xla_chunked``.  ``q_offset``/``kv_len`` position the
    queries inside a longer cache (cached prefill)."""
    _, lsum, acc = _chunked_stats(q, k, v, causal=causal, window=window, softcap=softcap,
                                  scale=scale, block=block, q_offset=q_offset, kv_len=kv_len)
    return _chunked_out(lsum, acc, q)


def _split_chunked(q, k, v, group, *, k_offset, window, softcap, scale, q_offset, kv_len):
    """:func:`_attention_chunked` over a slice of the keys (from
    ``k_offset``): each rank's running statistics are rescaled to the
    group's row max and summed over the group."""
    sk = k.shape[2]
    block = CHUNK if sk % CHUNK == 0 else sk
    m, lsum, acc = _chunked_stats(q, k, v, causal=True, window=window, softcap=softcap,
                                  scale=scale, block=block, q_offset=q_offset, kv_len=kv_len,
                                  k_offset=k_offset)
    alpha = torch.exp(m - _all_reduce(m, "max", group))
    return _chunked_out(_all_reduce(lsum * alpha, "sum", group),
                        _all_reduce(acc * alpha, "sum", group), q)


def _checkpointed(fn, *args, **kwargs):
    """``fn`` recomputed in the backward (``jax.checkpoint``)."""
    return checkpoint(functools.partial(fn, **kwargs), *args, use_reentrant=False,
                      preserve_rng_state=False)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous.  A gradient leaving a
    rank's shard in the layout ``bmm``'s backward gives it (k's is
    transposed) meets DTensor's reshapes of the heads, which DTensor plans
    as views from the global strides: with one kv head a rank, on the dry
    run's fake tensors, that local layout cannot be viewed and the
    backward fails."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _per_shard(fn, q, k, v):
    """``fn(q, k, v)``; on DTensors, run on each rank's shard after
    :func:`~repro_torch.kernels.ops.attention_layout` (whole batch x kv
    head blocks a rank), whose placements the output keeps."""
    if not shd.is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    def local(*qkv):
        return fn(*(_ContiguousGrad.apply(t) for t in qkv))

    q, k, v = kops.attention_layout(q, k, v)
    place = q.placements
    return local_map(local, out_placements=(place,), in_placements=(place,) * 3,
                     device_mesh=q.device_mesh, redistribute_inputs=True)(q, k, v)


def multihead_attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """Cache-free attention (train, cache-free forward), q (B, H, S, D), k/v
    (B, Hkv, S, D), by :data:`ATTN_IMPL` (``repro/models/layers.py::
    multihead_attention``, :234-255): the flash_attention op at any length
    (its CUDA kernel masks ragged tiles itself, so the reference's gate to
    plain code where S is not a multiple of 128 has nothing to route
    around); the chunked attention under a checkpoint where the key length
    is a multiple of :data:`CHUNK`; else the plain masked attention."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if ATTN_IMPL == "flash":
        return kops.attention(q, k, v, **opts)
    s = k.shape[2]
    if ATTN_IMPL == "chunked" and s % CHUNK == 0:
        return _per_shard(functools.partial(_checkpointed, _attention_chunked, **opts), q, k, v)
    return _per_shard(functools.partial(_attention, q_offset=0, kv_len=s, **opts), q, k, v)


def _cached_attention(q, ck, cv, idx, *, chunked, window, softcap, scale):
    """Causal attention of q (B, H, S, D), at positions ``idx ..
    idx+S-1``, over the written cache: chunked (cached prefill under
    ``"chunked"``) or plain."""
    s = q.shape[2]
    opts = dict(window=window, softcap=softcap, scale=scale, q_offset=idx, kv_len=idx + s)
    if chunked:
        return _checkpointed(_attention_chunked, q, ck, cv, causal=True, **opts)
    return _attention(q, ck, cv, **opts)


def _write_window(cache, new, start):
    """``cache`` (B, H, L, D), one rank's slice of a sequence-sharded cache,
    with ``new`` (B, H, S, D) written where its positions ``start ..
    start+S-1`` (relative to the slice's first position; any of them may
    fall outside it) land in the slice.  Each slot is a copy of a ``new``
    entry or of the cache's own, as the single-device write."""
    s = new.shape[2]
    rel = torch.arange(cache.shape[2], device=cache.device) - start
    inside = (rel >= 0) & (rel < s)
    src = new.index_select(2, rel.clamp(0, s - 1)).to(cache.dtype)
    return torch.where(inside[:, None], src, cache)


def _sharded_cached_attention(qt, kt, vt, cache, idx, *, chunked, window, softcap, scale):
    """The cached branch on DTensors, on each rank's shard: the new keys
    and values are written into the rank's shard of the cache (only the
    positions that fall in its slice, where ``seq`` is sharded), and
    attention runs on its batch rows and kv heads (its queries' heads with
    them), over its slice of the keys with the softmax statistics reduced
    over the slices (:func:`_split_attention`, :func:`_split_chunked`).
    Returns the output (heads sharded as the cache's kv heads, whole along
    the sequence) and both caches at the cache's placements."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = cache["k"].device_mesh
    place = tuple(cache["k"].placements)
    whole = tuple(Replicate() if p.is_shard(2) else p for p in place)

    def local(t, want):
        t = t if tuple(t.placements) == want else t.redistribute(mesh, want)
        return t.to_local()

    q, k, v = (local(t, whole) for t in (qt, kt, vt))
    ck, cv = cache["k"].to_local(), cache["v"].to_local()
    start = local(idx, (Replicate(),) * mesh.ndim) if shd.is_dtensor(idx) else idx
    opts = dict(window=window, softcap=softcap, scale=scale)
    seq_dims = [i for i, p in enumerate(place) if p.is_shard(2)]
    if not seq_dims:
        ck, cv = cache_update(ck, k, start, axis=2), cache_update(cv, v, start, axis=2)
        o = _cached_attention(q, ck, cv, start, chunked=chunked, **opts)
    else:
        (dim,) = seq_dims
        off = mesh.get_local_rank(dim) * ck.shape[2]
        ck, cv = _write_window(ck, k, start - off), _write_window(cv, v, start - off)
        split = _split_chunked if chunked else _split_attention
        o = split(q, ck, cv, mesh.get_group(dim), k_offset=off, q_offset=start,
                  kv_len=start + q.shape[2], **opts)
    wrap = lambda t, pl: DTensor.from_local(t, mesh, pl, run_check=False)  # noqa: E731
    return wrap(o, whole), wrap(ck, place), wrap(cv, place)


def _split_heads(t: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(B, S, heads * hd) -> (B, S, heads, hd).  A DTensor whose last dim
    is sharded into a count of shards that does not divide ``heads`` (the
    weight's ``heads * hd`` columns divided, its heads not: 3 kv heads on 2
    ranks) is first replicated on those mesh dims, which GSPMD does for
    the reference."""
    if shd.is_dtensor(t):
        last = t.ndim - 1
        dims = [i for i, p in enumerate(t.placements) if p.is_shard(last)]
        if heads % math.prod(t.device_mesh.size(i) for i in dims):
            from torch.distributed.tensor import Replicate
            want = [Replicate() if i in dims else p for i, p in enumerate(t.placements)]
            t = t.redistribute(t.device_mesh, want)
    return t.reshape(*t.shape[:-1], heads, hd)


def attn_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *, kind: str,
             positions: torch.Tensor, cache: dict | None,
             x_kv: torch.Tensor | None = None):
    """Attention, over a KV cache or (``cache=None``) over the whole
    sequence (``repro/models/layers.py::attn_fwd``, :258-351).

    x: (B, S, D). kind: dense | local | global | shared_attn | enc | dec |
    cross.  A ``local`` layer attends within ``cfg.sliding_window``
    positions (gemma2), on every branch; ``dense``, ``global``,
    ``shared_attn`` (zamba2's occurrences, as the reference's
    ``layers.py:279-281``) and ``dec`` (an encoder-decoder's decoder
    self-attention) attend causally with no window; ``enc`` attends to the
    whole sequence, not causally.  ``cross`` (or any kind given ``x_kv``,
    the encoder's output (B, Skv, D)) is cross-attention: the keys and
    values come from ``x_kv`` — or, over a cache, are the cache's, filled
    once at prefill (``model._fill_cross_caches``) and read as they are up
    to its index — it is not causal, and it takes no RoPE.  The reference
    also projects keys and values from ``x`` in the cached cross branch
    and drops them; the port does not compute them.
    cache: None or {"k": (B, Hkv, Smax, hd), "v": ..., "index": ()}.
    ``positions`` is (S,) for a uniform batch, or (B, S) for ragged decode,
    where every row writes its KV entry at its own position.
    Returns (out, updated_cache); the cache is None without one, and a
    cross-attention returns its cache unchanged.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    is_cross = x_kv is not None or kind == "cross"
    causal = kind != "enc" and not is_cross
    window = cfg.sliding_window if kind == "local" else None
    if cfg.query_pre_attn_scalar is not None:
        scale = cfg.query_pre_attn_scalar ** -0.5
    else:
        scale = hd ** -0.5
    q = _split_heads(linear(x, p["wq"]), hq, hd)
    if is_cross and cache is not None:
        # the cross cache was filled once from the encoder's output; its
        # index is the encoder's length, and slots past it are masked
        o = _attention(q.transpose(1, 2), cache["k"], cache["v"], causal=False, window=None,
                       softcap=cfg.attn_softcap, scale=scale, q_offset=0,
                       kv_len=cache["index"])
        o = o.transpose(1, 2).reshape(b, s, hq * hd)
        return linear(o, p["wo"]), cache
    src = x if x_kv is None else x_kv
    k = _split_heads(linear(src, p["wk"]), hkv, hd)
    v = _split_heads(linear(src, p["wv"]), hkv, hd)
    if not is_cross:                     # RoPE on self-attention only
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    # under an active mesh, shard the heads with the batch, so the kernel's
    # S x S work splits over the model axis (repro/models/layers.py:294-298)
    qt = shd.constrain_logical(q.transpose(1, 2), ("batch", "heads", None, None))
    kt = shd.constrain_logical(k.transpose(1, 2), ("batch", "kv_heads", None, None))
    vt = shd.constrain_logical(v.transpose(1, 2), ("batch", "kv_heads", None, None))

    if cache is None:
        o = multihead_attention(qt, kt, vt, causal=causal, window=window,
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
        ck, cv = shd.constrain_logical(ck, CACHE_AXES), shd.constrain_logical(cv, CACHE_AXES)
        o = _attention(qt, ck, cv, window=window, softcap=cfg.attn_softcap,
                       scale=scale, q_offset=pos_b, kv_len=pos_b + s)
    else:
        # cached prefill under "chunked": the flash schedule, not S x Smax
        # scores (repro/models/layers.py:338-346)
        chunked = s > 1 and ATTN_IMPL == "chunked" and cache["k"].shape[2] % CHUNK == 0
        opts = dict(chunked=chunked, window=window, softcap=cfg.attn_softcap, scale=scale)
        if shd.is_dtensor(cache["k"]):
            o, ck, cv = _sharded_cached_attention(qt, kt, vt, cache, idx, **opts)
        else:
            ck = cache_update(cache["k"], kt, idx, axis=2)
            cv = cache_update(cache["v"], vt, idx, axis=2)
            o = _cached_attention(qt, ck, cv, idx, **opts)
        ck, cv = shd.constrain_logical(ck, CACHE_AXES), shd.constrain_logical(cv, CACHE_AXES)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return linear(o, p["wo"]), {"k": ck, "v": cv, "index": idx + s}


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (deepseek-v3)
# ---------------------------------------------------------------------------
def mla_spec(cfg: ArchConfig) -> dict:
    """``repro/models/layers.py::mla_spec`` (:370): the query's low-rank
    path (``wq_a``, ``q_norm``, ``wq_b``), the joint key/value latent and
    the shared rope key (``wkv_a``, ``kv_norm``), the latent's per-head
    up-projection to (nope key, value) (``wkv_b``) and the output."""
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    nope, rope_d, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": dense(d, cfg.q_lora_rank, "embed", None),
        "q_norm": norm_scale(cfg.q_lora_rank),
        "wq_b": dense(cfg.q_lora_rank, h * (nope + rope_d), None, "heads"),
        "wkv_a": dense(d, r + rope_d, "embed", None),
        "kv_norm": norm_scale(r),
        "wkv_b": dense(r, h * (nope + vh), None, "heads"),
        "wo": dense(h * vh, d, "heads", "embed"),
    }


def mla_cache_spec(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The latent cache of an MLA layer as specs (``mla_cache_spec``,
    :464): the normed latent ``c_kv`` (B, Smax, kv_lora_rank) and the roped
    shared key ``k_rope`` (B, Smax, qk_rope_head_dim), bf16, and the write
    index."""
    return {"c_kv": ParamSpec((batch, max_len, cfg.kv_lora_rank), ("batch", "seq", "head_dim"),
                              "zeros", dtype=torch.bfloat16),
            "k_rope": ParamSpec((batch, max_len, cfg.qk_rope_head_dim), ("batch", "seq", None),
                                "zeros", dtype=torch.bfloat16),
            "index": ParamSpec((), (), "zeros", dtype=torch.int32)}


def mla_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """The zeroed latent cache of an MLA layer (:func:`mla_cache_spec`)."""
    return zeros(mla_cache_spec(cfg, batch, max_len), device)


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, n) -> (H, B*S, n), contiguous: a bmm operand batched over
    heads."""
    b, s, h, n = t.shape
    return t.permute(2, 0, 1, 3).contiguous().reshape(h, b * s, n)


def _batch_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, n) -> (B, H*S, n), contiguous: a bmm operand batched over
    the batch, its rows head-major."""
    b, s, h, n = t.shape
    return t.permute(0, 2, 1, 3).contiguous().reshape(b, h * s, n)


def mla_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
            positions: torch.Tensor, cache: dict | None):
    """Multi-head Latent Attention (``repro/models/layers.py::mla_fwd``,
    :386).  x: (B, S, D).  Returns (out, updated_cache).

    Without a cache (the cache-free forward) the per-head keys and values
    are materialized from the latent and attended with the plain
    :func:`_attention` at q/k width nope + rope and v width v_head_dim.
    Over a cache (cached prefill, decode) the up-projection is absorbed:
    the queries are taken into the latent space, scored against the cached
    latent and the shared rope key, and the context is projected out per
    head — the keys and values are never materialized.  This branch is f32
    throughout, its probabilities included (the reference's is).  Its
    products are each one ``torch.bmm`` over explicitly laid out operands:
    the query and value projections batched over heads, the two score
    products and the context product batched over the batch.  A
    ``positions`` of (B, S) takes the ragged branch: one-hot per-row
    latent writes and per-row query positions."""
    b, s, _ = x.shape
    h, r = cfg.num_heads, cfg.kv_lora_rank
    nope, rope_d, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = (nope + rope_d) ** -0.5

    q_lat = rmsnorm_fwd(p["q_norm"], linear(x, p["wq_a"]), cfg.norm_eps)
    q = linear(q_lat, p["wq_b"]).reshape(b, s, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = linear(x, p["wkv_a"])                               # (B, S, r + rope)
    # the latent is a strided slice of kv_a: the kernel takes contiguous rows
    c_kv = rmsnorm_fwd(p["kv_norm"], kv_a[..., :r].contiguous(), cfg.norm_eps)
    k_rope = kv_a[..., r:].reshape(b, s, 1, rope_d)

    cos, sin = rope_cos_sin(positions, rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)

    if cache is None:
        kv = linear(c_kv, p["wkv_b"]).reshape(b, s, h, nope + vh)
        k = torch.cat([kv[..., :nope], k_rope.expand(b, s, h, rope_d)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        o = _attention(q_full.transpose(1, 2), k.transpose(1, 2),
                       kv[..., nope:].transpose(1, 2), window=None, softcap=None,
                       scale=scale, q_offset=0, kv_len=s)
        o = o.transpose(1, 2).reshape(b, s, h * vh)
        return linear(o, p["wo"]), None

    idx = cache["index"]
    smax = cache["c_kv"].shape[1]
    if positions.dim() >= 2:
        # ragged decode (s == 1): one-hot per-row latent writes, per-row
        # query positions; the scalar index keeps ticking, unread
        pos_b = positions[:, 0].to(torch.int32)                   # (B,)
        sel = (torch.arange(smax, device=x.device)[None, :] == pos_b[:, None])[:, :, None]
        ckv = torch.where(sel, c_kv.to(cache["c_kv"].dtype), cache["c_kv"])
        krc = torch.where(sel, k_rope[:, :, 0].to(cache["k_rope"].dtype), cache["k_rope"])
        qpos = (pos_b[:, None] + torch.arange(s, device=x.device)[None, :])[:, None, :, None]
    else:
        ckv = cache_update(cache["c_kv"], c_kv, idx, axis=1)      # (B, Smax, r)
        krc = cache_update(cache["k_rope"], k_rope[:, :, 0], idx, axis=1)
        qpos = (idx + torch.arange(s, device=x.device))[None, None, :, None]

    wkv_b = p["wkv_b"].reshape(r, h, nope + vh)
    w_k = wkv_b[..., :nope].permute(1, 2, 0).contiguous().float()  # (h, nope, r)
    w_v = wkv_b[..., nope:].permute(1, 0, 2).contiguous().float()  # (h, r, vh)

    q_abs = torch.bmm(_heads_first(q_nope.float()), w_k)        # (h, B*S, r)
    q_abs = _batch_first(q_abs.reshape(h, b, s, r).permute(1, 2, 0, 3))   # (B, h*S, r)
    ckv_f, krc_f = ckv.float(), krc.float()
    scores = (torch.bmm(q_abs, ckv_f.transpose(1, 2)) +
              torch.bmm(_batch_first(q_rope.float()), krc_f.transpose(1, 2))) * scale
    # causal within the incoming window: the query at idx+i sees keys <= idx+i
    kpos = torch.arange(smax, device=x.device)[None, None, None, :]
    scores = torch.where(kpos <= qpos, scores.reshape(b, h, s, smax), -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.bmm(probs.reshape(b, h * s, smax), ckv_f)      # (B, h*S, r)
    ctx = _heads_first(ctx.reshape(b, h, s, r).permute(0, 2, 1, 3))   # (h, B*S, r)
    o = torch.bmm(ctx, w_v).reshape(h, b, s, vh).permute(1, 2, 0, 3)  # (B, S, h, vh)
    o = o.reshape(b, s, h * vh).to(x.dtype)
    return linear(o, p["wo"]), {"c_kv": ckv, "k_rope": krc, "index": idx + s}
