"""Public kernel wrappers, as PyTorch custom ops, and their registration as
the overlay's LARGE-tile bitstreams (``repro/kernels/ops.py:148-166``).

Each kernel is one ``torch.library.custom_op``:

* ``repro_torch::vmul_reduce(a, b)``, ``repro_torch::rmsnorm(x, w, eps)``,
  ``repro_torch::attention(q, k, v, causal, window, softcap, scale)`` and
  ``repro_torch::ssd(x, a, b, c, initial_state, chunk)``;
* the CUDA implementation is the hand-written kernel (it launches or raises;
  there is no fallback), the CPU implementation is the plain version — a
  wrapper takes the plain version only because its tensors lie on the CPU;
* a ``register_fake`` gives shapes, which is how the trace frontend
  (``make_fx`` in fake mode) sees a kernel call as ONE node — the port's
  counterpart of the reference's rule for registered calls
  (``repro/core/trace.py:17-21``).

rmsnorm's, attention's and ssd's backward is the VJP of the plain version,
recomputed from the inputs inside a ``torch.autograd.Function``
(``repro/kernels/ops.py:42-45,69-75,114-118``); the reference has no
backward kernel, so the port has none either.

On DTensors (``torch.distributed.tensor``: the sharded train step) rmsnorm
and attention have sharding strategies (:func:`_register_sharding`,
registered the first time a wrapper sees a DTensor): the op runs on each
rank's local shard, so the hand-written kernel still launches, on local
rows and heads.  rmsnorm takes ``x`` sharded on any dim but the last and
``w`` replicated.  attention takes the batch dim sharded freely and q's
heads sharded with k/v's kv heads on one mesh dim, where that dim's size
divides the kv head count (contiguous blocks then keep each query head's
kv head on its rank under GQA); :func:`attention` first brings q, k and v
to that layout (:func:`attention_layout`, which the plain attention modes
of ``models/layers.py`` use too).  rmsnorm's backward is the plain VJP on DTensors;
attention's is the plain VJP of each rank's shard (``local_map``), which
is its shard of the VJP: the blocks are independent.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.patterns import Operator, TileClass, register_call
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import vmul_reduce as _vr
from repro_torch.sharding import is_dtensor


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
    if is_dtensor(x):
        _register_sharding()
    return _RMSNorm.apply(x, w, eps)


# ---------------------------------------------------------------------------
# attention — backward recomputes the plain version's VJP from q, k, v
# ---------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::attention", mutates_args=(),
                         device_types="cpu")
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: Optional[int], softcap: Optional[float],
                  scale: float) -> torch.Tensor:
    _fa.check_shapes(q, k, v)
    return _fa.plain(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=scale)


@_attention_op.register_kernel("cuda")
def _(q, k, v, causal, window, softcap, scale):
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)


@_attention_op.register_fake
def _(q, k, v, causal, window, softcap, scale):
    _fa.check_shapes(q, k, v)
    return torch.empty_like(q)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return _attention_op(q, k, v, causal, window, softcap, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if is_dtensor(q):
            # each rank's shard holds whole (batch, kv-head group) blocks, so
            # the plain VJP of its shard is its shard of the VJP; run it on
            # the local tensors (on DTensors the plain version's reshapes of
            # a sharded batch x heads dim cost DTensor a search per op)
            from torch.distributed.tensor.experimental import local_map
            place = q.placements
            vjp = local_map(functools.partial(_attention_vjp, opts=ctx.opts),
                            out_placements=(place,) * 3, in_placements=(place,) * 4,
                            device_mesh=q.device_mesh, redistribute_inputs=True)
            grads = vjp(q, k, v, g)
        else:
            grads = _attention_vjp(q, k, v, g, opts=ctx.opts)
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad)),
                None, None, None, None)


def _attention_vjp(q, k, v, g, *, opts):
    """The plain version's VJP at (q, k, v) applied to ``g``."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(ref.attention(*qkv, **opts), qkv, g)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Flash attention with GQA + sliding window + softcap, in the
    reference's layout: q (B, Hq, S, D), k/v (B, Hkv, S, D)."""
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if is_dtensor(q):
        _register_sharding()
        q, k, v = attention_layout(q, k, v)
    return _Attention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal, window, softcap, scale)


# ---------------------------------------------------------------------------
# Sharding strategies for DTensor inputs (the sharded train step)
# ---------------------------------------------------------------------------
def _head_dims(placements) -> list[int]:
    return [i for i, p in enumerate(placements) if p.is_shard(1)]


def attention_layout(q, k, v):
    """q, k and v redistributed to the layout the attention op shards:
    every mesh dim on which q shards the batch keeps it sharded; the first
    one on which q shards its heads keeps them sharded (k's and v's kv
    heads with them) where its size divides the kv head count; every other
    mesh dim is replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, hkv = q.device_mesh, k.shape[1]
    want, heads = [], False
    for i, p in enumerate(q.placements):
        if p.is_shard(0):
            want.append(Shard(0))
        elif p.is_shard(1) and not heads and hkv % mesh.size(i) == 0:
            want.append(Shard(1))
            heads = True
        else:
            want.append(Replicate())
    want = tuple(want)
    return tuple(t if tuple(t.placements) == want else t.redistribute(mesh, want)
                 for t in (q, k, v))


_SHARDING_REGISTERED: list[bool] = []


def _register_sharding() -> None:
    """Register the rmsnorm and attention ops' strategies with DTensor
    (once).  Each strategy is a list of (output placements, input
    placements) for one mesh dim, which DTensor expands over the mesh."""
    if _SHARDING_REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.rmsnorm.default)
    def _(x, w, eps):
        out = [([Replicate()], [Replicate(), Replicate(), None])]
        out += [([Shard(d)], [Shard(d), Replicate(), None]) for d in range(x.ndim - 1)]
        return out

    @register_sharding(torch.ops.repro_torch.attention.default)
    def _(q, k, v, causal, window, softcap, scale):
        rest = [None] * 4
        out = [([Replicate()], [Replicate()] * 3 + rest),
               ([Shard(0)], [Shard(0)] * 3 + rest)]
        heads = _head_dims(q.placements)
        if len(heads) == 1 and heads == _head_dims(k.placements) == _head_dims(v.placements) \
                and k.shape[1] % q.mesh.size(heads[0]) == 0:
            out.append(([Shard(1)], [Shard(1)] * 3 + rest))
        return out

    _SHARDING_REGISTERED.append(True)


# ---------------------------------------------------------------------------
# SSD — the chunked scan; backward recomputes the plain chunked VJP
# ---------------------------------------------------------------------------
def _check_ssd(x, a, b, c, initial_state, chunk) -> None:
    if x.dim() != 4 or a.shape != x.shape[:3] or b.dim() != 4 or \
            b.shape != c.shape or b.shape[:3] != x.shape[:3]:
        raise ValueError(f"expect x (B, S, H, p), a (B, S, H) and b, c (B, S, H, n), got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, s, h, p = x.shape
    if s % chunk:
        raise ValueError(f"seqlen {s} must divide chunk {chunk}")
    if initial_state is not None and initial_state.shape != (bsz, h, b.shape[-1], p):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} is not "
                         f"{(bsz, h, b.shape[-1], p)}")


# Both implementations return contiguous tensors, as the fake one does: a
# traced graph records views of the result that only a contiguous tensor has.
@torch.library.custom_op("repro_torch::ssd", mutates_args=(), device_types="cpu")
def _ssd_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            initial_state: Optional[torch.Tensor],
            chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    _check_ssd(x, a, b, c, initial_state, chunk)
    y, final = ref.ssd_chunked(x, a, b, c, chunk=chunk, initial_state=initial_state,
                               return_state=True)
    return y.contiguous(), final.contiguous()


@_ssd_op.register_kernel("cuda")
def _(x, a, b, c, initial_state, chunk):
    _check_ssd(x, a, b, c, initial_state, chunk)
    y, final = _ssd.ssd(x, a, b, c, chunk=chunk, initial_state=initial_state)
    return y.contiguous(), final.contiguous()


@_ssd_op.register_fake
def _(x, a, b, c, initial_state, chunk):
    _check_ssd(x, a, b, c, initial_state, chunk)
    bsz, _, h, p = x.shape
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty((bsz, h, b.shape[-1], p), dtype=torch.float32))


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, c, chunk):
        ctx.save_for_backward(x, a, b, c)
        ctx.chunk = chunk
        return _ssd_op(x, a, b, c, None, chunk)[0]

    @staticmethod
    def backward(ctx, g):
        # the chunked plain version, not the per-step recurrence: its
        # residuals are per-chunk states (repro/kernels/ops.py:89-92)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            grads = torch.autograd.grad(ref.ssd_chunked(*ins, chunk=ctx.chunk), ins, g)
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad)), None)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
        chunk: int = 64) -> torch.Tensor:
    """Mamba-2 SSD, y only (use :func:`ssd_with_state` for stateful decode).
    x (B, S, H, p), a (B, S, H), b/c (B, S, H, n); S a multiple of chunk."""
    return _SSD.apply(x, a, b, c, chunk)


def ssd_with_state(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   *, chunk: int = 64, initial_state: torch.Tensor | None = None):
    """(y, final_state (B, H, n, p) f32), starting from ``initial_state``."""
    return _ssd_op(x, a, b, c, initial_state, chunk)


def ssd_decode_step(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    state: torch.Tensor):
    """Single-token SSD update (serving): x (B, H, p), a (B, H), b/c
    (B, H, n), state (B, H, n, p).  Plain PyTorch, as it is jnp in the
    reference (``repro/kernels/ops.py:137-142``)."""
    new = state * torch.exp(a)[..., None, None] + b[..., :, None] * x[..., None, :]
    y = torch.sum(c[..., :, None] * new, dim=-2)
    return y.to(x.dtype), new


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
register_call("repro_torch::attention",
              Operator("kernels/attention", 3, attention,
                       TileClass.LARGE, flops_per_elem=4.0), override=True)
register_call("repro_torch::ssd",
              Operator("kernels/ssd", 4, ssd,
                       TileClass.LARGE, flops_per_elem=6.0), override=True)

LAUNCH_COUNTERS = (_vr.launches, _rn.launches, _fa.launches, _ssd.launches)
