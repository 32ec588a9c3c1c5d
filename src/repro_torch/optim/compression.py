"""Gradient compression for data-parallel reduction.

Port of ``repro/optim/compression.py``.  Where the gradient all-reduce
crosses a slow link, int8 quantization with per-tensor scales cuts its
bytes 4x against f32 and 2x against bf16.  Error feedback (Seide et al.;
the 1-bit SGD lineage) carries each step's quantization residual into the
next one, so compression adds no bias drift.

Usage across the ranks of one mesh axis::

    q, scales = quantize(grads)
    back = dequantize(q, scales)          # each rank's own scale
    grads = make_reduce_fn(mesh, "data")(back)

or through :class:`CompressedReducer`, which keeps the error state.  The
reference's ``psum`` over a mesh axis is :func:`make_reduce_fn`'s
``dist.all_reduce`` over that axis's process group.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

INT8_MAX = 127.0


def _quantize_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    g = g.float()
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / INT8_MAX
    # torch.round rounds half to even, as jnp.round
    q = torch.clamp(torch.round(g / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def quantize(tree: Any) -> tuple[Any, Any]:
    """Per-leaf symmetric int8 quantization. Returns (int8 tree, scale tree),
    each scale an f32 scalar ``max|g| / 127``."""
    leaves, spec = pytree.tree_flatten(tree)
    pairs = [_quantize_leaf(g) for g in leaves]
    return (pytree.tree_unflatten([q for q, _ in pairs], spec),
            pytree.tree_unflatten([s for _, s in pairs], spec))


def dequantize(q_tree: Any, scale_tree: Any) -> Any:
    return pytree.tree_map(lambda q, s: q.float() * s, q_tree, scale_tree)


def compression_error(tree: Any) -> Any:
    """Residual tree: g - dequantize(quantize(g)) — the error-feedback term."""
    q, s = quantize(tree)
    back = dequantize(q, s)
    return pytree.tree_map(lambda g, b: g.float() - b, tree, back)


def make_reduce_fn(mesh: Any, axis: str):
    """A tree's mean over one axis of a ``DeviceMesh``: each leaf summed by
    one ``dist.all_reduce`` on that axis's process group (the reference's
    ``psum`` over the axis), then divided by the axis size.  The leaves are
    reduced into copies; the caller's tree is untouched."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def reduce_fn(tree: Any) -> Any:
        def one(t: torch.Tensor) -> torch.Tensor:
            t = t.clone()
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            return t / n
        return pytree.tree_map(one, tree)

    return reduce_fn


@dataclasses.dataclass
class CompressedReducer:
    """Error-feedback int8 gradient reducer.

    step(grads, reduce_fn) -> reduced grads; ``reduce_fn`` is the mean over
    the data-parallel group (:func:`make_reduce_fn`; identity when None).
    The residual of each step is added back before quantizing the next one.
    """

    error: Any = None

    def step(self, grads: Any, reduce_fn=None) -> Any:
        if self.error is not None:
            grads = pytree.tree_map(lambda g, e: g.float() + e, grads, self.error)
        q, scales = quantize(grads)
        back = dequantize(q, scales)
        self.error = pytree.tree_map(lambda g, b: g.float() - b, grads, back)
        if reduce_fn is not None:
            back = reduce_fn(back)
        return back
