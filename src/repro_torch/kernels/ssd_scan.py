"""Mamba-2 SSD on Hopper: the wrapper of ``csrc/ssd_chunk.cu``, its plain
version, and the full chunked scan around it.

The SSD recurrence  h_t = e^{a_t} h_{t-1} + B_t ⊗ x_t ,  y_t = C_t · h_t  is
evaluated chunk by chunk (Mamba-2 paper §6): inside a chunk of L steps it is
expanded into a quadratic, attention-like form — the kernel — and across
chunks only the (n, p) chunk states take part, in closed form: one ``bmm``
of the chunk-pair decays by the stacked states (:func:`ref.chunk_states`),
where the reference runs a ``jax.lax.scan`` under jit.

* :func:`ssd_chunk` replaces ``repro/kernels/ssd_scan.py::ssd_chunk`` (its
  Pallas kernel ``_kernel`` at :31, ``pallas_call`` at :73).  The kernels
  are bound by bytes; see the note at the top of the CUDA source for the
  design.  It checks its inputs, allocates the f32 outputs, launches on
  PyTorch's current stream and counts the launch in :data:`launches`,
  under its variant (:func:`variant`): ``"mma"``, the tensor-core kernel,
  for bf16 x, b, c with f32 a, p 64 and n 128 (every mamba2 path launch);
  ``"simt"``, the CUDA-core kernel, for everything else.  It raises for
  tensors off the card.  :func:`plain` repeats the kernel body
  (``ssd_scan.py:32-51``) in f32.
* :func:`ssd` is ``ssd_scan.py:97-145``: the transpose to rows
  ``batch·h + head``, the chunk kernel, the inter-chunk recurrence and the
  ``y_off`` term.  Products are ``bmm`` (never ``einsum``/``matmul``:
  ROADMAP queue 3).  It is the CUDA implementation of the
  ``repro_torch::ssd`` op (``kernels/ops.py``), which checks the shapes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import native, ref

VARIANTS = ("mma", "simt")
launches = native.LaunchCounter("ssd_chunk", VARIANTS)

MAX_CHUNK = 64                   # both kernels: 16-row steps over at most 64 rows
MAX_SMEM_BYTES = 232_448         # shared memory one Hopper block may opt in to (227 KB)
MMA_HEAD_DIM, MMA_STATE = 64, 128   # the only p and n the tensor-core kernel takes
_VARIANT_CODES = {"simt": 0, "mma": 1}


def variant(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> str:
    """The kernel that runs these chunk inputs (shapes as :func:`ssd_chunk`):
    ``"mma"`` for bf16 x, b, c, f32 a, p 64, n 128, chunks of at most 64
    steps and 16-byte aligned x, b, c (its copies move 16 bytes at a time);
    ``"simt"`` otherwise."""
    if x.dtype == b.dtype == c.dtype == torch.bfloat16 and a.dtype == torch.float32 \
            and x.shape[-1] == MMA_HEAD_DIM and b.shape[-1] == MMA_STATE \
            and x.shape[2] <= MAX_CHUNK and all(t.data_ptr() % 16 == 0 for t in (x, b, c)):
        return "mma"
    return "simt"


def smem_bytes(L: int, p: int, n: int) -> int:
    """Shared memory of one ``simt`` block: x (Lp, p), b and c (Lp, n + 1),
    the score tile (Lp, Lp + 1), a_cum and w (Lp), in f32; Lp is L rounded
    up to 16 (the sum ``smem_floats`` in the CUDA source)."""
    lp = (L + 15) // 16 * 16
    return 4 * (lp * p + 2 * lp * (n + 1) + lp * (lp + 1) + 2 * lp)


def check_shapes(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, chunk: int) -> None:
    if x.dim() != 4 or a.shape != x.shape[:3] or b.dim() != 4 or \
            b.shape != c.shape or b.shape[:3] != x.shape[:3]:
        raise ValueError(f"expect x (bh, nc, L, p), a (bh, nc, L) and b, c (bh, nc, L, n), "
                         f"got {tuple(x.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if x.shape[2] != chunk:
        raise ValueError(f"chunk mismatch {x.shape[2]} != {chunk}")


def plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
          chunk: int):
    """The kernel body in plain PyTorch, in f32: (y_diag, states, a_cum)."""
    check_shapes(x, a, b, c, chunk)
    bh, nc, L, p = x.shape
    n = b.shape[-1]
    xf = x.float().reshape(bh * nc, L, p)
    bf = b.float().reshape(bh * nc, L, n)
    cf = c.float().reshape(bh * nc, L, n)
    a_cum = torch.cumsum(a.float(), dim=-1)                      # (bh, nc, L)
    ac = a_cum.reshape(bh * nc, L)
    seg = ac[:, :, None] - ac[:, None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    # mask before exp (j > i entries have seg > 0 -> overflow)
    decay = torch.exp(torch.where(tri, seg, -torch.inf))
    scores = torch.bmm(cf, bf.transpose(1, 2)) * decay
    y = torch.bmm(scores, xf)
    w = torch.exp(ac[:, -1:] - ac)                               # (bh*nc, L)
    st = torch.bmm((bf * w[:, :, None]).transpose(1, 2), xf)    # (bh*nc, n, p)
    return y.reshape(bh, nc, L, p), st.reshape(bh, nc, n, p), a_cum


@functools.cache
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return native.c_function("ssd_chunk", "repro_ssd_chunk",
                             [p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i,
                              i, i, i, i, i, p])


def ssd_chunk(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
              chunk: int, kernel: str | None = None):
    """Chunk-local SSD terms, by a kernel.

    Args:
      x: (bh, nc, L, p) pre-discretized inputs (x·Δ).
      a: (bh, nc, L) log-decay per step (Δ·A, ≤ 0).
      b, c: (bh, nc, L, n) input/output projections.
      All on one CUDA device, float32 or bfloat16, contiguous.
      kernel: the variant to launch; by default :func:`variant` picks it.
        ``"simt"`` takes every input; ``"mma"`` raises for inputs it does
        not take.
    Returns:
      y_diag (bh, nc, L, p), states (bh, nc, n, p), a_cum (bh, nc, L), f32.
    """
    check_shapes(x, a, b, c, chunk)
    chosen = variant(x, a, b, c)
    kernel = chosen if kernel is None else kernel
    if kernel not in VARIANTS or (kernel == "mma" and chosen != "mma"):
        raise ValueError(f"ssd_chunk kernel {kernel!r} does not take x {x.dtype} "
                         f"{tuple(x.shape)}, a {a.dtype}, b/c {b.dtype} n {b.shape[-1]}")
    ins = (x, a, b, c)
    if x.device.type != "cuda" or any(t.device != x.device for t in ins):
        raise ValueError(f"ssd_chunk needs x, a, b, c on one CUDA device, got "
                         f"{[str(t.device) for t in ins]}")
    if any(t.dtype not in native.DTYPE_CODES for t in ins):
        raise TypeError(f"ssd_chunk takes float32 or bfloat16 inputs, got "
                        f"{[t.dtype for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd_chunk needs contiguous x, a, b, c")
    bh, nc, L, p = x.shape
    n = b.shape[-1]
    if L > MAX_CHUNK:
        raise ValueError(f"ssd_chunk takes chunks of at most {MAX_CHUNK} steps, got {L}")
    if kernel == "simt" and smem_bytes(L, p, n) > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_chunk: chunk {L}, head dim {p} and state {n} need "
                         f"{smem_bytes(L, p, n)} bytes of shared memory a block, over "
                         f"the {MAX_SMEM_BYTES} a Hopper block may use")
    y = torch.empty((bh, nc, L, p), dtype=torch.float32, device=x.device)
    st = torch.empty((bh, nc, n, p), dtype=torch.float32, device=x.device)
    a_cum = torch.empty((bh, nc, L), dtype=torch.float32, device=x.device)
    if bh * nc == 0:
        return y, st, a_cum                # nothing to launch
    with torch.cuda.device(x.device):
        rc = _entry()(*(t.data_ptr() for t in (x, a, b, c, y, st, a_cum)), bh * nc,
                      L, p, n, *(native.DTYPE_CODES[t.dtype] for t in ins),
                      _VARIANT_CODES[kernel], native.raw_stream(x.device.index))
    native.check_launch(rc, f"ssd_chunk ({kernel})")
    launches.add(kernel)
    return y, st, a_cum


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
        chunk: int = 64, initial_state: torch.Tensor | None = None):
    """Full SSD: the chunk-local op plus the inter-chunk state scan.

    Args:
      x: (batch, seqlen, heads, p), seqlen a multiple of chunk;
      a: (batch, seqlen, heads);
      b, c: (batch, seqlen, heads, n); initial_state: None or
      (batch, heads, n, p).
    Returns:
      y (batch, seqlen, heads, p) in x's dtype, final_state
      (batch, heads, n, p) in f32.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk

    def to_bh(t):
        # (batch, s, h, f?) -> (batch*h, nc, L, f?), row batch·h + head
        return t.transpose(1, 2).reshape(bsz * h, nc, chunk, *t.shape[3:]).contiguous()

    xb, ab, bb, cb = to_bh(x), to_bh(a), to_bh(b), to_bh(c)
    y_diag, states, a_cum = ssd_chunk(xb, ab, bb, cb, chunk=chunk)

    # the inter-chunk recurrence on (n, p) states, in closed form (one bmm)
    prev_states, final = ref.chunk_states(states, a_cum[..., -1], initial_state)

    # inter-chunk contribution: y_off[l] = C_l · prev_state · e^{a_cum_l}
    z = bsz * h * nc
    y_off = torch.bmm(cb.float().reshape(z, chunk, n), prev_states.reshape(z, n, p))
    y_off = y_off.reshape(bsz * h, nc, chunk, p) * torch.exp(a_cum)[..., None]
    y = (y_diag + y_off).reshape(bsz, h, s, p).transpose(1, 2)
    return y.to(x.dtype), final.reshape(bsz, h, n, p)
