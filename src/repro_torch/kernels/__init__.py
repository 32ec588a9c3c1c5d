"""Hand-written CUDA kernels for Hopper — the LARGE-tile operator bitstreams.

Kernel inventory (one module per kernel, each with its plain version in
``ref.py`` and its custom-op wrapper in ``ops.py``):

  vmul_reduce — the paper's own evaluation pattern (Σ A⃗·B⃗), csrc/vmul_reduce.cu:
                one launch a call, one thread-block cluster for small n, a
                grid whose last block adds the partials for large n
  rmsnorm     — fused RMSNorm, csrc/rmsnorm.cu: a warp per row, the row in
                registers; a block per row for ragged or unaligned rows
  flash_attention — blocked online-softmax attention (causal, GQA, sliding
                window, soft-cap), csrc/flash_attention.cu: bf16 with a head
                dim that is a multiple of 16 on the tensor cores (wgmma, a
                TMA-fed K/V ring), float32 and other head dims on the CUDA
                cores
  ssd_scan    — Mamba-2 SSD, the chunk-local quadratic part, one block per
                (batch·head, chunk), csrc/ssd_chunk.cu; the inter-chunk scan
                around it is plain PyTorch

Importing :mod:`repro_torch.kernels.ops` registers the kernels with the
overlay's trace frontend.
"""
