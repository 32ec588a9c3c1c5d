"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths end to end and fails loudly if any phase fails:

1. builds every CUDA kernel of the paths from ``src/repro_torch/csrc``
   (one nvcc per source, all started together);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it (tolerances stated below), checks that
   repeated vmul_reduce, flash_attention and ssd_chunk launches are
   bit-identical, and holds the full SSD scan (its inter-chunk recurrence in
   closed form) with an initial state against the sequential recurrence,
   also across 64 chunks of steep decay, where the op's gradients must be
   finite; flash_attention runs the variant its wrapper picks (the
   tensor-core kernel for bf16 with a head dim that is a multiple of 16, the
   CUDA-core kernel otherwise; not causal with as many queries as keys at
   seamless's encoder shape, and with 16 queries over 4096 keys; causal
   with 32 query heads over 8 kv heads at pixtral's shape, and with 128
   heads of 56 over 2047 positions at deepseek's MTP layer's, on the
   CUDA-core kernel), ssd_chunk
   every variant that takes each case; checks with ``torch.profiler``
   that one vmul_reduce call and one rmsnorm call each run exactly one CUDA
   kernel, on every variant;
3. runs the paper's workload, ``sum(a * b)``, through ``Overlay(3, 3).jit``
   at n = 4096 and 2^24, each size on a fresh static and a fresh dynamic
   overlay: the static placements with 0-3 pass-through tiles, dynamic
   placement (0 pass-through tiles, or the run fails) — outputs
   bit-identical across placements — and the LARGE ``vmul_reduce``
   bitstream; prints every row's pass-through count and ms per call, and
   the host time of each layer of the LARGE row at 4096.  ``[mesh]`` (after
   ``[async-fig3]``) starts an NCCL group of world 1 on a ``FileStore`` and
   runs fig3's ``sum(a * b)`` as ``vmul_reduce(a * b, 1)`` (the product
   vector crosses the hops to the kernel's tile) through ``Overlay(3, 3,
   mesh=)`` over a 1-rank ``"tiles"`` mesh, static with 0-3 pass-through
   tiles and dynamic, at 4096 and 2^24: outputs bit-identical to the local
   overlay's, one vmul_reduce launch a call, as many NCCL kernels a call as
   the placement's hops (``torch.profiler``), the specialized tier (a CUDA
   graph captured through NCCL) bit-identical to the generic one, ms per
   call beside the local rows; then ``moe_fwd_ep`` at granite-moe-1b-a400m's
   full width on 4096 bf16 tokens over a ``(1, 1)`` mesh against the local
   MoE, and ``CompressedReducer`` two steps on an f32 tree of granite's
   parameter shapes reduced through NCCL ``all_reduce`` (the int8 bound a
   step, the error-feedback sum within one step's bound of the true sum);
   every number a world-1 number.  ``[train-mesh]`` then trains
   phi3-mini-3.8b at full width cut to 2 of its 32 layers, batch 1 x seq
   4096, through the sharded train step (``make_sharded_train_step``:
   ``make_train_step`` on DTensor state placed by ``cell_shardings``) on
   the ``(data 1, model 1)`` mesh of an NCCL group of world 1, 2 steps,
   against 2 single-device steps of ``make_train_step`` from the same
   seeded bf16 weights and batches: every state leaf a DTensor at its
   cell placements before and after, losses, grad norms and every new
   parameter and moment bit-identical, 4 flash_attention launches a step
   (tensor-core kernel) and 9 rmsnorm launches in both; both step times
   beside the card's name and power limit; no CUDA graph captured, the
   group destroyed after.  ``[serve-mesh]`` serves the same cut of phi3
   through the sharded serve steps (``make_sharded_prefill_step``/
   ``make_sharded_serve_step`` on the state of ``shard_serve_state``): a
   batch-1 prefill of 4096 tokens into a cache of 5120, then 8 decodes,
   on that mesh under ``DEFAULT_RULES`` and ``SERVE_RULES``, against the
   single-device steps: every call's logits and every cache leaf
   bit-identical, every leaf a DTensor at its cell placement, 5 rmsnorm
   launches a call (warp kernel) and no flash_attention launch in every
   path; then the chunked cached prefill against the plain one (stated
   tolerance); prefill and decode ms and host ms beside the card's name
   and power limit; the group destroyed after.  ``[dryrun]`` runs
   ``python -m repro_torch.launch.dryrun`` on phi3's ``decode_32k`` cell
   over a fake group of 256 ranks, with the default rules and with
   ``--serve-rules`` (two processes at once): each line ``ok``, 256 chips,
   ``model_flops_per_dev`` = 2 N_active 128 / 256; its terms and memory
   printed;
4. serves phi3-mini-3.8b at full width (random bf16 weights from a seed,
   32 layers) through ``Overlay(3, 3)`` and with ``overlay=None``: identical
   greedy token streams, and one rmsnorm launch per norm call;
   Then, on the same weights: ``[relocate]`` serves them through an
   ``Overlay(3, 3)`` that first holds fig3's LARGE ``sum(a * b)`` at 2^24,
   evicts it and ``compact()``s, then ``resize(1)``s, serving after each:
   streams identical to plain, relocations with no new download or cache
   insertion, the host ms of each move; ``[specialize]`` captures the decode
   step as a CUDA graph (the route-constant tier), serves on it, relocates
   it (it despecializes and frees the graph), serves, specializes again and
   serves: every decode call of a specialized round on the graph, streams
   identical to plain, outputs bit-identical to the generic walk, host ms
   per decode call for generic, specialized and plain; ``[serve-loop]``
   serves them through ``EventLoopEngine`` plainly, on asynchronous
   overlays (with and without faults) and on a synchronous one; ``[fleet]``
   serves them through a two-member ``FleetOverlay`` sharing the card:
   ``ServeEngine`` (streams identical to plain, replications, routed calls
   and rmsnorm launches per member), the same with a member killed by
   ``FaultPlan(member_deaths=)`` (its sole copy evacuated), and
   ``EventLoopEngine`` on asynchronous members (a replica downloaded on a
   low lane); each fleet leaves under 1 GiB allocated after ``close()``;
5. trains phi3-mini-3.8b at full width (32 layers, batch 1, seq 4096) for 4
   eager steps of ``launch.train.make_step`` on the synthetic stream:
   finite losses, and the flash_attention and rmsnorm launches each step
   must make (forward plus the remat recompute), every flash_attention
   launch on the tensor-core kernel;
6. ``[train-overlay]`` trains full-width phi3 (16 of its 32 layers) at seq 1024
   for 2 steps through ``Overlay(3, 3).jit(train_step,
   donate_argnums=(0,))`` and eagerly in place from the same seed: equal
   losses and every state leaf bit-identical, every returned state leaf in
   its donated storage, the traced peak memory below the eager one plus
   half a state, one flash_attention and rmsnorm launch a step per node;
7. serves mamba2-130m at full width (24 layers) with prompts of 37, 500 and
   4096 tokens through ``Overlay(3, 3)`` and plainly: identical streams,
   one ``kernels/ssd`` node per layer in each traced prefill, and the
   ssd_chunk and rmsnorm launches each prefill and decode must make, every
   ssd_chunk launch on the tensor-core kernel; once more on
   ``Overlay(3, 3, cost_model_placement=True)``, identical streams, its
   downloads and re-downloads beside first-fit's;
8. trains mamba2-130m at full width for 3 eager steps at batch 1 x seq 4096:
   finite losses and 48 ssd_chunk and 49 rmsnorm launches a step, every
   ssd_chunk launch on the tensor-core kernel; the aten ops the host issues
   a step;
9. ``[train-gemma2]``: trains gemma2-27b at full width cut to its first
   (local, global) unit (random bf16 weights from the seed; its 46 layers
   with f32 moments need ~330 GB) at batch 1 x seq 6144, past the local
   layer's 4096 window: 4 eager steps under remat ``"full"``, then the
   same weights again and 2 steps under ``"dots"`` (each layer's 2-D
   products saved, the rest recomputed): finite losses, 4 flash_attention
   launches a step on the tensor-core kernel (the local layer's with
   window 4096, both with softcap 50) and 17 rmsnorm launches on the block
   kernel, under both policies; losses and grad norms bit-identical
   between them; a profiled step; one optimizer step alone and its peak
   memory above its start;
10. ``[train-minicpm]``: trains minicpm-2b at full width and all 40
    layers at batch 1 x seq 4096 on the launcher's ``wsd`` schedule, 4
    steps (one warmup step, three at the peak): finite losses, the lr of
    each step the schedule's, 80 flash_attention launches a step
    (tensor-core kernel, 36 heads of 64) and 161 rmsnorm launches (warp
    kernel);
11. ``[train-granite]``: trains the mixture-of-experts granite-moe-1b-a400m
    at full width and all 24 layers (32 experts, top-8, capacity factor
    1.25) at batch 1 x seq 4096, 4 steps under remat ``"full"`` on the
    reference's loss ``ce + 0.01 * aux``, the backward through the
    sort-based dispatch: finite losses, a finite aux above 0 and the loss
    equal to ce + 0.01 x aux on every step, 48 flash_attention launches a
    step (tensor-core kernel, 16 heads over 8 of 64) and 97 rmsnorm
    launches (warp kernel); a profiled step with the device time of the
    dispatch's index ops against the experts' bmm; whether step 1 again
    from the seed gives the same bits (printed, not required);
12. ``[train-pixtral]``: trains the vlm pixtral-12b at full width cut to 8
    of its 40 layers (d 5120, 32 heads over 8 kv heads of 128, untied vocab
    131072, the vision stub's ``frontend_proj``) at batch 1 x seq 4096
    under ``make_batch``'s 256 patches, 4 steps under remat ``"full"`` on
    the reference's vlm loss, which masks the patch positions out:
    finite losses equal to ce, 16 flash_attention launches a step
    (tensor-core kernel) and 33 rmsnorm launches (block kernel); a
    profiled step split into the f32 unembed's mm, the attention VJP and
    the optimizer; other labels under the patches give the same loss and
    grad norm bit for bit, and ``frontend_proj``'s gradient is finite and
    nonzero;
13. ``[train-deepseek]``: trains deepseek-v3-671b at full width cut to its
    3 ``mla_dense`` layers of 61 (d 7168, Multi-head Latent Attention over
    128 heads, d_ff 18432, untied vocab 129280, the multi-token-prediction
    module ``mtp``: random bf16 weights from the seed) at batch 1 x seq
    2048, 3 steps under remat ``"full"`` on the reference's loss ``ce +
    0.01 * aux + 0.3 * ce2``: finite losses, aux 0, ``ce2`` finite and
    positive, 1 flash_attention launch a step (the MTP layer's, 128 heads
    of 56 over 2047 positions, on the CUDA-core kernel), 16 rmsnorm
    launches on the block kernel and 12 on the warp kernel; a profiled step
    split into the two f32 unembeds, MLA's plain attention, the MTP layer
    and the optimizer; after the steps every gradient leaf under ``mtp``
    finite and nonzero, and ``embed``'s gradient moved by the MTP term;
14. ``[train-seamless]``: trains the encoder-decoder seamless-m4t-medium
    at full width and depth (12 ``enc`` + 12 ``dec`` layers, d 1024, 16
    heads of 64, untied vocab 256206; random bf16 weights from the seed)
    at batch 1 x 4096 tokens over 4096 frames, 3 steps under remat
    ``"full"`` on the reference's enc-dec loss: finite losses equal to ce,
    72 flash_attention launches a step (tensor-core kernel; 24 causal, the
    decoder's self-attentions, 48 not, the encoder's and the
    cross-attentions) and 122 rmsnorm launches (warp kernel); a profiled
    step split into the f32 unembed, the attention VJP, the optimizer and
    the bf16 products; after the steps every gradient leaf of the stub, the
    encoder and the cross-attentions finite and nonzero, and other frames
    move the loss;
15. ``[serve-gemma2]``: serves gemma2-27b at full width cut to 8 of its 46
    layers (4 units of local and global attention, softcaps, post norms,
    tied embeddings; random bf16 weights from the seed) at batch 2,
    max_len 4608: four (16, 8) requests and one (4352, 16), whose prompt
    reaches past the 4096 window, through ``Overlay(3, 3)`` and plainly:
    the logits of every call bit-identical (digest), identical streams
    (with random weights they repeat one token, so the digests carry the
    check), 33 rmsnorm launches a call, every one on the block kernel
    (d 4608); a plain prefill of the long prompt and the decode after it,
    again with no window, must give other logits; under 1 GiB left;
16. ``[serve-archs]``: the same for minicpm-2b cut to 8 of its 40 layers
    (17 warp launches a call) and mistral-large-123b cut to 8 of its 88
    layers (17 block launches a call), four (16, 8) requests each;
17. ``[serve-zamba2]``: serves the hybrid zamba2-7b at full width cut to
    15 of its 81 layers (the leading 3 mamba layers and 2 of its 13 (5
    mamba, shared_attn) units: 13 mamba layers at state 64 and 2
    occurrences of ONE shared attention+MLP weight set, each with its own
    KV cache; random bf16 weights from the seed) at batch 2, max_len 4128:
    four (16, 8) requests and one (4096, 16) through ``Overlay(3, 3)`` and
    plainly: the logits of every call bit-identical (digest) and finite,
    identical streams, 18 rmsnorm launches a call on the warp kernel (d
    3584), ssd_chunk 13 times a prefill on the CUDA-core kernel (state 64)
    and never in decode; under 1 GiB left;
18. ``[serve-granite]``: serves the mixture-of-experts granite-moe-1b-a400m
    at full width and depth (24 layers, 32 experts, top-8, capacity factor
    1.25, tied embeddings; random bf16 weights from the seed, 2.67 GB) at
    batch 2, max_len 4128: four (16, 8) requests and one (4096, 16) through
    ``Overlay(3, 3)`` and plainly: the logits of every call bit-identical
    (digest) and finite, identical streams, 49 rmsnorm launches a call on
    the warp kernel (d 1024), no ssd_chunk and no flash_attention (cached
    attention is plain code); prints total against active parameters;
    under 1 GiB left;
19. ``[serve-deepseek]``: serves deepseek-v3-671b at full width cut to its
    first 4 of 61 layers (3 ``mla_dense`` and 1 ``mla_moe``: Multi-head
    Latent Attention over a bf16 latent cache, 256 experts, top-8, one
    shared expert, sigmoid scoring; random bf16 weights from the seed,
    31.6 GB with the multi-token-prediction module the tree carries) at
    batch 2, max_len 2080: four (16, 8) requests and one (2048, 16)
    through ``Overlay(3, 3)`` and plainly: the logits of every call
    bit-identical (digest) and finite, identical streams, 17 rmsnorm
    launches a call (9 on the block kernel at d 7168, 8 on the warp
    kernel at the latents' 1536 and 512), no ssd_chunk and no
    flash_attention (MLA's attention is plain code, as the reference's);
    prints the expert capacity of each call's token count; under 1 GiB
    left; then times the plain 2048-token prefill and a batch-2 decode,
    each to a synchronize, the decode beside the time to read its
    weights once;
20. ``[serve-seamless]``: serves the encoder-decoder seamless-m4t-medium
    at full width and depth (12 ``enc`` + 12 ``dec`` layers, the audio
    stub's ``frontend_proj``; random bf16 weights from the seed, 1.96 GB)
    through the model API (``prefill(enc_in=frames)``, then greedy
    ``decode_step``; no engine serves an encoder-decoder, the reference's
    passes no encoder input) at batch 2, max_len 4096: frames of 1024 with
    16 new tokens, then 4096 with 32, each after a 2-token prompt, through
    ``Overlay(3, 3).jit`` of both steps and plainly: the logits of every
    call bit-identical (digest) and finite, identical streams, 62 rmsnorm
    launches a prefill and 37 a decode (warp, d 1024), 12 flash_attention
    launches a prefill (the encoder's, not causal, tensor-core kernel) and
    none a decode, no ssd_chunk, 12 ``kernels/attention`` nodes in each of
    the two traced prefills; under 1 GiB left; then times the plain
    4096-frame prefill and a batch-2 decode, each to a synchronize, the
    decode beside the time to read its weights and caches once;
21. ``[serve-pixtral]``: serves the vlm pixtral-12b at full width cut to
    8 of its 40 ``dense`` layers (d 5120, 32 heads over 8 kv heads of 128,
    untied vocab 131072, the vision stub's ``frontend_proj``; random bf16
    weights from the seed) two ways, each through
    ``Overlay(3, 3)`` and plainly: (a) as text through ``ServeEngine``,
    as the reference's engine serves it (it passes no patches), four
    (16, 8) requests at max_len 128; (b) through the model API at batch
    2, max_len 4096, ``prefill(patch_embeds=)`` of 256 patches (1024
    features, bf16, ``make_batch``'s count) over the leading slots of a
    512-token prompt, then 16 greedy ``decode_step`` calls, and of a
    2048-token prompt, then 32, both steps through ``Overlay(3, 3).jit``
    (a quarter of the fabric each).  Each way: the logits of every call
    bit-identical (digest) and finite, identical streams, 17 rmsnorm
    launches a call, all on the block kernel (d 5120), no flash_attention
    and no ssd_chunk (cached attention is plain code), one decode and two
    prefill signatures through the model API; the stub acts (the prompt
    without patches gives another digest) and the tokens under the
    patches do not (new ids there give the same bits); under 1 GiB left;
    then times the plain 2048-token prefill and a batch-2 decode, each to
    a synchronize, the decode beside the time to read its weights once;
22. ``[step-graph]``: ``build_step_graph`` of full-width phi3 at (2, 16)
    assembled on an all-LARGE ``Overlay(3, 3)``: logits bit-identical to
    ``forward`` + ``unembed``, 65 rmsnorm and 32 flash_attention launches;
    then zamba2-7b's at (1, 4096): bit-identical, 95 rmsnorm (warp), 68
    ssd_chunk (CUDA-core) and 13 flash_attention launches (tensor-core, at
    head dim 112); then granite-moe-1b-a400m's at (1, 4096): bit-identical,
    49 rmsnorm (warp) and 24 flash_attention launches (tensor-core, head dim
    64, 16 heads over 8); then deepseek-v3-671b's (4 layers) at (1, 2048):
    bit-identical, 9 rmsnorm on the block kernel and 8 on the warp kernel,
    no flash_attention (MLA's cache-free attention has q/k width 192 and v
    width 128: plain code, as the reference's); then pixtral-12b's at (1,
    2048): bit-identical, 81 rmsnorm (block) and 40 flash_attention
    launches (tensor-core, head dim 128, 32 heads over 8);
23. checks the models' outputs: finite full-width logits, small float32
    phi3, mamba2, gemma2 (window 8: prefill, three decodes and a
    cache-free forward through the flash kernel), zamba2 (state 64: the
    same), granite-moe (32 experts, top-8, capacity 1 at a batch-2
    decode: the same), deepseek (MLA over latents of 128, 32 experts,
    sigmoid scoring: the same, and a ragged decode; the MTP loss and its
    gradients, the MTP layer's one flash launch on the CUDA-core kernel)
    and seamless (d 256,
    2 + 2 layers, 256 frames: prefill, three decodes and a cache-free
    forward, whose flash launches are not causal with Sq = Sk in the
    encoder and Sq != Sk in the cross-attention) and pixtral (d 256, 2
    layers, a 128-token prompt under 64 patches: prefill, three decodes
    and a cache-free forward with the patches; the vlm loss and its
    gradients) models on the card (kernels) against the same models on
    the CPU (plain versions), serving and one train step;
24. runs the serve launcher on mamba2-130m at full width, phi3 (smoke) on
    the event loop, gemma2 (smoke) through the overlay, and the train
    launcher on pixtral-12b at full width cut to 2 layers (seq 1024 under
    256 patches) with an injected failure at step 3: it restores its 18.9
    GB step-2 checkpoint, replays and ends with rc 0 and finite losses (free disk
    and host memory before it, the seconds of each host copy, write and
    restore, the bytes on disk);
25. ``[warm-restart]``: boots the serve launcher in fresh processes on one
    persistent bitstream store directory — phi3-mini-3.8b at full width
    cut to 2 of its 32 layers (``--layers 2``; the ``[serve]`` requests)
    plain, cold (``--store`` on an empty
    directory), warm (the same directory) and garbled (one entry flipped
    mid-payload and one truncated, ``REPRO_SANITIZE=1``); then mamba2-130m
    at full width cut to 2 of its 24 layers (``--layers 2``) plain, cold
    and warm on a second directory (prompts of 37, 500 and 4096 tokens); a two-member fleet (``--fleet 2 --store D``) cold and
    warm on a third.  Streams identical to plain; the cold boot saves every
    kernel key and writes the ledger; the warm boot loads every key and
    builds no kernel; the garbled boot warns, rebuilds each bad entry and
    trips no invariant; the rmsnorm and ssd_chunk launches each boot must
    make.  Prints first-token seconds (process start plus init, trace,
    assembly or load, the first call), bytes on disk and load-vs-build ms
    per entry, the sanitizer's host ms per check, mamba2's downloads cold
    and warm;
26. ``[analysis]``: ``python -m repro_torch.analysis report`` on the card
    (lock lint, live checkers under the sanitizer, a two-member fleet's
    records and ``describe()``, the store, injected faults) must exit 0;
27. prints the kernels line (time per call, host included, and device time
    alone from CUDA-graph replays, for each kernel and its library call;
    bound, plain time, launches by path and by variant, flash_attention's
    and ssd_chunk's CUDA-core kernels' times), timings at other shapes
    (vmul_reduce's launch variants against each other, rmsnorm at every row
    shape of the paths, ssd_chunk's variants at every checked shape, the
    inter-chunk recurrence as the old loop over chunks and in closed form),
    the card's name and power limit, and last the result line.

Launch counts come from the wrappers' counters, set to 0 just before each
driven path (the paper workload, its calls on the mesh and local overlays
in ``[mesh]``, the sharded and single-device steps of ``[train-mesh]`` and
``[serve-mesh]`` (the chunked prefill too),
the overlay-served runs, the relocation
and specialization rounds, the fleet runs, the full-width training runs
(the train launcher's too),
the dense family's, zamba2's, granite's (training too), deepseek's (training
too), seamless's (training too) and
pixtral's runs (training too) and the step graphs' calls)
and read just
after; launches made to compare or time a kernel are not counted.  A
launcher boot of ``[warm-restart]`` is a process of its own: it counts from
0 and reports its counts in its result line.  Before each phase the script
prints the card's SM clock, temperature and active throttle reasons, and
the threads alive when ``[train]`` starts, and after it the phase's
seconds (``[phase]``).  A
CUDA-graph replay runs no wrapper: it adds to the counters the launches its
capture recorded.  Exits non-zero without a result line when CUDA is
unavailable or the port's sources are missing.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
    sys.exit("chip_smoke.py: src/repro_torch not found beside this script")
sys.path.insert(0, os.path.join(ROOT, "src"))

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: CUDA is not available")

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch import sharding as shd  # noqa: E402
from repro_torch.configs import (PAPER_VECTOR_LEN, cut_layers, get_config,  # noqa: E402
                                 smoke_config)
from repro_torch.core import (FaultPlan, FleetOverlay, Overlay, PlacementPolicy,  # noqa: E402
                              place)
from repro_torch.core import interpreter as interp  # noqa: E402
from repro_torch.data.pipeline import batch_specs, make_batch  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import native, ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels import vmul_reduce as vr_mod  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import params as pm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update_, constant, cosine, decay_mask  # noqa: E402
from repro_torch.optim.adamw import SLICE_ELEMENTS  # noqa: E402
from repro_torch.optim.compression import CompressedReducer, make_reduce_fn  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serving.loop import EventLoopEngine  # noqa: E402

DEV = torch.device("cuda")
SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 peak outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 peak in the tensor cores
BATCH, PROMPT, MAX_NEW, MAX_LEN, REQUESTS = 2, 16, 8, 128, 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 1, 4096, 4        # the reference's train_4k shape
# [train-overlay]: phi3 at full width cut to 16 of its 32 layers (the trace
# and the walk grow with depth; 16 keeps the script within its time)
OVERLAY_LAYERS, OVERLAY_SEQ, OVERLAY_STEPS = 16, 1024, 2
MAMBA = "mamba2-130m"
MAMBA_BATCH, MAMBA_REQUESTS, MAMBA_NEW = 4, 6, 16
MAMBA_PROMPTS = (37, 500, 4096)       # one ragged chunk, a padded tail, 64 full chunks
MAMBA_MAX_LEN = 4096 + 64
MAMBA_TRAIN_STEPS = 3
SSD_PATH = (24, 4096 // 64, 64, 64, 128)   # (batch*heads, chunks, L, p, n) of a 4096-token prefill
MAMBA_D = 768
# [serve-loop]: 8 requests, the last two shed by max_queue; prompts of 16
# and 37 / 100 / 300 tokens reach prefill_chunk as chunks of 16 and 64
LOOP_PROMPTS = (16, 37, 100, 300) * 2
LOOP_BATCH, LOOP_MAX_LEN, LOOP_CHUNK, LOOP_NEW, LOOP_QUEUE = 2, 512, 64, 16, 6
LOOP_FAULTS = dict(download_failure_rate=0.3, dispatch_failure_rate=0.02,
                   resident_loss_rate=0.02)
# rmsnorm's x on the main paths: phi3's serving prompt, batched prompt and
# decode rows, its event loop's full prefill chunk and its training x (d
# 3072); mamba2's prefills, one request at a time, its training x and its
# decode rows (d 768)
# the dense family: gemma2-27b at full width cut to 8 of its 46 layers
# (batch 2, max_len 4608: four (16, 8) requests and one (4352, 16), whose
# prompt reaches past the 4096 window of the local layers), minicpm-2b at 8
# of its 40 and mistral-large-123b at 8 of its 88 layers (245 GB in bf16),
# each with four (16, 8) requests
GEMMA = "gemma2-27b"
GEMMA_MAX_LEN, GEMMA_LONG, GEMMA_LONG_NEW = 4608, 4352, 16
GEMMA_REQUESTS = ((PROMPT, MAX_NEW),) * REQUESTS + ((GEMMA_LONG, GEMMA_LONG_NEW),)
GEMMA_D = 4608
GEMMA_SERVE_LAYERS = 8       # [serve-gemma2]: 4 of its 23 (local, global) units, at full width
DENSE_ARCHS = (("minicpm-2b", 8), ("mistral-large-123b", 8))   # (arch, layers kept)
# the hybrid zamba2-7b at full width, served at 15 of its 81 layers: four
# (16, 8) requests and one (4096, 16), whose prefill launches ssd_chunk at
# the full chunked shape (112 heads, 64 chunks of 64, head dim 64, state
# 64); its step graph at (1, 4096) and all 81 layers
ZAMBA = "zamba2-7b"
ZAMBA_MAX_LEN, ZAMBA_LONG, ZAMBA_LONG_NEW = 4128, 4096, 16
ZAMBA_REQUESTS = ((PROMPT, MAX_NEW),) * REQUESTS + ((ZAMBA_LONG, ZAMBA_LONG_NEW),)
ZAMBA_D = 3584
ZAMBA_SSD = (112, ZAMBA_LONG // 64, 64, 64, 64)   # (batch*heads, chunks, L, p, n) of its prefill
ZAMBA_FLASH = (1, 32, ZAMBA_LONG, 112)           # q (B, H, S, D) of its cache-free forward
ZAMBA_SERVE_LAYERS = 15      # [serve-zamba2]: 3 + 2 x 6 of its 81 layers, at full width
# the mixture-of-experts granite-moe-1b-a400m at full width and depth (24
# layers, 32 experts, top-8): four (16, 8) requests and one (4096, 16); its
# step graph at (1, 4096), whose cache-free forward launches flash at head
# dim 64 over 8 kv heads
GRANITE = "granite-moe-1b-a400m"
GRANITE_MAX_LEN, GRANITE_LONG, GRANITE_LONG_NEW = 4128, 4096, 16
GRANITE_REQUESTS = ((PROMPT, MAX_NEW),) * REQUESTS + ((GRANITE_LONG, GRANITE_LONG_NEW),)
GRANITE_D = 1024
GRANITE_FLASH = (1, 16, 8, GRANITE_LONG, 64)     # (B, Hq, Hkv, S, D) of its cache-free forward
# deepseek-v3-671b at full width cut to 4 of its 61 layers (3 mla_dense + 1
# mla_moe; all 61 are 1.34 TB in bf16): four (16, 8) requests and one
# (2048, 16).  The absorbed cached prefill keeps (1, 128, S, max_len) f32
# scores, 2.2 GB a copy at 2048 tokens; its step graph at (1, 2048)
DEEPSEEK = "deepseek-v3-671b"
DEEPSEEK_LAYERS = 4
DEEPSEEK_MAX_LEN, DEEPSEEK_LONG, DEEPSEEK_LONG_NEW = 2080, 2048, 16
DEEPSEEK_REQUESTS = ((PROMPT, MAX_NEW),) * REQUESTS + ((DEEPSEEK_LONG, DEEPSEEK_LONG_NEW),)
DEEPSEEK_D, DEEPSEEK_Q_LORA, DEEPSEEK_KV_LORA = 7168, 1536, 512
# the encoder-decoder seamless-m4t-medium at full width and depth (12 enc +
# 12 dec layers, d 1024): batch 2, max_len 4096 (the cross cache is as long
# as the self cache, so the encoder's frames must fit it), two rounds of a
# 2-token decoder prompt after (frames, new tokens): a short utterance and a
# long one, 4096 frames, the long-prompt length of the granite and zamba2
# phases.  Its encoder's self-attention is flash, not causal, q = k = v
# (2, 16, S, 64); a cache-free cross-attention has Sq != Sk (16 over 4096)
SEAMLESS = "seamless-m4t-medium"
SEAMLESS_MAX_LEN, SEAMLESS_PROMPT = 4096, 2
SEAMLESS_ROUNDS = ((1024, 16), (4096, 32))
SEAMLESS_D, SEAMLESS_HEADS, SEAMLESS_HEAD_DIM = 1024, 16, 64
SEAMLESS_CROSS_Q = 16
# the vlm pixtral-12b at full width (d 5120, 32 heads over 8 kv heads of
# 128), served at 8 of its 40 dense layers: as text through ServeEngine (four
# (16, 8) requests), and through the model API at batch 2, max_len 4096
# with 256 patches (make_batch's min(256, seq // 2)) over the leading slots
# of a 512-token prompt (16 decodes), then a 2048-token one (32 decodes);
# its step graph at (1, 2048), all 40 layers, launches flash causal at 32
# over 8 heads
PIXTRAL = "pixtral-12b"
PIXTRAL_MAX_LEN, PIXTRAL_NPATCH = 4096, 256
PIXTRAL_ROUNDS = ((512, 16), (2048, 32))
PIXTRAL_D = 5120
PIXTRAL_FLASH = (1, 32, 8, 2048, 128)     # (B, Hq, Hkv, S, D) of its cache-free forward
PIXTRAL_SERVE_LAYERS = 8     # [serve-pixtral]: 8 of its 40 layers, at full width
# dense-family training: gemma2-27b at full width cut to one (local, global)
# unit (its 46 layers and f32 moments need ~330 GB), batch 1 x seq 6144 so
# the local layer's 4096 window drops pairs, 4 steps under remat "full"
# and 2 more from the same seed under "dots"; minicpm-2b at full width and
# depth, 1 x 4096 on the wsd schedule
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_SEQ, GEMMA_TRAIN_STEPS, GEMMA_DOTS_STEPS = 2, 6144, 4, 2
GEMMA_FLASH = dict(softcap=50.0, scale=144 ** -0.5)      # its layers' options; local adds the window
MINICPM = "minicpm-2b"
MINICPM_TRAIN_STEPS = 4
MINICPM_D = 2304
MINICPM_FLASH = (1, 36, TRAIN_SEQ, 64)    # q, k, v (B, H, S, D) of its training forward (MHA)
# MoE training: granite-moe-1b-a400m at full width and depth, 1 x 4096, 4 steps
GRANITE_TRAIN_STEPS = 4
# vlm training: pixtral-12b at full width cut to 8 of its 40 layers (all 40
# with f32 moments need ~147 GB), 1 x 4096 under make_batch's 256 patches,
# 4 steps under remat "full"; the train launcher's full-width checkpoint
# restart: pixtral at 2 layers, seq 1024 (256 patches), a failure at step 3
PIXTRAL_TRAIN_LAYERS, PIXTRAL_TRAIN_STEPS = 8, 4
PIXTRAL_TRAIN_FLASH = (TRAIN_BATCH, 32, 8, TRAIN_SEQ, 128)   # (B, Hq, Hkv, S, D) in training
# multi-token-prediction training: deepseek-v3-671b at full width cut to its
# 3 mla_dense layers of 61 (any mla_moe layer is 11.3 B parameters, 135 GB of
# state), 1 x 2048 (MLA's plain attention and the MTP layer's attention VJP
# hold (1, 128, S, S) f32 tensors, 2.15 GB each at 2048), 3 steps under
# remat "full"; its MTP layer is a dense one, 128 heads of 7168 / 128 = 56
# over the 2047 positions that have a next label
DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_TRAIN_SEQ, DEEPSEEK_TRAIN_STEPS = 3, 2048, 3
DEEPSEEK_MTP_FLASH = (TRAIN_BATCH, 128, 128, DEEPSEEK_TRAIN_SEQ - 1, 56)  # (B, Hq, Hkv, S, D)
# enc-dec training: seamless-m4t-medium at full width and depth (12 enc + 12
# dec layers, d 1024, 16 heads of 64, untied vocab 256206), 1 x 4096 tokens
# over make_batch's 4096 frames, 3 steps under remat "full"; its attention is
# q, k, v (1, 16, 4096, 64): the encoder's and the cross-attention not
# causal, the decoder's self-attention causal; its rows (4096, 1024), warp
SEAMLESS_TRAIN_STEPS = 3
SEAMLESS_TRAIN_FLASH = (TRAIN_BATCH, SEAMLESS_HEADS, SEAMLESS_HEADS, TRAIN_SEQ, SEAMLESS_HEAD_DIM)
LAUNCHER_LAYERS, LAUNCHER_SEQ = 2, 1024
LAUNCHER_TRAIN = ["--arch", PIXTRAL, "--layers", str(LAUNCHER_LAYERS), "--batch", "1",
                  "--seq", str(LAUNCHER_SEQ), "--steps", "4", "--ckpt-every", "2",
                  "--fail-at", "3", "--log-every", "1", "--seed", str(SEED)]
RMSNORM_SHAPES = ((PROMPT, 3072), (BATCH * PROMPT, 3072), (BATCH, 3072), (1, LOOP_CHUNK, 3072),
                  (TRAIN_BATCH, TRAIN_SEQ, 3072),
                  *((1, s, MAMBA_D) for s in MAMBA_PROMPTS), (MAMBA_BATCH, 1, MAMBA_D),
                  # gemma2's decode rows, its long prefill (the block kernel:
                  # d > MAX_WARP_D), minicpm's decode rows, mistral's
                  (BATCH, GEMMA_D), (GEMMA_LONG, GEMMA_D), (BATCH, 2304), (BATCH, 12288),
                  # zamba2's decode rows, short prompts and long prefill
                  (BATCH, ZAMBA_D), (1, PROMPT, ZAMBA_D), (1, ZAMBA_LONG, ZAMBA_D),
                  # granite's
                  (BATCH, GRANITE_D), (1, PROMPT, GRANITE_D), (1, GRANITE_LONG, GRANITE_D),
                  # deepseek's: ln1/ln2/final (the block kernel), the query
                  # and key/value latents (the warp kernel)
                  *((*rows, d) for d in (DEEPSEEK_D, DEEPSEEK_Q_LORA, DEEPSEEK_KV_LORA)
                    for rows in ((BATCH, 1), (1, PROMPT), (1, DEEPSEEK_LONG))),
                  # seamless's encoder at 4096 and 1024 frames, its decoder
                  # prompt and decode rows (d 1024, the warp kernel)
                  (BATCH, SEAMLESS_ROUNDS[1][0], SEAMLESS_D),
                  (BATCH, SEAMLESS_ROUNDS[0][0], SEAMLESS_D),
                  (BATCH, SEAMLESS_PROMPT, SEAMLESS_D), (BATCH, 1, SEAMLESS_D),
                  # pixtral's decode rows and its 2048-token prefill at batch
                  # 2 (d 5120, the block kernel)
                  (BATCH, PIXTRAL_D), (BATCH * PIXTRAL_ROUNDS[1][0], PIXTRAL_D),
                  # training: gemma2's rows at 6144 and 1024, pixtral's at 4096
                  # and the launcher's 1024 (block), minicpm's at 4096 (warp)
                  (TRAIN_BATCH, GEMMA_TRAIN_SEQ, GEMMA_D), (1, 1024, GEMMA_D),
                  (TRAIN_BATCH, TRAIN_SEQ, PIXTRAL_D), (1, LAUNCHER_SEQ, PIXTRAL_D),
                  (TRAIN_BATCH, TRAIN_SEQ, MINICPM_D),
                  # deepseek's MTP layer and its norm at 2047 rows (block)
                  (TRAIN_BATCH, DEEPSEEK_MTP_FLASH[3], DEEPSEEK_D))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call (CUDA events around ``iters`` calls)."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


_capture_stream = None


def device_ms(fn, calls: int = 100, replays: int = 10) -> float:
    """Device time of one call alone: ``calls`` calls captured in one CUDA
    graph (``torch.cuda.CUDAGraph``), replayed ``replays`` times between CUDA
    events, so the host's cost of issuing each call is not in it.  Warmed up
    on the capture stream first, so anything a wrapper allocates once per
    stream is allocated outside the capture."""
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    s = _capture_stream
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        for _ in range(calls):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (replays * calls)


PROFILE_MARGIN_S = 0.02     # idle card time at each edge of a profiler window


def kernels_launched(fn, calls: int = 3) -> list[str]:
    """The names of the CUDA kernels (and copies) the card ran for ``calls``
    calls of ``fn``, as ``torch.profiler`` records them.  The window opens
    and closes on an idle card, ``PROFILE_MARGIN_S`` from the first and the
    last launch: a kernel launched right at an edge of the window is now and
    then left out of its record."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return [ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def gpu_state(phase: str) -> str:
    """The card's SM clock, temperature and active throttle reasons, logged
    before ``phase``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,"
                          "clocks_throttle_reasons.active", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    log(f"[gpu] before {phase}: SM clock, temperature, throttle reasons: {out} "
        f"(allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    return out


def reset_counters() -> None:
    for c in ops.LAUNCH_COUNTERS:
        c.reset()


def counts() -> dict[str, int]:
    """Launches by kernel, and by variant as ``<kernel>/<variant>``."""
    out = {c.name: c.count for c in ops.LAUNCH_COUNTERS}
    for c in ops.LAUNCH_COUNTERS:
        out.update({f"{c.name}/{v}": n for v, n in c.by_variant.items()})
    return out


# ---------------------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    paths = native.build()
    log(f"[build] {sorted(paths)} in {time.perf_counter() - t0:.1f}s "
        f"(nvcc -gencode arch=compute_90a,code=sm_90a)")
    for name, path in paths.items():
        text = path.with_suffix(".log").read_text()
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {name}: " + " | ".join(sorted(set(regs))))
        if name == "flash_attention":
            for entry, props in ptxas_entries(text).items():
                if "flash_fwd_wgmma" in entry:
                    log(f"[build] flash_attention {entry}: {props}")
            for ln in text.splitlines():
                if "Performance Loss" in ln or "arning" in ln:
                    log(f"[build] flash_attention ptxas: {ln.strip()}")


def ptxas_entries(log_text: str) -> dict[str, str]:
    """Registers and spills of each kernel in an ``nvcc -Xptxas -v`` log, by
    the kernel's (mangled) name."""
    out, entry = {}, None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            out[entry] = ""
        elif entry and ("spill" in ln or "registers" in ln):
            out[entry] = (out[entry] + " | " if out[entry] else "") + ln.strip()
    return out


def phase_kernel_checks(gen: torch.Generator) -> dict[str, float]:
    """Each kernel against its plain version at the main path's shapes.

    Tolerances: vmul_reduce accumulates in f32 in another order than
    torch.sum, so |kernel - plain| <= 1e-5 * sum(|a*b|) (+ one bf16 rounding
    of the result, 2**-8 * |plain|, for bf16); rmsnorm computes the same
    f32 expression per element with another reduction order and rsqrtf, so
    |kernel - plain| <= 1e-5 * (1 + |plain|) in f32 and one bf16 ulp
    (2**-7 * |plain|) in bf16."""
    errs = {"vmul_reduce": 0.0, "rmsnorm": 0.0}
    for n in (PAPER_VECTOR_LEN, 1000003, 1 << 26):
        for dt in (torch.float32, torch.bfloat16):
            a = torch.randn(n, generator=gen, device=DEV).to(dt)
            b = torch.randn(n, generator=gen, device=DEV).to(dt)
            k1 = vr_mod.vmul_reduce_cuda(a, b)
            k2 = vr_mod.vmul_reduce_cuda(a, b)
            p = vr_mod.plain(a, b)
            abs_sum = (a.float() * b.float()).abs().sum().item()
            err = abs(k1.float().item() - p.float().item())
            tol = 1e-5 * abs_sum + (2 ** -8 * abs(p.float().item())
                                    if dt == torch.bfloat16 else 0.0)
            check(torch.equal(k1, k2), f"vmul_reduce n={n} {dt}: repeated launches differ")
            check(err <= tol, f"vmul_reduce n={n} {dt}: err {err} > tol {tol}")
            errs["vmul_reduce"] = max(errs["vmul_reduce"], err)
            log(f"[kernels] vmul_reduce n={n} {str(dt)[6:]}: kernel {k1.float().item():.6f} "
                f"plain {p.float().item():.6f} err {err:.3g} tol {tol:.3g} bit-identical repeat")
            del a, b
    for shape in RMSNORM_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(*shape, generator=gen, device=DEV).to(dt)
            w = 1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device=DEV)
            y = rn_mod.rmsnorm_cuda(x, w)
            p = rn_mod.plain(x, w)
            diff = (y.float() - p.float()).abs()
            rel = 2 ** -7 if dt == torch.bfloat16 else 1e-5
            check(bool((diff <= rel * (1 + p.float().abs())).all()),
                  f"rmsnorm {shape} {dt}: max err {diff.max().item()}")
            errs["rmsnorm"] = max(errs["rmsnorm"], diff.max().item())
            log(f"[kernels] rmsnorm {shape} {str(dt)[6:]} x, f32 w: "
                f"max err {diff.max().item():.3g}")
    errs["flash_attention"] = check_flash(gen)
    errs["ssd_chunk"] = check_ssd(gen)
    torch.cuda.synchronize()
    return errs


def phase_one_launch(gen: torch.Generator) -> None:
    """One vmul_reduce call and one rmsnorm call each make exactly one CUDA
    kernel, through the wrapper and through the custom op, on every variant
    (``torch.profiler``'s record of three calls: three kernels, each the
    wrapper's own)."""
    cases = []
    for n in (PAPER_VECTOR_LEN, 1 << 24):
        a = torch.randn(n, generator=gen, device=DEV)
        b = torch.randn(n, generator=gen, device=DEV)
        kind = "cluster" if vr_mod.plan(n).cluster else "grid"
        cases += [(f"vmul_reduce_cuda n={n} ({kind})", "vmul_reduce_" + kind,
                   lambda a=a, b=b: vr_mod.vmul_reduce_cuda(a, b)),
                  (f"ops.vmul_reduce n={n} ({kind})", "vmul_reduce_" + kind,
                   lambda a=a, b=b: ops.vmul_reduce(a, b))]
    for shape, kind in (((BATCH, 3072), "warp"), ((8192, 3072), "warp"), ((5, 3001), "block")):
        x = torch.randn(*shape, generator=gen, device=DEV).bfloat16()
        w = 1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device=DEV)
        check(rn_mod.variant(x, x) == kind, f"rmsnorm {shape} picks {rn_mod.variant(x, x)}")
        cases += [(f"rmsnorm_cuda {shape} ({kind})", "rmsnorm_" + kind,
                   lambda x=x, w=w: rn_mod.rmsnorm_cuda(x, w)),
                  (f"ops.rmsnorm {shape} ({kind})", "rmsnorm_" + kind,
                   lambda x=x, w=w: ops.rmsnorm(x, w))]
    for case, kernel, fn in cases:
        names = kernels_launched(fn)
        check(len(names) == 3 and all(kernel in nm for nm in names),
              f"{case}: three calls ran {names}, not three {kernel} kernels")
        log(f"[kernels] {case}: one kernel per call ({kernel}), by torch.profiler")


FLASH_CASES = [   # (B, Hq, Hkv, Sq, Sk, D, dtype, options)
    (TRAIN_BATCH, 32, 32, TRAIN_SEQ, TRAIN_SEQ, 96, torch.bfloat16, {}),   # the training path
    (2, 8, 2, 256, 256, 64, torch.bfloat16, {}),                # GQA
    (2, 8, 2, 256, 256, 64, torch.float32, {}),
    (2, 8, 2, 512, 512, 128, torch.bfloat16, {}),               # GQA at d 128
    (1, 4, 4, 384, 384, 96, torch.float32, dict(window=100)),
    (1, 4, 4, 384, 384, 96, torch.bfloat16, dict(window=100)),
    (1, 4, 2, 256, 256, 32, torch.float32, dict(softcap=30.0, scale=0.1)),
    (1, 4, 2, 256, 256, 32, torch.bfloat16, dict(softcap=30.0, scale=0.1)),
    (1, 4, 4, 200, 200, 128, torch.float32, dict(causal=False)),   # ragged tiles
    (1, 4, 2, 77, 77, 96, torch.bfloat16, {}),                  # ragged, bf16
    (1, 4, 2, 200, 200, 16, torch.bfloat16, dict(causal=False)),
    (1, 4, 4, 1, 1, 64, torch.bfloat16, {}),
    (1, 4, 2, 256, 256, 40, torch.bfloat16, {}),                # bf16 on the CUDA cores
    # gemma2-27b's local and global layers in training at seq 6144 (the
    # window acts) and at 1024 (it does not)
    *((1, 32, 16, s, s, 128, torch.bfloat16, dict(window=w, **GEMMA_FLASH))
      for s in (GEMMA_TRAIN_SEQ, 1024) for w in (4096, None)),
    # minicpm-2b's 40 layers in training: 36 heads of 64, no GQA
    (MINICPM_FLASH[0], MINICPM_FLASH[1], MINICPM_FLASH[1], MINICPM_FLASH[2], MINICPM_FLASH[2],
     MINICPM_FLASH[3], torch.bfloat16, {}),
    # zamba2-7b's shared_attn occurrences in its 4096-token cache-free forward
    (ZAMBA_FLASH[0], ZAMBA_FLASH[1], ZAMBA_FLASH[1], ZAMBA_FLASH[2], ZAMBA_FLASH[2],
     ZAMBA_FLASH[3], torch.bfloat16, {}),
    # granite-moe-1b-a400m's 24 layers in its 4096-token cache-free forward
    (*GRANITE_FLASH[:4], GRANITE_FLASH[3], GRANITE_FLASH[4], torch.bfloat16, {}),
    # seamless-m4t-medium's encoder at 4096 and 1024 frames (not causal,
    # every query tile walks every key tile), and a cache-free
    # cross-attention, 16 queries over 4096 keys, bf16 and f32
    *((BATCH, SEAMLESS_HEADS, SEAMLESS_HEADS, n, n, SEAMLESS_HEAD_DIM, torch.bfloat16,
       dict(causal=False)) for n, _ in reversed(SEAMLESS_ROUNDS)),
    *((BATCH, SEAMLESS_HEADS, SEAMLESS_HEADS, SEAMLESS_CROSS_Q, SEAMLESS_ROUNDS[1][0],
       SEAMLESS_HEAD_DIM, dt, dict(causal=False)) for dt in (torch.bfloat16, torch.float32)),
    # pixtral-12b's 40 layers in its 2048-token cache-free forward, its 8
    # in training at 4096 and the train launcher's 2 at 1024
    (*PIXTRAL_FLASH[:4], PIXTRAL_FLASH[3], PIXTRAL_FLASH[4], torch.bfloat16, {}),
    *((*PIXTRAL_TRAIN_FLASH[:3], s, s, PIXTRAL_TRAIN_FLASH[4], torch.bfloat16, {})
      for s in (TRAIN_SEQ, LAUNCHER_SEQ)),
    # deepseek-v3's MTP layer in training: 128 heads of 56 (the CUDA-core
    # kernel: 56 is no multiple of 16) over 2047 positions (ragged tiles)
    (*DEEPSEEK_MTP_FLASH[:4], DEEPSEEK_MTP_FLASH[3], DEEPSEEK_MTP_FLASH[4], torch.bfloat16, {}),
    # seamless-m4t-medium in training: the decoder's self-attention (causal),
    # the encoder's and the cross-attention (not causal; 4096 queries over
    # 4096 frames); its (4096, 1024) rmsnorm rows are granite's long prefill's
    *((*SEAMLESS_TRAIN_FLASH[:4], SEAMLESS_TRAIN_FLASH[3], SEAMLESS_TRAIN_FLASH[4],
       torch.bfloat16, kw) for kw in ({}, dict(causal=False))),
]


def check_flash(gen: torch.Generator) -> float:
    """flash_attention against the plain version (``ref.attention``), each
    case on the variant its wrapper picks.

    Tolerances (``flash_attention.tolerance``): both compute the scores and
    the softmax in f32, but the kernels scale in another place than the
    plain version, sum in another order and normalize online, so in f32
    |kernel - plain| <= 1e-5 * (1 + |plain|); a bf16 output is rounded once
    from f32 values that close, so it lands within one bf16 ulp,
    |kernel - plain| <= 2**-7 * |plain| + 1e-5; the tensor-core kernel also
    rounds P to bf16 before P V, which moves an output by at most
    2**-9 * max|v|, so it gets 2**-8 * max|v| more (the max over the keys of
    the row's kv head, per column)."""
    worst = 0.0
    for b, hq, hkv, sq, sk, d, dt, kw in FLASH_CASES:
        q = torch.randn(b, hq, sq, d, generator=gen, device=DEV).to(dt)
        k = torch.randn(b, hkv, sk, d, generator=gen, device=DEV).to(dt)
        v = torch.randn(b, hkv, sk, d, generator=gen, device=DEV).to(dt)
        kernel = fa_mod.variant(dt, d)
        k1 = fa_mod.flash_attention(q, k, v, **kw)
        k2 = fa_mod.flash_attention(q, k, v, **kw)
        p = fa_mod.plain(q, k, v, **kw)
        diff = (k1.float() - p.float()).abs()
        tol = fa_mod.tolerance(p, v, kernel)
        case = f"flash_attention {(b, hq, hkv, sq, sk, d)} {dt} {kw} on {kernel}"
        check(torch.equal(k1, k2), f"{case}: repeated launches differ")
        check(bool((diff <= tol).all()), f"{case}: max err {diff.max().item()}, "
              f"worst err / tol {(diff / tol).max().item()}")
        worst = max(worst, diff.max().item())
        log(f"[kernels] flash_attention q ({b}, {hq}, {sq}, {d}) kv heads {hkv} keys {sk} "
            f"{str(dt)[6:]} {kw or 'causal'} on {kernel}: max err {diff.max().item():.3g} "
            f"(worst err / tol {(diff / tol).max().item():.3f}), bit-identical repeat")
        del q, k, v, k1, k2, p, diff, tol
    return worst


SSD_CASES = [   # (bh, nc, L, p, n, dtype of x/b/c, a_cum span per chunk)
    (*SSD_PATH, torch.bfloat16, 2.0),           # the 4096-token prefill, f32 a
    (24, 1, 37, 64, 128, torch.bfloat16, 2.0),  # a 37-token prompt: one ragged chunk
    (24, 8, 64, 64, 128, torch.float32, 2.0),
    (16, 3, 8, 16, 16, torch.float32, 2.0),     # the smoke configs' shape
    (24, 4, 64, 64, 128, torch.bfloat16, 60.0), # a_cum spans -60..0: the masked exp
    (*ZAMBA_SSD, torch.bfloat16, 2.0),          # zamba2's 4096-token prefill (state 64: simt)
    (112, 1, 16, 64, 64, torch.bfloat16, 2.0),  # zamba2's 16-token prompt: one short chunk
]


def check_ssd(gen: torch.Generator) -> float:
    """ssd_chunk against the plain version (``ssd_scan.plain``), all three
    outputs, each case on every variant that takes it.  Tolerance: both
    sides compute in f32 from the same inputs and differ only in the order
    of their sums (the dot products, the cumsum), so every output is within
    1e-5 of the largest plain value of its tensor (a normwise bound: a sum's
    rounding scales with its terms, not with a cancelled result).  The
    tensor-core kernel multiplies bf16 operands exactly and splits each f32
    operand into three bf16 parts, which carry its 24 bits: it is held to
    the same bound.  Then the full scan (``ssd_scan.ssd``, the inter-chunk
    recurrence in closed form) with an initial state against the sequential
    recurrence (``ref.ssd_naive``), another order of the whole sum: the
    reference's own 2e-4, at 4 chunks and at 64 chunks whose a_cum spans 60
    each, where the op's gradients must also be finite."""
    worst = 0.0
    for bh, nc, L, p, n, dt, span in SSD_CASES:
        x = torch.randn(bh, nc, L, p, generator=gen, device=DEV).to(dt)
        b = torch.randn(bh, nc, L, n, generator=gen, device=DEV).to(dt)
        c = torch.randn(bh, nc, L, n, generator=gen, device=DEV).to(dt)
        a = -torch.rand(bh, nc, L, generator=gen, device=DEV) * (2 * span / L)
        want = ssd_mod.plain(x, a, b, c, chunk=L)
        chosen = ssd_mod.variant(x, a, b, c)
        for kernel in ssd_mod.VARIANTS:
            if kernel == "mma" and chosen != "mma":
                continue                       # the CUDA-core kernel takes every case
            k1 = ssd_mod.ssd_chunk(x, a, b, c, chunk=L, kernel=kernel)
            k2 = ssd_mod.ssd_chunk(x, a, b, c, chunk=L, kernel=kernel)
            case = f"ssd_chunk {(bh, nc, L, p, n)} {dt} span {span} on {kernel}"
            errs = []
            for name, u, v, w in zip(("y_diag", "states", "a_cum"), k1, k2, want):
                check(torch.equal(u, v), f"{case}: repeated {name} differ")
                err, scale = (u - w).abs().max().item(), w.abs().max().item()
                check(err <= 1e-5 * scale, f"{case}: {name} max err {err} > 1e-5 * {scale}")
                errs.append(f"{name} {err:.3g} (of {scale:.3g})")
                worst = max(worst, err)
            log(f"[kernels] ssd_chunk x ({bh}, {nc}, {L}, {p}) n {n} {str(dt)[6:]}, a_cum span "
                f"{span} on {kernel}{' (picked)' if kernel == chosen else ''}: max err "
                + ", ".join(errs) + ", bit-identical repeat")
            del k1, k2
        del x, b, c, a, want
    for s, span in ((256, None), (4096, 60.0)):
        x, b, c = (0.5 * torch.randn(2, s, 3, 16, generator=gen, device=DEV) for _ in range(3))
        a = -(0.2 if span is None else 2 * span / 64) * torch.rand(2, s, 3, generator=gen,
                                                                   device=DEV)
        init = torch.randn(2, 3, 16, 16, generator=gen, device=DEV)
        y, final = ssd_mod.ssd(x, a, b, c, chunk=64, initial_state=init)
        yn, fn = ref.ssd_naive(x, a, b, c, init)
        case = f"ssd scan (2, {s}, 3, 16) chunk 64" + (f", a_cum span {span} a chunk"
                                                       if span else "")
        for name, got, want in (("y", y, yn), ("final state", final, fn)):
            err = (got - want).abs()
            check(bool((err <= 2e-4 * (1 + want.abs())).all()),
                  f"{case} with an initial state: {name} max err {err.max().item()}")
        msg = ""
        if span is not None:
            ins = [t.detach().requires_grad_() for t in (x, a, b, c)]
            grads = torch.autograd.grad(ops.ssd(*ins, chunk=64).sum(), ins)
            check(all(bool(torch.isfinite(g_).all()) for g_ in grads),
                  f"{case}: non-finite gradients of the ssd op")
            msg = "; the op's four gradients finite"
        log(f"[kernels] {case} with an initial state vs the sequential recurrence: y max err "
            f"{(y - yn).abs().max().item():.3g}, final state "
            f"{(final - fn).abs().max().item():.3g}{msg}")
    return worst


class Counted:
    """Counts calls of a serving step (prefill or decode) and keeps each
    call's host time.  The steps are host-bound (the card idles while Python
    issues the aten ops), so the time to issue a call is close to its time
    to run; the tick's one device-to-host copy ends each decode call.  For
    an overlay step it also counts the calls that found a valid
    specialized dispatch record; other attributes (``prefetch``,
    ``specialize``) are the step's own."""

    def __init__(self, fn):
        self.fn, self.calls, self.seconds, self.lengths = fn, 0, [], []
        self.spec_calls = 0

    def __getattr__(self, name):
        return getattr(self.fn, name)

    @property
    def tile_budget(self):              # ServeEngine.resize sets the step's budget
        return self.fn.tile_budget

    @tile_budget.setter
    def tile_budget(self, value):
        self.fn.tile_budget = value

    def __call__(self, *args):
        self.calls += 1
        self.lengths.append(args[1].shape[1])      # tokens of the call
        entries = getattr(self.fn, "_entries", None)
        if entries and len(entries) == 1:          # the fast path's own validity test
            rec = next(iter(entries.values())).record
            if rec is not None and rec.tier == "specialized" and rec.res.live \
                    and rec.res.generation == rec.generation:
                self.spec_calls += 1
        t0 = time.perf_counter()
        out = self.fn(*args)
        self.seconds.append(time.perf_counter() - t0)
        return out

    def split_ms(self) -> str:
        """First call (trace and assembly, for an overlay) and the median of
        the rest, in ms."""
        return (f"first {self.seconds[0] * 1e3:.1f} ms, then median "
                f"{float(np.median(self.seconds[1:])) * 1e3:.1f} ms")

    def by_length_ms(self) -> str:
        """Per call length: first call and the median of the rest, in ms."""
        out = []
        for n in sorted(set(self.lengths)):
            ts = [t * 1e3 for t, m in zip(self.seconds, self.lengths) if m == n]
            rest = f", then median {float(np.median(ts[1:])):.1f}" if len(ts) > 1 else ""
            out.append(f"{n} tokens: first {ts[0]:.1f}{rest} ({len(ts)} calls)")
        return "; ".join(out)


FIG3_SIZES = (PAPER_VECTOR_LEN, 1 << 24)
# trace node ids: inputs 0, 1; VMUL (mul) 2; Reduce (sum) 3.  The grid's LARGE
# tiles are (0,0), (1,1), (2,2): Reduce is pinned at (0,0) and VMUL moved
# progressively further away (fig. 2 of the paper).
FIG3_STATIC = (("static_0pass", (0, 1)), ("static_1pass", (0, 2)),
               ("static_2pass", (1, 2)), ("static_3pass", (2, 2)))


def _fig3_dot(a, b):
    return torch.sum(a * b)


def _fig3_large(a, b):
    return ops.vmul_reduce(a, b)


def _fig3_mesh(a, b, one):
    """fig3's ``sum(a * b)`` with the reduction on the LARGE kernel: VMUL
    (an elementwise mul on a SMALL tile) streams its product vector through
    the pass-through tiles to ``vmul_reduce`` (times 1, exact) on a LARGE
    tile, as the paper's VMUL -> Reduce."""
    return ops.vmul_reduce(a * b, one)


# trace node ids of _fig3_mesh: inputs 0-2, mul 3, kernels/vmul_reduce 4
FIG3_MESH_STATIC = tuple((name, {3: vmul, 4: (0, 0)}) for name, vmul in FIG3_STATIC)
MESH_TIME_ITERS = {PAPER_VECTOR_LEN: 100, 1 << 24: 20}


def nccl_kernels(fn) -> int:
    """NCCL kernels the card runs for one call of ``fn`` (``torch.profiler``;
    ``ncclDevKernel_*``, ``ncclKernel_*`` before NCCL 2.19), not the device
    ranges the collectives annotate (``nccl:all_to_all``)."""
    return sum(1 for name in kernels_launched(fn, calls=1)
               if name.startswith(("ncclDevKernel", "ncclKernel")))


def phase_mesh(gen: torch.Generator) -> dict:
    """[mesh] The port's multi-device paths at world 1 over NCCL (the card's
    machine has one GPU): the overlay across a 1-rank ``"tiles"`` mesh
    (each hop a ring shift, ``dist.all_to_all_single``), expert-parallel
    MoE at granite's full width over a ``(1, 1)`` mesh, and int8 gradient
    compression reduced through ``all_reduce``.  The group lives on a
    ``FileStore`` in a temporary directory and is destroyed at the end,
    after the overlays' ``close()``, which releases every CUDA graph that
    captured a collective (a live one makes ``destroy_process_group``
    hang).  Returns the launches of the overlay rows."""
    log(f"[mesh] NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, world 1 on "
        f"{torch.cuda.get_device_name(0)}")
    store_dir = tempfile.mkdtemp(prefix="mesh_store_")
    backend = mesh_lib.init_group("cuda", os.path.join(store_dir, "store"))
    check(backend == "nccl" and dist.get_backend() == "nccl",
          f"[mesh] the group's backend is {dist.get_backend()}, not nccl")
    overlays, alive = [], []
    try:
        tiles = mesh_lib.make_mesh("cuda", (1,), ("tiles",))
        host = mesh_lib.make_host_mesh("cuda")
        launches = _mesh_overlay_rows(gen, tiles, overlays)
        _mesh_ep(gen, host)
        _mesh_compression(gen, host)
    finally:
        for ov in overlays:         # a mesh overlay's close frees its captured graphs
            ov.close()
        overlays.clear()
        torch.cuda.synchronize()
        gc.collect()
        alive = [o for o in gc.get_objects() if isinstance(o, interp.GraphKernel)
                 and o.kernel.hop_fn is not interp.local_hop and o._graph is not None]
        for o in alive:             # so that a failed check below cannot hang the teardown
            o.release()
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    check(not alive, f"[mesh] Overlay.close() left {len(alive)} captured graph(s) of the "
          f"mesh alive")
    check(not dist.is_initialized(), "[mesh] the process group outlived the phase")
    return launches


MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS, MESH_TRAIN_LR = 2, 2, 3e-4   # [train-mesh]


def card_name_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole; any other tensor as it is."""
    return t.full_tensor() if shd.is_dtensor(t) else t


def _scalar(t: torch.Tensor) -> float:
    return _whole(t).item()


def _leaf_diffs(got, want) -> list[float]:
    """Largest |got - want| of each leaf pair."""
    return [(_whole(a).float() - _whole(b).float()).abs().max().item()
            for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want))]


def _placed_as_cell(tag: str, cfg, params, opt, mesh) -> None:
    """Every leaf of the state is a DTensor on ``mesh`` at its
    ``cell_shardings`` placements."""
    (p_sh, o_sh, _), _ = steps_lib.cell_shardings(cfg, "train_4k", mesh)

    def placed(t, s) -> None:
        check(shd.is_dtensor(t) and t.device_mesh == mesh
              and tuple(t.placements) == s.placements(),
              f"[{tag}] a state leaf is {type(t).__name__} "
              f"{getattr(t, 'placements', None)}, not a DTensor at {s.placements()}")

    pytree.tree_map(placed, (params, opt), (p_sh, o_sh))


def phase_train_mesh() -> dict:
    """[train-mesh] The sharded train step (``launch/steps.py::
    make_sharded_train_step``: ``make_train_step`` on DTensor state) of
    phi3-mini-3.8b at full width cut to 2 of its 32 layers, batch 1 x seq
    4096, on the ``(data 1, model 1)`` host mesh over an NCCL group of
    world 1, against 2 single-device steps of ``make_train_step`` from the
    same seeded bf16 weights and batches.  At world 1 every rule maps to a
    size-1 axis, so every leaf is replicated and each op runs on the whole
    tensor: the losses, grad norms and every new leaf must be bit-identical
    (what differs is printed first).  Per step 4 flash_attention launches
    on the tensor-core kernel (2 layers, forward and remat recompute) and
    9 rmsnorm launches, in both steps alike.  No CUDA graph is captured;
    the group is destroyed at the end.  Returns both paths' launches."""
    cfg = cut_layers(get_config("phi3-mini-3.8b"), MESH_TRAIN_LAYERS)
    params = pm.init(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    batches = [make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, step=i, seed=SEED, device=DEV)
               for i in range(MESH_TRAIN_STEPS)]
    card = card_name_power()

    def run(step, state, tag):
        ms, host_ms, metrics = [], [], []
        reset_counters()                       # the driven path starts here
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = step(*state, batch)
            host_ms.append((time.perf_counter() - t0) * 1e3)   # the host's issue time
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            state = (p, o)
            metrics.append(m)
        launches = counts()
        log(f"[train-mesh] {tag}: step ms to a synchronize {[round(t, 1) for t in ms]}, "
            f"host ms to return {[round(t, 1) for t in host_ms]} ({card}); losses "
            f"{[round(_scalar(m['loss']), 4) for m in metrics]}; launches {launches}")
        return state, ms, metrics, launches, host_ms

    want, single_ms, single_m, single_n, single_host = run(
        steps_lib.make_train_step(cfg, lr=MESH_TRAIN_LR), (params, adamw_init(params)),
        "single device")
    store_dir = tempfile.mkdtemp(prefix="train_mesh_store_")
    mesh_lib.init_group("cuda", os.path.join(store_dir, "store"))
    try:
        mesh = mesh_lib.make_host_mesh("cuda")
        state = steps_lib.shard_train_state(cfg, params, adamw_init(params), mesh)
        _placed_as_cell("train-mesh", cfg, *state, mesh)
        step = steps_lib.make_sharded_train_step(cfg, mesh, lr=MESH_TRAIN_LR)
        got, mesh_ms, mesh_m, mesh_n, mesh_host = run(step, state, "sharded (DTensor)")
        _placed_as_cell("train-mesh", cfg, *got, mesh)
        diffs = {name: max(_leaf_diffs(g, w)) for name, g, w in
                 (("params", got[0], want[0]), ("mu", got[1].mu, want[1].mu),
                  ("nu", got[1].nu, want[1].nu))}
        diffs["step"] = abs(_scalar(got[1].step) - _scalar(want[1].step))
        for k in ("loss", "ce", "acc", "grad_norm"):
            diffs[k] = max(abs(_scalar(a[k]) - _scalar(b[k])) for a, b in zip(mesh_m, single_m))
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    check(not dist.is_initialized(), "[train-mesh] the process group outlived the phase")
    log(f"[train-mesh] {cfg.name}, {cfg.num_layers} of 32 layers, batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, world 1 (data 1, model 1) over NCCL: largest difference sharded vs "
        f"single device {diffs}; step ms sharded {[round(t, 1) for t in mesh_ms]} vs single "
        f"{[round(t, 1) for t in single_ms]}, host ms to return sharded "
        f"{[round(t, 1) for t in mesh_host]} vs single {[round(t, 1) for t in single_host]} "
        f"({card})")
    check(all(v == 0 for v in diffs.values()),
          f"[train-mesh] the sharded step is not bit-identical to the single-device one: {diffs}")
    per_step = {"flash_attention": MESH_TRAIN_STEPS * 2 * cfg.num_layers,
                "rmsnorm": MESH_TRAIN_STEPS * ((2 * cfg.num_layers + 1) + 2 * cfg.num_layers)}
    variants = {"flash_attention": "wgmma", "rmsnorm": "warp"}
    check_launches("train-mesh", mesh_n, per_step, variants)
    check_launches("train-mesh", single_n, per_step, variants)
    del want, got, state, params
    _free()
    return {"launches": mesh_n, "single_launches": single_n, "ms": mesh_ms,
            "single_ms": single_ms, "host_ms": mesh_host, "single_host_ms": single_host}


SERVE_MESH_LAYERS, SERVE_MESH_PROMPT = 2, 4096            # [serve-mesh]
SERVE_MESH_MAX_LEN, SERVE_MESH_DECODES = 5120, 8          # 5 x 1024: the chunked gate
# the chunked cached prefill against the plain one (bf16 weights, f32
# scores; the plain one rounds its probabilities to bf16 before the value
# product, the chunked one does not): |logits| difference over max |logits|
SERVE_MESH_CHUNKED_TOL = 10 * 2**-8        # ten bf16 steps


def _serve_calls(prefill, serve, params, caches, prompt, tokens, tag: str,
                 check_fn=None) -> dict:
    """A prefill of ``prompt``, then a decode of each of ``tokens``, with
    the counters reset just before: each call's logits and caches, ms to a
    synchronize and host ms to return, and the launches."""
    out = {"logits": [], "caches": [], "ms": [], "host_ms": []}
    reset_counters()                       # the driven path starts here
    for i, tok in enumerate([prompt, *tokens]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = (prefill if i == 0 else serve)(params, tok, caches)
        out["host_ms"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if check_fn is not None:
            check_fn(logits, caches)
        out["logits"].append(logits)
        out["caches"].append(caches)
    out["launches"] = counts()
    log(f"[serve-mesh] {tag}: prefill ms to a synchronize {out['ms'][0]:.2f}, decode ms "
        f"{[round(t, 2) for t in out['ms'][1:]]}; host ms to return prefill "
        f"{out['host_ms'][0]:.2f}, decode {[round(t, 2) for t in out['host_ms'][1:]]}; "
        f"launches {out['launches']}")
    return out


def phase_serve_mesh(gen: torch.Generator) -> dict:
    """[serve-mesh] The sharded serve steps (``launch/steps.py::
    make_sharded_prefill_step``/``make_sharded_serve_step`` on the state of
    ``shard_serve_state``) of phi3-mini-3.8b at full width cut to 2 of its
    32 layers (seeded bf16 weights): a batch-1 prefill of 4096 tokens into
    a cache of 5120 positions, then 8 decodes, on the ``(data 1, model
    1)`` host mesh over an NCCL group of world 1, under ``DEFAULT_RULES``
    and ``SERVE_RULES``, against ``make_prefill_step``/``make_serve_step``
    on one device from the same weights and tokens.  The logits of every
    call and every cache leaf after every call must be bit-identical, every
    leaf a DTensor at its cell placement; per call 5 rmsnorm launches on
    the warp kernel and no flash_attention launch, in every path.  Then the
    chunked cached prefill (``set_attn_impl("chunked")``) against the plain
    one, within :data:`SERVE_MESH_CHUNKED_TOL`.  The group is destroyed at
    the end.  Returns each path's launches."""
    from repro_torch.models import layers as layers_lib

    cfg = cut_layers(get_config("phi3-mini-3.8b"), SERVE_MESH_LAYERS)
    params = pm.init(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    prompt = torch.randint(0, cfg.vocab_size, (1, SERVE_MESH_PROMPT), generator=gen,
                           device=DEV, dtype=torch.int32)
    tokens = list(torch.randint(0, cfg.vocab_size, (SERVE_MESH_DECODES, 1, 1), generator=gen,
                                device=DEV, dtype=torch.int32))
    fresh = lambda: mdl.init_cache(cfg, 1, SERVE_MESH_MAX_LEN, DEV)  # noqa: E731
    prefill = steps_lib.make_prefill_step(cfg)
    single_prefill = lambda p, t, c: prefill(p, t, c, {})  # noqa: E731
    card = card_name_power()
    single = _serve_calls(single_prefill, steps_lib.make_serve_step(cfg), params, fresh(),
                          prompt, tokens, "single device")
    calls = 1 + SERVE_MESH_DECODES
    want = {"flash_attention": 0, "rmsnorm": calls * (2 * cfg.num_layers + 1)}
    variants = {"flash_attention": "wgmma", "rmsnorm": "warp"}
    check_launches("serve-mesh", single["launches"], want, variants)
    out = {"single": single["launches"]}
    store_dir = tempfile.mkdtemp(prefix="serve_mesh_store_")
    mesh_lib.init_group("cuda", os.path.join(store_dir, "store"))
    try:
        mesh = mesh_lib.make_host_mesh("cuda")
        for name, rules in (("default", shd.DEFAULT_RULES), ("serve", shd.SERVE_RULES)):
            (_, _, c_sh, _), (l_sh, _) = steps_lib.serve_shardings(
                cfg, "prefill", 1, SERVE_MESH_MAX_LEN, mesh, rules, SERVE_MESH_PROMPT)
            wanted = [s.placements() for s in pytree.tree_leaves(c_sh)]

            def placed(logits, caches, _wanted=wanted, _l=l_sh.placements(), _n=name):
                leaves = [logits, *pytree.tree_leaves(caches)]
                check(all(shd.is_dtensor(t) and t.device_mesh == mesh
                          and tuple(t.placements) == w
                          for t, w in zip(leaves, [_l, *_wanted])),
                      f"[serve-mesh] {_n}: a leaf is not a DTensor at its cell placement")

            sp, sc = steps_lib.shard_serve_state(cfg, params, fresh(), mesh, rules)
            got = _serve_calls(steps_lib.make_sharded_prefill_step(cfg, mesh, rules),
                               steps_lib.make_sharded_serve_step(cfg, mesh, rules), sp, sc,
                               prompt, tokens, f"sharded (DTensor, {name} rules)", placed)
            check_launches("serve-mesh", got["launches"], want, variants)
            diffs = {"logits": max(_leaf_diffs(got["logits"], single["logits"])),
                     "caches": max(_leaf_diffs(got["caches"], single["caches"]))}
            log(f"[serve-mesh] {name} rules: largest difference sharded vs single device "
                f"{diffs}; prefill ms sharded {got['ms'][0]:.2f} vs single "
                f"{single['ms'][0]:.2f}, decode ms (mean of {SERVE_MESH_DECODES}) sharded "
                f"{sum(got['ms'][1:]) / SERVE_MESH_DECODES:.2f} vs single "
                f"{sum(single['ms'][1:]) / SERVE_MESH_DECODES:.2f}, host ms to return "
                f"(decode mean) sharded {sum(got['host_ms'][1:]) / SERVE_MESH_DECODES:.2f} "
                f"vs single {sum(single['host_ms'][1:]) / SERVE_MESH_DECODES:.2f} ({card})")
            check(all(v == 0 for v in diffs.values()),
                  f"[serve-mesh] {name}: the sharded steps are not bit-identical to the "
                  f"single-device ones: {diffs}")
            # the host time of building a step's shardings, which the sharded steps
            # now do once for each cache shape, not on every call
            build_ms = {}
            for depth, c in ((cfg.num_layers, cfg), (32, get_config("phi3-mini-3.8b"))):
                t0 = time.perf_counter()
                for _ in range(5):
                    steps_lib.serve_shardings(c, "decode", 1, SERVE_MESH_MAX_LEN, mesh, rules, 1)
                build_ms[depth] = (time.perf_counter() - t0) / 5 * 1e3
            log(f"[serve-mesh] {name} rules: host ms to build the decode shardings "
                f"(serve_shardings) "
                f"{', '.join(f'{v:.3f} at {d} layers' for d, v in build_ms.items())} ({card})")
            out[name] = got["launches"]
            out[f"{name}_ms"], out[f"{name}_host_ms"] = got["ms"], got["host_ms"]
            del got, sp, sc
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    check(not dist.is_initialized(), "[serve-mesh] the process group outlived the phase")
    layers_lib.set_attn_impl("chunked")
    try:
        reset_counters()
        chunked, _ = single_prefill(params, prompt, fresh())
        out["chunked"] = counts()
    finally:
        layers_lib.set_attn_impl("flash")
    check_launches("serve-mesh", out["chunked"],
                   {"flash_attention": 0, "rmsnorm": 2 * cfg.num_layers + 1}, variants)
    plain = single["logits"][0].float()
    err = ((chunked.float() - plain).abs().max() / plain.abs().max()).item()
    log(f"[serve-mesh] chunked cached prefill (key blocks of {layers_lib.CHUNK}) vs plain: "
        f"max |difference| / max |logits| {err:.3e} (limit {SERVE_MESH_CHUNKED_TOL})")
    check(err <= SERVE_MESH_CHUNKED_TOL, f"[serve-mesh] chunked prefill off by {err:.3e}")
    out["ms"], out["host_ms"] = single["ms"], single["host_ms"]
    del single, params
    _free()
    return out


DRYRUN_TIMEOUT_S = 300
DRYRUN_CELL = ("phi3-mini-3.8b", "decode_32k")      # [dryrun]


def phase_dryrun() -> dict:
    """[dryrun] ``python -m repro_torch.launch.dryrun`` on phi3-mini-3.8b's
    ``decode_32k`` cell (full width, 32 layers, batch 128 against caches
    of 32768) over a fake group of 256 ranks (the ``(16, 16)`` production
    mesh), with the default rules and with ``--serve-rules``, the two
    processes at once: each must exit 0 with one ``ok`` line of 256 chips
    whose ``model_flops_per_dev`` is ``2 * N_active * 128 / 256``.  Prints
    each line's roofline terms and memory."""
    arch, shape = DRYRUN_CELL
    cfg = get_config(arch)
    want_mf = 2.0 * cfg.active_param_count() * steps_lib.SHAPES[shape]["batch"] / 256
    runs = {name: subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                                    "--arch", arch, "--shape", shape, *flags],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                   cwd=ROOT, env=_env())
            for name, flags in (("default", []), ("serve-rules", ["--serve-rules"]))}
    out = {}
    for name, proc in runs.items():
        try:
            stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in runs.values():
                p.kill()
            raise
        lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
        if proc.returncode != 0 or len(lines) != 1:
            for line in (stdout + stderr).splitlines()[-30:]:
                log(f"[dryrun] {name}: {line[:300]}")
        check(proc.returncode == 0 and len(lines) == 1,
              f"[dryrun] {name}: exit {proc.returncode}, {len(lines)} result lines")
        r = lines[0]
        log(f"[dryrun] {arch} {shape} {name}: status {r['status']}, mesh {r['mesh']}, run "
            f"{r['lower_s']} s; per device flops {r['hlo_flops_per_dev']:.4g} (model "
            f"{r['model_flops_per_dev']:.4g}), bytes {r['hlo_bytes_per_dev']:.4g}, "
            f"collective bytes {r['collective_bytes_per_dev']:.4g} {r['collectives']}; terms "
            f"{r['terms']}; memory {r['memory']}, fits_h100_80gb {r['fits_h100_80gb']}")
        check(r["status"] == "ok" and r["chips"] == 256
              and math.isclose(r["model_flops_per_dev"], want_mf, rel_tol=1e-12),
              f"[dryrun] {name}: {r['status']}, {r['chips']} chips, model flops "
              f"{r['model_flops_per_dev']} (want {want_mf})")
        out[name] = r
    return out


def _mesh_overlay_rows(gen: torch.Generator, tiles, overlays: list) -> dict:
    """fig3 through ``Overlay(3, 3, mesh=tiles)`` and the local overlay at
    every placement and both sizes: bit-identical outputs, one vmul_reduce
    launch a call, NCCL kernels a call = hops; then ms per call."""
    rows = {}
    reset_counters()                           # the driven path starts here
    calls = 0
    for size in FIG3_SIZES:
        a = torch.randn(size, generator=gen, device=DEV)
        b = torch.randn(size, generator=gen, device=DEV)
        one = torch.ones(size, device=DEV)
        fns = {}
        for where, kw in (("mesh", {"mesh": tiles}), ("local", {})):
            static_ov = Overlay(3, 3, policy=PlacementPolicy.STATIC, **kw)
            dyn_ov = Overlay(3, 3, **kw)
            overlays += [static_ov, dyn_ov]
            for name, fixed in FIG3_MESH_STATIC:
                fns[(where, name)] = static_ov.jit(_fig3_mesh, name="vmul_reduce_mesh",
                                                   fixed=fixed)
            fns[(where, "dynamic")] = dyn_ov.jit(_fig3_mesh, name="vmul_reduce_mesh")
        outs = {key: f(a, b, one) for key, f in fns.items()}
        calls += len(fns)
        for (where, name), y in outs.items():
            check(torch.equal(y, outs[("local", name)]),
                  f"[mesh] n={size} {name}: the mesh overlay's {y.item()!r} != the local "
                  f"overlay's {outs[('local', name)].item()!r}")
        check(abs(outs[("mesh", "dynamic")].item() - torch.dot(a, b).item())
              <= 1e-5 * (a * b).abs().sum().item(), f"[mesh] n={size}: sum(a*b) disagrees "
              f"with torch.dot")
        rows[size] = (fns, a, b, one)
    torch.cuda.synchronize()
    launches = counts()
    check(launches["vmul_reduce"] == calls,
          f"[mesh] vmul_reduce launched {launches['vmul_reduce']} for {calls} calls (want one a call)")
    log(f"[mesh] fig3 as vmul_reduce(a * b, 1) on Overlay(3, 3, mesh=<1-rank 'tiles' mesh>) "
        f"and on the local overlay, static 0-3 pass-through and dynamic, n = "
        f"{', '.join(map(str, FIG3_SIZES))}: bit-identical; launches {launches}")

    fns, a, b, one = rows[PAPER_VECTOR_LEN]
    hops = {}
    for (where, name), f in fns.items():
        if where != "mesh":
            continue
        h = int(f.accelerator(a, b, one).routes.sum())
        k = nccl_kernels(lambda f=f: f(a, b, one))
        hops[name] = (h, k, f.accelerator(a, b, one).placement.total_passthrough)
        check(k == h, f"[mesh] {name}: {k} NCCL kernels for one call of {h} hops")
    log("[mesh] n=4096 one call: (hops, NCCL kernels, pass-through tiles) " +
        ", ".join(f"{name} {v}" for name, v in hops.items()))

    times = {}
    for size, (fns, a, b, one) in rows.items():
        iters = MESH_TIME_ITERS[size]
        times[size] = {f"{where}/{name}": time_ms(lambda f=f: f(a, b, one), iters)
                       for (where, name), f in fns.items()}
        log(f"[mesh] n={size} ms per call (world 1, NCCL; CUDA events over {iters} calls): " +
            ", ".join(f"{k}={v:.4f}" for k, v in times[size].items()))

    # the route-constant tier on the mesh: a CUDA graph captured through NCCL
    fns, a, b, one = rows[PAPER_VECTOR_LEN]
    f = fns[("mesh", "static_3pass")]
    generic = f(a, b, one)
    builds = count_spec_builds(f.overlay)
    f.specialize(a, b, one)
    (entry,) = f._entries.values()
    spec = f(a, b, one)
    torch.cuda.synchronize()
    check(entry.record.tier == "specialized" and builds[0] == 1,
          f"[mesh] static_3pass did not specialize (tier {entry.record.tier}, builds {builds})")
    check(torch.equal(spec, generic), f"[mesh] the specialized tier's {spec.item()!r} != the "
          f"generic tier's {generic.item()!r}")
    spec_nccl = nccl_kernels(lambda: f(a, b, one))
    check(spec_nccl == hops["static_3pass"][0],
          f"[mesh] a replay ran {spec_nccl} NCCL kernels for {hops['static_3pass'][0]} hops")
    spec_ms = time_ms(lambda: f(a, b, one), MESH_TIME_ITERS[PAPER_VECTOR_LEN])
    log(f"[mesh] n={PAPER_VECTOR_LEN} static_3pass specialized (the walk captured as a CUDA "
        f"graph, NCCL's kernels in it): bit-identical to generic, {spec_nccl} NCCL kernels a "
        f"replay, {spec_ms:.4f} ms per call (generic "
        f"{times[PAPER_VECTOR_LEN]['mesh/static_3pass']:.4f}, world 1)")
    return launches


def _mesh_ep(gen: torch.Generator, host) -> None:
    """``moe_fwd_ep`` at granite-moe-1b-a400m's full width on 4096 bf16
    tokens over the ``(1, 1)`` host mesh, held to ``_moe_fwd_local``."""
    cfg = get_config(GRANITE)
    e, d, f, t = cfg.num_experts, cfg.d_model, cfg.moe_d_ff, 4096
    w = lambda *shape, fan: (torch.randn(*shape, generator=gen, device=DEV)  # noqa: E731
                             * fan ** -0.5).to(torch.bfloat16)
    p = {"router": w(d, e, fan=d), "w_gate": w(e, d, f, fan=d), "w_up": w(e, d, f, fan=d),
         "w_down": w(e, f, d, fan=f)}
    x = torch.randn(t, d, generator=gen, device=DEV).to(torch.bfloat16)
    rules = shd.DEFAULT_RULES
    lay = moe_mod.ep_layout(cfg, host, rules, t, d)
    shards = moe_mod.ep_shards(p, cfg, host, rules, t)
    y_ep, aux_ep = moe_mod.moe_fwd_ep(shards, x, cfg, host, rules)
    y_loc, aux_loc = moe_mod._moe_fwd_local(p, x, cfg)
    torch.cuda.synchronize()
    diff = (y_ep.float() - y_loc.float()).abs().max().item()
    scale = y_loc.float().abs().max().item()
    check(y_ep.shape == y_loc.shape and bool(torch.isfinite(y_ep).all()),
          f"[mesh] EP output {tuple(y_ep.shape)} (want {tuple(y_loc.shape)}, finite)")
    check(diff <= 1e-2 * scale and abs(aux_ep.item() - aux_loc.item()) <= 1e-5 * aux_loc.item(),
          f"[mesh] EP differs from the local MoE by {diff} (max |y| {scale}), aux "
          f"{aux_ep.item()} vs {aux_loc.item()}")
    ep_ms = time_ms(lambda: moe_mod.moe_fwd_ep(shards, x, cfg, host, rules), 10)
    local_ms = time_ms(lambda: moe_mod._moe_fwd_local(p, x, cfg), 10)
    log(f"[mesh] moe_fwd_ep at {GRANITE}'s full width (d {d}, {e} experts, top-"
        f"{cfg.experts_per_token}, expert d_ff {f}) on {t} bf16 tokens over a (1, 1) mesh "
        f"(capacity {lay.cap}, {lay.e_loc} experts a rank): max |EP - local| {diff:.3e} "
        f"(max |y| {scale:.3e}; bit-identical {torch.equal(y_ep, y_loc)}), aux {aux_ep.item():.6f} "
        f"vs {aux_loc.item():.6f}; {ep_ms:.3f} ms per call, local {local_ms:.3f} ms (world 1)")


def _mesh_compression(gen: torch.Generator, host) -> None:
    """Two ``CompressedReducer`` steps on an f32 tree of granite's
    parameter shapes, reduced through NCCL ``all_reduce`` over the host
    mesh's ``"data"`` axis: each step's per-element error within the int8
    bound (half a scale, ``max|g| / 254`` a leaf), and the two steps' sum
    within one step's bound of the true sum (error feedback leaves only
    the last step's residual)."""
    spec = pm.model_spec(get_config(GRANITE))
    leaves = pytree.tree_leaves(spec)
    grads = [[torch.randn(s.shape, generator=gen, device=DEV) * 1e-2 for s in leaves]
             for _ in range(2)]
    n = sum(g.numel() for g in grads[0])
    reduce_fn = make_reduce_fn(host, "data")
    red = CompressedReducer()
    sums, ms, worst = None, [], []
    for g in grads:
        fed = g if red.error is None else [x + e for x, e in zip(g, red.error)]
        half_scales = [x.abs().max() / 254.0 for x in fed]
        t_ms, back = _sync_ms(lambda g=g: red.step(g, reduce_fn))
        ms.append(t_ms)
        worst.append(max(((y - x).abs().max() / h).item()
                         for y, x, h in zip(back, fed, half_scales)))
        sums = back if sums is None else [t + y for t, y in zip(sums, back)]
        del fed, back
    drift = max(((t - (g0 + g1)).abs().max() / h).item()
                for t, g0, g1, h in zip(sums, grads[0], grads[1], half_scales))
    # f32 rounding of g / scale and q * scale: ~1e-5 of a scale
    check(max(worst) <= 1 + 1e-3, f"[mesh] compression: errors of {worst} half-scales "
          f"(the int8 bound is 1)")
    check(drift <= 1 + 1e-3, f"[mesh] compression: the two steps' sum is {drift} half-scales "
          f"of the last step from the true sum (the bound is 1)")
    log(f"[mesh] CompressedReducer on {len(leaves)} f32 leaves of {GRANITE}'s parameter "
        f"shapes ({n} elements), reduced through NCCL all_reduce: worst error "
        f"{', '.join(f'{w:.6f}' for w in worst)} half-scales by step (bound 1); the sum of "
        f"both steps {drift:.6f} half-scales of step 2 from the true sum (bound 1); ms per "
        f"step {', '.join(f'{v:.1f}' for v in ms)} (world 1)")
    del grads, sums, red
    _free()


def phase_overlay_paper(gen: torch.Generator) -> dict:
    """The paper's VMUL&Reduce through Overlay.jit on every placement, each
    size on fresh fabrics (one static and one dynamic ``Overlay`` per size,
    as the reference places each size anew): outputs bit-identical across
    placements, the pass-through count of every row from that size's own
    placement, 0 for dynamic placement, then ms per call of each row and the
    host time of each layer of the LARGE row at the paper's size."""
    reset_counters()                           # the driven path starts here
    runs = {}
    for size in FIG3_SIZES:
        a = torch.randn(size, generator=gen, device=DEV)
        b = torch.randn(size, generator=gen, device=DEV)
        static_ov = Overlay(3, 3, policy=PlacementPolicy.STATIC)
        dyn_ov = Overlay(3, 3)
        fns = {name: static_ov.jit(_fig3_dot, name="vmul_reduce", fixed={2: vmul, 3: (0, 0)})
               for name, vmul in FIG3_STATIC}
        fns["dynamic"] = dyn_ov.jit(_fig3_dot, name="vmul_reduce")
        fns["large_vmul_reduce"] = dyn_ov.jit(_fig3_large, name="vmul_reduce_large")
        outs = {name: f(a, b) for name, f in fns.items()}
        before = (dyn_ov.stats.traces, dyn_ov.stats.downloads)
        outs["large_again"] = fns["large_vmul_reduce"](a, b)   # a resident hit
        check((dyn_ov.stats.traces, dyn_ov.stats.downloads) == before,
              f"n={size}: second LARGE call traced or downloaded again")
        base = outs["dynamic"]
        for name, _ in FIG3_STATIC:
            check(torch.equal(outs[name], base), f"n={size}: {name} differs from dynamic placement")
        check(torch.equal(outs["large_vmul_reduce"], outs["large_again"]),
              f"n={size}: LARGE vmul_reduce not bit-identical across calls")
        check(abs(outs["large_vmul_reduce"].item() - base.item())
              <= 1e-5 * (a * b).abs().sum().item(), f"n={size}: LARGE vmul_reduce disagrees "
              f"with sum(a*b)")
        passes = {name: f.accelerator(a, b).placement.total_passthrough
                  for name, f in fns.items()}
        for i, (name, _) in enumerate(FIG3_STATIC):
            check(passes[name] == i, f"n={size}: {name} placed with {passes[name]} pass-through tiles")
        check(passes["dynamic"] == 0,
              f"n={size}: dynamic placement has {passes['dynamic']} pass-through tiles")
        large_graph = fns["large_vmul_reduce"].lower(a, b).graph
        check([nd.name for nd in large_graph.op_nodes()] == ["kernels/vmul_reduce"],
              f"n={size}: the LARGE call did not lower to one kernels/vmul_reduce node")
        runs[size] = (fns, a, b, passes)
    torch.cuda.synchronize()
    launches = counts()
    check(launches["vmul_reduce"] == 2 * len(FIG3_SIZES),
          f"vmul_reduce launched {launches} on the overlay path (want 2 a size)")
    log(f"[overlay] each size on a fresh static and a fresh dynamic Overlay(3, 3): "
        f"bit-identical across static 0-3 pass-through and dynamic placement; LARGE "
        f"vmul_reduce = one large node; launches {launches}")

    times = {}
    for size, (fns, a, b, passes) in runs.items():
        iters = 200 if size == PAPER_VECTOR_LEN else 50
        row = {name: time_ms(lambda f=f: f(a, b), iters) for name, f in fns.items()}
        row["custom_torch_sum"] = time_ms(lambda: _fig3_dot(a, b), iters)
        times[size] = row
        log(f"[overlay] n={size} ms per call: " + ", ".join(
            f"{k}={v:.4f}" + (f"(pass={passes[k]})" if k in passes else "")
            for k, v in row.items()))
    split = large_host_split(*runs[PAPER_VECTOR_LEN][:3])
    log(f"[overlay] n={PAPER_VECTOR_LEN} LARGE row, host us per call by layer (perf_counter_ns "
        f"over {HOST_SPLIT_CALLS} calls each, no synchronize inside): " +
        ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    return {"launches": launches, "times": times, "host_split_us": split}


HOST_SPLIT_CALLS, HOST_SPLIT_BATCH = 4000, 100


def _host_us(fn) -> float:
    """Host microseconds a call of ``fn`` takes to return, over
    ``HOST_SPLIT_CALLS`` calls in batches of ``HOST_SPLIT_BATCH`` with a
    synchronize between batches (outside the clock), so the launch queue
    never fills and blocks the host."""
    for _ in range(HOST_SPLIT_BATCH):
        fn()
    total = 0
    for _ in range(HOST_SPLIT_CALLS // HOST_SPLIT_BATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(HOST_SPLIT_BATCH):
            fn()
        total += time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return total / HOST_SPLIT_CALLS / 1e3


def large_host_split(fns: dict, a: torch.Tensor, b: torch.Tensor) -> dict[str, float]:
    """Where the host time of the LARGE row goes, layer by layer: each level
    of the call is timed alone and the layer is the difference to the level
    below it."""
    jitted = fns["large_vmul_reduce"]
    walk = jitted.accelerator(a, b).fn           # the interpreter's kernel walk, routes bound
    plan = vr_mod.plan(a.shape[0])
    check(plan.cluster, "the paper's size takes the cluster launch")
    out = torch.empty((), dtype=a.dtype, device=DEV)
    index = a.device.index
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), 0, a.shape[0], plan.blocks,
            plan.blocks, native.DTYPE_CODES[a.dtype], index, native.raw_stream(index))
    entry = vr_mod._entry()
    # (layer, the call that runs it and every layer below)
    levels = (("overlay dispatch", lambda: jitted(a, b)),
              ("interpreter step", lambda: walk(a, b)),
              ("custom-op dispatch", lambda: ops.vmul_reduce(a, b)),
              ("wrapper", lambda: vr_mod.vmul_reduce_cuda(a, b)),
              ("launch (ctypes, C entry, cudaLaunchKernelEx)", lambda: entry(*args)))
    us = [_host_us(fn) for _, fn in levels]
    split = {"total": us[0]}
    for i, (layer, _) in enumerate(levels):
        split[layer] = us[i] - (us[i + 1] if i + 1 < len(us) else 0.0)
    return split


def serve(params, cfg, overlay) -> tuple[list, dict, float, dict, ServeEngine]:
    rng = np.random.default_rng(SEED)
    engine = ServeEngine(params, cfg, batch=BATCH, max_len=MAX_LEN, overlay=overlay,
                         device=DEV)
    engine._prefill, engine._decode = Counted(engine._prefill), Counted(engine._decode)
    for rid in range(REQUESTS):
        prompt = rng.integers(0, cfg.vocab_size, size=(PROMPT,)).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW))
    torch.cuda.synchronize()
    reset_counters()                           # the driven path starts here
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts()
    calls = {"prefill": engine._prefill.calls, "decode": engine._decode.calls}
    streams = [r.out for r in sorted(done, key=lambda r: r.rid)]
    return streams, launches, dt, calls, engine


def phase_serve(gen: torch.Generator) -> dict:
    cfg = get_config("phi3-mini-3.8b")
    t0 = time.perf_counter()
    params = pm.init(cfg, gen, DEV)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {pm.count(params) / 1e9:.3f} B params "
        f"(d_model {cfg.d_model}, {cfg.num_layers} layers, bf16) initialized in "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    ov = Overlay(3, 3)
    s_ov, l_ov, dt_ov, calls, eng_ov = serve(params, cfg, ov)
    s_pl, l_pl, dt_pl, calls_pl, eng_pl = serve(params, cfg, None)
    tokens = sum(len(s) for s in s_ov)
    check(s_ov == s_pl, f"overlay and plain token streams differ:\n{s_ov}\n{s_pl}")
    check(all(len(s) == 1 + MAX_NEW and all(0 <= t < cfg.vocab_size for t in s)
              for s in s_ov), "unexpected token stream shape/range")
    norms = 2 * cfg.num_layers + 1
    want = norms * (calls["prefill"] + calls["decode"])
    check(l_ov["rmsnorm"] == want,
          f"rmsnorm launches {l_ov['rmsnorm']} != {norms} x {calls} = {want}")
    check(l_pl["rmsnorm"] == norms * (calls_pl["prefill"] + calls_pl["decode"]),
          f"plain engine rmsnorm launches {l_pl['rmsnorm']}")
    desc = ov.describe()
    log(f"[serve] overlay: {tokens} tokens in {dt_ov:.2f}s ({tokens / dt_ov:.1f} tok/s), "
        f"calls {calls}, launches {l_ov}; traces {desc['traces']} "
        f"({desc['trace_seconds']:.1f}s), downloads {desc['downloads']}, "
        f"cache {desc['cache']['hits']} hits / {desc['cache']['misses']} misses")
    log(f"[serve] plain:   {tokens} tokens in {dt_pl:.2f}s ({tokens / dt_pl:.1f} tok/s), "
        f"launches {l_pl}; streams identical: {s_ov == s_pl}")
    for step in ("prefill", "decode"):
        jitted = getattr(eng_ov, f"_{step}").fn
        (entry,) = jitted._entries.values()
        graph = entry.lowered.graph
        log(f"[serve] {step} host time per call: overlay {getattr(eng_ov, f'_{step}').split_ms()}"
            f" (trace {entry.trace_seconds:.2f} s, assemble {entry.assemble_seconds:.2f} s); "
            f"plain {getattr(eng_pl, f'_{step}').split_ms()}; graph {len(graph.op_nodes())} "
            f"op nodes ({len(entry.lowered.unmapped)} residue), "
            f"{entry.acc.placement.total_passthrough} pass-through hops")
    log(f"[serve] streams: {s_ov}")
    log(f"[serve] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prompt = torch.tensor([list(range(1, PROMPT + 1))], dtype=torch.int32, device=DEV)
    logits, _ = mdl.prefill(params, cfg, prompt, mdl.init_cache(cfg, 1, MAX_LEN, DEV))
    check(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          "full-width prefill logits not finite / wrong shape")
    del eng_ov, eng_pl, ov
    ov, eng, relocated = phase_relocate(params, cfg, s_pl, gen)
    specialized = phase_specialize(params, cfg, s_pl, ov, eng)
    del ov, eng
    gc.collect()
    torch.cuda.empty_cache()
    looped = phase_serve_loop(params, cfg)
    gpu_state("[fleet]")
    fleet = phase_fleet(params, cfg, s_pl, looped.pop("plain_streams"))
    del params
    torch.cuda.empty_cache()
    return {"launches": l_ov, "calls": calls, "tok_s_overlay": tokens / dt_ov,
            "tok_s_plain": tokens / dt_pl, "relocate": relocated,
            "specialize": specialized, "serve_loop": looped, "fleet": fleet}


class TimedOverlay(Overlay):
    """An ``Overlay`` that keeps the host ms of each relocation it makes (the
    move: controller program, routes, tiles and the rebind of live entries;
    the placement search that precedes a move is outside it)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.relocation_ms: list[float] = []

    def _relocate_resident(self, *args, **kwargs):
        t0 = time.perf_counter()
        res = super()._relocate_resident(*args, **kwargs)
        self.relocation_ms.append((time.perf_counter() - t0) * 1e3)
        return res


def serve_round(engine: ServeEngine, cfg, first_rid: int) -> tuple[list, float]:
    """The serve phase's requests (the same prompts) through ``engine``: the
    streams in request order and the round's seconds."""
    rng = np.random.default_rng(SEED)
    for i in range(REQUESTS):
        prompt = rng.integers(0, cfg.vocab_size, size=(PROMPT,)).tolist()
        engine.submit(Request(rid=first_rid + i, prompt=prompt, max_new_tokens=MAX_NEW))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    return [r.out for r in sorted(done, key=lambda r: r.rid)], time.perf_counter() - t0


def phase_relocate(params, cfg, want: list, gen: torch.Generator):
    """[relocate] phi3-mini-3.8b served through an ``Overlay(3, 3)`` that
    first holds a co-tenant, fig3's LARGE ``sum(a * b)`` at 2^24 (the
    vmul_reduce kernel).  Serve; evict the co-tenant and ``compact()``;
    serve; ``resize(1)``; serve.  Every round's streams must equal plain
    serving's; the moves must be relocations (``stats.relocations`` rises)
    with no new download and no new cache insertion; rmsnorm launches once
    per norm of every prefill and decode call."""
    ov = TimedOverlay(3, 3)
    n = 1 << 24
    a = torch.randn(n, generator=gen, device=DEV)
    b = torch.randn(n, generator=gen, device=DEV)
    engine = ServeEngine(params, cfg, batch=BATCH, max_len=MAX_LEN, overlay=ov, device=DEV)
    engine._prefill, engine._decode = Counted(engine._prefill), Counted(engine._decode)
    torch.cuda.synchronize()
    reset_counters()                           # the driven path starts here
    y = ov.jit(_fig3_large, name="vmul_reduce_large")(a, b)
    check(abs(y.item() - torch.dot(a, b).item()) <= 1e-5 * (a * b).abs().sum().item(),
          "the co-tenant's sum(a*b) disagrees with torch.dot")
    co_tiles = sorted(ov.fabric.lru().tiles)
    streams, dt1 = serve_round(engine, cfg, 0)
    check(streams == want, f"[relocate] round 1 streams differ from plain:\n{streams}\n{want}")
    (entry,) = engine._decode.fn._entries.values()
    first_call_s, trace_s, assemble_s = (engine._decode.seconds[0], entry.trace_seconds,
                                         entry.assemble_seconds)
    layout = {r.name: sorted(r.tiles) for r in ov.fabric.residents.values()}
    downloads, insertions = ov.stats.downloads, ov.cache.stats.insertions
    ov.evict("vmul_reduce_large")
    t0 = time.perf_counter()
    moved = engine.compact()
    compact_ms = (time.perf_counter() - t0) * 1e3
    check(moved >= 1 and ov.stats.relocations == moved,
          f"compact() moved {moved} residents, relocations {ov.stats.relocations}")
    compacted = {r.name: sorted(r.tiles) for r in ov.fabric.residents.values()}
    streams, dt2 = serve_round(engine, cfg, 100)
    check(streams == want, "[relocate] streams after compact() differ from plain")
    engine.resize(1)
    streams, dt3 = serve_round(engine, cfg, 200)
    check(streams == want, "[relocate] streams after resize(1) differ from plain")
    check(ov.stats.relocations > moved, "resize(1) relocated no resident")
    check(ov.stats.downloads == downloads and ov.cache.stats.insertions == insertions,
          f"relocations re-downloaded: downloads {downloads} -> {ov.stats.downloads}, "
          f"cache insertions {insertions} -> {ov.cache.stats.insertions}")
    launches = counts()
    norms = 2 * cfg.num_layers + 1
    calls = engine._prefill.calls + engine._decode.calls
    check(launches["vmul_reduce"] == 1 and launches["rmsnorm"] == norms * calls,
          f"[relocate] launches {launches}, want 1 vmul_reduce and {norms} x {calls} rmsnorm")
    resized = {r.name: sorted(r.tiles) for r in ov.fabric.residents.values()}
    tokens = REQUESTS * (1 + MAX_NEW)
    log(f"[relocate] co-tenant vmul_reduce_large (2^24, one vmul_reduce launch) on {co_tiles}; "
        f"round 1 layout {layout}; evict + compact() moved {moved} in {compact_ms:.1f} ms "
        f"-> {compacted}; resize(1) -> {resized}")
    log(f"[relocate] relocations {ov.stats.relocations}, host ms each "
        f"{[round(ms, 2) for ms in ov.relocation_ms]}; the first decode call took "
        f"{first_call_s:.2f} s (trace {trace_s:.2f} s, assemble {assemble_s:.2f} s); downloads "
        f"{ov.stats.downloads} and cache insertions {ov.cache.stats.insertions} unchanged since "
        f"round 1; streams identical to plain in all 3 rounds; tok/s by round "
        f"{tokens / dt1:.1f}, {tokens / dt2:.1f}, {tokens / dt3:.1f}; launches {launches}")
    return ov, engine, launches


def _two_caches(caches):
    """Two copies of a cache pytree, so a call can be fed inputs that moved
    since the last call, as the engine feeds each tick."""
    return [pytree.tree_map(torch.clone, caches) for _ in range(2)]


def _decode_ms(fn, calls: int = 10) -> tuple[float, float]:
    """Median host ms for one call to return, and ms a call of ``calls``
    back-to-back calls ended by a synchronize."""
    fn(0)
    torch.cuda.synchronize()
    host = []
    t0 = time.perf_counter()
    for i in range(calls):
        t1 = time.perf_counter()
        fn(i)
        host.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(host)), (time.perf_counter() - t0) * 1e3 / calls


def phase_specialize(params, cfg, want: list, ov: Overlay, engine: ServeEngine) -> dict:
    """[specialize] phi3-mini-3.8b's decode step on the route-constant tier,
    on the [relocate] engine: ``specialize`` the decode (the walk captured
    once as a CUDA graph) and serve; relocate the decode resident (it must
    despecialize and free the graph) and serve; specialize again and serve.
    Every round's streams equal plain serving's, every decode call of a
    specialized round dispatches on the specialized tier, and rmsnorm
    launches once per norm of every prefill and decode call and of each
    specialization's warm-up walk (a replay adds what its capture
    recorded).  Then, outside the counted run: specialized and generic
    outputs bit-identical on the same inputs, and host ms per decode call
    for generic, specialized and plain."""
    jitted = engine._decode.fn
    (entry,) = jitted._entries.values()
    res = ov.fabric.get(entry.acc.resident_id)
    stats = ov.cache.spec_stats
    state = lambda: (params, engine.cur_tokens, engine.caches, engine.slot_pos)
    calls0 = (engine._prefill.calls, engine._decode.calls)
    torch.cuda.synchronize()
    reset_counters()                           # the driven path starts here
    t0 = time.perf_counter()
    jitted.specialize(*state())
    spec_s = [time.perf_counter() - t0]
    exe = res.spec_fn.func
    check(isinstance(exe, interp.GraphKernel) and res.tier == "specialized"
          and entry.record.tier == "specialized", "decode did not go to the CUDA-graph tier")
    per_replay = exe.launches_per_replay()
    rounds = []
    for r in range(3):
        hits, dec = stats.specialized_hits, engine._decode.calls
        streams, dt = serve_round(engine, cfg, 300 + 100 * r)
        check(streams == want, f"[specialize] round {r + 1} streams differ from plain")
        host_ms = float(np.median(engine._decode.seconds[dec:])) * 1e3
        rounds.append((engine._decode.calls - dec, stats.specialized_hits - hits,
                       round(dt, 3), round(host_ms, 2)))
        if r == 0:
            g = entry.lowered.graph
            despec = stats.despecializations
            mem0 = torch.cuda.memory_allocated()
            ov.relocate(g, place(g, ov.grid, ov.policy, occupied=ov.fabric.occupied(),
                                 max_tiles=res.tile_budget))
            torch.cuda.synchronize()
            mem1 = torch.cuda.memory_allocated()
            check(res.tier == "generic" and res.spec_fn is None and exe._graph is None
                  and ov.cache.specialized_count() == 0
                  and stats.despecializations == despec + 1,
                  "relocating the decode resident did not despecialize it and release the graph")
        if r == 1:
            t0 = time.perf_counter()
            jitted.specialize(*state())
            spec_s.append(time.perf_counter() - t0)
            check(res.tier == "specialized", "the decode resident did not specialize again")
    check(rounds[0][1] == rounds[0][0] and rounds[2][1] == rounds[2][0] and rounds[1][1] == 0,
          f"[specialize] (decode calls, specialized dispatches) by round {rounds}: every "
          f"decode call of rounds 1 and 3 must be specialized, none of round 2")
    launches = counts()
    norms = 2 * cfg.num_layers + 1
    calls = (engine._prefill.calls - calls0[0]) + (engine._decode.calls - calls0[1])
    check(launches["rmsnorm"] == norms * (calls + len(spec_s)),
          f"[specialize] rmsnorm launches {launches['rmsnorm']} != {norms} x ({calls} calls + "
          f"{len(spec_s)} warm-up walks)")
    check(per_replay == {"rmsnorm": norms}, f"a decode replay launches {per_replay}")
    # outside the counted run: bit-identity and host time on the same inputs
    exe = res.spec_fn.func
    flat = pytree.tree_leaves(state())
    generic_out, spec_out = entry.acc.fn(*flat), res.spec_fn(*flat)
    diff = [i for i, (u, v) in enumerate(zip(pytree.tree_leaves(generic_out),
                                              pytree.tree_leaves(spec_out)))
            if not torch.equal(u, v)]
    check(not diff, f"specialized and generic decode outputs differ in leaves {diff}")
    caches = _two_caches(engine.caches)
    args = lambda i: (params, engine.cur_tokens, caches[i % 2], engine.slot_pos)
    fns = {"generic": lambda i: entry.acc.fn(*pytree.tree_leaves(args(i))),
           "specialized": lambda i: res.spec_fn(*pytree.tree_leaves(args(i))),
           "plain": lambda i: mdl.decode_step(params, cfg, engine.cur_tokens, caches[i % 2],
                                              positions=engine.slot_pos)}
    times = {k: [] for k in fns}
    for k in (*fns, *reversed(fns)):               # in turns: a b c c b a
        times[k].append(_decode_ms(fns[k]))
    log(f"[specialize] decode captured as a CUDA graph in {spec_s[0]:.2f} s (warm-up walk + "
        f"capture; again after the relocation {spec_s[1]:.2f} s), {per_replay} launches a "
        f"replay; (decode calls, specialized dispatches, round s, median decode host ms) by "
        f"round {rounds}; relocation "
        f"despecialized and freed {(mem0 - mem1) / 2**20:.0f} MiB; streams identical to plain; "
        f"generic and specialized outputs bit-identical ({len(pytree.tree_leaves(spec_out))} "
        f"leaves); launches {launches}")
    log("[specialize] decode ms a call (host to return, then per call of 10 back-to-back to a "
        "synchronize; two runs in turns, inputs moved every call): " + "; ".join(
            f"{k} " + ", ".join(f"{h:.2f} / {e:.2f}" for h, e in v) for k, v in times.items()))
    return launches


def phase_async_fig3(gen: torch.Generator) -> dict:
    """[async-fig3] The paper's ``sum(a * b)`` at 2^24 f32, its LARGE
    ``vmul_reduce`` form, through ``Overlay(3, 3, async_downloads=True).jit``:
    the first call is served by the fallback (the function run eagerly,
    which launches the kernel) while the kernel builds on the scheduler's
    worker; after ``drain()`` the next call is served by the resident (its
    dispatch queues the zero-hop specialization on the low lane: a CUDA
    graph captured on the worker, whose warm-up walk launches the kernel
    once); after another ``drain()`` a third call replays the graph.  The
    three outputs must be bit-identical and every call must launch
    vmul_reduce: launches = calls + warm-up walks."""
    n = 1 << 24
    a = torch.randn(n, generator=gen, device=DEV)
    b = torch.randn(n, generator=gen, device=DEV)
    ov = Overlay(3, 3, async_downloads=True)
    builds = count_spec_builds(ov)
    f = ov.jit(_fig3_large, name="vmul_reduce_large")
    torch.cuda.synchronize()
    reset_counters()                           # the driven path starts here
    t0 = time.perf_counter()
    y1 = f(a, b)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    after_first = counts()["vmul_reduce"]
    check(ov.stats.fallback_calls == 1 and after_first == 1,
          f"[async-fig3] first call: fallback_calls {ov.stats.fallback_calls}, "
          f"vmul_reduce launches {after_first} (want 1 and 1)")
    check(ov.drain(60), "[async-fig3] the download did not drain")
    y2 = f(a, b)
    (entry,) = f._entries.values()
    tiers = [entry.record.tier]
    check(ov.drain(60), "[async-fig3] the specialization did not drain")
    y3 = f(a, b)
    tiers.append(entry.record.tier)
    torch.cuda.synchronize()
    launches = counts()
    check(ov.stats.fallback_calls == 1, "[async-fig3] the resident did not serve the later calls")
    check(torch.equal(y1, y2) and torch.equal(y1, y3),
          f"[async-fig3] outputs differ: fallback {y1.item()!r}, resident {y2.item()!r}, "
          f"specialized {y3.item()!r}")
    check(launches["vmul_reduce"] == 3 + builds[0] and builds[0] == 1,
          f"[async-fig3] vmul_reduce launched {launches['vmul_reduce']} for 3 calls and "
          f"{builds[0]} warm-up walks")
    check(abs(y1.item() - torch.dot(a, b).item()) <= 1e-5 * (a * b).abs().sum().item(),
          "[async-fig3] sum(a*b) disagrees with torch.dot")
    sched = ov.scheduler.describe()
    log(f"[async-fig3] n={n} f32 on Overlay(3, 3, async_downloads=True): call 1 by the "
        f"fallback in {first_ms:.1f} ms (trace {entry.trace_seconds:.2f} s), kernel built "
        f"on the worker in {entry.assemble_seconds * 1e3:.1f} ms; call 2 on the {tiers[0]} "
        f"tier, call 3 on the {tiers[1]} tier; outputs bit-identical; fallback_calls "
        f"{ov.stats.fallback_calls}; scheduler submitted {sched['submitted']}, low jobs "
        f"{sched['low_jobs']}; launches {launches}")
    ov.close()
    return launches


def count_spec_builds(ov) -> list:
    """Count the route-constant builds of an overlay, or of a fleet's
    members (through the ``_compile_specialized_tier`` seam): on the card
    each one makes one eager warm-up walk, whose launches are real, before
    its capture."""
    n = [0]
    for member in getattr(ov, "members", [ov]):
        def counted(pending, build=member._compile_specialized_tier):
            n[0] += 1
            return build(pending)

        member._compile_specialized_tier = counted
    return n


def loop_requests(cfg) -> list:
    rng = np.random.default_rng(SEED)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=(n,)).tolist(),
                    max_new_tokens=LOOP_NEW, priority=i % 2)
            for i, n in enumerate(LOOP_PROMPTS)]


class TickClock:
    """Wraps an engine's ``step``: each tick's host seconds, split by whether
    a background job of the overlay was queued or running when it began or
    when it ended.  :meth:`detach` drops the engine (a clock kept for its
    summary must not keep an engine's graphs alive)."""

    def __init__(self, engine, overlay):
        self.step, self.overlay = engine.step, overlay
        self.busy, self.idle = [], []
        engine.step = self

    def __call__(self):
        busy = self._in_flight()
        t0 = time.perf_counter()
        out = self.step()
        dt = time.perf_counter() - t0
        (self.busy if busy or self._in_flight() else self.idle).append(dt)
        return out

    def _in_flight(self) -> bool:
        return self.overlay is not None and any(
            m.scheduler.outstanding() > 0 for m in getattr(self.overlay, "members", [self.overlay]))

    def detach(self) -> None:
        self.step = self.overlay = None

    def summary(self) -> str:
        p50 = lambda xs: f"{float(np.median(xs)) * 1e3:.1f} ms" if xs else "none"
        return (f"tick p50 with a background job in flight {p50(self.busy)} "
                f"({len(self.busy)} ticks), without {p50(self.idle)} ({len(self.idle)} ticks)")


def serve_loop(params, cfg, overlay) -> dict:
    """One [serve-loop] run: the 8 requests in one burst against
    ``max_queue=6`` (the last two shed as ``queue_full``), drained."""
    engine = EventLoopEngine(params, cfg, batch=LOOP_BATCH, max_len=LOOP_MAX_LEN,
                             overlay=overlay, chunk=LOOP_CHUNK, max_queue=LOOP_QUEUE,
                             device=DEV)
    engine._prefill_chunk = Counted(engine._prefill_chunk)
    engine._decode = Counted(engine._decode)
    builds = count_spec_builds(overlay) if overlay is not None else [0]
    ticks = TickClock(engine, overlay)
    reqs = loop_requests(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()                           # the driven path starts here
    t0 = time.perf_counter()
    accepted = [engine.submit(r) for r in reqs]
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if overlay is not None:
        check(overlay.drain(120), "[serve-loop] background jobs did not drain")
        torch.cuda.synchronize()
    launches = counts()
    return {"engine": engine, "done": done, "accepted": accepted, "seconds": dt,
            "launches": launches, "builds": builds[0], "ticks": ticks,
            "streams": {r.rid: r.out for r in done},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def loop_signatures(engine) -> str:
    """Each traced signature's trace seconds and assembly seconds (for a
    background download, the worker's kernel build), in order of first call."""
    out = []
    sizes = list(dict.fromkeys(engine._prefill_chunk.lengths))
    for n, entry in zip(sizes, engine._prefill_chunk.fn._entries.values()):
        out.append(f"prefill_chunk({n}) trace {entry.trace_seconds:.2f} s, assembly "
                   f"{entry.assemble_seconds:.3f} s")
    for entry in engine._decode.fn._entries.values():
        out.append(f"decode trace {entry.trace_seconds:.2f} s, assembly "
                   f"{entry.assemble_seconds:.3f} s")
    return "; ".join(out)


def phase_serve_loop(params, cfg) -> dict:
    """[serve-loop] phi3-mini-3.8b at full width (the [serve] weights)
    through ``EventLoopEngine`` (batch 2, max_len 512, chunk 64): 8 requests
    of 16, 37, 100 and 300 tokens (twice each, from the seed), 16 new
    tokens each, priorities 0 and 1 alternating, submitted in one burst
    against ``max_queue=6``.  Runs: (a) plain (``overlay=None``), (b)
    ``Overlay(3, 3, async_downloads=True)``, (c) the same with a fault plan,
    (d) a synchronous ``Overlay(3, 3)`` (for the time to first token).
    Every run sheds exactly the last two requests as ``queue_full``; (b),
    (c) and (d) stream exactly what (a) streams; every chunk that reaches
    ``prefill_chunk`` is 16 or 64 tokens; rmsnorm launches 65 times for
    every prefill-chunk and decode call and every specialization's warm-up
    walk, all on the warp kernel; on (b) decode reaches the CUDA-graph tier
    through a low-lane capture made while serving; (c) records at least
    one download failure and completes every admitted request.  The
    synchronous ``ServeEngine``'s streams on the same requests are printed
    beside them, not required (a 64-token chunk and a whole prompt may get
    different cuBLAS algorithms)."""
    norms = 2 * cfg.num_layers + 1
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    runs = {}
    for name, make in (("plain", lambda: None),
                       ("async", lambda: Overlay(3, 3, async_downloads=True)),
                       ("async+faults", lambda: Overlay(
                           3, 3, async_downloads=True, faults=FaultPlan(SEED, **LOOP_FAULTS))),
                       ("sync-overlay", lambda: Overlay(3, 3))):
        ov = make()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            run = serve_loop(params, cfg, ov)
        eng = run["engine"]
        shed = [(r.rid, r.shed_reason) for r in eng.shed]
        check(run["accepted"] == [True] * LOOP_QUEUE + [False] * 2
              and shed == [(6, "queue_full"), (7, "queue_full")],
              f"[serve-loop] {name}: shed {shed}, accepted {run['accepted']}")
        check(len(run["done"]) == LOOP_QUEUE and all(
            len(s) == 1 + LOOP_NEW and all(0 <= t < cfg.vocab_size for t in s)
            for s in run["streams"].values()),
            f"[serve-loop] {name}: {len(run['done'])} requests completed")
        sizes = set(eng._prefill_chunk.lengths)
        check(sizes == {16, 64}, f"[serve-loop] {name}: prefill chunk sizes {sizes}")
        calls = eng._prefill_chunk.calls + eng._decode.calls
        l = run["launches"]
        check(l["rmsnorm"] == norms * (calls + run["builds"]) and l["rmsnorm/warp"] == l["rmsnorm"],
              f"[serve-loop] {name}: rmsnorm launches {l['rmsnorm']} (warp "
              f"{l['rmsnorm/warp']}) != {norms} x ({calls} calls + {run['builds']} warm-up walks)")
        run["calls"] = {"prefill_chunk": eng._prefill_chunk.calls, "decode": eng._decode.calls}
        run["warnings"] = len(caught)
        run["metrics"] = eng.metrics()
        run["spec_calls"] = eng._decode.spec_calls
        first = next(r for r in run["done"] if r.rid == 0)
        run["ttft0"] = first.first_token_time - first.submit_time
        if name != "plain":
            check(run["streams"] == runs["plain"]["streams"],
                  f"[serve-loop] {name} streams differ from plain:\n{run['streams']}\n"
                  f"{runs['plain']['streams']}")
        if ov is not None:
            run["signatures"] = loop_signatures(eng)
            run["describe"] = ov.describe()
            run["ledger"] = ov.failure_ledger()
            run["tiers"] = {r.name.split(".")[-1]: r.tier for r in ov.fabric.residents.values()}
            run["graph"] = any(isinstance(r.spec_fn.func, interp.GraphKernel)
                               for r in ov.fabric.residents.values()
                               if r.tier == "specialized" and r.name.endswith(".decode"))
            ov.close()
        runs[name] = run
        run.pop("engine")
        run["ticks"].detach()
        del eng, ov
        gc.collect()
        torch.cuda.empty_cache()
    b, c = runs["async"], runs["async+faults"]
    check(b["tiers"].get("decode") == "specialized" and b["graph"]
          and b["describe"]["scheduler"]["low_jobs"] >= 1
          and b["describe"]["specialization"]["specialized_hits"] > 0,
          f"[serve-loop] async: decode did not reach the CUDA-graph tier through the low lane "
          f"(tiers {b['tiers']}, scheduler {b['describe']['scheduler']})")
    check(not any(b["ledger"].values()), f"[serve-loop] async without faults: ledger {b['ledger']}")
    check(c["ledger"]["download_failures"] >= 1,
          f"[serve-loop] async+faults: no download failure in the ledger {c['ledger']}")
    # the synchronous engine on the same admitted requests, for comparison only
    sync = ServeEngine(params, cfg, batch=LOOP_BATCH, max_len=LOOP_MAX_LEN, device=DEV)
    for r in loop_requests(cfg)[:LOOP_QUEUE]:
        sync.submit(r)
    sync_streams = {r.rid: r.out for r in sync.run_until_drained()}
    agree = sum(sync_streams[k] == v for k, v in runs["plain"]["streams"].items())
    del sync
    gc.collect()
    torch.cuda.synchronize()
    left = (torch.cuda.memory_allocated() - mem0) / 2**30
    check(left < 1.0, f"[serve-loop] {left:.2f} GiB still allocated after the runs (a graph or "
                      f"an engine kept alive)")
    for name, run in runs.items():
        tokens = sum(len(s) for s in run["streams"].values())
        d = run.get("describe")
        log(f"[serve-loop] {name}: {tokens} tokens in {run['seconds']:.2f} s "
            f"({tokens / run['seconds']:.1f} tok/s); calls {run['calls']}, decode calls on "
            f"the specialized tier {run['spec_calls']}; request 0's time "
            f"to first token {run['ttft0']:.3f} s; {run['ticks'].summary()}; max_memory_allocated "
            f"{run['peak_gib']:.2f} GiB; launches {run['launches']}; warm-up walks "
            f"{run['builds']}; RuntimeWarnings {run['warnings']}")
        log(f"[serve-loop] {name} metrics: {json.dumps(run['metrics'])}")
        if d is not None:
            sched = d["scheduler"]
            log(f"[serve-loop] {name} overlay: fallback_calls {d['fallback_calls']}, "
                f"prefetch_hits {d['prefetch_hits']}, downloads {d['downloads']}, "
                f"stale_downloads {d['stale_downloads']}, traces {d['traces']} "
                f"({d['trace_seconds']:.1f} s); scheduler submitted {sched['submitted']}, "
                f"coalesced {sched['coalesced']}, completed {sched['completed']}, low jobs "
                f"{sched['low_jobs']}, priority jobs {sched['priority_jobs']}, dropped stale "
                f"{sched['dropped_stale']}, cancelled {sched['cancelled']}, failed "
                f"{sched['failed']}, worker seconds {sched['download_seconds']:.2f}; "
                f"specialized dispatches {d['specialization']['specialized_hits']} "
                f"(specializations {d['specialization']['specializations']}, dropped "
                f"{d['specialization']['dropped_stale']}); tiers {run['tiers']}; "
                f"{run['signatures']}")
            log(f"[serve-loop] {name} failure ledger: {run['ledger']}")
    log(f"[serve-loop] admitted streams identical across plain, async, async+faults and "
        f"sync-overlay; the synchronous ServeEngine agrees on {agree} of {LOOP_QUEUE} "
        f"requests (printed, not required); {left:.3f} GiB left allocated after the runs")
    launches = {}
    for name in ("plain", "async", "async+faults"):
        for k, v in runs[name]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "sync_overlay_launches": runs["sync-overlay"]["launches"],
            "plain_streams": runs["plain"]["streams"]}


def member_launches(fleet) -> list:
    """rmsnorm launches made inside each member's calls, counted at the seam
    the fleet dispatches through (``JitAssembled._invoke`` of the member
    wrappers, made by ``Overlay.jit``).  Valid while no background work
    launches kernels (synchronous members)."""
    per = [0] * len(fleet.members)
    rms = next(c for c in ops.LAUNCH_COUNTERS if c.name == "rmsnorm")
    for i, member in enumerate(fleet.members):
        def jit(*args, _jit=member.jit, _i=i, **kwargs):
            wrapper = _jit(*args, **kwargs)

            def invoke(call_args, writeback=True, _invoke=wrapper._invoke):
                n0 = rms.count
                try:
                    return _invoke(call_args, writeback)
                finally:
                    per[_i] += rms.count - n0

            wrapper._invoke = invoke
            return wrapper

        member.jit = jit
    return per


def fleet_summary(fleet) -> str:
    fl = fleet.describe()["fleet"]
    return (f"placements {fl['placements']}, replications {fl['replications']}, "
            f"replica_teardowns {fl['replica_teardowns']}, replicas_lost "
            f"{fl['replicas_lost']}, failovers {fl['failovers']}, evacuations "
            f"{fl['evacuations']}, member_deaths {fl['member_deaths']}, rebalances "
            f"{fl['rebalances']}; health {[h['state'] for h in fl['health']]}; scores "
            f"{fl['scores']}; routed per member {fl['routed_per_member']}; dispatch p50 us "
            f"{fl['dispatch_p50_us']}")


def fleet_homes(fleet) -> dict:
    """Each record's copies as (member, downloaded)."""
    out = {}
    for wrapper in list(fleet._wrappers):
        for rec in wrapper._records.values():
            out[rec.label] = [(rep.member_index,
                               getattr(rep.wrapper._entries.get(rec.sig_key), "acc", None)
                               is not None) for rep in rec.replicas]
    return out


def serve_fleet(params, cfg, fleet) -> dict:
    """The [serve] requests through ``ServeEngine`` on ``fleet``."""
    per = member_launches(fleet)
    engine = ServeEngine(params, cfg, batch=BATCH, max_len=MAX_LEN, overlay=fleet, device=DEV)
    engine._prefill, engine._decode = Counted(engine._prefill), Counted(engine._decode)
    first = []
    install = engine._install_stripe

    def timed_install(*args):
        install(*args)
        if not first:
            first.append(time.perf_counter())

    engine._install_stripe = timed_install
    rng = np.random.default_rng(SEED)
    for rid in range(REQUESTS):
        prompt = rng.integers(0, cfg.vocab_size, size=(PROMPT,)).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()                           # the driven path starts here
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"streams": [r.out for r in sorted(done, key=lambda r: r.rid)],
            "launches": counts(), "seconds": dt, "ttft": first[0] - t0,
            "calls": {"prefill": engine._prefill.calls, "decode": engine._decode.calls},
            "per_member": per, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_fleet(params, cfg, want: list, loop_want: dict) -> dict:
    """[fleet] phi3-mini-3.8b at full width (the [serve] weights) through a
    two-member ``FleetOverlay`` sharing the card (each member a 3x3 fabric
    with its own scheduler; the weights are call arguments, so no member
    holds a copy).  A window of 4 dispatches and ``replicate_after=2`` make
    the hot signatures replicate while the requests run.

    * ``sync``: ``ServeEngine`` with the [serve] requests: streams equal to
      plain; rmsnorm launches 65 a routed call, counted per member;
    * ``member death``: the same with ``FaultPlan(member_deaths={0: 3})``:
      member 0 dies before the third dispatch, its sole copy (prefill) is
      evacuated to member 1 (at least one evacuation), nothing is dropped,
      streams equal to plain;
    * ``async event loop``: ``EventLoopEngine`` with the [serve-loop]
      requests on a fleet of ``async_downloads=True`` members: admitted
      streams equal to plain's, at least one replica downloaded on a member
      scheduler's low lane.

    Each run leaves less than 1 GiB allocated after ``close()``."""
    norms = 2 * cfg.num_layers + 1
    kw = dict(rows=3, cols=3, window=4, replicate_after=2, drain_below=1)
    out = {}
    for name, make in (("sync", lambda: FleetOverlay(2, **kw)),
                       ("member death", lambda: FleetOverlay(
                           2, faults=FaultPlan(SEED, member_deaths={0: 3}), **kw))):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        fleet = make()
        run = serve_fleet(params, cfg, fleet)
        calls = run["calls"]["prefill"] + run["calls"]["decode"]
        routed = fleet.describe()["fleet"]["routed_per_member"]
        l = run["launches"]
        check(run["streams"] == want, f"[fleet] {name} streams differ from plain:\n"
                                      f"{run['streams']}\n{want}")
        check(l["rmsnorm"] == norms * calls and l["rmsnorm/warp"] == l["rmsnorm"],
              f"[fleet] {name}: rmsnorm launches {l} != {norms} x {calls} calls")
        check(run["per_member"] == [norms * n for n in routed],
              f"[fleet] {name}: rmsnorm launches per member {run['per_member']} != {norms} x "
              f"routed calls {routed}")
        check(sum(routed) == calls, f"[fleet] {name}: routed {routed} for {calls} calls")
        if name == "sync":
            check(fleet.stats.replications >= 1 and min(routed) > 0,
                  f"[fleet] sync: no replication or an idle member: {fleet_summary(fleet)}")
        else:
            check(fleet.stats.member_deaths == 1 and fleet.stats.evacuations >= 1
                  and fleet._health[0].state == "dead",
                  f"[fleet] member death: {fleet_summary(fleet)}")
        tokens = sum(len(x) for x in run["streams"])
        log(f"[fleet] {name}: {tokens} tokens in {run['seconds']:.2f} s "
            f"({tokens / run['seconds']:.1f} tok/s); request 0's time to first token "
            f"{run['ttft']:.3f} s; calls {run['calls']}; {fleet_summary(fleet)}; "
            f"max_memory_allocated {run['peak_gib']:.2f} GiB")
        log(f"[fleet] {name}: homes (member, downloaded) {fleet_homes(fleet)}; rmsnorm "
            f"launches per member {run['per_member']} ({norms} x routed calls); members' "
            f"traces {[m.stats.traces for m in fleet.members]}, downloads "
            f"{[m.stats.downloads for m in fleet.members]}; failure ledger "
            f"{fleet.failure_ledger()}")
        fleet.close()
        del fleet
        gc.collect()
        torch.cuda.empty_cache()
        left = (torch.cuda.memory_allocated() - mem0) / 2**30
        check(left < 1.0, f"[fleet] {name}: {left:.2f} GiB still allocated after close")
        log(f"[fleet] {name}: {left:.3f} GiB left allocated after close")
        out["fleet_sync" if name == "sync" else "fleet_member_death"] = l

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    fleet = FleetOverlay(2, async_downloads=True, **kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        run = serve_loop(params, cfg, fleet)
    eng = run.pop("engine")
    shed = {r.rid for r in eng.shed}
    check(run["streams"] == loop_want and shed == {6, 7},
          f"[fleet] async event loop: streams differ from plain or shed {shed}:\n"
          f"{run['streams']}\n{loop_want}")
    calls = eng._prefill_chunk.calls + eng._decode.calls
    l = run["launches"]
    check(l["rmsnorm"] == norms * (calls + run["builds"]) and l["rmsnorm/warp"] == l["rmsnorm"],
          f"[fleet] async event loop: rmsnorm launches {l} != {norms} x ({calls} calls + "
          f"{run['builds']} warm-up walks)")
    homes = fleet_homes(fleet)
    replicas = [(label, copy) for label, copies in homes.items() for copy in copies[1:]]
    low = [m.scheduler.stats.low_jobs for m in fleet.members]
    check(fleet.stats.replications >= 1 and any(done for _, (_, done) in replicas)
          and sum(low) >= 1,
          f"[fleet] async event loop: no replica downloaded on a low lane: homes {homes}, "
          f"low-lane jobs {low}, {fleet_summary(fleet)}")
    first = next(r for r in run["done"] if r.rid == 0)
    tokens = sum(len(x) for x in run["streams"].values())
    log(f"[fleet] async event loop: {tokens} tokens in {run['seconds']:.2f} s "
        f"({tokens / run['seconds']:.1f} tok/s); request 0's time to first token "
        f"{first.first_token_time - first.submit_time:.3f} s; calls {{'prefill_chunk': "
        f"{eng._prefill_chunk.calls}, 'decode': {eng._decode.calls}}}; {fleet_summary(fleet)}; "
        f"max_memory_allocated {run['peak_gib']:.2f} GiB")
    log(f"[fleet] async event loop: homes (member, downloaded) {homes}; low-lane jobs per "
        f"member {low}; capture warm-up walks {run['builds']}; {run['ticks'].summary()}; "
        f"RuntimeWarnings {len(caught)}; failure ledger {fleet.failure_ledger()}")
    run["ticks"].detach()
    fleet.close()
    del fleet, eng, run
    gc.collect()
    torch.cuda.empty_cache()
    left = (torch.cuda.memory_allocated() - mem0) / 2**30
    check(left < 1.0, f"[fleet] async event loop: {left:.2f} GiB still allocated after close")
    log(f"[fleet] async event loop: {left:.3f} GiB left allocated after close")
    out["fleet_async_loop"] = l
    return out


def _sync_ms(fn) -> tuple:
    """Host time of ``fn()`` up to a device synchronize, in ms, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def train_steps(tag: str, cfg, schedule, steps: int, seq: int) -> dict:
    """Random bf16 weights from the seed, then ``steps`` eager in-place
    steps of ``launch.train.make_step`` at batch ``TRAIN_BATCH`` x ``seq``
    on the synthetic stream, the launch counters set to 0 just before the
    first.  Returns the launches, step ms, losses, their cross-entropy and
    load-balance terms and grad norms (on the host), the peak memory, and
    the state, step fn and batches for what the phase runs after the
    counted steps."""
    params = pm.init(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    opt = adamw_init(params)
    step_fn = train_cli.make_step(cfg, schedule)
    batches = [make_batch(cfg, TRAIN_BATCH, seq, step=i, seed=SEED, device=DEV)
               for i in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, step_ms, losses, gnorms, lrs = (params, opt), [], [], [], []
    ces, auxs = [], []
    reset_counters()                           # the driven path starts here
    for batch in batches:
        ms, (state, metrics) = _sync_ms(lambda: step_fn(state, batch))
        step_ms.append(ms)
        losses.append(metrics["loss"].cpu())
        ces.append(metrics["ce"].cpu())
        auxs.append(metrics["aux"].cpu())
        gnorms.append(metrics["grad_norm"].cpu())
        lrs.append(metrics["lr"].item())
        log(f"[{tag}] step {len(losses)}: loss {losses[-1].item():.4f} (ce "
            f"{ces[-1].item():.4f}, aux {auxs[-1].item():.4f}) grad_norm "
            f"{gnorms[-1].item():.3f} lr {metrics['lr'].item():.2e} {ms:.1f} ms")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x.item()) for x in losses), f"[{tag}] non-finite loss {losses}")
    steady = float(np.median(step_ms[1:]))
    tokens = TRAIN_BATCH * seq
    log(f"[{tag}] {cfg.name}: {pm.count(params) / 1e9:.3f} B params, {cfg.num_layers} layers, "
        f"batch {TRAIN_BATCH} x seq {seq}, remat {cfg.remat}: step ms first {step_ms[0]:.1f}, "
        f"steady (median of the rest) {steady:.1f}; {tokens / steady * 1e3:.0f} tokens/s; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); launches "
        f"{launches}")
    return {"launches": launches, "step_ms": step_ms, "losses": losses, "grad_norms": gnorms,
            "ces": ces, "auxs": auxs, "lrs": lrs, "peak_bytes": peak,
            "tok_s": tokens / steady * 1e3, "state": state, "step_fn": step_fn,
            "batches": batches}


def check_launches(tag: str, launches: dict, want: dict, variants: dict) -> None:
    """Each kernel's launches equal ``want``, every one on the variant
    ``variants`` names."""
    for name, n in want.items():
        check(launches[name] == n, f"[{tag}] {name} launches {launches[name]} != {n}")
        check(launches[f"{name}/{variants[name]}"] == n,
              f"[{tag}] {name} launches by variant: {launches} (every one must be on "
              f"{variants[name]})")


def _free() -> None:
    """Returns what the phase dropped to the card before the next one."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_train() -> dict:
    """phi3-mini-3.8b at its published widths and all 32 layers, random bf16
    weights from the seed, 4 eager in-place steps at batch 1 x seq 4096 on
    the synthetic stream.  Per step: one flash_attention launch per layer in
    the forward and one in the remat recompute; one rmsnorm launch per norm
    in the forward (2 per layer + the final norm) and per layer norm in the
    recompute (the final norm is outside the rematerialized layers)."""
    cfg = get_config("phi3-mini-3.8b")
    alive = [f"{t.name}{' (daemon)' if t.daemon else ''}" for t in threading.enumerate()]
    log(f"[train] threads alive at the start: {len(alive)}: {alive}")
    run = train_steps("train", cfg, cosine(3e-4, warmup=1, total=TRAIN_STEPS), TRAIN_STEPS,
                      TRAIN_SEQ)
    profile_step(lambda: run["step_fn"](run["state"], run["batches"][0]))
    check_launches("train", run["launches"],
                   {"flash_attention": TRAIN_STEPS * 2 * cfg.num_layers,
                    "rmsnorm": TRAIN_STEPS * ((2 * cfg.num_layers + 1) + 2 * cfg.num_layers)},
                   {"flash_attention": "wgmma", "rmsnorm": "warp"})
    out = {k: run[k] for k in ("launches", "step_ms", "losses", "peak_bytes", "tok_s")}
    del run
    _free()
    return out


KERNEL_GROUPS = (   # (group, lower-case substrings of CUDA kernel names), first match wins
    ("flash_attention", ("flash_fwd",)),
    ("ssd_chunk", ("ssd_chunk_mma", "ssd_chunk_simt")),
    ("rmsnorm", ("rmsnorm_warp", "rmsnorm_block")),
    ("matrix products (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "cublas", "nvjet")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce",)),
    ("copies", ("copy", "memcpy", "memset")),
)


def aten_ops(fn) -> int:
    """The aten ops one call of ``fn`` dispatches, the backward's included
    (a ``TorchDispatchMode`` that counts and runs each): what the host
    issues one at a time."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n


OPTIMIZER_RANGE = "adamw_update_"     # the profiler range of recorded_optimizer


def profile_step(fn, tag: str = "train", op_groups: tuple = (), shapes: bool = False) -> None:
    """One more train step (after the counted run) under ``torch.profiler``:
    device time by kernel group, and the device's busy share of the step's
    wall time (kernels run on one stream, so their times add).  With
    ``op_groups`` ((group, test of an aten op's profiler event), ...): the
    device time of the kernels each group's aten ops launch themselves
    (each op's self device time, so nested ops are not counted twice),
    first match wins; ``shapes`` records each op's input shapes for the
    tests to read (``record_shapes``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        ms, _ = _sync_ms(fn)
    groups: dict[str, float] = {}
    kernels: dict[str, float] = {}
    busy = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name == OPTIMIZER_RANGE \
                or getattr(ev, "is_user_annotation", False):
            continue                 # a range's span on the device is no kernel
        us = ev.time_range.elapsed_us()
        busy += us
        name = ev.name.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                     "other elementwise")
        groups[group] = groups.get(group, 0.0) + us
        kernels[ev.name] = kernels.get(ev.name, 0.0) + us
    if busy == 0.0:
        log(f"[{tag}] profile: the profiler saw no device time; breakdown not measured")
        return
    parts = ", ".join(f"{g} {us / 1e3:.1f} ms ({us / busy:.0%})"
                      for g, us in sorted(groups.items(), key=lambda kv: -kv[1]))
    log(f"[{tag}] profile of one step ({ms:.1f} ms wall, under the profiler): device busy "
        f"{busy / 1e3:.1f} ms ({busy / 1e3 / ms:.0%} of the step, idle {1 - busy / 1e3 / ms:.0%}); "
        f"{parts}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    log(f"[{tag}] profile: the kernels that take most of it: "
        + "; ".join(f"{name[:90]} {us / 1e3:.1f} ms" for name, us in top))
    if not op_groups:
        return
    by_op: dict[str, float] = {}
    names: dict[str, dict[str, float]] = {}     # the kernels of each group, us by name
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        group = next((g for g, test in op_groups if test(ev)), None)
        if group is not None and us:
            by_op[group] = by_op.get(group, 0.0) + us
            for k in getattr(ev, "kernels", ()):
                named = names.setdefault(group, {})
                named[k.name] = named.get(k.name, 0.0) + k.duration
    if not by_op:
        log(f"[{tag}] profile: the profiler gave its aten ops no device time; the split by "
            f"op is not measured")
        return
    log(f"[{tag}] profile by aten op (self device time of the kernels each op launches): "
        + ", ".join(f"{g} {by_op.get(g, 0.0) / 1e3:.1f} ms ({by_op.get(g, 0.0) / busy:.1%})"
                    for g, _ in op_groups))
    for g, named in names.items():
        top = sorted(named.items(), key=lambda kv: -kv[1])[:3]
        log(f"[{tag}] profile: {g}'s kernels: "
            + "; ".join(f"{name[:80]} {us / 1e3:.1f} ms" for name, us in top))


def phase_train_overlay() -> dict:
    """The train step through ``Overlay(3, 3).jit(train_step,
    donate_argnums=(0,))`` (functional: forward, the backward and the
    optimizer traced into one accelerator, the state donated) against the
    eager in-place step from the same state, at phi3-mini's published
    widths cut to 16 of its 32 layers, batch 1 x seq 1024, 2 steps.  Two full states
    do not fit on the card, so the traced run goes first, its final state
    goes to the host, and the eager run starts again from the seed.  The
    traced graph replays the eager run's aten ops, so losses and every state
    leaf must be bit-identical; every state leaf the traced step returns
    must be the tensor donated to it (the same storage); the traced step's
    peak memory must stay below the eager step's plus half a state (a second
    copy of the state would add a whole one); flash_attention and rmsnorm
    launch once a step per node of the graph, every flash launch on the
    tensor-core kernel."""
    cfg = get_config("phi3-mini-3.8b").scaled(blocks=((("dense",), OVERLAY_LAYERS),))
    sched = cosine(3e-4, warmup=1, total=OVERLAY_STEPS)
    batches = [make_batch(cfg, 1, OVERLAY_SEQ, step=i, seed=SEED, device=DEV)
               for i in range(OVERLAY_STEPS)]

    def fresh_state():
        params = pm.init(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
        return params, adamw_init(params)

    ov = Overlay(3, 3)
    traced = train_cli.make_step(cfg, sched, overlay=ov)
    state = fresh_state()
    leaves = pytree.tree_leaves(state)
    state_bytes = sum(x.numel() * x.element_size() for x in leaves)
    ptrs = [x.data_ptr() for x in leaves]
    del leaves
    ms_ov, loss_ov, peak_ov, moved = [], [], [], []
    torch.cuda.synchronize()
    reset_counters()                           # the driven path starts here
    for batch in batches:
        torch.cuda.reset_peak_memory_stats()
        ms, (state, m) = _sync_ms(lambda: traced(state, batch))
        ms_ov.append(ms)
        peak_ov.append(torch.cuda.max_memory_allocated())
        loss_ov.append(m["loss"].cpu())
        out = pytree.tree_leaves(state)
        moved.append(sum(x.data_ptr() != p for x, p in zip(out, ptrs)))
        del out, m
    launches = counts()
    (entry,) = traced._entries.values()
    names = [n.name for n in entry.lowered.graph.op_nodes()]
    t0 = time.perf_counter()
    host = [x.cpu() for x in pytree.tree_leaves(state)]
    to_host_s = time.perf_counter() - t0
    n_leaves, n_donated = len(host), len(entry.aliases)
    info = (f"trace {entry.trace_seconds:.2f} s, assembly {entry.assemble_seconds:.2f} s; "
            f"graph {len(names)} op nodes ({len(entry.lowered.unmapped)} residue, "
            f"{names.count('kernels/attention')} attention, {names.count('kernels/rmsnorm')} "
            f"rmsnorm), {entry.acc.placement.total_passthrough} pass-through hops")
    ov.close()
    del state, traced, entry, ov
    gc.collect()
    torch.cuda.empty_cache()

    eager = train_cli.make_step(cfg, sched)
    state = fresh_state()
    ms_eg, loss_eg, peak_eg = [], [], []
    for batch in batches:
        torch.cuda.reset_peak_memory_stats()
        ms, (state, m) = _sync_ms(lambda: eager(state, batch))
        ms_eg.append(ms)
        peak_eg.append(torch.cuda.max_memory_allocated())
        loss_eg.append(m["loss"].cpu())
        del m
    for i in range(OVERLAY_STEPS):
        log(f"[train-overlay] step {i + 1}: loss overlay {loss_ov[i].item():.6f} eager "
            f"{loss_eg[i].item():.6f}; ms overlay {ms_ov[i]:.1f} eager {ms_eg[i]:.1f}; "
            f"max_memory_allocated overlay {peak_ov[i] / 2**30:.2f} GiB eager "
            f"{peak_eg[i] / 2**30:.2f} GiB; returned state leaves not in their donated "
            f"storage {moved[i]}")
    check(all(torch.equal(a, b) for a, b in zip(loss_ov, loss_eg)),
          f"[train-overlay] losses differ: overlay {loss_ov} eager {loss_eg}")
    mismatched = [i for i, (a, b) in enumerate(zip(host, pytree.tree_leaves(state)))
                  if not torch.equal(a.to(DEV), b)]
    check(not mismatched, f"[train-overlay] overlay and eager states differ in leaves "
                          f"{mismatched[:20]} ({len(mismatched)} of {len(host)})")
    check(not any(moved), f"[train-overlay] returned state leaves outside their donated "
                          f"storage, by step: {moved}")
    check(n_donated == n_leaves, f"[train-overlay] {n_donated} donated outputs for "
                                 f"{n_leaves} state leaves")
    worst = max(p - e for p, e in zip(peak_ov, peak_eg))
    check(worst < state_bytes / 2,
          f"[train-overlay] traced peak exceeds eager by {worst / 2**30:.2f} GiB, over half "
          f"a state ({state_bytes / 2**30:.2f} GiB): the step holds two copies")
    want = {"flash_attention": OVERLAY_STEPS * names.count("kernels/attention"),
            "rmsnorm": OVERLAY_STEPS * names.count("kernels/rmsnorm")}
    for name, n in want.items():
        check(launches[name] == n, f"[train-overlay] {name} launches {launches[name]} != {n}")
    check(launches["flash_attention/wgmma"] == want["flash_attention"],
          f"[train-overlay] flash_attention launches by variant: {launches}")
    log(f"[train-overlay] {OVERLAY_LAYERS} layers, seq {OVERLAY_SEQ}: losses and all "
        f"{n_leaves} state leaves bit-identical after {OVERLAY_STEPS} steps; every returned "
        f"state leaf is its donated tensor ({n_donated} donated outputs); {info}; "
        f"state {state_bytes / 2**30:.2f} GiB; max_memory_allocated traced "
        f"{max(peak_ov) / 2**30:.2f} GiB ({max(peak_ov) / 1e9:.2f} GB) vs eager in place "
        f"{max(peak_eg) / 2**30:.2f} GiB ({max(peak_eg) / 1e9:.2f} GB); step ms traced "
        f"{ms_ov} eager {ms_eg}; final state to host {to_host_s:.1f} s; launches {launches}")
    del state, host, eager
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_mamba(params, cfg, overlay) -> tuple[list, dict, float, ServeEngine]:
    engine = ServeEngine(params, cfg, batch=MAMBA_BATCH, max_len=MAMBA_MAX_LEN,
                         overlay=overlay, device=DEV)
    engine._prefill, engine._decode = Counted(engine._prefill), Counted(engine._decode)
    rng = np.random.default_rng(SEED)
    for rid in range(MAMBA_REQUESTS):
        n = MAMBA_PROMPTS[rid % len(MAMBA_PROMPTS)]
        prompt = rng.integers(0, cfg.vocab_size, size=(n,)).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=MAMBA_NEW))
    torch.cuda.synchronize()
    reset_counters()                           # the driven path starts here
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts()
    streams = [r.out for r in sorted(done, key=lambda r: r.rid)]
    return streams, launches, dt, engine


def phase_serve_mamba(gen: torch.Generator) -> dict:
    """mamba2-130m at its published widths and all 24 layers, random bf16
    weights from the seed: 6 requests of 37, 500 and 4096 prompt tokens
    (one ragged chunk, a padded tail, 64 full chunks), 16 new tokens each,
    batch 4, through ``Overlay(3, 3)`` and plainly.  Each prefill launches
    ssd_chunk once per layer (24), each on the tensor-core kernel, and decode
    never (its step is plain); each prefill and decode call launches rmsnorm
    25 times (24 ln1 + final)."""
    cfg = get_config(MAMBA)
    check(cfg.d_model == MAMBA_D, f"{MAMBA} d_model {cfg.d_model}: the rmsnorm checks use {MAMBA_D}")
    params = pm.init(cfg, gen, DEV)
    torch.cuda.synchronize()
    log(f"[serve-mamba] {cfg.name}: {pm.count(params) / 1e6:.1f} M params (d_model "
        f"{cfg.d_model}, {cfg.num_layers} layers, state {cfg.ssm_state}, bf16)")
    torch.cuda.reset_peak_memory_stats()
    ov = Overlay(3, 3)
    s_ov, l_ov, dt_ov, eng_ov = serve_mamba(params, cfg, ov)
    s_pl, l_pl, dt_pl, eng_pl = serve_mamba(params, cfg, None)
    ov_cm = Overlay(3, 3, cost_model_placement=True)
    s_cm, l_cm, dt_cm, eng_cm = serve_mamba(params, cfg, ov_cm)
    peak = torch.cuda.max_memory_allocated()
    check(s_ov == s_pl, f"mamba overlay and plain token streams differ:\n{s_ov}\n{s_pl}")
    check(s_cm == s_pl, f"mamba cost-model overlay and plain token streams differ:\n{s_cm}\n{s_pl}")
    check(all(len(s) == 1 + MAMBA_NEW and all(0 <= t < cfg.vocab_size for t in s)
              for s in s_ov), "unexpected mamba token stream shape/range")
    layers = cfg.num_layers
    for name, eng, got in (("overlay", eng_ov, l_ov), ("plain", eng_pl, l_pl),
                           ("cost-model overlay", eng_cm, l_cm)):
        calls = eng._prefill.calls + eng._decode.calls
        want = {"ssd_chunk": layers * eng._prefill.calls, "rmsnorm": (layers + 1) * calls}
        for kernel, n in want.items():
            check(got[kernel] == n, f"mamba {name} serving: {kernel} launches {got[kernel]} != {n}")
        check(got["ssd_chunk/mma"] == got["ssd_chunk"],
              f"mamba {name} serving: ssd_chunk launches by variant {got} (every one must be a "
              f"tensor-core launch)")
    tokens = sum(len(s) for s in s_ov)
    desc = ov.describe()
    log(f"[serve-mamba] overlay: {tokens} tokens in {dt_ov:.2f}s ({tokens / dt_ov:.1f} tok/s), "
        f"prefill {eng_ov._prefill.calls} / decode {eng_ov._decode.calls} calls, launches "
        f"{l_ov}; traces {desc['traces']} ({desc['trace_seconds']:.1f}s), downloads "
        f"{desc['downloads']}")
    log(f"[serve-mamba] plain:   {tokens} tokens in {dt_pl:.2f}s ({tokens / dt_pl:.1f} tok/s), "
        f"launches {l_pl}; streams identical: {s_ov == s_pl}")
    for name, o, dt in (("first-fit", ov, dt_ov), ("cost-model", ov_cm, dt_cm)):
        d = o.describe()
        log(f"[serve-mamba] {name} placement: downloads {d['downloads']} for {d['traces']} "
            f"signatures ({d['downloads'] - d['traces']} re-downloads), reclaims {d['reclaims']}, "
            f"{tokens / dt:.1f} tok/s; tiles at the end "
            f"{ {r.name: sorted(r.tiles) for r in o.fabric.residents.values()} }")
    log(f"[serve-mamba] cost-model streams identical to plain: {s_cm == s_pl}")
    for step in ("prefill", "decode"):
        log(f"[serve-mamba] {step} host ms per call: overlay "
            f"{getattr(eng_ov, f'_{step}').by_length_ms()}; plain "
            f"{getattr(eng_pl, f'_{step}').by_length_ms()}")
        for entry in getattr(eng_ov, f"_{step}").fn._entries.values():
            graph = entry.lowered.graph
            names = [nd.name for nd in graph.op_nodes()]
            toks = next(a.shape for a in graph.input_avals()
                        if a.dtype == torch.int32 and len(a.shape) == 2)
            if step == "prefill":
                check(names.count("kernels/ssd") == layers,
                      f"a traced mamba prefill holds {names.count('kernels/ssd')} kernels/ssd nodes")
            log(f"[serve-mamba] {step} signature tokens {toks}: trace "
                f"{entry.trace_seconds:.2f} s, assemble {entry.assemble_seconds:.2f} s; "
                f"{len(names)} op nodes ({len(entry.lowered.unmapped)} residue, "
                f"{names.count('kernels/ssd')} kernels/ssd, {names.count('kernels/rmsnorm')} "
                f"kernels/rmsnorm), {entry.acc.placement.total_passthrough} pass-through hops")
    log(f"[serve-mamba] streams: {[s[:6] for s in s_ov]}...")
    log(f"[serve-mamba] max_memory_allocated {peak / 2**30:.2f} GiB")
    del params, eng_ov, eng_pl, eng_cm
    torch.cuda.empty_cache()
    return {"launches": l_ov, "launches_cost_model": l_cm, "tok_s_overlay": tokens / dt_ov,
            "tok_s_plain": tokens / dt_pl}


def phase_train_mamba() -> dict:
    """mamba2-130m at its published widths and all 24 layers, random bf16
    weights from the seed, 3 eager in-place steps at batch 1 x seq 4096 on
    the synthetic stream.  Per step: one ssd_chunk launch per layer in the
    forward and one in the remat recompute (the backward is plain), each on
    the tensor-core kernel; one
    rmsnorm launch per ln1 in the forward and the recompute, plus the final
    norm."""
    cfg = get_config(MAMBA)
    run = train_steps("train-mamba", cfg, cosine(3e-4, warmup=1, total=MAMBA_TRAIN_STEPS),
                      MAMBA_TRAIN_STEPS, TRAIN_SEQ)
    state, batch = run["state"], run["batches"][0]
    profile_step(lambda: run["step_fn"](state, batch), tag="train-mamba")
    step_ops = aten_ops(lambda: run["step_fn"](state, batch))
    grad_ops = aten_ops(lambda: train_cli._loss_and_grads(cfg, state[0], batch))
    log(f"[train-mamba] aten ops the host issues a step: {step_ops} ({step_ops / cfg.num_layers:.0f} "
        f"a layer), of which the loss and gradients {grad_ops}, the optimizer and the rest "
        f"{step_ops - grad_ops}")
    check_launches("train-mamba", run["launches"],
                   {"ssd_chunk": MAMBA_TRAIN_STEPS * 2 * cfg.num_layers,
                    "rmsnorm": MAMBA_TRAIN_STEPS * (2 * cfg.num_layers + 1)},
                   {"ssd_chunk": "mma", "rmsnorm": "warp"})
    out = {k: run[k] for k in ("launches", "step_ms", "losses")}
    del run, state, batch
    _free()
    return out


@contextlib.contextmanager
def flash_options(record: dict, key=lambda q, k, kw: (q.shape[2], kw.get("window"),
                                                      kw.get("softcap"))):
    """Counts each flash_attention launch by ``key(q, k, options)``, (Sq,
    window, softcap) by default, while open: the custom op's CUDA kernel
    calls ``fa_mod.flash_attention``."""
    wrapped = fa_mod.flash_attention

    def recording(q, k, v, **kw):
        at = key(q, k, kw)
        record[at] = record.get(at, 0) + 1
        return wrapped(q, k, v, **kw)

    fa_mod.flash_attention = recording
    try:
        yield record
    finally:
        fa_mod.flash_attention = wrapped


def phase_train_gemma2() -> dict:
    """[train-gemma2]: gemma2-27b at its published widths cut to its first
    (local, global) unit (``cut_layers``; random bf16 weights from the
    seed), 4 eager in-place steps at batch 1 x seq 6144 under remat
    ``"full"``, then one more under ``torch.profiler`` and an optimizer
    step alone with its peak above its start (the slices bound it); then
    the same weights made again from the seed and 2 steps under
    ``"dots"``.  Per step under both: flash_attention twice a layer
    (forward and the recompute) on the tensor-core kernel, the local
    layer's with window 4096 and both with softcap 50; rmsnorm 4 a layer
    and the final norm in the forward, 4 a layer in the recompute, all on
    the block kernel (d 4608).  ``"dots"`` saves each layer's 2-D products
    and recomputes the rest from the same inputs: its losses and grad norms
    must equal the ``"full"`` run's bit for bit."""
    cfg = cut_layers(get_config(GEMMA), GEMMA_TRAIN_LAYERS)
    sched = cosine(3e-4, warmup=1, total=GEMMA_TRAIN_STEPS)
    n = cfg.num_layers

    def train(remat: str, steps: int) -> dict:
        tag = f"train-gemma2 {remat}"
        with flash_options({}) as opts:
            run = train_steps(tag, cfg.scaled(remat=remat), sched, steps, GEMMA_TRAIN_SEQ)
        check_launches(tag, run["launches"],
                       {"flash_attention": steps * 2 * n, "rmsnorm": steps * (8 * n + 1)},
                       {"flash_attention": "wgmma", "rmsnorm": "block"})
        each = steps * 2 * (n // 2)         # forward + recompute of the local and global layers
        want = {(GEMMA_TRAIN_SEQ, cfg.sliding_window, cfg.attn_softcap): each,
                (GEMMA_TRAIN_SEQ, None, cfg.attn_softcap): each}
        check(opts == want, f"[{tag}] flash launches by (Sq, window, softcap) {opts} != {want}")
        log(f"[{tag}] flash launches by (Sq, window, softcap): {opts}")
        return run

    full = train("full", GEMMA_TRAIN_STEPS)
    state, batch = full.pop("state"), full.pop("batches")[0]
    step_fn = full.pop("step_fn")
    profile_step(lambda: step_fn(state, batch), tag="train-gemma2")
    _, _, grads, _ = train_cli._loss_and_grads(cfg, state[0], batch)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    torch.cuda.reset_peak_memory_stats()
    ms, _ = _sync_ms(lambda: adamw_update_(state[0], grads, state[1], lr=3e-4,
                                           decay=decay_mask(state[0])))
    extra = torch.cuda.max_memory_allocated() - start
    largest = max(p.numel() for p in pytree.tree_leaves(state[0]))
    log(f"[train-gemma2] optimizer step alone: {ms:.1f} ms, peak {extra / 2**30:.3f} GiB above "
        f"its start of {start / 2**30:.2f} GiB (state and {grad_bytes / 2**30:.2f} GiB of "
        f"gradients); largest leaf {largest} elements, in slices of {SLICE_ELEMENTS}")
    del state, batch, step_fn, grads
    _free()
    dots = train("dots", GEMMA_DOTS_STEPS)
    same = [torch.equal(a, b) and torch.equal(c, d)
            for a, b, c, d in zip(dots["losses"], full["losses"], dots["grad_norms"],
                                  full["grad_norms"])]
    check(all(same), f"[train-gemma2] dots vs full: losses {dots['losses']} vs "
                     f"{full['losses']}, grad norms {dots['grad_norms']} vs {full['grad_norms']}")
    log(f"[train-gemma2] dots vs full: losses and grad norms of steps 1-{GEMMA_DOTS_STEPS} "
        f"bit-identical; max_memory_allocated dots {dots['peak_bytes'] / 2**30:.2f} GiB vs full "
        f"{full['peak_bytes'] / 2**30:.2f} GiB; steady step ms dots "
        f"{float(np.median(dots['step_ms'][1:])):.1f} vs full "
        f"{float(np.median(full['step_ms'][1:])):.1f}")
    result = {"launches": full["launches"], "launches_dots": dots["launches"]}
    del full, dots
    _free()
    return result


def phase_train_minicpm() -> dict:
    """[train-minicpm]: minicpm-2b at its published widths and all 40
    layers (tied embeddings x12, residual scale 1.4/sqrt(40); random bf16
    weights from the seed), 4 eager in-place steps at batch 1 x seq 4096 on
    the launcher's ``wsd`` schedule (``make_schedule``; over 4 steps it is
    one warmup step at lr 0 and three at the peak, its decay starting at
    the peak: the lr of each step must be the schedule's).  Per step:
    flash_attention twice a layer on the tensor-core kernel (36 heads of
    64, no GQA), rmsnorm 2 a layer and the final norm in the forward, 2 a
    layer in the recompute, on the warp kernel (d 2304)."""
    cfg = get_config(MINICPM)
    steps = MINICPM_TRAIN_STEPS
    sched = train_cli.make_schedule("wsd", 3e-4, steps)
    run = train_steps("train-minicpm", cfg, sched, steps, TRAIN_SEQ)
    want_lr = [float(sched(i)) for i in range(steps)]
    check(all(math.isclose(a, b, rel_tol=1e-6) for a, b in zip(run["lrs"], want_lr)),
          f"[train-minicpm] lr by step {run['lrs']} != the wsd schedule's {want_lr}")
    state, batch = run["state"], run["batches"][0]
    profile_step(lambda: run["step_fn"](state, batch), tag="train-minicpm")
    n = cfg.num_layers
    check_launches("train-minicpm", run["launches"],
                   {"flash_attention": steps * 2 * n, "rmsnorm": steps * ((2 * n + 1) + 2 * n)},
                   {"flash_attention": "wgmma", "rmsnorm": "warp"})
    out = {k: run[k] for k in ("launches", "step_ms", "peak_bytes")}
    del run, state, batch
    _free()
    return out


def _under(ev, text: str) -> bool:
    """Whether a profiler event or one of its host parents has ``text`` in
    its name."""
    while ev is not None:
        if text in ev.name:
            return True
        ev = ev.cpu_parent
    return False


def _in_attention(ev) -> bool:
    """Whether a profiler event runs inside the attention op (its plain
    VJP runs under the ``_Attention`` autograd node's backward)."""
    return _under(ev, "_Attention")


# the aten ops of granite's training step whose kernels the profile splits
# out: the MoE dispatch's sorts, counts, gathers and scatters (their
# backward's accumulating index_put too; the embedding's index_select is
# among them); the experts' bmm, and the plain attention VJP's f32 bmm
# apart from them; the 2-D products
GRANITE_OP_GROUPS = (
    ("dispatch index ops",
     lambda ev: any(k in ev.name for k in ("index", "sort", "gather", "scatter", "cumsum"))),
    ("expert bmm", lambda ev: ev.name == "aten::bmm" and not _in_attention(ev)),
    ("the attention VJP's bmm", lambda ev: ev.name == "aten::bmm"),
    ("mm", lambda ev: ev.name == "aten::mm"),
)


def phase_train_granite() -> dict:
    """[train-granite]: the mixture-of-experts granite-moe-1b-a400m at its
    published widths and all 24 ``moe`` layers (32 experts, top-8,
    capacity factor 1.25: 1281 slots an expert at 4096 tokens; tied
    embeddings; random bf16 weights from the seed), 4 eager in-place steps
    at batch 1 x seq 4096 under remat ``"full"`` on ``cosine(3e-4, warmup=1,
    total=4)``, the reference's loss ``ce + 0.01 * aux``, then one more
    under ``torch.profiler``.  Each step: a finite loss, a finite ``aux``
    above 0, the loss equal to ``ce + 0.01 * aux`` to f32 rounding;
    flash_attention twice a layer (forward and the recompute) on the
    tensor-core kernel (16 heads over 8 kv heads of 64), rmsnorm 2 a layer
    and the final norm in the forward, 2 a layer in the recompute, on the
    warp kernel (d 1024).  Printed, not required: whether step 1 again
    (fresh weights from the seed, the same batch) gives the same loss and
    grad norm bit for bit."""
    cfg = get_config(GRANITE)
    n, steps = cfg.num_layers, GRANITE_TRAIN_STEPS
    check(pm.layer_kinds(cfg) == ["moe"] * 24 and cfg.d_model == GRANITE_D
          and (TRAIN_BATCH, cfg.num_heads, cfg.num_kv_heads, TRAIN_SEQ, cfg.resolved_head_dim)
          == GRANITE_FLASH, f"{GRANITE} config {cfg}")
    cap = int(TRAIN_BATCH * TRAIN_SEQ * cfg.experts_per_token / cfg.num_experts
              * cfg.capacity_factor) + 1
    log(f"[train-granite] {cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters "
        f"({cfg.active_param_count() / 1e9:.3f} B active a token), {cfg.num_experts} experts, "
        f"top-{cfg.experts_per_token}, capacity {cap} slots an expert of "
        f"{TRAIN_BATCH * TRAIN_SEQ * cfg.experts_per_token} a layer; state (bf16 parameters "
        f"and gradients, f32 moments) {12 * cfg.param_count() / 1e9:.2f} GB")
    sched = cosine(3e-4, warmup=1, total=steps)
    run = train_steps("train-granite", cfg, sched, steps, TRAIN_SEQ)
    for i, (loss, ce, aux) in enumerate(zip(run["losses"], run["ces"], run["auxs"])):
        want = ce + 0.01 * aux                 # f32 on the host, as on the card
        check(math.isfinite(aux.item()) and aux.item() > 0,
              f"[train-granite] step {i + 1}: aux {aux.item()} (must be finite and > 0)")
        check(abs(loss.item() - want.item()) <= 4 * torch.finfo(torch.float32).eps
              * abs(want.item()),
              f"[train-granite] step {i + 1}: loss {loss.item()!r} != ce + 0.01 * aux "
              f"{want.item()!r}")
    log(f"[train-granite] loss = ce + 0.01 * aux on every step; aux by step "
        f"{[round(a.item(), 4) for a in run['auxs']]} ({n} layers: "
        f"{run['auxs'][0].item() / n:.4f} a layer at step 1)")
    check_launches("train-granite", run["launches"],
                   {"flash_attention": steps * 2 * n, "rmsnorm": steps * ((2 * n + 1) + 2 * n)},
                   {"flash_attention": "wgmma", "rmsnorm": "warp"})
    state, batch, step_fn = run.pop("state"), run["batches"][0], run.pop("step_fn")
    profile_step(lambda: step_fn(state, batch), tag="train-granite",
                 op_groups=GRANITE_OP_GROUPS)
    del state, step_fn
    _free()
    params = pm.init(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    _, m = train_cli.make_step(cfg, sched)((params, adamw_init(params)), batch)
    loss, gnorm = m["loss"].cpu(), m["grad_norm"].cpu()
    same = torch.equal(loss, run["losses"][0]) and torch.equal(gnorm, run["grad_norms"][0])
    gaps = [abs(a.item() - b.item()) / abs(b.item()) for a, b in
            ((loss, run["losses"][0]), (gnorm, run["grad_norms"][0]))]
    log(f"[train-granite] step 1 again (fresh weights from the seed, the same batch): "
        + ("loss and grad norm bit-identical" if same else
           f"NOT bit-identical: loss {loss.item()!r} vs {run['losses'][0].item()!r}, grad norm "
           f"{gnorm.item()!r} vs {run['grad_norms'][0].item()!r}; relative gaps {gaps}")
        + " (printed, not required)")
    out = {k: run[k] for k in ("launches", "step_ms", "peak_bytes", "tok_s")}
    out["repeat_bit_identical"] = same
    del run, params, m, batch
    _free()
    return out


def _has_dim(ev, n: int) -> bool:
    """Whether one of a profiler event's recorded input shapes has a
    dimension of ``n``."""
    return any(isinstance(shape, (list, tuple)) and n in shape
               for shape in (ev.input_shapes or ()))


@contextlib.contextmanager
def recorded_optimizer():
    """While open, the eager step's optimizer runs under a profiler range
    named ``OPTIMIZER_RANGE`` (``launch.train``'s step calls it by its
    module name)."""
    saved = train_cli.adamw_update_

    def recorded(*args, **kwargs):
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            return saved(*args, **kwargs)

    train_cli.adamw_update_ = recorded
    try:
        yield
    finally:
        train_cli.adamw_update_ = saved


def pixtral_op_groups(vocab: int) -> tuple:
    """The aten ops of pixtral's training step whose kernels the profile
    splits out (its input shapes recorded): the untied f32 unembed's three
    ``mm``, the forward's and the backward's two, each with an operand
    ``vocab`` wide; the plain attention VJP (every aten op under the
    ``_Attention`` node: the flash forward is no aten op); the optimizer;
    the other ops on vocab-wide tensors (the head's f32 cast and its
    gradient's, the cross-entropy and its backward); the layers' ``mm``."""
    return (
        ("the f32 unembed's mm", lambda ev: ev.name == "aten::mm" and _has_dim(ev, vocab)),
        ("the attention VJP", lambda ev: ev.name.startswith("aten::") and _in_attention(ev)),
        ("the optimizer", lambda ev: ev.name.startswith("aten::")
         and _under(ev, OPTIMIZER_RANGE)),
        ("other ops on vocab-wide tensors",
         lambda ev: ev.name.startswith("aten::") and _has_dim(ev, vocab)),
        ("the layers' mm", lambda ev: ev.name == "aten::mm"),
    )


def _loss_and_norm(cfg, params, batch, leaf: int) -> tuple:
    """``launch.train._loss_and_grads`` on the card: the loss, the norm of
    every gradient (one f32 norm a leaf, then the norm of those), and the
    largest |gradient| of leaf ``leaf`` and whether all of it is finite.
    The gradients are dropped before it returns."""
    loss, _, grads, _ = train_cli._loss_and_grads(cfg, params, batch)
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                 for g in grads]))
    top, finite = grads[leaf].abs().max().float(), torch.isfinite(grads[leaf]).all()
    del grads
    return loss.cpu(), norm.cpu(), top.item(), bool(finite)


def phase_train_pixtral() -> dict:
    """[train-pixtral]: the vlm pixtral-12b at its published widths (d
    5120, 32 heads over 8 kv heads of 128, d_ff 14336, untied vocab
    131072, the vision stub's ``frontend_proj`` (1024, 5120)) cut to its
    first 8 of 40 ``dense`` layers (``cut_layers``; random bf16 weights
    from the seed), 4 eager in-place steps at batch 1 x seq 4096 under
    remat ``"full"`` on ``cosine(3e-4, warmup=1, total=4)``, each batch
    with ``make_batch``'s 256 patches over the leading slots, which the
    reference's vlm loss masks out; then one more step under
    ``torch.profiler`` (input shapes recorded, the optimizer in a range of
    its own).  Each step: a finite loss equal to ``ce`` (aux 0: no
    router); flash_attention twice a layer (forward and the recompute) on
    the tensor-core kernel, rmsnorm 2 a layer and the final norm in the
    forward, 2 a layer in the recompute, on the block kernel (d 5120).
    Then, on the state after those steps, the loss and gradients of batch
    1 and of batch 1 with other labels under the patches: the same loss
    and grad norm bit for bit; ``frontend_proj``'s gradient finite and
    nonzero."""
    cfg = cut_layers(get_config(PIXTRAL), PIXTRAL_TRAIN_LAYERS)
    n, steps = cfg.num_layers, PIXTRAL_TRAIN_STEPS
    check(pm.layer_kinds(cfg) == ["dense"] * n and cfg.d_model == PIXTRAL_D
          and not cfg.tie_embeddings and cfg.frontend == "vision"
          and (TRAIN_BATCH, cfg.num_heads, cfg.num_kv_heads, TRAIN_SEQ, cfg.resolved_head_dim)
          == PIXTRAL_TRAIN_FLASH, f"{PIXTRAL} config {cfg}")
    log(f"[train-pixtral] {cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters at {n} of "
        f"{get_config(PIXTRAL).num_layers} layers, vocab {cfg.vocab_size} untied; state (bf16 "
        f"parameters and gradients, f32 moments) {12 * cfg.param_count() / 1e9:.2f} GB")
    run = train_steps("train-pixtral", cfg, cosine(3e-4, warmup=1, total=steps), steps,
                      TRAIN_SEQ)
    npatch = run["batches"][0]["patch_embeds"].shape[1]
    check(npatch == PIXTRAL_NPATCH and all(b["patch_embeds"].shape[1] == npatch
                                           for b in run["batches"]),
          f"[train-pixtral] patches {[tuple(b['patch_embeds'].shape) for b in run['batches']]}")
    for i, (loss, ce, aux) in enumerate(zip(run["losses"], run["ces"], run["auxs"])):
        check(torch.equal(loss, ce) and aux.item() == 0.0,
              f"[train-pixtral] step {i + 1}: loss {loss.item()!r} != ce {ce.item()!r} or aux "
              f"{aux.item()} != 0")
    text = TRAIN_BATCH * (TRAIN_SEQ - npatch)
    steady = float(np.median(run["step_ms"][1:]))
    log(f"[train-pixtral] loss = ce on every step (aux 0); {npatch} patches a row: "
        f"{text} positions of {TRAIN_BATCH * TRAIN_SEQ} in the loss, {text / steady * 1e3:.0f} "
        f"loss tokens/s ({run['tok_s']:.0f} tokens/s counting every position)")
    check_launches("train-pixtral", run["launches"],
                   {"flash_attention": steps * 2 * n, "rmsnorm": steps * ((2 * n + 1) + 2 * n)},
                   {"flash_attention": "wgmma", "rmsnorm": "block"})
    state, step_fn, batch = run.pop("state"), run.pop("step_fn"), run["batches"][0]
    with recorded_optimizer():
        profile_step(lambda: step_fn(state, batch), tag="train-pixtral",
                     op_groups=pixtral_op_groups(cfg.vocab_size), shapes=True)
    del step_fn
    _free()
    stub = next(i for i, t in enumerate(pytree.tree_leaves(state[0]))
                if t is state[0]["frontend_proj"])
    other = dict(batch, labels=batch["labels"].clone())
    other["labels"][:, :npatch] = (other["labels"][:, :npatch] + 1) % cfg.vocab_size
    loss_a, norm_a, top, finite = _loss_and_norm(cfg, state[0], batch, stub)
    _free()
    loss_b, norm_b, _, _ = _loss_and_norm(cfg, state[0], other, stub)
    check(torch.equal(loss_a, loss_b) and torch.equal(norm_a, norm_b),
          f"[train-pixtral] other labels under the {npatch} patches moved the loss or the grad "
          f"norm: {loss_a.item()!r} vs {loss_b.item()!r}, {norm_a.item()!r} vs "
          f"{norm_b.item()!r}")
    check(finite and top > 0, f"[train-pixtral] frontend_proj's gradient: max |g| {top}, "
                              f"finite {finite}")
    log(f"[train-pixtral] the patch mask: other labels under the {npatch} patches give the "
        f"same loss {loss_a.item():.6f} and grad norm {norm_a.item():.6f} bit for bit; "
        f"frontend_proj's gradient finite, max |g| {top:.4g}")
    out = {k: run[k] for k in ("launches", "step_ms", "peak_bytes", "tok_s")}
    del run, state, batch, other
    _free()
    return out


def _has_square(ev, n: int) -> bool:
    """Whether one of a profiler event's recorded input shapes has ``n``
    in two of its dimensions (an (n, n) score block)."""
    return any(isinstance(shape, (list, tuple)) and list(shape).count(n) >= 2
               for shape in (ev.input_shapes or ()))


def deepseek_op_groups(vocab: int, seq: int) -> tuple:
    """``pixtral_op_groups``' groups for deepseek's training step (the f32
    unembed's ``mm`` are those of its two unembeds; the attention VJP is
    the MTP layer's, the one layer that takes the attention op), with two
    more before the last two: MLA's plain attention (its bmm and the ops
    on its (seq, seq) scores: forward, recompute and VJP), then the rest
    of the MTP module (ops on its ``seq - 1`` positions: the concat,
    ``proj``, its layer, its norm, the second cross-entropy)."""
    base = pixtral_op_groups(vocab)
    return base[:3] + (
        ("MLA's plain attention", lambda ev: ev.name.startswith("aten::") and (
            _has_square(ev, seq) or (ev.name == "aten::bmm" and _has_dim(ev, seq)))),
        ("the rest of the MTP module",
         lambda ev: ev.name.startswith("aten::") and _has_dim(ev, seq - 1)),
    ) + base[3:]


def phase_train_deepseek() -> dict:
    """[train-deepseek]: deepseek-v3-671b at its published widths (d 7168,
    MLA with q_lora 1536, kv_lora 512, nope 128, rope 64, v 128 over 128
    heads, d_ff 18432, untied vocab 129280, ``mtp_depth`` 1) cut to its
    first 3 of 61 layers (``cut_layers``: its three ``mla_dense`` layers;
    random bf16 weights from the seed), 3 eager in-place steps at batch 1 x
    seq 2048 under remat ``"full"`` on ``cosine(3e-4, warmup=1, total=3)``
    and the reference's loss ``ce + 0.01 * aux + 0.3 * ce2``, where ``ce2``
    is the multi-token prediction's (the ``mtp`` module: ``proj``, one
    ``dense`` layer of 128 heads of 56 over 2047 positions, its norm, the
    second unembedding); then one more step under ``torch.profiler`` (input
    shapes recorded, the optimizer in a range of its own).  Each step: a
    finite loss, aux 0 (no router), ``ce2 = (loss - ce) / 0.3`` finite and
    positive; flash_attention once (the MTP layer's forward, outside the
    rematerialized stack; its backward is the plain VJP; MLA's attention
    is plain code) on the CUDA-core kernel; rmsnorm 16 times on the block
    kernel (ln1 and ln2 of each layer in the forward and the recompute,
    the final norm, the MTP layer's two norms and ``mtp.norm``) and 12 on
    the warp kernel (the query and key/value latents' norms, forward and
    recompute).  Then, on the state after those steps: every gradient leaf
    under ``mtp`` finite and nonzero, and ``embed``'s gradient other than
    the one the same batch gives with the MTP term taken out (its label
    embeddings)."""
    full = get_config(DEEPSEEK)
    cfg = cut_layers(full, DEEPSEEK_TRAIN_LAYERS)
    n, steps, seq = cfg.num_layers, DEEPSEEK_TRAIN_STEPS, DEEPSEEK_TRAIN_SEQ
    check(pm.layer_kinds(cfg) == ["mla_dense"] * DEEPSEEK_TRAIN_LAYERS and cfg.mtp_depth == 1
          and cfg.d_model == DEEPSEEK_D and not cfg.tie_embeddings and cfg.remat == "full"
          and (TRAIN_BATCH, cfg.num_heads, cfg.num_kv_heads, seq - 1, cfg.resolved_head_dim)
          == DEEPSEEK_MTP_FLASH, f"{DEEPSEEK} config {cfg}")
    spec = pm.model_spec(cfg)
    sizes = {k: sum(math.prod(leaf.shape) for leaf in pytree.tree_leaves(spec[k]))
             for k in spec}
    total = sum(sizes.values())
    log(f"[train-deepseek] {cfg.name}: {total / 1e9:.3f} B parameters at {n} of "
        f"{full.num_layers} layers (" + ", ".join(f"{k} {v / 1e9:.3f} B"
                                                    for k, v in sizes.items())
        + f"), vocab {cfg.vocab_size} untied; state (bf16 parameters and gradients, f32 "
        f"moments) {12 * total / 1e9:.2f} GB; the MTP layer's attention q, k, v "
        f"{DEEPSEEK_MTP_FLASH[:2] + DEEPSEEK_MTP_FLASH[3:]} over {cfg.num_kv_heads} kv heads")
    run = train_steps("train-deepseek", cfg, cosine(3e-4, warmup=1, total=steps), steps, seq)
    ce2s = []
    for i, (loss, ce, aux) in enumerate(zip(run["losses"], run["ces"], run["auxs"])):
        ce2 = (loss - ce).item() / 0.3
        ce2s.append(ce2)
        check(aux.item() == 0.0 and math.isfinite(ce2) and ce2 > 0,
              f"[train-deepseek] step {i + 1}: aux {aux.item()} (must be 0), ce2 = (loss - ce) "
              f"/ 0.3 = {ce2} (must be finite and > 0)")
    log(f"[train-deepseek] aux 0 on every step; ce by step "
        f"{[round(c.item(), 4) for c in run['ces']]}, ce2 = (loss - ce) / 0.3 by step "
        f"{[round(c, 4) for c in ce2s]} (ln V = {math.log(cfg.vocab_size):.4f})")
    check_launches("train-deepseek", run["launches"], {"flash_attention": steps},
                   {"flash_attention": "simt"})
    blocks, warps = steps * ((2 * n + 1) + 2 * n + 3), steps * 2 * (2 * n)
    check(run["launches"]["rmsnorm/block"] == blocks and run["launches"]["rmsnorm/warp"] == warps
          and run["launches"]["rmsnorm"] == blocks + warps,
          f"[train-deepseek] rmsnorm launches {run['launches']} (want {blocks} block and {warps} "
          f"warp)")
    state, step_fn, batch = run.pop("state"), run.pop("step_fn"), run["batches"][0]
    with recorded_optimizer():
        profile_step(lambda: step_fn(state, batch), tag="train-deepseek",
                     op_groups=deepseek_op_groups(cfg.vocab_size, seq), shapes=True)
    del step_fn
    _free()
    params = state[0]
    leaves = pytree.tree_leaves(params)
    mtp_ids = {id(t) for t in pytree.tree_leaves(params["mtp"])}
    mtp = [i for i, t in enumerate(leaves) if id(t) in mtp_ids]
    embed = next(i for i, t in enumerate(leaves) if t is params["embed"])
    loss, metrics, grads, _ = train_cli._loss_and_grads(cfg, params, batch)
    mtp_tops = [(grads[i].abs().max().float().item(), bool(torch.isfinite(grads[i]).all()))
                for i in mtp]
    g_embed = grads[embed]
    del grads
    _free()
    params0 = {k: v for k, v in params.items() if k != "mtp"}
    leaves0 = pytree.tree_leaves(params0)
    loss0, metrics0, grads0, _ = train_cli._loss_and_grads(cfg.scaled(mtp_depth=0), params0,
                                                           batch)
    g_embed0 = grads0[next(i for i, t in enumerate(leaves0) if t is params["embed"])]
    del grads0
    moved = (g_embed - g_embed0).abs().max().float().item()
    top = g_embed.abs().max().float().item()
    check(all(finite and t > 0 for t, finite in mtp_tops),
          f"[train-deepseek] mtp's gradients (max |g|, finite) {mtp_tops}")
    check(moved > 0, "[train-deepseek] embed's gradient is the same without the MTP term")
    log(f"[train-deepseek] on the state after {steps} steps: the {len(mtp)} gradient leaves under "
        f"mtp finite and nonzero (max |g| from {min(t for t, _ in mtp_tops):.4g} to "
        f"{max(t for t, _ in mtp_tops):.4g}); embed's gradient moves by up to {moved:.4g} "
        f"(its largest |g| {top:.4g}) when the MTP term is taken out; loss {loss.item():.6f} "
        f"with it, {loss0.item():.6f} without (ce {metrics['ce'].item():.6f} and "
        f"{metrics0['ce'].item():.6f})")
    out = {k: run[k] for k in ("launches", "step_ms", "peak_bytes", "tok_s")}
    out["ce2"] = ce2s
    del run, state, params, params0, batch, g_embed, g_embed0
    _free()
    return out


def phase_train_seamless() -> dict:
    """[train-seamless]: the encoder-decoder seamless-m4t-medium at its
    published widths and full depth (12 ``enc`` + 12 ``dec`` layers, d
    1024, 16 heads of 64 over 16 kv heads, d_ff 4096, untied vocab 256206,
    the audio stub's ``frontend_proj`` (1024, 1024); random bf16 weights
    from the seed), 3 eager in-place steps at batch 1 x 4096 tokens over
    ``make_batch``'s 4096 frames under remat ``"full"`` on
    ``cosine(3e-4, warmup=1, total=3)`` and the reference's enc-dec loss
    (the encoder on the frames, every ``dec`` layer cross-attending to its
    output); then one more step under ``torch.profiler`` (input shapes
    recorded, the optimizer in a range of its own).  Each step: a finite
    loss equal to ``ce`` (aux 0: no router); flash_attention twice (the
    forward and the recompute) for each encoder self-attention (not
    causal), each decoder self-attention (causal) and each cross-attention
    (not causal), 72 a step, all on the tensor-core kernel; rmsnorm twice
    for each of the encoder's 2 norms a layer and the decoder's 3, and
    once each for ``enc_norm`` and the final norm, 122 a step, all on the
    warp kernel (d 1024).  Then, on the state after those steps: every
    gradient leaf of ``frontend_proj``, the encoder layers, ``enc_norm``
    and each ``dec`` layer's ``cross`` weights finite and nonzero (the loss
    reaches the encoder only through the cross-attention), and the loss
    moved by other frames under the same tokens."""
    cfg = get_config(SEAMLESS)
    ne, nd, steps = len(pm.encoder_kinds(cfg)), len(pm.layer_kinds(cfg)), SEAMLESS_TRAIN_STEPS
    check(pm.encoder_kinds(cfg) == ["enc"] * 12 and pm.layer_kinds(cfg) == ["dec"] * 12
          and cfg.d_model == SEAMLESS_D and not cfg.tie_embeddings and cfg.remat == "full"
          and (TRAIN_BATCH, cfg.num_heads, cfg.num_kv_heads, TRAIN_SEQ, cfg.resolved_head_dim)
          == SEAMLESS_TRAIN_FLASH, f"{SEAMLESS} config {cfg}")
    spec = pm.model_spec(cfg)
    sizes = {k: sum(math.prod(leaf.shape) for leaf in pytree.tree_leaves(spec[k]))
             for k in spec}
    total = sum(sizes.values())
    log(f"[train-seamless] {cfg.name}: {total / 1e9:.6f} B parameters (param_count() "
        f"{cfg.param_count() / 1e9:.6f} B), {ne} enc + {nd} dec layers ("
        + ", ".join(f"{k} {v / 1e9:.4f} B" for k, v in sizes.items())
        + f"), vocab {cfg.vocab_size} untied; state (bf16 parameters and gradients, f32 "
        f"moments) {12 * total / 1e9:.2f} GB")
    with flash_options({}, key=lambda q, k, kw: (q.shape[2], k.shape[2],
                                                 kw.get("causal", True))) as opts:
        run = train_steps("train-seamless", cfg, cosine(3e-4, warmup=1, total=steps), steps,
                          TRAIN_SEQ)
    check(all(tuple(b["frames"].shape) == (TRAIN_BATCH, TRAIN_SEQ, cfg.frontend_dim)
              for b in run["batches"]),
          f"[train-seamless] frames {[tuple(b['frames'].shape) for b in run['batches']]}")
    for i, (loss, ce, aux) in enumerate(zip(run["losses"], run["ces"], run["auxs"])):
        check(torch.equal(loss, ce) and aux.item() == 0.0,
              f"[train-seamless] step {i + 1}: loss {loss.item()!r} != ce {ce.item()!r} or aux "
              f"{aux.item()} != 0")
    log(f"[train-seamless] loss = ce on every step (aux 0); losses "
        f"{[round(x.item(), 4) for x in run['losses']]} (ln V = {math.log(cfg.vocab_size):.4f})")
    check_launches("train-seamless", run["launches"],
                   {"flash_attention": steps * 2 * (ne + 2 * nd),
                    "rmsnorm": steps * (2 * (2 * ne + 3 * nd) + 2)},
                   {"flash_attention": "wgmma", "rmsnorm": "warp"})
    want = {(TRAIN_SEQ, TRAIN_SEQ, True): steps * 2 * nd,
            (TRAIN_SEQ, TRAIN_SEQ, False): steps * 2 * (ne + nd)}
    check(opts == want, f"[train-seamless] flash launches by (Sq, Sk, causal) {opts} != {want}")
    log(f"[train-seamless] flash launches by (Sq, Sk, causal): {opts}")
    state, step_fn, batch = run.pop("state"), run.pop("step_fn"), run["batches"][0]
    with recorded_optimizer():
        profile_step(lambda: step_fn(state, batch), tag="train-seamless",
                     op_groups=pixtral_op_groups(cfg.vocab_size), shapes=True)
    del step_fn
    _free()
    params = state[0]
    flat, _ = pytree.tree_flatten_with_path(params)
    names = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
             for path, _ in flat]
    watched = [i for i, n in enumerate(names)
               if n.split("/")[0] in ("frontend_proj", "enc_layers", "enc_norm")
               or (n.startswith("layers/") and n.split("/")[2] == "cross")]
    loss, _, grads, _ = train_cli._loss_and_grads(cfg, params, batch)
    tops = [(names[i], grads[i].abs().max().float().item(), bool(torch.isfinite(grads[i]).all()))
            for i in watched]
    del grads
    _free()
    bad = [(n, t, f) for n, t, f in tops if not (f and t > 0)]
    check(not bad and len(tops) == 1 + 9 * ne + 1 + 4 * nd,
          f"[train-seamless] gradients of the encoder, the stub and the cross-attention that are "
          f"zero or not finite: {bad} ({len(tops)} leaves watched)")
    other = dict(batch, frames=torch.roll(batch["frames"], 1, dims=1))
    with torch.no_grad():
        moved, _ = mdl.loss_fn(params, other, cfg)
    check(math.isfinite(moved.item()) and moved.item() != loss.item(),
          f"[train-seamless] other frames under the same tokens: loss {moved.item()!r} vs "
          f"{loss.item()!r}")
    log(f"[train-seamless] on the state after {steps} steps: the {len(tops)} gradient leaves of "
        f"frontend_proj, the encoder, enc_norm and the {nd} cross-attentions finite and nonzero "
        f"(max |g| from {min(t for _, t, _ in tops):.4g} to {max(t for _, t, _ in tops):.4g}); "
        f"the frames rolled by one position under the same tokens move the loss from "
        f"{loss.item():.6f} to {moved.item():.6f}")
    out = {k: run[k] for k in ("launches", "step_ms", "peak_bytes", "tok_s")}
    del run, state, params, batch, other
    _free()
    return out


def phase_small_mamba_reference() -> None:
    """A small float32 mamba2 (d_model 128, 2 layers, state 16, head dim 16,
    chunk 8, so rmsnorm and ssd_chunk both run) on the card (kernels)
    against the same model on the CPU (plain versions): prefill and decode
    logits, and one train step.  f32 everywhere (the conv windows the
    decode reads come from the prefill in f32), so the two differ by f32
    sums in other orders only: logits within 1e-4 * (1 + |logit|), loss
    rtol 1e-5, grad norm rtol 1e-4, parameters within 0.1 * lr (Adam divides
    each gradient by its own magnitude, so a near-zero gradient's rounding
    difference moves its update by up to lr)."""
    cfg = smoke_config(MAMBA).scaled(d_model=128, dtype="float32")
    cpu = _to(pm.init(cfg, torch.Generator().manual_seed(SEED), "cpu"), "cpu", torch.float32)
    cuda = _to(cpu, DEV)
    toks = torch.tensor([[5, 17, 42, 99, 7, 3, 11, 200, 31, 64, 2, 9, 77]], dtype=torch.int32)
    lc, cc = mdl.prefill(cpu, cfg, toks, mdl.init_cache(cfg, 1, 16, "cpu"))
    lg, cg = mdl.prefill(cuda, cfg, toks.to(DEV), mdl.init_cache(cfg, 1, 16, DEV))
    dc, _ = mdl.decode_step(cpu, cfg, toks[:, :1], cc)
    dg, _ = mdl.decode_step(cuda, cfg, toks[:, :1].to(DEV), cg)
    for name, want, got in (("prefill", lc, lg), ("decode", dc, dg)):
        err = (got.cpu() - want).abs()
        check(bool(err.le(1e-4 * (1 + want.abs())).all()),
              f"small mamba {name}: card vs CPU max err {err.max().item()}")
        log(f"[reference] small f32 mamba2 {name} logits: card (kernels) vs CPU (plain) max "
            f"err {err.max().item():.3g}")
    lr = 1e-3
    out = {}
    for dev, params in (("cpu", _to(cpu, "cpu")), (DEV, _to(cpu, DEV))):
        step = train_cli.make_step(cfg, constant(lr))
        (params, _), m = step((params, adamw_init(params)),
                              make_batch(cfg, 2, 64, seed=SEED, device=dev))
        out[dev] = (m["loss"].item(), m["grad_norm"].item(), pytree.tree_leaves(_to(params, "cpu")))
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[DEV]
    check(abs(lg - lc) <= 1e-5 * abs(lc), f"small mamba train loss card {lg} vs CPU {lc}")
    check(abs(gg - gc) <= 1e-4 * abs(gc), f"small mamba grad norm card {gg} vs CPU {gc}")
    perr = max((a - b).abs().max().item() for a, b in zip(pg, pc))
    check(perr <= 0.1 * lr, f"small mamba train step: parameters differ by {perr}")
    log(f"[reference] small f32 mamba2 train step: card (kernels) vs CPU (plain): loss "
        f"{lg:.6f} vs {lc:.6f}, grad norm {gg:.6f} vs {gc:.6f}, params max err {perr:.3g}")


def phase_small_train_reference() -> None:
    """One train step of a small float32 phi3 (d_model 128, seq 128, so both
    kernels run) on the card against the CPU (plain versions).  Loss within
    rtol 1e-5 and grad norm within 1e-4 (f32 sums in other orders; the
    kernel scales q before the product).  Parameters within 0.1 * lr: Adam
    divides each gradient by its own magnitude, so a near-zero gradient's
    rounding difference moves its update by up to lr."""
    cfg = smoke_config("phi3-mini-3.8b").scaled(d_model=128, head_dim=32, dtype="float32")
    lr = 1e-3
    base = _to(pm.init(cfg, torch.Generator().manual_seed(SEED), "cpu"), "cpu", torch.float32)
    out = {}
    for dev in ("cpu", DEV):
        params = _to(base, dev)
        step = train_cli.make_step(cfg, constant(lr))
        (params, _), m = step((params, adamw_init(params)),
                              make_batch(cfg, 2, 128, seed=SEED, device=dev))
        out[dev] = (m["loss"].item(), m["grad_norm"].item(),
                         pytree.tree_leaves(_to(params, "cpu")))
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[DEV]
    check(abs(lg - lc) <= 1e-5 * abs(lc), f"small train loss card {lg} vs CPU {lc}")
    check(abs(gg - gc) <= 1e-4 * abs(gc), f"small train grad norm card {gg} vs CPU {gc}")
    perr = max((a - b).abs().max().item() for a, b in zip(pg, pc))
    check(perr <= 0.1 * lr, f"small train step: parameters differ by {perr}")
    log(f"[reference] small f32 phi3 train step: card (kernels) vs CPU (plain): loss "
        f"{lg:.6f} vs {lc:.6f}, grad norm {gg:.6f} vs {gc:.6f}, params max err {perr:.3g}")


def logits_digest(logits: torch.Tensor) -> str:
    """A digest of a serving call's logits, bit for bit."""
    return hashlib.sha256(logits.detach().float().cpu().numpy().tobytes()).hexdigest()[:16]


class Digested(Counted):
    """``Counted`` that also keeps a digest of every call's logits, whether
    they are all finite, the call's rmsnorm launches by variant and
    ssd_chunk launches, and its flash_attention launches by variant, each
    taken after the call's time is read."""

    def __init__(self, fn):
        super().__init__(fn)
        self.digests: list[str] = []
        self.finite: list[bool] = []
        # ({rmsnorm variant: launches}, ssd_chunk launches) of each call
        self.launches: list[tuple[dict[str, int], int]] = []
        self.flash: list[dict[str, int]] = []       # {flash variant: launches} of each call

    def __call__(self, *args):
        before = counts()
        out = super().__call__(*args)
        after = counts()
        self.digests.append(logits_digest(out[0]))
        self.finite.append(bool(torch.isfinite(out[0]).all()))
        self.launches.append(({v: after[f"rmsnorm/{v}"] - before[f"rmsnorm/{v}"]
                               for v in rn_mod.VARIANTS},
                              after["ssd_chunk"] - before["ssd_chunk"]))
        self.flash.append({v: after[f"flash_attention/{v}"] - before[f"flash_attention/{v}"]
                           for v in fa_mod.VARIANTS})
        return out


def norms_per_call(cfg) -> dict[str, int]:
    """rmsnorm launches a full forward of the decoder makes, by variant: ln1
    of a mamba layer; ln1 and ln2 of an attention layer (and gemma2's two
    post norms; a ``dec`` layer's ``ln_cross``), at d_model; an MLA layer's
    query and key/value latent norms, at their ranks; the final norm.  A bf16 row (fresh, 16-byte aligned) takes the
    warp kernel up to ``MAX_WARP_D`` and the block kernel past it; rows
    narrower than 128 take the plain version (``layers.rmsnorm_fwd``) and
    launch nothing."""
    widths = [cfg.d_model]
    for kind in pm.layer_kinds(cfg):
        widths += [cfg.d_model] * (1 if kind == "mamba" else 4 if cfg.post_norms
                                   else 3 if kind == "dec" else 2)
        if kind.startswith("mla"):
            widths += [cfg.q_lora_rank, cfg.kv_lora_rank]
    out = dict.fromkeys(rn_mod.VARIANTS, 0)
    for d in widths:
        if d >= 128:
            out["warp" if d % 8 == 0 and d <= rn_mod.MAX_WARP_D else "block"] += 1
    return out


def ssd_variant(cfg) -> str:
    """The ssd_chunk variant a mamba layer of ``cfg`` launches in bf16: the
    tensor-core kernel takes only p 64 and n 128."""
    return ("mma" if (cfg.ssm_head_dim, cfg.ssm_state) == (ssd_mod.MMA_HEAD_DIM,
                                                           ssd_mod.MMA_STATE) else "simt")


def serve_dense(params, cfg, overlay, requests, max_len: int) -> dict:
    """``requests`` ((prompt tokens, new tokens), ...) through a
    ``ServeEngine`` at batch ``BATCH``: streams, launches, seconds, peak
    memory and the engine."""
    rng = np.random.default_rng(SEED)
    engine = ServeEngine(params, cfg, batch=BATCH, max_len=max_len, overlay=overlay,
                         device=DEV)
    engine._prefill, engine._decode = Digested(engine._prefill), Digested(engine._decode)
    for rid, (n, new) in enumerate(requests):
        prompt = rng.integers(0, cfg.vocab_size, size=(n,)).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()                           # the driven path starts here
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"streams": [r.out for r in sorted(done, key=lambda r: r.rid)],
            "launches": counts(), "seconds": dt, "engine": engine,
            "peak": torch.cuda.max_memory_allocated()}


def serve_arch(tag: str, cfg, requests, max_len: int, gen: torch.Generator,
               window_check: bool = False, params=None) -> dict:
    """One arch of the dense family or zamba2 at full width, random bf16
    weights from the seed, served through ``Overlay(3, 3)`` and plainly:
    the logits of every call bit-identical (digest) and finite, identical
    streams, rmsnorm launched once per norm every call on the variant each
    norm's width takes (:func:`norms_per_call`), ssd_chunk once
    per mamba layer every prefill call and never in decode, on the variant
    its state takes (:func:`ssd_variant`), one ``kernels/ssd`` node per
    mamba layer in each traced prefill, under 1 GiB left allocated after
    the phase.  Prints tok/s, host ms per call, trace and assembly seconds
    per signature, the peak memory and the distinct tokens of each stream.
    With ``window_check``: a plain prefill of the long prompt and the decode
    step after it, once more with ``sliding_window=None``, must give other
    logits (the window acts).  With ``params`` it serves the caller's
    weights and leaves them, and the memory check, to the caller.  Returns
    the overlay run's launches."""
    own = params is None
    if own:
        t0 = time.perf_counter()
        params = pm.init(cfg, gen, DEV)
        torch.cuda.synchronize()
        gb = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(params)) / 1e9
        log(f"[{tag}] {cfg.name}: {pm.count(params) / 1e9:.3f} B params (d_model "
            f"{cfg.d_model}, {cfg.num_layers} layers, bf16, {gb:.2f} GB) initialized in "
            f"{time.perf_counter() - t0:.1f}s")
    log(f"[{tag}] {cfg.name}: requests (prompt, new) {tuple(requests)}, batch {BATCH}, "
        f"max_len {max_len}")
    norms = norms_per_call(cfg)
    mamba = pm.layer_kinds(cfg).count("mamba")
    ssd_kind = ssd_variant(cfg)
    runs = {}
    for name, overlay in (("overlay", Overlay(3, 3)), ("plain", None)):
        r = serve_dense(params, cfg, overlay, requests, max_len)
        eng = r["engine"]
        calls = {"prefill": eng._prefill.calls, "decode": eng._decode.calls}
        n = r["launches"]
        ncalls = calls["prefill"] + calls["decode"]
        check(n["rmsnorm"] == sum(norms.values()) * ncalls
              and all(n[f"rmsnorm/{v}"] == k * ncalls for v, k in norms.items()),
              f"[{tag}] {cfg.name} {name}: rmsnorm launches {n} != {norms} x {calls}")
        per_call = {step: getattr(eng, f"_{step}").launches for step in calls}
        check(all(lc == (norms, mamba) for lc in per_call["prefill"])
              and all(lc == (norms, 0) for lc in per_call["decode"]),
              f"[{tag}] {cfg.name} {name}: (rmsnorm by variant, ssd_chunk) launches by call "
              f"{per_call}, "
              f"not ({norms}, {mamba}) a prefill and ({norms}, 0) a decode")
        check(n[f"ssd_chunk/{ssd_kind}"] == n["ssd_chunk"],
              f"[{tag}] {cfg.name} {name}: ssd_chunk launches {n}, not all on {ssd_kind}")
        check(all(eng._prefill.finite + eng._decode.finite),
              f"[{tag}] {cfg.name} {name}: non-finite logits")
        tokens = sum(len(st) for st in r["streams"])
        log(f"[{tag}] {cfg.name} {name}: {tokens} tokens in {r['seconds']:.2f}s "
            f"({tokens / r['seconds']:.2f} tok/s), calls {calls}, launches "
            f"{ {k: v for k, v in n.items() if v} }; host ms per call: prefill "
            f"{eng._prefill.by_length_ms()}; decode {eng._decode.by_length_ms()}")
        if overlay is not None:
            desc = overlay.describe()
            log(f"[{tag}] {cfg.name} overlay: traces {desc['traces']} "
                f"({desc['trace_seconds']:.1f}s), downloads {desc['downloads']}")
            for step in ("prefill", "decode"):
                for entry in getattr(eng, f"_{step}").fn._entries.values():
                    graph = entry.lowered.graph
                    toks = next(a.shape for a in graph.input_avals()
                                if a.dtype == torch.int32 and len(a.shape) == 2)
                    ssd = [nd.name for nd in graph.op_nodes()].count("kernels/ssd")
                    check(ssd == (mamba if step == "prefill" else 0),
                          f"[{tag}] a traced {cfg.name} {step} holds {ssd} kernels/ssd nodes")
                    log(f"[{tag}] {cfg.name} {step} signature tokens {toks}: trace "
                        f"{entry.trace_seconds:.2f} s, assemble {entry.assemble_seconds:.2f} s; "
                        f"{len(graph.op_nodes())} op nodes ({len(entry.lowered.unmapped)} "
                        f"residue, {ssd} kernels/ssd), "
                        f"{entry.acc.placement.total_passthrough} pass-through hops")
            overlay.close()
        runs[name] = dict(r, calls=calls, tokens=tokens,
                          digests=eng._prefill.digests + eng._decode.digests)
        del r, eng
        runs[name].pop("engine")
        gc.collect()
        torch.cuda.empty_cache()
    ov, pl = runs["overlay"], runs["plain"]
    check(ov["streams"] == pl["streams"],
          f"[{tag}] {cfg.name}: overlay and plain streams differ:\n{ov['streams']}\n{pl['streams']}")
    check(len(ov["digests"]) == len(pl["digests"]) and ov["digests"] == pl["digests"],
          f"[{tag}] {cfg.name}: overlay and plain logits differ on calls "
          f"{[i for i, (a, b) in enumerate(zip(ov['digests'], pl['digests'])) if a != b]}")
    check(all(len(st) == 1 + new and all(0 <= t < cfg.vocab_size for t in st)
              for st, (_, new) in zip(ov["streams"], requests)),
          f"[{tag}] {cfg.name}: unexpected token stream shape/range")
    log(f"[{tag}] {cfg.name} overlay / plain tok/s "
        f"{(ov['tokens'] / ov['seconds']) / (pl['tokens'] / pl['seconds']):.3f}; logits "
        f"bit-identical (digest) and finite on all {len(ov['digests'])} calls")
    log(f"[{tag}] {cfg.name} max_memory_allocated overlay {ov['peak'] / 2**30:.2f} GiB "
        f"({ov['peak'] / 1e9:.2f} GB), plain {pl['peak'] / 2**30:.2f} GiB "
        f"({pl['peak'] / 1e9:.2f} GB); streams {[st[:6] for st in ov['streams']]}...; "
        f"distinct tokens per stream {[len(set(st)) for st in ov['streams']]}")
    if window_check:
        n = GEMMA_LONG
        prompt = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
            0, cfg.vocab_size, size=(1, n)).astype(np.int32)).to(DEV)
        out = {}
        with torch.no_grad():
            for name, c in (("window", cfg), ("none", cfg.scaled(sliding_window=None))):
                lp, caches = mdl.prefill(params, c, prompt, mdl.init_cache(c, 1, max_len, DEV))
                ld = mdl.decode_step(params, c, prompt[:, -1:], caches)[0]
                out[name] = (lp.float(), ld.float())
                del lp, ld, caches
                gc.collect()
        dp, dd = ((a - b).abs().max().item() for a, b in zip(out["window"], out["none"]))
        check(all(bool(torch.isfinite(t).all()) for t in (*out["window"], *out["none"])),
              f"[{tag}] long-prompt logits not finite")
        check(dp > 1e-2 and dd > 1e-2,
              f"[{tag}] the window does not act: a {n}-token prefill and the decode after it "
              f"differ from no-window logits by {dp} and {dd}")
        log(f"[{tag}] the window acts: logits of a {n}-token prefill and the decode step after "
            f"it differ from no-window logits by max {dp:.4g} and {dd:.4g}")
        del out
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if own:
        left = torch.cuda.memory_allocated() / 2**30
        check(left < 1.0, f"[{tag}] {cfg.name}: {left:.2f} GiB still allocated after the phase")
        log(f"[{tag}] {cfg.name}: {left:.3f} GiB allocated after the phase")
    return {"launches": ov["launches"], "tok_s_overlay": ov["tokens"] / ov["seconds"],
            "tok_s_plain": pl["tokens"] / pl["seconds"]}


def phase_serve_gemma2(gen: torch.Generator) -> dict:
    """[serve-gemma2]: gemma2-27b at full width cut to its first
    ``GEMMA_SERVE_LAYERS`` layers (4 (local, global) units; local and global
    attention, softcaps 50 / 30, post norms, tied embeddings): every norm
    on the block kernel (d 4608 > ``MAX_WARP_D``), 4 a layer and the final
    norm a call, and the window acts on the 4352-token prompt."""
    full = get_config(GEMMA)
    cfg = cut_layers(full, GEMMA_SERVE_LAYERS)
    check(cfg.d_model == GEMMA_D and full.num_layers == 46
          and pm.layer_kinds(cfg) == ["local", "global"] * (GEMMA_SERVE_LAYERS // 2)
          and norms_per_call(cfg) == {"warp": 0, "block": 4 * cfg.num_layers + 1}
          and cfg.sliding_window == 4096 and GEMMA_LONG > cfg.sliding_window,
          f"{GEMMA} config {cfg}")
    log(f"[serve-gemma2] {GEMMA}: cut to {cfg.num_layers} of {full.num_layers} layers")
    return serve_arch("serve-gemma2", cfg, GEMMA_REQUESTS, GEMMA_MAX_LEN, gen,
                      window_check=True)


def phase_serve_archs(gen: torch.Generator) -> dict:
    """[serve-archs]: minicpm-2b at full width cut to 8 of its 40 layers
    (d 2304: the warp kernel, 17 launches a call; ``[train-minicpm]``
    keeps all 40) and mistral-large-123b at full width cut to 8 of its 88
    layers (d 12288: the block kernel, 17 a call), four (16, 8) requests
    each; the launch counts come from each cut config."""
    out = {}
    for arch, layers in DENSE_ARCHS:
        cfg = get_config(arch)
        if layers is not None:
            full = sum(math.prod(sp.shape) * sp.dtype.itemsize
                       for sp in pytree.tree_leaves(pm.model_spec(cfg)))
            log(f"[serve-archs] {arch}: cut to {layers} of {cfg.num_layers} layers "
                f"(the full depth is {full / 1e9:.0f} GB in bf16)")
            cfg = cut_layers(cfg, layers)
        out[arch] = serve_arch("serve-archs", cfg, ((PROMPT, MAX_NEW),) * REQUESTS, MAX_LEN, gen)
    return out


def phase_serve_zamba2(gen: torch.Generator) -> dict:
    """[serve-zamba2]: zamba2-7b at full width cut to its first
    ``ZAMBA_SERVE_LAYERS`` layers (``cut_layers``: the leading group of 3
    mamba layers and 2 of the 13 (5 mamba, shared_attn) units, so 13 mamba
    layers at state 64 and 2 occurrences of the one shared attention+MLP
    set, each with its own KV cache): rmsnorm once a mamba layer, twice a
    shared_attn occurrence and once for the final norm a call, on the warp
    kernel (d 3584), ssd_chunk once a mamba layer a prefill on the
    CUDA-core kernel and never a decode, counts derived from the cut
    config."""
    full = get_config(ZAMBA)
    cfg = cut_layers(full, ZAMBA_SERVE_LAYERS)
    kinds = pm.layer_kinds(cfg)
    mamba, shared = kinds.count("mamba"), kinds.count("shared_attn")
    check(cfg.d_model == ZAMBA_D and len(kinds) == ZAMBA_SERVE_LAYERS
          and kinds == pm.layer_kinds(full)[:ZAMBA_SERVE_LAYERS] and shared >= 1
          and norms_per_call(cfg) == {"warp": mamba + 2 * shared + 1, "block": 0}
          and ssd_variant(cfg) == "simt", f"{ZAMBA} config {cfg}")
    spec = pm.model_spec(cfg)
    log(f"[serve-zamba2] {ZAMBA}: cut to {len(kinds)} of {full.num_layers} layers ({mamba} "
        f"mamba, {shared} shared_attn occurrences); {len(spec['layers'])} per-layer weight sets "
        f"and {len(spec['shared'])} shared set ({list(spec['shared'])}) read by {shared} "
        f"occurrences")
    return serve_arch("serve-zamba2", cfg, ZAMBA_REQUESTS, ZAMBA_MAX_LEN, gen)


def phase_serve_granite(gen: torch.Generator) -> dict:
    """[serve-granite]: granite-moe-1b-a400m at full width and all 24 layers
    (32 experts, top-8, capacity factor 1.25, tied embeddings): 49 rmsnorm
    launches a call on the warp kernel (d 1024), no ssd_chunk and no
    flash_attention (serving's attention reads a KV cache: plain code, as
    the reference's).  A batch-2 decode routes its two rows with capacity
    1, so the second row loses each expert the first also chose, as in the
    reference; overlay and plain must still agree bit for bit."""
    cfg = get_config(GRANITE)
    kinds = pm.layer_kinds(cfg)
    check(cfg.d_model == GRANITE_D and kinds == ["moe"] * 24
          and norms_per_call(cfg) == {"warp": 49, "block": 0}
          and (cfg.num_experts, cfg.experts_per_token) == (32, 8)
          and GRANITE_FLASH[1:] == (cfg.num_heads, cfg.num_kv_heads, GRANITE_LONG,
                                    cfg.resolved_head_dim), f"{GRANITE} config {cfg}")
    caps = {n: int(n * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor) + 1
            for n in (BATCH, PROMPT, GRANITE_LONG)}
    log(f"[serve-granite] {GRANITE}: {cfg.param_count() / 1e9:.3f} B params in all, "
        f"{cfg.active_param_count() / 1e9:.3f} B active a token ({cfg.experts_per_token} of "
        f"{cfg.num_experts} experts); expert capacity by tokens a call {caps}")
    out = serve_arch("serve-granite", cfg, GRANITE_REQUESTS, GRANITE_MAX_LEN, gen)
    check(out["launches"]["flash_attention"] == 0 and out["launches"]["ssd_chunk"] == 0,
          f"[serve-granite] launches {out['launches']}")
    return out


def phase_serve_deepseek(gen: torch.Generator) -> dict:
    """[serve-deepseek]: deepseek-v3-671b at full width cut to its first 4
    layers (3 ``mla_dense``, 1 ``mla_moe``: 256 experts, top-8, one shared
    expert, sigmoid scoring): 17 rmsnorm launches a call, 9 on the block
    kernel (ln1, ln2 and the final norm at d 7168) and 8 on the warp
    kernel (the query latent at 1536 and the key/value latent at 512), no
    ssd_chunk and no flash_attention (MLA attends over its latent cache in
    plain code, as the reference does).  A batch-2 decode and a 16-token
    prompt route with expert capacity 1, the 2048-token prompt with 81.
    Then the plain steps once more, each ended by a synchronize (the
    engine's host times end before the card does): a 2048-token prefill
    and a batch-2 ragged decode, the decode beside its bound, the
    weights it reads once."""
    full = get_config(DEEPSEEK)
    cfg = cut_layers(full, DEEPSEEK_LAYERS)
    check(cfg.d_model == DEEPSEEK_D and cfg.num_heads == 128
          and (cfg.q_lora_rank, cfg.kv_lora_rank) == (DEEPSEEK_Q_LORA, DEEPSEEK_KV_LORA)
          and pm.layer_kinds(cfg) == ["mla_dense"] * 3 + ["mla_moe"]
          and (cfg.num_experts, cfg.experts_per_token, cfg.num_shared_experts,
               cfg.router_scoring) == (256, 8, 1, "sigmoid")
          and norms_per_call(cfg) == {"warp": 8, "block": 9}, f"{DEEPSEEK} config {cfg}")
    leaves = pytree.tree_leaves(pm.model_spec(full))
    caps = {n: int(n * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor) + 1
            for n in (BATCH, PROMPT, DEEPSEEK_LONG)}
    log(f"[serve-deepseek] {DEEPSEEK}: cut to {DEEPSEEK_LAYERS} of {full.num_layers} layers "
        f"(all {full.num_layers}: {full.param_count() / 1e9:.1f} B params, "
        f"{sum(math.prod(sp.shape) * sp.dtype.itemsize for sp in leaves) / 1e12:.2f} TB in "
        f"bf16); the cut: {cfg.param_count() / 1e9:.3f} B params by param_count(), "
        f"{cfg.active_param_count() / 1e9:.3f} B active a token; latent cache "
        f"{(cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2} B a token a layer; expert capacity "
        f"by tokens a call {caps}")
    out = serve_arch("serve-deepseek", cfg, DEEPSEEK_REQUESTS, DEEPSEEK_MAX_LEN, gen)
    check(out["launches"]["flash_attention"] == 0 and out["launches"]["ssd_chunk"] == 0,
          f"[serve-deepseek] launches {out['launches']}")
    params = pm.init(cfg, gen, DEV)
    prompt = torch.randint(0, cfg.vocab_size, (1, DEEPSEEK_LONG), generator=gen, device=DEV,
                           dtype=torch.int64).to(torch.int32)
    with torch.no_grad():
        prefill = [_sync_ms(lambda: mdl.prefill(params, cfg, prompt, mdl.init_cache(
            cfg, 1, DEEPSEEK_MAX_LEN, DEV)))[0] for _ in range(2)]
        caches = mdl.init_cache(cfg, BATCH, DEEPSEEK_MAX_LEN, DEV)
        tok = prompt[:, :1].expand(BATCH, 1).contiguous()
        pos = torch.tensor([PROMPT, DEEPSEEK_LONG], dtype=torch.int32, device=DEV)
        host, synced = _decode_ms(lambda i: mdl.decode_step(params, cfg, tok, caches,
                                                            positions=pos))
    # the weights a decode call reads: all but the embedding (two rows
    # gathered) and the multi-token-prediction module (not run)
    read = sum(t.numel() * t.element_size() for k, v in params.items()
               if k not in ("embed", "mtp") for t in pytree.tree_leaves(v))
    log(f"[serve-deepseek] plain steps ended by a synchronize: a {DEEPSEEK_LONG}-token prefill "
        f"{prefill[1]:.1f} ms (first {prefill[0]:.1f}); a batch-{BATCH} decode {synced:.2f} ms "
        f"a call (the host issues it in {host:.2f} ms), against {read / 1e9:.2f} GB of weights "
        f"read once: {read / HBM_BYTES_PER_S * 1e3:.2f} ms")
    del params, prompt, caches, tok, pos
    gc.collect()
    torch.cuda.empty_cache()
    return out


def seamless_rounds(cfg) -> list:
    """The two rounds of ``[serve-seamless]``: (the decoder prompt (BATCH, 2)
    int32, frames (BATCH, S, 1024) bf16, new tokens), numpy draws from the
    seed."""
    rng = np.random.default_rng(SEED)
    out = []
    for n, new in SEAMLESS_ROUNDS:
        frames = rng.standard_normal((BATCH, n, cfg.frontend_dim))
        prompt = rng.integers(0, cfg.vocab_size, size=(BATCH, SEAMLESS_PROMPT))
        out.append((torch.from_numpy(prompt.astype(np.int32)).to(DEV),
                    torch.from_numpy(frames).to(torch.bfloat16).to(DEV), new))
    return out


def serve_api(params, cfg, overlay, rounds, stub: str, max_len: int) -> dict:
    """Each round (prompt, the stub's input, new tokens) through
    ``prefill(prompt, **{stub: input})`` (``enc_in`` frames, or
    ``patch_embeds``) and ``new`` greedy ``decode_step`` calls on a fresh
    cache of ``max_len``; with an overlay both steps go through
    ``overlay.jit`` as ``ServeEngine`` traces its own (a quarter of the
    fabric each).  Returns the streams, the launches, the seconds, the peak
    memory and the two wrapped steps."""
    pf = lambda p, t, c, x: mdl.prefill(p, cfg, t, c, **{stub: x})
    dec = lambda p, t, c: mdl.decode_step(p, cfg, t, c)
    if overlay is not None:
        budget = max(1, overlay.grid.num_tiles // 4)
        pf = overlay.jit(pf, name=f"{cfg.name}.prefill", tile_budget=budget)
        dec = overlay.jit(dec, name=f"{cfg.name}.decode", tile_budget=budget)
    pf, dec = Digested(pf), Digested(dec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()                           # the driven path starts here
    t0 = time.perf_counter()
    streams = []
    for prompt, stub_in, new in rounds:
        caches = mdl.init_cache(cfg, BATCH, max_len, DEV)
        logits, caches = pf(params, prompt, caches, stub_in)
        toks = [torch.argmax(logits, -1).to(torch.int32)]
        for _ in range(new):
            logits, caches = dec(params, toks[-1][:, None], caches)
            toks.append(torch.argmax(logits, -1).to(torch.int32))
        streams += torch.stack(toks, 1).tolist()
        del caches, logits
    torch.cuda.synchronize()
    return {"streams": streams, "launches": counts(), "seconds": time.perf_counter() - t0,
            "peak": torch.cuda.max_memory_allocated(), "prefill": pf, "decode": dec}


def phase_serve_seamless(gen: torch.Generator) -> dict:
    """[serve-seamless]: the encoder-decoder seamless-m4t-medium at full
    width and depth (12 ``enc`` + 12 ``dec`` layers, GELU, untied vocab of
    256206; random bf16 weights from the seed) through the model API, as
    no engine serves it (the reference's engine passes no encoder input):
    two rounds of frames (1024, then 4096) with a 2-token decoder prompt
    and 16, then 32 greedy decodes, through ``Overlay(3, 3).jit`` and
    plainly.  The logits of every call bit-identical (digest) and finite,
    identical streams; rmsnorm 62 times a prefill (the encoder's 2 x 12 and
    ``enc_norm``, the decoder's 3 x 12 and the final norm) and 37 times a
    decode, all on the warp kernel (d 1024); flash_attention 12 times a
    prefill, all on the tensor-core kernel (the encoder's non-causal
    self-attention), none a decode (the decoder's self- and
    cross-attention read caches: plain code, as the reference's); no
    ssd_chunk; 12 ``kernels/attention`` nodes in each traced prefill, two
    prefill signatures and one decode signature; under 1 GiB left.  Then
    the plain steps once more, each ended by a synchronize: a 4096-frame
    prefill and a batch-2 decode, the decode beside the time to read its
    weights and the caches it attends over once."""
    cfg = get_config(SEAMLESS)
    enc, kinds = pm.encoder_kinds(cfg), pm.layer_kinds(cfg)
    decoder_norms = norms_per_call(cfg)
    check(cfg.d_model == SEAMLESS_D and enc == ["enc"] * 12 and kinds == ["dec"] * 12
          and (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) ==
          (SEAMLESS_HEADS, SEAMLESS_HEADS, SEAMLESS_HEAD_DIM)
          and decoder_norms == {"warp": 37, "block": 0}
          and fa_mod.variant(torch.bfloat16, cfg.resolved_head_dim) == "wgmma"
          and all(n <= SEAMLESS_MAX_LEN for n, _ in SEAMLESS_ROUNDS), f"{SEAMLESS} config {cfg}")
    want = {"prefill": ({"warp": 2 * len(enc) + 1 + decoder_norms["warp"], "block": 0}, 0,
                        {"wgmma": len(enc), "simt": 0}),
            "decode": (decoder_norms, 0, {"wgmma": 0, "simt": 0})}
    t0 = time.perf_counter()
    params = pm.init(cfg, gen, DEV)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(params)) / 1e9
    rounds = seamless_rounds(cfg)
    log(f"[serve-seamless] {cfg.name}: {pm.count(params) / 1e9:.3f} B params "
        f"({cfg.param_count() / 1e9:.3f} B by param_count(), d_model {cfg.d_model}, "
        f"{len(enc)} enc + {len(kinds)} dec layers, bf16, {gb:.2f} GB) initialized in "
        f"{time.perf_counter() - t0:.1f}s; rounds (frames, prompt, new) "
        f"{[(f.shape[1], p.shape[1], n) for p, f, n in rounds]}, batch {BATCH}, max_len "
        f"{SEAMLESS_MAX_LEN}")
    runs = {}
    for name, overlay in (("overlay", Overlay(3, 3)), ("plain", None)):
        r = serve_api(params, cfg, overlay, rounds, "enc_in", SEAMLESS_MAX_LEN)
        pf, dec = r["prefill"], r["decode"]
        for step, fn in (("prefill", pf), ("decode", dec)):
            got = [(norms, ssd, flash) for (norms, ssd), flash in zip(fn.launches, fn.flash)]
            check(all(g == want[step] for g in got),
                  f"[serve-seamless] {name}: (rmsnorm by variant, ssd_chunk, flash_attention by "
                  f"variant) launches of each {step} call {got}, not {want[step]}")
        check(all(pf.finite + dec.finite), f"[serve-seamless] {name}: non-finite logits")
        n = r["launches"]
        tokens = sum(len(st) for st in r["streams"])
        log(f"[serve-seamless] {cfg.name} {name}: {tokens} tokens in {r['seconds']:.2f}s "
            f"({tokens / r['seconds']:.2f} tok/s), calls prefill {pf.calls} decode {dec.calls}, "
            f"launches { {k: v for k, v in n.items() if v} }; host ms a prefill (1024, 4096 "
            f"frames) {[round(t * 1e3, 1) for t in pf.seconds]}; decode {dec.split_ms()}")
        if overlay is not None:
            desc = overlay.describe()
            log(f"[serve-seamless] {cfg.name} overlay: traces {desc['traces']} "
                f"({desc['trace_seconds']:.1f}s), downloads {desc['downloads']}")
            sigs = {"prefill": list(pf.fn._entries.values()),
                    "decode": list(dec.fn._entries.values())}
            check(len(sigs["prefill"]) == 2 and len(sigs["decode"]) == 1,
                  f"[serve-seamless] signatures {({k: len(v) for k, v in sigs.items()})}, not "
                  f"two prefills and one decode")
            for step, entries in sigs.items():
                for entry in entries:
                    graph = entry.lowered.graph
                    frames = [tuple(a.shape) for a in graph.input_avals() if len(a.shape) == 3
                              and a.shape[-1] == cfg.frontend_dim]
                    attn = [nd.name for nd in graph.op_nodes()].count("kernels/attention")
                    check(attn == (len(enc) if step == "prefill" else 0),
                          f"[serve-seamless] a traced {step} holds {attn} kernels/attention nodes")
                    log(f"[serve-seamless] {cfg.name} {step} signature frames {frames}: trace "
                        f"{entry.trace_seconds:.2f} s, assemble {entry.assemble_seconds:.2f} s; "
                        f"{len(graph.op_nodes())} op nodes ({len(entry.lowered.unmapped)} "
                        f"residue, {attn} kernels/attention), "
                        f"{entry.acc.placement.total_passthrough} pass-through hops")
            overlay.close()
        runs[name] = dict(r, tokens=tokens, digests=pf.digests + dec.digests,
                          calls=pf.calls + dec.calls)
        for key in ("prefill", "decode"):
            runs[name].pop(key)
        del r, pf, dec
        gc.collect()
        torch.cuda.empty_cache()
    ov, pl = runs["overlay"], runs["plain"]
    check(ov["streams"] == pl["streams"],
          f"[serve-seamless] overlay and plain streams differ:\n{ov['streams']}\n{pl['streams']}")
    check(len(ov["digests"]) == len(pl["digests"]) == ov["calls"]
          and ov["digests"] == pl["digests"],
          f"[serve-seamless] overlay and plain logits differ on calls "
          f"{[i for i, (a, b) in enumerate(zip(ov['digests'], pl['digests'])) if a != b]}")
    check(all(all(0 <= t < cfg.vocab_size for t in st) for st in ov["streams"])
          and [len(st) for st in ov["streams"]] ==
          [1 + new for _, new in SEAMLESS_ROUNDS for _ in range(BATCH)],
          f"[serve-seamless] unexpected token stream shape/range")
    log(f"[serve-seamless] {cfg.name} overlay / plain tok/s "
        f"{(ov['tokens'] / ov['seconds']) / (pl['tokens'] / pl['seconds']):.3f}; logits "
        f"bit-identical (digest) and finite on all {len(ov['digests'])} calls; "
        f"max_memory_allocated overlay {ov['peak'] / 2**30:.2f} GiB ({ov['peak'] / 1e9:.2f} GB), "
        f"plain {pl['peak'] / 2**30:.2f} GiB; streams {[st[:6] for st in ov['streams']]}...; "
        f"distinct tokens per stream {[len(set(st)) for st in ov['streams']]}")
    prompt, frames, _ = rounds[1]
    with torch.no_grad():
        prefill = [_sync_ms(lambda: mdl.prefill(params, cfg, prompt, mdl.init_cache(
            cfg, BATCH, SEAMLESS_MAX_LEN, DEV), enc_in=frames))[0] for _ in range(2)]
        _, caches = mdl.prefill(params, cfg, prompt, mdl.init_cache(
            cfg, BATCH, SEAMLESS_MAX_LEN, DEV), enc_in=frames)
        tok = prompt[:, :1].contiguous()
        host, synced = _decode_ms(lambda i: mdl.decode_step(params, cfg, tok, caches))
    # what a decode call reads once: the decoder's weights and the head (the
    # embedding gives two rows; the encoder and frontend_proj do not run),
    # and every self and cross cache slot (the plain attention reads all of
    # max_len and masks)
    read = sum(t.numel() * t.element_size() for k, v in params.items()
               if k in ("layers", "final_norm", "lm_head") for t in pytree.tree_leaves(v))
    cache_bytes = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(caches))
    log(f"[serve-seamless] plain steps ended by a synchronize: a {frames.shape[1]}-frame "
        f"prefill (batch {BATCH}, {SEAMLESS_PROMPT}-token prompt) {prefill[1]:.1f} ms (first "
        f"{prefill[0]:.1f}); a batch-{BATCH} decode {synced:.2f} ms a call (the host issues it "
        f"in {host:.2f} ms), against {read / 1e9:.3f} GB of weights read once: "
        f"{read / HBM_BYTES_PER_S * 1e3:.3f} ms, and {cache_bytes / 1e9:.3f} GB of caches: "
        f"{(read + cache_bytes) / HBM_BYTES_PER_S * 1e3:.3f} ms for both")
    del params, caches, tok, rounds, frames, prompt
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    check(left < 1.0, f"[serve-seamless] {left:.2f} GiB still allocated after the phase")
    log(f"[serve-seamless] {cfg.name}: {left:.3f} GiB allocated after the phase")
    return {"launches": ov["launches"], "tok_s_overlay": ov["tokens"] / ov["seconds"],
            "tok_s_plain": pl["tokens"] / pl["seconds"], "prefill_ms": prefill[1],
            "decode_ms": synced}


def pixtral_rounds(cfg) -> list:
    """The two model-API rounds of ``[serve-pixtral]``: (the prompt (BATCH,
    S) int32, the patches (BATCH, 256, 1024) bf16, new tokens), numpy draws
    from the seed; 256 patches is ``make_batch``'s count at both S."""
    rng = np.random.default_rng(SEED)
    out = []
    for n, new in PIXTRAL_ROUNDS:
        npatch = batch_specs(cfg, BATCH, n, DEV)["patch_embeds"].shape[1]
        check(npatch == PIXTRAL_NPATCH, f"[serve-pixtral] {npatch} patches at {n} tokens")
        prompt = rng.integers(0, cfg.vocab_size, size=(BATCH, n))
        patches = rng.standard_normal((BATCH, npatch, cfg.frontend_dim))
        out.append((torch.from_numpy(prompt.astype(np.int32)).to(DEV),
                    torch.from_numpy(patches).to(torch.bfloat16).to(DEV), new))
    return out


def phase_serve_pixtral(gen: torch.Generator) -> dict:
    """[serve-pixtral]: the vlm pixtral-12b at full width cut to the first
    ``PIXTRAL_SERVE_LAYERS`` of its 40 ``dense`` layers (d 5120, 32 heads
    over 8 kv heads of 128, untied vocab 131072, the vision stub's
    ``frontend_proj``; random bf16 weights from the seed), one set of
    weights served two ways, each through
    ``Overlay(3, 3)`` and plainly: as text through ``ServeEngine``
    (:func:`serve_arch`, as the reference's engine serves it), and through
    the model API with 256 patches over the leading slots of a 512-token
    prompt (16 greedy decodes), then of a 2048-token one (32), at batch 2,
    max_len 4096 (:func:`serve_api`).  Each way: the logits of every call
    bit-identical (digest) and finite, identical streams, rmsnorm 2 a layer
    and the final norm a call on the block kernel (d 5120), no flash_attention and no
    ssd_chunk (cached attention is plain code, as the reference's); one
    decode and two prefill signatures through the model API, the patches an
    input of each traced prefill.  Then, plainly: the stub acts (the
    512-token prompt without its patches gives another digest) and the
    tokens under the patches do not (new ids in the 256 slots give the
    same bits); the 2048-token prefill and a batch-2 decode, each ended by
    a synchronize, the decode beside the time to read its weights once;
    under 1 GiB left."""
    full = get_config(PIXTRAL)
    cfg = cut_layers(full, PIXTRAL_SERVE_LAYERS)
    norms = norms_per_call(cfg)
    check(cfg.d_model == PIXTRAL_D and pm.layer_kinds(full) == ["dense"] * 40
          and pm.layer_kinds(cfg) == ["dense"] * PIXTRAL_SERVE_LAYERS
          and cfg.frontend == "vision" and norms == {"warp": 0, "block": 2 * cfg.num_layers + 1}
          and PIXTRAL_FLASH[1:] == (cfg.num_heads, cfg.num_kv_heads, PIXTRAL_ROUNDS[1][0],
                                    cfg.resolved_head_dim)
          and fa_mod.variant(torch.bfloat16, cfg.resolved_head_dim) == "wgmma",
          f"{PIXTRAL} config {cfg}")
    t0 = time.perf_counter()
    params = pm.init(cfg, gen, DEV)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(params)) / 1e9
    kv = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    log(f"[serve-pixtral] {cfg.name}: {pm.count(params) / 1e9:.3f} B params "
        f"({cfg.param_count() / 1e9:.3f} B by param_count(), frontend_proj "
        f"{tuple(params['frontend_proj'].shape)}; d_model {cfg.d_model}, cut to "
        f"{cfg.num_layers} of {full.num_layers} layers, bf16, {gb:.2f} GB) initialized in "
        f"{time.perf_counter() - t0:.1f}s; KV cache "
        f"{kv} B a token, {kv * BATCH * PIXTRAL_MAX_LEN / 1e9:.2f} GB at batch {BATCH} and "
        f"max_len {PIXTRAL_MAX_LEN}")
    engine = serve_arch("serve-pixtral", cfg, ((PROMPT, MAX_NEW),) * REQUESTS, MAX_LEN, gen,
                        params=params)
    check(engine["launches"]["flash_attention"] == 0 and engine["launches"]["ssd_chunk"] == 0,
          f"[serve-pixtral] engine launches {engine['launches']}")
    rounds = pixtral_rounds(cfg)
    log(f"[serve-pixtral] model API rounds (prompt, patches, new) "
        f"{[(p.shape[1], pe.shape[1], n) for p, pe, n in rounds]}, batch {BATCH}, max_len "
        f"{PIXTRAL_MAX_LEN}")
    want = (norms, 0, {"wgmma": 0, "simt": 0})
    runs = {}
    for name, overlay in (("overlay", Overlay(3, 3)), ("plain", None)):
        r = serve_api(params, cfg, overlay, rounds, "patch_embeds", PIXTRAL_MAX_LEN)
        pf, dec = r["prefill"], r["decode"]
        for step, fn in (("prefill", pf), ("decode", dec)):
            got = [(n_, ssd, flash) for (n_, ssd), flash in zip(fn.launches, fn.flash)]
            check(all(g == want for g in got),
                  f"[serve-pixtral] {name}: (rmsnorm by variant, ssd_chunk, flash_attention by "
                  f"variant) launches of each {step} call {got}, not {want}")
        check(all(pf.finite + dec.finite), f"[serve-pixtral] {name}: non-finite logits")
        n = r["launches"]
        tokens = sum(len(st) for st in r["streams"])
        log(f"[serve-pixtral] {cfg.name} patches {name}: {tokens} tokens in {r['seconds']:.2f}s "
            f"({tokens / r['seconds']:.2f} tok/s), calls prefill {pf.calls} decode {dec.calls}, "
            f"launches { {k: v for k, v in n.items() if v} }; host ms a prefill (512, 2048 "
            f"tokens) {[round(t * 1e3, 1) for t in pf.seconds]}; decode {dec.split_ms()}")
        if overlay is not None:
            desc = overlay.describe()
            log(f"[serve-pixtral] {cfg.name} patches overlay: traces {desc['traces']} "
                f"({desc['trace_seconds']:.1f}s), downloads {desc['downloads']}")
            sigs = {"prefill": list(pf.fn._entries.values()),
                    "decode": list(dec.fn._entries.values())}
            check(len(sigs["prefill"]) == 2 and len(sigs["decode"]) == 1,
                  f"[serve-pixtral] signatures {({k: len(v) for k, v in sigs.items()})}, not "
                  f"two prefills and one decode")
            for step, entries in sigs.items():
                for entry in entries:
                    graph = entry.lowered.graph
                    patches = [tuple(a.shape) for a in graph.input_avals() if len(a.shape) == 3
                               and a.shape[-1] == cfg.frontend_dim]
                    toks = next(a.shape for a in graph.input_avals()
                                if a.dtype == torch.int32 and len(a.shape) == 2)
                    check(patches == ([(BATCH, PIXTRAL_NPATCH, cfg.frontend_dim)]
                                      if step == "prefill" else []),
                          f"[serve-pixtral] a traced {step} takes patch inputs {patches}")
                    log(f"[serve-pixtral] {cfg.name} {step} signature tokens {tuple(toks)}, "
                        f"patches {patches}: trace {entry.trace_seconds:.2f} s, assemble "
                        f"{entry.assemble_seconds:.2f} s; {len(graph.op_nodes())} op nodes "
                        f"({len(entry.lowered.unmapped)} residue), "
                        f"{entry.acc.placement.total_passthrough} pass-through hops")
            overlay.close()
        runs[name] = dict(r, tokens=tokens, digests=pf.digests + dec.digests,
                          prefill_digests=pf.digests, calls=pf.calls + dec.calls)
        for key in ("prefill", "decode"):
            runs[name].pop(key)
        del r, pf, dec
        gc.collect()
        torch.cuda.empty_cache()
    ov, pl = runs["overlay"], runs["plain"]
    check(ov["streams"] == pl["streams"],
          f"[serve-pixtral] overlay and plain streams differ:\n{ov['streams']}\n{pl['streams']}")
    check(len(ov["digests"]) == len(pl["digests"]) == ov["calls"]
          and ov["digests"] == pl["digests"],
          f"[serve-pixtral] overlay and plain logits differ on calls "
          f"{[i for i, (a, b) in enumerate(zip(ov['digests'], pl['digests'])) if a != b]}")
    check(all(all(0 <= t < cfg.vocab_size for t in st) for st in ov["streams"])
          and [len(st) for st in ov["streams"]] ==
          [1 + new for _, new in PIXTRAL_ROUNDS for _ in range(BATCH)],
          f"[serve-pixtral] unexpected token stream shape/range")
    log(f"[serve-pixtral] {cfg.name} patches overlay / plain tok/s "
        f"{(ov['tokens'] / ov['seconds']) / (pl['tokens'] / pl['seconds']):.3f}; logits "
        f"bit-identical (digest) and finite on all {len(ov['digests'])} calls; "
        f"max_memory_allocated overlay {ov['peak'] / 2**30:.2f} GiB ({ov['peak'] / 1e9:.2f} GB), "
        f"plain {pl['peak'] / 2**30:.2f} GiB; streams {[st[:6] for st in ov['streams']]}...; "
        f"distinct tokens per stream {[len(set(st)) for st in ov['streams']]}")

    def prefill_digest(prompt, patches):
        logits, _ = mdl.prefill(params, cfg, prompt, mdl.init_cache(
            cfg, BATCH, PIXTRAL_MAX_LEN, DEV), patch_embeds=patches)
        return logits_digest(logits)

    prompt, patches, _ = rounds[0]
    under = prompt.clone()
    under[:, :PIXTRAL_NPATCH] = (prompt[:, :PIXTRAL_NPATCH] + 1) % cfg.vocab_size
    with torch.no_grad():
        stub = {"patches": prefill_digest(prompt, patches),
                "no patches": prefill_digest(prompt, None),
                "new ids under the patches": prefill_digest(under, patches)}
    check(stub["patches"] == pl["prefill_digests"][0]
          and stub["no patches"] != stub["patches"]
          and stub["new ids under the patches"] == stub["patches"],
          f"[serve-pixtral] stub checks on the {prompt.shape[1]}-token prompt: digests {stub} "
          f"(served {pl['prefill_digests'][0]})")
    log(f"[serve-pixtral] the stub acts: the {prompt.shape[1]}-token prefill's digest "
        f"{stub['patches']} without its patches is {stub['no patches']}; with new ids in the "
        f"{PIXTRAL_NPATCH} slots under the patches it is {stub['new ids under the patches']} "
        f"(the same bits)")
    prompt, patches, _ = rounds[1]
    with torch.no_grad():
        prefill = [_sync_ms(lambda: mdl.prefill(params, cfg, prompt, mdl.init_cache(
            cfg, BATCH, PIXTRAL_MAX_LEN, DEV), patch_embeds=patches))[0] for _ in range(2)]
        _, caches = mdl.prefill(params, cfg, prompt, mdl.init_cache(
            cfg, BATCH, PIXTRAL_MAX_LEN, DEV), patch_embeds=patches)
        tok = prompt[:, :1].contiguous()
        host, synced = _decode_ms(lambda i: mdl.decode_step(params, cfg, tok, caches))
    # what a decode call reads once: every weight but the embedding (two rows
    # gathered) and frontend_proj (not run); and every cache slot (the plain
    # attention reads all of max_len and masks)
    read = sum(t.numel() * t.element_size() for k, v in params.items()
               if k not in ("embed", "frontend_proj") for t in pytree.tree_leaves(v))
    cache_bytes = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(caches))
    log(f"[serve-pixtral] plain steps ended by a synchronize: a {prompt.shape[1]}-token prefill "
        f"under {patches.shape[1]} patches (batch {BATCH}) {prefill[1]:.1f} ms (first "
        f"{prefill[0]:.1f}); a batch-{BATCH} decode {synced:.2f} ms a call (the host issues it "
        f"in {host:.2f} ms), against {read / 1e9:.3f} GB of weights read once: "
        f"{read / HBM_BYTES_PER_S * 1e3:.3f} ms, and {cache_bytes / 1e9:.3f} GB of caches: "
        f"{(read + cache_bytes) / HBM_BYTES_PER_S * 1e3:.3f} ms for both")
    del params, caches, tok, rounds, prompt, patches, under
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    check(left < 1.0, f"[serve-pixtral] {left:.2f} GiB still allocated after the phase")
    log(f"[serve-pixtral] {cfg.name}: {left:.3f} GiB allocated after the phase")
    return {"launches": engine["launches"], "launches_patches": ov["launches"],
            "tok_s_overlay": ov["tokens"] / ov["seconds"],
            "tok_s_plain": pl["tokens"] / pl["seconds"], "prefill_ms": prefill[1],
            "decode_ms": synced}


def step_graph(cfg, shape: tuple[int, int], gen: torch.Generator, want_launches: dict) -> dict:
    """``build_step_graph(cfg, shape)`` at full width assembled on an
    all-LARGE ``Overlay(3, 3)``: its logits are bit-identical to
    ``forward`` + ``unembed``, and one call makes the launches
    ``want_launches`` ({"<kernel>/<variant>": n}: every launch of each
    kernel named is on the variants named, as many on each)."""
    b, s = shape
    params = pm.init(cfg, gen, DEV)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=DEV,
                         dtype=torch.int64).to(torch.int32)
    g = mdl.build_step_graph(cfg, (b, s), DEV)
    ov = Overlay(3, 3, large_fraction=1.0)
    t0 = time.perf_counter()
    acc = ov.assemble(g)
    assemble_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counters()                           # the driven path starts here
    got = acc(params, toks)
    torch.cuda.synchronize()
    launches = counts()
    with torch.no_grad():
        h, _ = tfm.forward(params, cfg, toks)
        want = tfm.unembed(params, h, cfg)
    check(tuple(got.shape) == (b, s, cfg.vocab_size) and torch.equal(got, want),
          f"[step-graph] {cfg.name} logits differ from forward + unembed by "
          f"{(got - want).abs().max().item()}")
    for key, n in want_launches.items():
        kernel = key.split("/")[0]
        total = sum(m for k, m in want_launches.items() if k.split("/")[0] == kernel)
        check(launches[key] == n and launches[kernel] == total,
              f"[step-graph] {cfg.name} launches {launches}, not {want_launches}")
    ms = time_ms(lambda: acc(params, toks), 5, warmup=1)
    tiles = {nd.name: acc.placement.assignment[nd.node_id] for nd in g.op_nodes()}
    log(f"[step-graph] {cfg.name} build_step_graph {(b, s)}: stages "
        f"{[nd.name for nd in g.op_nodes()]} on tiles {tiles}, "
        f"{acc.placement.total_passthrough} pass-through; assembled in {assemble_s:.2f} s, "
        f"{ms:.1f} ms a call; logits bit-identical to forward + unembed; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    del params, acc, ov, got, want, h
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_step_graph(gen: torch.Generator) -> dict:
    """[step-graph]: ``build_step_graph`` of phi3-mini-3.8b at (2, 16):
    rmsnorm 65 times (warp) and flash_attention 32 times (wgmma) a call;
    then of zamba2-7b at (1, 4096): rmsnorm 95 times (warp), ssd_chunk 68
    times (simt, state 64) and flash_attention 13 times (wgmma, head dim
    112: the 13 occurrences of the shared set); then of
    granite-moe-1b-a400m at (1, 4096): rmsnorm 49 times (warp) and
    flash_attention 24 times (wgmma, head dim 64, 16 heads over 8); then
    of deepseek-v3-671b cut to 4 layers at (1, 2048): rmsnorm 9 times on
    block (d 7168) and 8 times on warp (the latents), no flash_attention
    (MLA's q/k and v widths differ: plain code); then of pixtral-12b at
    (1, 2048), tokens only as the reference's: rmsnorm 81 times on block
    (d 5120) and flash_attention 40 times (wgmma, head dim 128, 32 heads
    over 8)."""
    phi3 = get_config("phi3-mini-3.8b")
    out = {"step_graph": step_graph(phi3, (BATCH, PROMPT), gen, {
        "rmsnorm/warp": 2 * phi3.num_layers + 1,
        "flash_attention/wgmma": phi3.num_layers})}
    zamba = get_config(ZAMBA)
    check(ZAMBA_FLASH[3] == zamba.resolved_head_dim and ZAMBA_SSD[0] ==
          zamba.ssm_expand * zamba.d_model // zamba.ssm_head_dim, f"{ZAMBA} shapes")
    out["step_graph_zamba2"] = step_graph(zamba, (1, ZAMBA_LONG), gen, {
        "rmsnorm/warp": norms_per_call(zamba)["warp"], "ssd_chunk/simt": 68,
        "flash_attention/wgmma": 13})
    granite = get_config(GRANITE)
    check(fa_mod.variant(torch.bfloat16, granite.resolved_head_dim) == "wgmma",
          f"{GRANITE} head dim {granite.resolved_head_dim} is not on wgmma")
    out["step_graph_granite"] = step_graph(granite, (1, GRANITE_LONG), gen, {
        "rmsnorm/warp": norms_per_call(granite)["warp"], "flash_attention/wgmma": 24})
    deepseek = cut_layers(get_config(DEEPSEEK), DEEPSEEK_LAYERS)
    out["step_graph_deepseek"] = step_graph(deepseek, (1, DEEPSEEK_LONG), gen, {
        f"rmsnorm/{v}": k for v, k in norms_per_call(deepseek).items()})
    check(out["step_graph_deepseek"]["flash_attention"] == 0
          and out["step_graph_deepseek"]["ssd_chunk"] == 0,
          f"[step-graph] {DEEPSEEK} launches {out['step_graph_deepseek']}")
    pixtral = get_config(PIXTRAL)
    check(fa_mod.variant(torch.bfloat16, pixtral.resolved_head_dim) == "wgmma"
          and norms_per_call(pixtral) == {"warp": 0, "block": 81}, f"{PIXTRAL} shapes")
    out["step_graph_pixtral"] = step_graph(pixtral, (1, PIXTRAL_FLASH[3]), gen, {
        "rmsnorm/block": 81, "flash_attention/wgmma": pixtral.num_layers})
    return out


def phase_small_gemma2_reference() -> None:
    """A small float32 gemma2 (d_model 128, 4 layers: local, global, local,
    global, window 8, 4 heads over 2 kv heads) on the card (CUDA kernels)
    against the same model on the CPU (plain versions): a 20-token prefill
    and three decodes past the window (tolerance 1e-2 * (1 + |logit|), the
    bf16 KV cache, as for phi3), and a cache-free forward of 24 tokens,
    which runs the flash kernel with the window and the softcap once per
    layer (f32 throughout: 1e-3 * (1 + |logit|))."""
    cfg = smoke_config(GEMMA).scaled(d_model=128, head_dim=32, num_kv_heads=2,
                                     query_pre_attn_scalar=128 / 4, sliding_window=8,
                                     dtype="float32")
    cpu = _to(pm.init(cfg, torch.Generator().manual_seed(SEED), "cpu"), "cpu", torch.float32)
    cuda = _to(cpu, DEV)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 20)).astype(np.int32))
    errs = {}
    lc, cc = mdl.prefill(cpu, cfg, toks, mdl.init_cache(cfg, 2, 32, "cpu"))
    lg, cg = mdl.prefill(cuda, cfg, toks.to(DEV), mdl.init_cache(cfg, 2, 32, DEV))
    pairs = [("prefill", lc, lg)]
    for i in range(3):
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32))
        dc, cc = mdl.decode_step(cpu, cfg, nxt, cc)
        dg, cg = mdl.decode_step(cuda, cfg, nxt.to(DEV), cg)
        pairs.append((f"decode {i + 1}", dc, dg))
    for name, want, got in pairs:
        got = got.cpu()
        errs[name] = (got - want).abs().max().item()
        check(bool((got - want).abs().le(1e-2 * (1 + want.abs())).all()),
              f"small gemma2 {name}: card vs CPU max err {errs[name]}")
    free = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32))
    with torch.no_grad():
        hc, _ = tfm.forward(cpu, cfg, free)
        want = tfm.unembed(cpu, hc, cfg)
        reset_counters()
        hg, _ = tfm.forward(cuda, cfg, free.to(DEV))
        torch.cuda.synchronize()
        flash = counts()["flash_attention"]
        got = tfm.unembed(cuda, hg, cfg).cpu()
    errs["cache-free forward of 24 tokens"] = (got - want).abs().max().item()
    check(flash == cfg.num_layers, f"small gemma2 cache-free forward: {flash} flash launches")
    check(bool((got - want).abs().le(1e-3 * (1 + want.abs())).all()),
          f"small gemma2 cache-free forward: card vs CPU max err {errs['cache-free forward of 24 tokens']}")
    log(f"[reference] small f32 gemma2-27b ({cfg.num_layers} layers, window 8, softcaps "
        f"{cfg.attn_softcap}/{cfg.final_softcap}) logits card (kernels) vs CPU (plain) max err: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; {flash} flash_attention launches in the cache-free forward")


def phase_small_zamba2_reference() -> None:
    """A small float32 zamba2 (its smoke config at d_model 128 with the full
    config's state 64 and head dim 64: 15 layers, two occurrences of the
    shared set) on the card (CUDA kernels) against the same model on the
    CPU (plain versions): a 20-token prefill and three decodes (tolerance
    1e-2 * (1 + |logit|), the bf16 KV and conv caches, as for phi3), and a
    cache-free forward of 24 tokens, which runs ssd_chunk (simt) once per
    mamba layer and the flash kernel once per occurrence (f32 throughout:
    1e-3 * (1 + |logit|))."""
    cfg = smoke_config(ZAMBA).scaled(d_model=128, ssm_state=64, ssm_head_dim=64,
                                     dtype="float32")
    cpu = _to(pm.init(cfg, torch.Generator().manual_seed(SEED), "cpu"), "cpu", torch.float32)
    cuda = _to(cpu, DEV)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 20)).astype(np.int32))
    errs = {}
    lc, cc = mdl.prefill(cpu, cfg, toks, mdl.init_cache(cfg, 2, 32, "cpu"))
    lg, cg = mdl.prefill(cuda, cfg, toks.to(DEV), mdl.init_cache(cfg, 2, 32, DEV))
    pairs = [("prefill", lc, lg)]
    for i in range(3):
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32))
        dc, cc = mdl.decode_step(cpu, cfg, nxt, cc)
        dg, cg = mdl.decode_step(cuda, cfg, nxt.to(DEV), cg)
        pairs.append((f"decode {i + 1}", dc, dg))
    for name, want, got in pairs:
        got = got.cpu()
        errs[name] = (got - want).abs().max().item()
        check(bool((got - want).abs().le(1e-2 * (1 + want.abs())).all()),
              f"small zamba2 {name}: card vs CPU max err {errs[name]}")
    free = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32))
    with torch.no_grad():
        hc, _ = tfm.forward(cpu, cfg, free)
        want = tfm.unembed(cpu, hc, cfg)
        reset_counters()
        hg, _ = tfm.forward(cuda, cfg, free.to(DEV))
        torch.cuda.synchronize()
        n = counts()
        got = tfm.unembed(cuda, hg, cfg).cpu()
    errs["cache-free forward of 24 tokens"] = (got - want).abs().max().item()
    check(n["flash_attention"] == 2 and n["ssd_chunk"] == n["ssd_chunk/simt"] == 13,
          f"small zamba2 cache-free forward: launches {n}")
    check(bool((got - want).abs().le(1e-3 * (1 + want.abs())).all()),
          f"small zamba2 cache-free forward: card vs CPU max err "
          f"{errs['cache-free forward of 24 tokens']}")
    log(f"[reference] small f32 zamba2-7b ({cfg.num_layers} layers, 2 shared_attn "
        f"occurrences, state {cfg.ssm_state}) logits card (kernels) vs CPU (plain) max err: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; the cache-free forward launched flash_attention {n['flash_attention']} and "
        f"ssd_chunk {n['ssd_chunk']} times (simt)")


def phase_small_granite_reference() -> None:
    """A small float32 granite-moe (its smoke config at d_model 128, head
    dim 32, with the full config's routing: 32 experts, top-8, capacity
    factor 1.25) on the card (CUDA kernels) against the same model on the
    CPU (plain versions): a 20-token prefill and three decodes at batch 2
    (capacity 1: slots drop; tolerance 1e-2 * (1 + |logit|), the bf16 KV
    cache, as for phi3), a cache-free forward of 24 tokens, which runs
    the flash kernel once per layer (f32 throughout: 1e-3 * (1 +
    |logit|)), and the training loss, its aux (relative 1e-4) and every
    gradient (1e-3 of each leaf's largest) at batch 2 x 32."""
    cfg = smoke_config(GRANITE).scaled(d_model=128, head_dim=32, num_experts=32,
                                       experts_per_token=8, capacity_factor=1.25,
                                       dtype="float32")
    cpu = _to(pm.init(cfg, torch.Generator().manual_seed(SEED), "cpu"), "cpu", torch.float32)
    cuda = _to(cpu, DEV)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 20)).astype(np.int32))
    errs = {}
    lc, cc = mdl.prefill(cpu, cfg, toks, mdl.init_cache(cfg, 2, 32, "cpu"))
    lg, cg = mdl.prefill(cuda, cfg, toks.to(DEV), mdl.init_cache(cfg, 2, 32, DEV))
    pairs = [("prefill", lc, lg)]
    for i in range(3):
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32))
        dc, cc = mdl.decode_step(cpu, cfg, nxt, cc)
        dg, cg = mdl.decode_step(cuda, cfg, nxt.to(DEV), cg)
        pairs.append((f"decode {i + 1}", dc, dg))
    for name, want, got in pairs:
        got = got.cpu()
        errs[name] = (got - want).abs().max().item()
        check(bool((got - want).abs().le(1e-2 * (1 + want.abs())).all()),
              f"small granite {name}: card vs CPU max err {errs[name]}")
    free = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32))
    with torch.no_grad():
        hc, _ = tfm.forward(cpu, cfg, free)
        want = tfm.unembed(cpu, hc, cfg)
        reset_counters()
        hg, _ = tfm.forward(cuda, cfg, free.to(DEV))
        torch.cuda.synchronize()
        n = counts()
        got = tfm.unembed(cuda, hg, cfg).cpu()
    errs["cache-free forward of 24 tokens"] = (got - want).abs().max().item()
    check(n["flash_attention"] == cfg.num_layers and n["rmsnorm"] == 2 * cfg.num_layers + 1,
          f"small granite cache-free forward: launches {n}")
    check(bool((got - want).abs().le(1e-3 * (1 + want.abs())).all()),
          f"small granite cache-free forward: card vs CPU max err "
          f"{errs['cache-free forward of 24 tokens']}")
    log(f"[reference] small f32 granite-moe-1b-a400m ({cfg.num_layers} layers, "
        f"{cfg.num_experts} experts, top-{cfg.experts_per_token}) logits card (kernels) vs CPU "
        f"(plain) max err: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; the cache-free forward launched flash_attention {n['flash_attention']} times")
    # the training loss ce + 0.01 * aux and its gradients through the
    # sort-based dispatch (slots drop at 2 x 32 tokens: capacity 21)
    batch = make_batch(cfg, 2, 32, step=0, seed=SEED, device="cpu")
    lc, mc, gc_, _ = train_cli._loss_and_grads(cfg, cpu, batch)
    lg, mg, gg, _ = train_cli._loss_and_grads(cfg, cuda, {k: v.to(DEV) for k, v in batch.items()})
    worst = max(((g.cpu() - w).abs().max() / w.abs().max()).item() for g, w in zip(gg, gc_))
    check(math.isclose(lg.item(), lc.item(), rel_tol=1e-4)
          and math.isclose(mg["aux"].item(), mc["aux"].item(), rel_tol=1e-4) and worst < 1e-3,
          f"small granite train: card vs CPU loss {lg.item()} vs {lc.item()}, aux "
          f"{mg['aux'].item()} vs {mc['aux'].item()}, worst gradient error {worst} of a leaf's "
          f"largest")
    log(f"[reference] small f32 granite-moe-1b-a400m loss ce + 0.01 * aux card vs CPU: "
        f"{lg.item():.6f} vs {lc.item():.6f} (aux {mg['aux'].item():.6f} vs "
        f"{mc['aux'].item():.6f}); worst gradient error {worst:.3g} of a leaf's largest")


def phase_small_deepseek_reference() -> None:
    """A small float32 deepseek (its smoke config at d_model 128 with both
    latents at 128, so every norm takes the kernel; 4 heads, nope 32, rope
    16, v 32; 32 experts, top-8, sigmoid scoring, one shared expert) on the
    card (CUDA kernels) against the same model on the CPU (plain
    versions): a 20-token prefill, three decodes and a ragged decode at
    batch 2 over the bf16 latent cache (tolerance 1e-2 * (1 + |logit|), as
    for phi3's bf16 KV cache), and a cache-free forward of 24 tokens (f32
    throughout: 1e-3 * (1 + |logit|)), which launches rmsnorm 4 times a
    layer and once more, and no flash_attention."""
    cfg = smoke_config(DEEPSEEK).scaled(d_model=128, q_lora_rank=128, kv_lora_rank=128,
                                        qk_nope_head_dim=32, qk_rope_head_dim=16,
                                        v_head_dim=32, num_experts=32, experts_per_token=8,
                                        capacity_factor=1.25, dtype="float32")
    cpu = _to(pm.init(cfg, torch.Generator().manual_seed(SEED), "cpu"), "cpu", torch.float32)
    cuda = _to(cpu, DEV)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 20)).astype(np.int32))
    errs = {}
    with torch.no_grad():
        lc, cc = mdl.prefill(cpu, cfg, toks, mdl.init_cache(cfg, 2, 32, "cpu"))
        lg, cg = mdl.prefill(cuda, cfg, toks.to(DEV), mdl.init_cache(cfg, 2, 32, DEV))
        pairs = [("prefill", lc, lg)]
        for i in range(3):
            nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32))
            dc, cc = mdl.decode_step(cpu, cfg, nxt, cc)
            dg, cg = mdl.decode_step(cuda, cfg, nxt.to(DEV), cg)
            pairs.append((f"decode {i + 1}", dc, dg))
        pos = torch.tensor([22, 13], dtype=torch.int32)
        rc, _ = mdl.decode_step(cpu, cfg, nxt, cc, positions=pos)
        rg, _ = mdl.decode_step(cuda, cfg, nxt.to(DEV), cg, positions=pos.to(DEV))
        pairs.append(("ragged decode", rc, rg))
    for name, want, got in pairs:
        got = got.cpu()
        errs[name] = (got - want).abs().max().item()
        check(bool((got - want).abs().le(1e-2 * (1 + want.abs())).all()),
              f"small deepseek {name}: card vs CPU max err {errs[name]}")
    free = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32))
    with torch.no_grad():
        hc, _ = tfm.forward(cpu, cfg, free)
        want = tfm.unembed(cpu, hc, cfg)
        reset_counters()
        hg, _ = tfm.forward(cuda, cfg, free.to(DEV))
        torch.cuda.synchronize()
        n = counts()
        got = tfm.unembed(cuda, hg, cfg).cpu()
    errs["cache-free forward of 24 tokens"] = (got - want).abs().max().item()
    check(n["flash_attention"] == 0 and n["rmsnorm"] == 4 * cfg.num_layers + 1
          and n["rmsnorm/warp"] == n["rmsnorm"],
          f"small deepseek cache-free forward: launches {n}")
    check(bool((got - want).abs().le(1e-3 * (1 + want.abs())).all()),
          f"small deepseek cache-free forward: card vs CPU max err "
          f"{errs['cache-free forward of 24 tokens']}")
    log(f"[reference] small f32 deepseek-v3-671b ({cfg.num_layers} layers: "
        f"{pm.layer_kinds(cfg)}, {cfg.num_experts} experts, top-{cfg.experts_per_token}, "
        f"{cfg.router_scoring}) logits card (kernels) vs CPU (plain) max err: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; the cache-free forward launched rmsnorm {n['rmsnorm']} times")
    # the training loss ce + 0.01 * aux + 0.3 * ce2 and its gradients: the
    # MTP layer launches flash once, f32 on the CUDA-core kernel, over 31
    # positions (a ragged tile); rmsnorm 4 a layer in the forward and the
    # recompute, the final norm and the MTP module's 3
    batch = make_batch(cfg, 2, 32, step=0, seed=SEED, device="cpu")
    lc, mc, gc_, _ = train_cli._loss_and_grads(cfg, cpu, batch)
    reset_counters()
    lg, mg, gg, _ = train_cli._loss_and_grads(cfg, cuda, {k: v.to(DEV) for k, v in batch.items()})
    torch.cuda.synchronize()
    n = counts()
    check(n["flash_attention"] == 1 and n["flash_attention/simt"] == 1
          and n["rmsnorm"] == 8 * cfg.num_layers + 1 + 3,
          f"small deepseek train: launches {n}")
    worst = max(((g.cpu() - w).abs().max() / w.abs().max()).item() for g, w in zip(gg, gc_))
    check(math.isclose(lg.item(), lc.item(), rel_tol=1e-4)
          and math.isclose(mg["aux"].item(), mc["aux"].item(), rel_tol=1e-4) and worst < 1e-3,
          f"small deepseek train: card vs CPU loss {lg.item()} vs {lc.item()}, aux "
          f"{mg['aux'].item()} vs {mc['aux'].item()}, worst gradient error {worst} of a leaf's "
          f"largest")
    log(f"[reference] small f32 deepseek-v3-671b loss ce + 0.01 * aux + 0.3 * ce2 card vs CPU: "
        f"{lg.item():.6f} vs {lc.item():.6f} (aux {mg['aux'].item():.6f} vs "
        f"{mc['aux'].item():.6f}); worst gradient error {worst:.3g} of a leaf's largest; the "
        f"MTP layer launched flash_attention {n['flash_attention/simt']} time on simt (head dim "
        f"{cfg.resolved_head_dim}, 31 positions)")


def phase_small_seamless_reference() -> None:
    """A small float32 seamless (its smoke config at d_model 256, 4 heads of
    64, 2 ``enc`` + 2 ``dec`` layers) on the card (CUDA kernels) against
    the same model on the CPU (plain versions): ``prefill(enc_in=)`` of 256
    frames and a 20-token prompt at batch 2 and three decodes over the bf16
    self and cross caches (tolerance 1e-2 * (1 + |logit|), as for phi3's
    bf16 KV cache), and a cache-free ``forward(enc_out=encode(frames))`` of
    24 tokens (f32 throughout: 1e-3 * (1 + |logit|)), which launches
    flash_attention 6 times, every one not causal but the decoder's 2
    self-attentions — the encoder's 2 with Sq = Sk, the 2 cross-attentions
    with Sq 24 != Sk 256 — all on the CUDA-core kernel (f32), and rmsnorm 12
    times (the encoder's 2 x 2 and ``enc_norm``, the decoder's 3 x 2 and
    the final norm)."""
    cfg = smoke_config(SEAMLESS).scaled(d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
                                        d_ff=512, dtype="float32")
    cpu = _to(pm.init(cfg, torch.Generator().manual_seed(SEED), "cpu"), "cpu", torch.float32)
    cuda = _to(cpu, DEV)
    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(rng.standard_normal((2, 256, cfg.frontend_dim)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 20)).astype(np.int32))
    errs = {}
    with torch.no_grad():
        lc, cc = mdl.prefill(cpu, cfg, toks, mdl.init_cache(cfg, 2, 288, "cpu"), enc_in=frames)
        lg, cg = mdl.prefill(cuda, cfg, toks.to(DEV), mdl.init_cache(cfg, 2, 288, DEV),
                             enc_in=frames.to(DEV))
        pairs = [("prefill", lc, lg)]
        for i in range(3):
            nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32))
            dc, cc = mdl.decode_step(cpu, cfg, nxt, cc)
            dg, cg = mdl.decode_step(cuda, cfg, nxt.to(DEV), cg)
            pairs.append((f"decode {i + 1}", dc, dg))
    for name, want, got in pairs:
        got = got.cpu()
        errs[name] = (got - want).abs().max().item()
        check(bool((got - want).abs().le(1e-2 * (1 + want.abs())).all()),
              f"small seamless {name}: card vs CPU max err {errs[name]}")
    free = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32))
    with torch.no_grad():
        hc, _ = tfm.forward(cpu, cfg, free, enc_out=tfm.encode(cpu, cfg, frames))
        want = tfm.unembed(cpu, hc, cfg)
        torch.cuda.synchronize()
        reset_counters()
        hg, _ = tfm.forward(cuda, cfg, free.to(DEV), enc_out=tfm.encode(cuda, cfg, frames.to(DEV)))
        torch.cuda.synchronize()
        n = counts()
        got = tfm.unembed(cuda, hg, cfg).cpu()
    errs["cache-free forward of 24 tokens"] = (got - want).abs().max().item()
    check(n["flash_attention"] == n["flash_attention/simt"] == 6
          and n["rmsnorm"] == n["rmsnorm/warp"] == 12,
          f"small seamless cache-free forward: launches {n}")
    check(bool((got - want).abs().le(1e-3 * (1 + want.abs())).all()),
          f"small seamless cache-free forward: card vs CPU max err "
          f"{errs['cache-free forward of 24 tokens']}")
    log(f"[reference] small f32 seamless-m4t-medium ({pm.encoder_kinds(cfg)} + "
        f"{pm.layer_kinds(cfg)}, d {cfg.d_model}, 256 frames) logits card (kernels) vs CPU "
        f"(plain) max err: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; the cache-free forward launched flash_attention {n['flash_attention']} times "
        f"(simt), rmsnorm {n['rmsnorm']} times")
    # the enc-dec training loss and every gradient over 24 tokens and 40
    # frames (the cross-attention's Sq != Sk on a training path), then one
    # functional train step of launch.steps; 1e-3 * (1 + |x|) for every value
    batch = make_batch(cfg, 2, 24, step=0, seed=SEED, device="cpu")
    batch["frames"] = torch.from_numpy(
        rng.standard_normal((2, 40, cfg.frontend_dim)).astype(np.float32)).to(torch.bfloat16)
    on_card = {k: v.to(DEV) for k, v in batch.items()}

    def close(got, want) -> bool:
        return bool((got.cpu() - want).abs().le(1e-3 * (1 + want.abs())).all())

    lc, mc, gc_, _ = train_cli._loss_and_grads(cfg, cpu, batch)
    reset_counters()
    lg, mg, gg, _ = train_cli._loss_and_grads(cfg, cuda, on_card)
    torch.cuda.synchronize()
    n = counts()
    check(n["flash_attention"] == n["flash_attention/simt"] == 12
          and n["rmsnorm"] == n["rmsnorm/warp"] == 22,
          f"small seamless train: launches {n} (want 12 flash simt: 6 in the forward, 6 in the "
          f"recompute; 22 rmsnorm warp: 12 and 10)")
    worst = max(((g.cpu() - w).abs().max() / w.abs().max()).item() for g, w in zip(gg, gc_))
    check(close(lg, lc) and close(mg["ce"], mc["ce"]) and all(close(g, w) for g, w in zip(gg, gc_))
          and all(bool(w.abs().max() > 0) for w in gc_),
          f"small seamless train: card vs CPU loss {lg.item()} vs {lc.item()}, worst gradient "
          f"error {worst} of a leaf's largest")
    log(f"[reference] small f32 seamless-m4t-medium enc-dec loss (24 tokens over 40 frames) card "
        f"vs CPU: {lg.item():.6f} vs {lc.item():.6f}; every one of the {len(gc_)} gradient leaves "
        f"nonzero and within 1e-3 * (1 + |g|), worst error {worst:.3g} of a leaf's largest; "
        f"flash_attention {n['flash_attention']} launches (simt), rmsnorm {n['rmsnorm']}")
    del gc_, gg
    step = steps_lib.make_train_step(cfg)
    pc, oc, mc = step(_to(cpu, "cpu"), adamw_init(cpu), batch)
    pg, og, mg = step(_to(cuda, DEV), adamw_init(cuda), on_card)
    pairs = [(k, mg[k], mc[k]) for k in ("loss", "ce", "aux", "grad_norm")]
    pairs += [("params", a, b) for a, b in zip(pytree.tree_leaves(pg), pytree.tree_leaves(pc))]
    pairs += [("mu", a, b) for a, b in zip(pytree.tree_leaves(og.mu), pytree.tree_leaves(oc.mu))]
    wrong = [k for k, got, want in pairs if not close(got, want)]
    check(not wrong and int(og.step) == int(oc.step) == 1,
          f"small seamless launch.steps train step: card vs CPU differ in {wrong}")
    log(f"[reference] small f32 seamless-m4t-medium launch.steps.make_train_step: card vs CPU "
        f"loss {mg['loss'].item():.6f} vs {mc['loss'].item():.6f}, grad norm "
        f"{mg['grad_norm'].item():.6f} vs {mc['grad_norm'].item():.6f}; every parameter and "
        f"first moment within 1e-3 * (1 + |x|)")


def phase_small_pixtral_reference() -> None:
    """A small float32 pixtral (its smoke config at d_model 256, 4 heads of
    64 over 2 kv heads, 2 ``dense`` layers, patches of 64 features) on the
    card (CUDA kernels) against the same model on the CPU (plain versions):
    ``prefill(patch_embeds=)`` of a 128-token prompt under 64 patches at
    batch 2 and three decodes over the bf16 KV cache (tolerance 1e-2 * (1 +
    |logit|), as for phi3), and the cache-free ``forward(patch_embeds=)``
    of the same prompt (f32 throughout: 1e-3 * (1 + |logit|)), which
    launches flash_attention twice, causal, on the CUDA-core kernel (f32),
    and rmsnorm 5 times (warp); and the vlm loss (the 16 patch positions
    of ``make_batch``'s batch 2 x 32 masked out) and every gradient,
    ``frontend_proj``'s included (relative 1e-4 on the loss, 1e-3 of each
    leaf's largest on the gradients)."""
    cfg = smoke_config(PIXTRAL).scaled(d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
                                       d_ff=512, frontend_dim=64, dtype="float32")
    cpu = _to(pm.init(cfg, torch.Generator().manual_seed(SEED), "cpu"), "cpu", torch.float32)
    cuda = _to(cpu, DEV)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 128)).astype(np.int32))
    patches = torch.from_numpy(rng.standard_normal((2, 64, cfg.frontend_dim)).astype(np.float32))
    errs = {}
    with torch.no_grad():
        lc, cc = mdl.prefill(cpu, cfg, toks, mdl.init_cache(cfg, 2, 160, "cpu"),
                             patch_embeds=patches)
        lg, cg = mdl.prefill(cuda, cfg, toks.to(DEV), mdl.init_cache(cfg, 2, 160, DEV),
                             patch_embeds=patches.to(DEV))
        pairs = [("prefill", lc, lg)]
        for i in range(3):
            nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32))
            dc, cc = mdl.decode_step(cpu, cfg, nxt, cc)
            dg, cg = mdl.decode_step(cuda, cfg, nxt.to(DEV), cg)
            pairs.append((f"decode {i + 1}", dc, dg))
    for name, want, got in pairs:
        got = got.cpu()
        errs[name] = (got - want).abs().max().item()
        check(bool((got - want).abs().le(1e-2 * (1 + want.abs())).all()),
              f"small pixtral {name}: card vs CPU max err {errs[name]}")
    with torch.no_grad():
        hc, _ = tfm.forward(cpu, cfg, toks, patch_embeds=patches)
        want = tfm.unembed(cpu, hc, cfg)
        torch.cuda.synchronize()
        reset_counters()
        hg, _ = tfm.forward(cuda, cfg, toks.to(DEV), patch_embeds=patches.to(DEV))
        torch.cuda.synchronize()
        n = counts()
        got = tfm.unembed(cuda, hg, cfg).cpu()
    errs["cache-free forward of 128 tokens"] = (got - want).abs().max().item()
    check(n["flash_attention"] == n["flash_attention/simt"] == 2
          and n["rmsnorm"] == n["rmsnorm/warp"] == 5,
          f"small pixtral cache-free forward: launches {n}")
    check(bool((got - want).abs().le(1e-3 * (1 + want.abs())).all()),
          f"small pixtral cache-free forward: card vs CPU max err "
          f"{errs['cache-free forward of 128 tokens']}")
    log(f"[reference] small f32 pixtral-12b ({pm.layer_kinds(cfg)}, d {cfg.d_model}, 128 "
        f"tokens under 64 patches) logits card (kernels) vs CPU (plain) max err: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; the cache-free forward launched flash_attention {n['flash_attention']} times "
        f"(simt), rmsnorm {n['rmsnorm']} times")
    # the vlm loss, its patch positions masked out, and every gradient
    batch = make_batch(cfg, 2, 32, step=0, seed=SEED, device="cpu")
    lc, mc, gc_, spec = train_cli._loss_and_grads(cfg, cpu, batch)
    lg, mg, gg, _ = train_cli._loss_and_grads(cfg, cuda, {k: v.to(DEV) for k, v in batch.items()})
    stub = pytree.tree_unflatten(list(range(len(gc_))), spec)["frontend_proj"]
    worst = max(((g.cpu() - w).abs().max() / w.abs().max()).item() for g, w in zip(gg, gc_))
    check(math.isclose(lg.item(), lc.item(), rel_tol=1e-4)
          and math.isclose(mg["ce"].item(), mc["ce"].item(), rel_tol=1e-4) and worst < 1e-3
          and bool(gc_[stub].abs().max() > 0),
          f"small pixtral train: card vs CPU loss {lg.item()} vs {lc.item()}, worst gradient "
          f"error {worst} of a leaf's largest, frontend_proj's max |g| "
          f"{gc_[stub].abs().max().item()}")
    log(f"[reference] small f32 pixtral-12b vlm loss ({batch['patch_embeds'].shape[1]} of 32 "
        f"positions masked) card vs CPU: {lg.item():.6f} vs {lc.item():.6f}; worst gradient "
        f"error {worst:.3g} of a leaf's largest (frontend_proj's "
        f"{((gg[stub].cpu() - gc_[stub]).abs().max() / gc_[stub].abs().max()).item():.3g})")


@contextlib.contextmanager
def timed_checkpoints(record: list):
    """Appends (what, seconds) for each checkpoint host copy, write and
    restore while open: ``CheckpointManager`` calls these functions of
    ``repro_torch.checkpoint.ckpt`` by their module names."""
    from repro_torch.checkpoint import ckpt as ckpt_mod
    names = ("_to_host", "save_checkpoint", "load_checkpoint")
    saved = {name: getattr(ckpt_mod, name) for name in names}

    def timed(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = saved[name](*args, **kwargs)
            record.append((name, time.perf_counter() - t0))
            return out
        return call

    for name in names:
        setattr(ckpt_mod, name, timed(name))
    try:
        yield record
    finally:
        for name in names:
            setattr(ckpt_mod, name, saved[name])


def _mem_available() -> int:
    with open("/proc/meminfo") as fh:
        line = next(ln for ln in fh if ln.startswith("MemAvailable:"))
    return int(line.split()[1]) * 1024


def phase_launcher() -> dict:
    """``launch.serve.main`` serving mamba2-130m at full width, phi3-mini
    (smoke) on the event loop and gemma2-27b (smoke) through the overlay,
    then ``launch.train.main`` training pixtral-12b at full width cut to 2
    layers (seq 1024 under 256 patches, the vlm loss) with a failure
    injected at step 3: it restores the step-2 checkpoint of its whole
    state (bf16 parameters, f32 moments: 18.9 GB) from disk, replays and
    ends with rc 0.  Returns the train launcher's launches (4 steps run:
    flash 2 a layer a step, rmsnorm (2n + 1) + 2n, all on the tensor-core
    and block kernels; the failed step runs none)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(["--arch", MAMBA, "--requests", "4", "--batch", "2",
                             "--prompt-len", "100", "--max-new", "4"])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[launcher] {line}")
    check(rc == 0 and "4/4 requests" in text and "on cuda" in text,
          "serve launcher did not serve mamba2-130m on the card")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(["--arch", "phi3-mini-3.8b", "--smoke", "--event-loop",
                             "--overlay"])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[launcher] {line[:400]}")
    check(rc == 0 and "8/8 requests" in text and "on cuda" in text and "metrics" in text,
          "the event-loop serve launcher did not serve phi3-mini (smoke) on the card")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(["--arch", GEMMA, "--smoke", "--overlay"])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[launcher] {line[:400]}")
    check(rc == 0 and "8/8 requests" in text and "on cuda" in text and "'downloads': " in text,
          "the serve launcher did not serve gemma2-27b (smoke) through the overlay on the card")
    _free()
    with tempfile.TemporaryDirectory() as ckpt:
        disk = shutil.disk_usage(ckpt)
        log(f"[launcher] train checkpoints in {ckpt}: {disk.free / 1e9:.1f} GB free of "
            f"{disk.total / 1e9:.1f}; host MemAvailable {_mem_available() / 1e9:.1f} GB")
        buf, timings = io.StringIO(), []
        reset_counters()                       # the driven path starts here
        with contextlib.redirect_stdout(buf), timed_checkpoints(timings):
            t0 = time.perf_counter()
            rc = train_cli.main(LAUNCHER_TRAIN + ["--ckpt-dir", ckpt])
            wall = time.perf_counter() - t0
        launches = counts()
        sizes = {d: sum(os.path.getsize(os.path.join(ckpt, d, f))
                        for f in os.listdir(os.path.join(ckpt, d)))
                 for d in sorted(os.listdir(ckpt))}
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[launcher] {line}")
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in text.splitlines()
              if ln.lstrip().startswith("step ")]
    n = cut_layers(get_config(PIXTRAL), LAUNCHER_LAYERS).num_layers
    check(rc == 0 and "restarts=1" in text and "on cuda" in text and f"{n} layers" in text
          and PIXTRAL in text and "4 steps" in text and len(losses) == 4
          and all(map(math.isfinite, losses)),
          f"the train launcher did not train {PIXTRAL} at {n} layers on the card, restart from "
          f"its checkpoint and finish with finite losses")
    check_launches("launcher", launches,
                   {"flash_attention": 4 * 2 * n, "rmsnorm": 4 * ((2 * n + 1) + 2 * n)},
                   {"flash_attention": "wgmma", "rmsnorm": "block"})
    by = {}
    for name, sec in timings:
        by.setdefault(name, []).append(round(sec, 2))
    log(f"[launcher] pixtral train launcher at {n} layers: {wall:.1f} s; "
        f"checkpoint bytes on disk {sizes}; host copy s {by.get('_to_host')}, write s (a "
        f"background thread) {by.get('save_checkpoint')}, restore s {by.get('load_checkpoint')}")
    return launches


BOOT_TIMEOUT_S = 300
PHI3_BOOT_LAYERS = 2          # full width, 2 of its 32 layers: the boots' trace and init
PHI3_BOOT = ["--arch", "phi3-mini-3.8b", "--layers", str(PHI3_BOOT_LAYERS),
             "--requests", str(REQUESTS), "--batch", str(BATCH),
             "--prompt-len", str(PROMPT), "--max-new", str(MAX_NEW), "--max-len", str(MAX_LEN),
             "--seed", str(SEED)]
MAMBA_BOOT_LAYERS = 2         # full width, 2 of its 24 layers: the boots' trace is per layer
MAMBA_BOOT = ["--arch", MAMBA, "--layers", str(MAMBA_BOOT_LAYERS),
              "--requests", str(MAMBA_REQUESTS), "--batch", str(MAMBA_BATCH),
              "--prompt-lens", ",".join(map(str, MAMBA_PROMPTS)), "--max-new", str(MAMBA_NEW),
              "--max-len", str(MAMBA_MAX_LEN), "--seed", str(SEED)]


def _env(**extra) -> dict:
    path = os.path.join(ROOT, "src")
    old = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": path + (os.pathsep + old if old else ""), **extra}


def boot(tag: str, args: list, **env) -> tuple[dict, str]:
    """One serve-launcher process (``python -m repro_torch.launch.serve``):
    its result line (the last line of its output) and its standard error."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, timeout=BOOT_TIMEOUT_S, cwd=ROOT,
                          env=_env(**env))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        for line in (proc.stdout + proc.stderr).splitlines()[-30:]:
            log(f"[warm-restart] {tag}: {line[:300]}")
    check(proc.returncode == 0, f"[warm-restart] {tag} boot exited {proc.returncode}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    result["wall_s"] = wall
    ttft = result.get("first_token_seconds", {})
    split = ", ".join(f"{k} {v:.3f}" for k, v in ttft.items())
    log(f"[warm-restart] {tag}: process {wall:.1f} s; first token (s): {split}; calls "
        f"{result['calls']}; kernels {result['kernels_built']}; downloads "
        f"{result.get('downloads')}; store hits {result.get('store_hits')}")
    return result, proc.stderr


def _garble(directory: str) -> list[str]:
    """Flip one byte mid-payload of the first ``.bits`` entry and truncate
    the second to half its length."""
    names = sorted(n for n in os.listdir(directory) if n.endswith(".bits"))
    check(len(names) >= 2, f"[warm-restart] {len(names)} entries to garble in {directory}")
    flip, cut = (os.path.join(directory, n) for n in names[:2])
    with open(flip, "rb") as fh:
        data = bytearray(fh.read())
    header_end = 12 + int.from_bytes(data[8:12], "little")
    data[(header_end + len(data)) // 2] ^= 0xFF
    with open(flip, "wb") as fh:
        fh.write(bytes(data))
    with open(cut, "rb") as fh:
        data = fh.read()
    with open(cut, "wb") as fh:
        fh.write(data[: len(data) // 2])
    return names[:2]


def _check_launches(tag: str, r: dict, norms: int, ssd_layers: int = 0) -> None:
    calls, n = r["calls"], r["launches"]
    want = norms * (calls["prefill"] + calls["decode"])
    check(n["rmsnorm"] == want and n["rmsnorm/warp"] == want,
          f"[warm-restart] {tag}: rmsnorm launches {n['rmsnorm']} != {norms} x {calls}")
    want = ssd_layers * calls["prefill"]
    check(n["ssd_chunk"] == want and n["ssd_chunk/mma"] == want,
          f"[warm-restart] {tag}: ssd_chunk launches {n['ssd_chunk']} (mma "
          f"{n['ssd_chunk/mma']}) != {ssd_layers} x {calls['prefill']}")


def _check_warm(tag: str, warm: dict, keys: int) -> None:
    """A warm boot loads every kernel key from disk and builds none: every
    download is a store hit (a key the fabric reclaimed and admitted again
    loads again, so hits may exceed the keys), with no load failure."""
    check(warm["store_hits"] == warm["downloads"] and warm["store_hits"] >= keys
          and warm["store"]["entries"] == keys and not warm["kernels_built"].get("Kernel")
          and warm["store"]["stats"]["load_failures"] == 0,
          f"[warm-restart] {tag} warm boot: {warm['store_hits']} store hits, "
          f"{warm['downloads']} downloads, {keys} keys, kernels {warm['kernels_built']}, "
          f"store {warm['store']}")


def _read_ms(warm: dict) -> float:
    """The part of a warm boot's load ms per kernel that reads the entry's
    file (the store's ``load_seconds``); the rest of the load rebuilds the
    kernel from its serial form."""
    return warm["store"]["stats"]["load_seconds"] / max(1, warm["store_hits"]) * 1e3


def _per_entry(cold: dict, warm: dict) -> tuple[float, float]:
    """Build ms per kernel (cold boot) and load ms per kernel (warm boot)."""
    c, w = cold["cache"], warm["cache"]
    builds = c["misses"] - c["store_hits"]          # a store load is booked as a miss too
    return ((c["compile_seconds"] - c["store_load_seconds"]) / max(1, builds) * 1e3,
            w["store_load_seconds"] / max(1, w["store_hits"]) * 1e3)


def phase_warm_restart() -> dict:
    """[warm-restart]: the persistent bitstream store across real processes
    (module docstring, item 22).  Returns the launches of each boot."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[warm-restart] phi3-mini-3.8b boots at full width, {PHI3_BOOT_LAYERS} of "
        f"{get_config('phi3-mini-3.8b').num_layers} layers; {MAMBA} boots at full width, "
        f"{MAMBA_BOOT_LAYERS} of {get_config(MAMBA).num_layers} layers (--layers)")
    out = {}
    with tempfile.TemporaryDirectory(prefix="warm-phi3-") as d1, \
            tempfile.TemporaryDirectory(prefix="warm-mamba-") as d2, \
            tempfile.TemporaryDirectory(prefix="warm-fleet-") as d3:
        norms = 2 * PHI3_BOOT_LAYERS + 1
        plain, _ = boot("phi3 plain", PHI3_BOOT)
        cold, _ = boot("phi3 cold", PHI3_BOOT + ["--store", d1])
        sizes = {n: os.path.getsize(os.path.join(d1, n)) for n in sorted(os.listdir(d1))}
        warm, _ = boot("phi3 warm", PHI3_BOOT + ["--store", d1])
        bad = _garble(d1)
        garbled, err = boot("phi3 garbled", PHI3_BOOT + ["--store", d1], REPRO_SANITIZE="1")
        for tag, r in (("plain", plain), ("cold", cold), ("warm", warm), ("garbled", garbled)):
            check(r["streams"] == plain["streams"],
                  f"[warm-restart] phi3 {tag} streams differ from plain:\n{r['streams']}\n"
                  f"{plain['streams']}")
            _check_launches(f"phi3 {tag}", r, norms)
            out[f"boot_phi3_{tag}"] = r["launches"]
        keys = cold["store"]["entries"]
        check(keys >= 2 and cold["store"]["stats"]["saves"] >= keys
              and os.path.exists(os.path.join(d1, "ledger.json")),
              f"[warm-restart] cold boot: {keys} keys, store {cold['store']}")
        _check_warm("phi3", warm, keys)
        gstats = garbled["store"]["stats"]
        check(gstats["load_failures"] >= 2 and "unusable" in err and garbled["sanitize"]
              and garbled["kernels_built"].get("Kernel", 0) >= 2 and gstats["saves"] >= 2
              and garbled["sanitizer_checks"] > 0,
              f"[warm-restart] garbled boot: store {garbled['store']}, kernels "
              f"{garbled['kernels_built']}, sanitizer {garbled['sanitizer_checks']} checks")
        build_ms, load_ms = _per_entry(cold, warm)
        san_ms = garbled["sanitizer_seconds"] / garbled["sanitizer_checks"] * 1e3
        log(f"[warm-restart] phi3 store: {keys} entries, bytes on disk {sizes}; build "
            f"{build_ms:.2f} ms a kernel (cold) vs load {load_ms:.2f} ms (warm; of it the file "
            f"read {_read_ms(warm):.2f} ms); garbled "
            f"{bad}: {gstats['load_failures']} load failures, rebuilt and saved again "
            f"{gstats['saves']}; sanitizer {garbled['sanitizer_checks']} checks, "
            f"{san_ms:.3f} ms host a check (an admission, evict or relocation edge)")
        for line in err.splitlines():
            if "unusable" in line or "deserialize" in line:
                log(f"[warm-restart] garbled boot warned: {line[:240]}")
        ttft = {t: r["first_token_seconds"] for t, r in
                (("plain", plain), ("cold", cold), ("warm", warm), ("garbled", garbled))}
        log(f"[warm-restart] phi3 first token from process start: "
            + ", ".join(f"{t} {v['from_process_start']:.2f} s" for t, v in ttft.items())
            + f"; warm - cold {ttft['warm']['from_process_start'] - ttft['cold']['from_process_start']:+.2f} s")

        # a two-member fleet persisting into one directory, cold then warm
        f_cold, _ = boot("phi3 fleet cold", PHI3_BOOT + ["--fleet", "2", "--store", d3])
        f_warm, _ = boot("phi3 fleet warm", PHI3_BOOT + ["--fleet", "2", "--store", d3])
        for tag, r in (("cold", f_cold), ("warm", f_warm)):
            check(r["streams"] == plain["streams"],
                  f"[warm-restart] phi3 fleet {tag} streams differ from plain:\n{r['streams']}")
            _check_launches(f"phi3 fleet {tag}", r, norms)
            out[f"boot_phi3_fleet_{tag}"] = r["launches"]
        f_keys = f_cold["store"]["entries"]
        check(f_keys >= 2 and f_cold["store"]["stats"]["saves"] >= f_keys
              and f_cold["kernels_built"].get("Kernel", 0) >= f_keys
              and f_cold["store_hits"] == 0 and os.path.exists(os.path.join(d3, "ledger.json")),
              f"[warm-restart] fleet cold boot: {f_keys} keys, kernels {f_cold['kernels_built']}, "
              f"store {f_cold['store']}")
        _check_warm("phi3 fleet", f_warm, f_keys)
        check(set(f_warm["kernels_built"]) == {"loaded"},
              f"[warm-restart] fleet warm boot built kernels: {f_warm['kernels_built']}")
        build_ms, load_ms = _per_entry(f_cold, f_warm)
        log(f"[warm-restart] phi3 fleet (2 members, one store): {f_keys} entries saved by the "
            f"cold boot ({f_cold['store']['stats']['saves']} saves), all loaded by the warm boot "
            f"({f_warm['store_hits']} store hits, kernels {f_warm['kernels_built']}); build "
            f"{build_ms:.2f} ms a kernel vs load {load_ms:.2f} ms (of it the file read "
            f"{_read_ms(f_warm):.2f} ms); first token from process "
            f"start cold {f_cold['first_token_seconds']['from_process_start']:.2f} s, warm "
            f"{f_warm['first_token_seconds']['from_process_start']:.2f} s")

        m_plain, _ = boot("mamba2 plain", MAMBA_BOOT)
        m_cold, _ = boot("mamba2 cold", MAMBA_BOOT + ["--store", d2])
        m_warm, _ = boot("mamba2 warm", MAMBA_BOOT + ["--store", d2])
        for tag, r in (("plain", m_plain), ("cold", m_cold), ("warm", m_warm)):
            check(r["streams"] == m_plain["streams"],
                  f"[warm-restart] mamba2 {tag} streams differ from plain")
            _check_launches(f"mamba2 {tag}", r, MAMBA_BOOT_LAYERS + 1, MAMBA_BOOT_LAYERS)
            out[f"boot_mamba_{tag}"] = r["launches"]
        m_keys = m_cold["store"]["entries"]
        _check_warm("mamba2", m_warm, m_keys)
        build_ms, load_ms = _per_entry(m_cold, m_warm)
        log(f"[warm-restart] mamba2 store: {m_keys} entries, {m_cold['store']['payload_bytes']}"
            f" payload bytes; build {build_ms:.2f} ms a kernel vs load {load_ms:.2f} ms; "
            f"downloads cold {m_cold['downloads']} vs warm {m_warm['downloads']} (the planner "
            f"with the seeded ledger; measured, not required); first token from process "
            f"start cold {m_cold['first_token_seconds']['from_process_start']:.2f} s, warm "
            f"{m_warm['first_token_seconds']['from_process_start']:.2f} s")
    return out


def phase_analysis() -> dict:
    """[analysis]: ``python -m repro_torch.analysis report`` on the card."""
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "report"],
                          capture_output=True, text=True, timeout=BOOT_TIMEOUT_S, cwd=ROOT,
                          env=_env())
    for line in proc.stdout.splitlines():
        log(f"[analysis] {line[:300]}")
    if proc.returncode != 0:
        for line in proc.stderr.splitlines()[-20:]:
            log(f"[analysis] stderr: {line[:300]}")
    check(proc.returncode == 0 and proc.stdout.rstrip().endswith("PASS"),
          f"[analysis] report exited {proc.returncode}")
    check("fleet records: 0 violation(s)" in proc.stdout
          and "fleet describe(): 0 violation(s)" in proc.stdout,
          "[analysis] the report's fleet half did not run clean")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("kernel launches "))
    return json.loads(line.removeprefix("kernel launches "))


def phase_small_reference() -> None:
    """A small float32 phi3 (d_model 128, 2 layers) on the card (CUDA
    kernels) against the same model on the CPU (plain versions).
    Tolerance 1e-2 * (1 + |logit|): f32 everywhere except the bf16 KV
    cache.  A cached key or value an f32 ulp apart on the two devices can
    round to neighbouring bf16 values, 2**-8 (0.4%) apart, and that moves
    the logits by a few 1e-3."""
    from repro_torch.configs import smoke_config
    cfg = smoke_config("phi3-mini-3.8b").scaled(d_model=128, head_dim=32,
                                                dtype="float32")
    cpu = _to(pm.init(cfg, torch.Generator().manual_seed(SEED), "cpu"), "cpu",
              torch.float32)
    cuda = _to(cpu, DEV)
    toks = torch.tensor([[5, 17, 42, 99, 7, 3]], dtype=torch.int32)
    lc, cc = mdl.prefill(cpu, cfg, toks, mdl.init_cache(cfg, 1, 16, "cpu"))
    lg, cg = mdl.prefill(cuda, cfg, toks.to(DEV), mdl.init_cache(cfg, 1, 16, DEV))
    dc, _ = mdl.decode_step(cpu, cfg, toks[:, :1], cc)
    dg, _ = mdl.decode_step(cuda, cfg, toks[:, :1].to(DEV), cg)
    for name, want, got in (("prefill", lc, lg), ("decode", dc, dg)):
        got = got.cpu()
        check(bool((got - want).abs().le(1e-2 * (1 + want.abs())).all()),
              f"small model {name}: card vs CPU max err {(got - want).abs().max().item()}")
        log(f"[reference] small f32 phi3 {name} logits: card (kernels) vs CPU "
            f"(plain) max err {(got - want).abs().max().item():.3g}")


def _to(tree, dev, dtype=None):
    """A copy of ``tree`` on ``dev`` (a copy even where nothing moves: the
    eager train step updates its parameters in place)."""
    if torch.is_tensor(tree):
        return tree.to(device=dev, dtype=dtype, copy=True)
    if isinstance(tree, list):
        return [_to(t, dev, dtype) for t in tree]
    return {k: _to(v, dev, dtype) for k, v in tree.items()}


def flash_bound_ms(b: int, hq: int, hkv: int, s: int, d: int,
                   window: int | None = None, *, sk: int | None = None,
                   causal: bool = True) -> tuple[float, str]:
    """The least time of attention on the card, bf16: q, k, v read once and
    o written once against QK^T and PV over the (query, key) pairs the mask
    keeps on the tensor cores — the causal half, or with a window each
    query's last ``window`` keys; without ``causal`` all ``s`` x ``sk``
    pairs of ``s`` queries over ``sk`` keys (default ``s``)."""
    sk = s if sk is None else sk
    bytes_ = (2 * b * hq * s * d + 2 * b * hkv * sk * d) * 2
    if causal:
        w = s if window is None else min(window, s)
        pairs = w * (w + 1) // 2 + (s - w) * w
    else:
        pairs = s * sk
    flops = 4 * b * hq * d * pairs
    by = "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S else "operations"
    return max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3, by


def ssd_bound_ms(bh: int, nc: int, L: int, p: int, n: int) -> tuple[float, str]:
    """bf16 x, b, c and f32 a read once, f32 y_diag, states and a_cum
    written once, against the chunk's products on the tensor cores: C B^T
    and S x over the causal half, and the chunk state."""
    rows = bh * nc
    bytes_ = (rows * L * (p + 2 * n) * 2 + rows * L * 4            # x, b, c bf16 and a f32 read
              + rows * (L * p + n * p + L) * 4)                    # y_diag, states, a_cum f32 written
    flops = rows * (2 * n * L * (L + 1) // 2        # C B^T over the causal half
                    + 2 * p * L * (L + 1) // 2      # S x over the causal half
                    + 2 * n * p * L)                # the chunk state
    by = "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S else "operations"
    return max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3, by


VMUL_SWEEP = tuple(1 << k for k in range(12, 19))
RMSNORM_TIMED = ((BATCH, 3072), (PROMPT, 3072), (BATCH * PROMPT, 3072), (LOOP_CHUNK, 3072),
                 (TRAIN_SEQ, 3072),
                 (8192, 3072), (TRAIN_SEQ, MAMBA_D), (MAMBA_BATCH, MAMBA_D),
                 (BATCH, GEMMA_D), (PROMPT, GEMMA_D), (GEMMA_LONG, GEMMA_D), (BATCH, 2304),
                 (PROMPT, 2304), (BATCH, 12288), (PROMPT, 12288), (BATCH, ZAMBA_D),
                 (ZAMBA_LONG, ZAMBA_D), (BATCH, GRANITE_D), (PROMPT, GRANITE_D),
                 (GRANITE_LONG, GRANITE_D),
                 *((BATCH * n, SEAMLESS_D) for n, _ in reversed(SEAMLESS_ROUNDS)),
                 (GEMMA_TRAIN_SEQ, GEMMA_D), (TRAIN_SEQ, MINICPM_D))


def vmul_bound_ms(n: int) -> tuple[float, str]:
    """a and b (f32) read once, one f32 written, against 2n float32 operations."""
    bytes_, flops = 2 * n * 4 + 4, 2 * n
    by = "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations"
    return max(bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3, by


def rmsnorm_bound_ms(rows: int, d: int) -> tuple[float, str]:
    """bf16 x read and y written once, f32 w read once, against 4 float32
    operations an element."""
    bytes_, flops = 2 * rows * d * 2 + d * 4, 4 * rows * d
    by = "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations"
    return max(bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3, by


def loop_chunk_states(states: torch.Tensor, a_tot: torch.Tensor, init: torch.Tensor):
    """The inter-chunk recurrence as the port ran it before its closed form:
    a Python loop over chunks, a few ops each.  Kept here only as the timing
    yardstick of ``ref.chunk_states``; the port does not call it."""
    carry, prev = init, []
    for ci in range(states.shape[1]):
        prev.append(carry)
        carry = carry * torch.exp(a_tot[:, ci])[:, None, None] + states[:, ci]
    return torch.stack(prev, dim=1), carry


def _host_ms(fn, calls: int = 20) -> float:
    """Median host ms for ``fn()`` to return (its work queued, not done),
    each call timed alone after a synchronize."""
    fn()
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(out))


def time_ssd_cases(gen: torch.Generator) -> None:
    """ssd_chunk's device ms at every ``SSD_CASES`` shape on every variant
    that takes it (CUDA-graph replays, the variants in turns)."""
    for bh, nc, L, p, n, dt, span in SSD_CASES:
        x = torch.randn(bh, nc, L, p, generator=gen, device=DEV).to(dt)
        b, c = (torch.randn(bh, nc, L, n, generator=gen, device=DEV).to(dt) for _ in range(2))
        a = -torch.rand(bh, nc, L, generator=gen, device=DEV) * (2 * span / L)
        kernels = ssd_mod.VARIANTS if ssd_mod.variant(x, a, b, c) == "mma" else ("simt",)
        ms = {k: [] for k in kernels}
        for k in (*kernels, *reversed(kernels)):
            ms[k].append(device_ms(lambda k=k: ssd_mod.ssd_chunk(x, a, b, c, chunk=L, kernel=k),
                                   calls=20, replays=3))
        log(f"[timing] ssd_chunk x ({bh}, {nc}, {L}, {p}) n {n} {str(dt)[6:]}, a_cum span {span}, "
            f"device ms (best of two, in turns): " +
            ", ".join(f"{k} {min(v):.4f}" for k, v in ms.items()))
        del x, a, b, c


def time_chunk_states(gen: torch.Generator) -> None:
    """The inter-chunk recurrence at the path's shape (a 4096-token row of 24
    heads: 64 chunk states of (128, 64), f32) as the old loop over chunks and
    in closed form (``ref.chunk_states``), on the same inputs: device ms
    (CUDA-graph replay) and host ms to issue a call, and their difference
    (another order of the same f32 sums)."""
    bh, nc, _, p, n = SSD_PATH
    states = torch.randn(bh, nc, n, p, generator=gen, device=DEV)
    a_tot = -4.0 * torch.rand(bh, nc, generator=gen, device=DEV)
    init = torch.randn(bh, n, p, generator=gen, device=DEV)
    (p_loop, f_loop), (p_cf, f_cf) = (loop_chunk_states(states, a_tot, init),
                                      ref.chunk_states(states, a_tot, init))
    err = max((p_cf - p_loop).abs().max().item() / p_loop.abs().max().item(),
              (f_cf - f_loop).abs().max().item() / f_loop.abs().max().item())
    check(err <= 1e-5, f"closed-form chunk states differ from the loop by {err} (normwise)")
    fns = {"loop": lambda: loop_chunk_states(states, a_tot, init),
           "closed form": lambda: ref.chunk_states(states, a_tot, init)}
    dev = {k: device_ms(f, calls=10, replays=5) for k, f in fns.items()}
    host = {k: _host_ms(f) for k, f in fns.items()}
    log(f"[timing] inter-chunk recurrence ({bh}, {nc}) chunk states of ({n}, {p}) f32: loop over "
        f"chunks device {dev['loop']:.4f} ms, host {host['loop']:.4f} ms a call; closed form "
        f"device {dev['closed form']:.4f} ms, host {host['closed form']:.4f} ms; normwise "
        f"difference {err:.3g}")


def flash_timing(gen: torch.Generator, b: int, hq: int, hkv: int, sq: int, hd: int, *,
                 causal: bool = True) -> dict:
    """flash_attention at q (b, hq, sq, hd) over k, v (b, hkv, sq, hd), bf16,
    causal unless ``causal`` is False: ms a call and on the device alone,
    beside its bound, the plain version and SDPA (``enable_gqa`` where hq !=
    hkv); logs a [timing] line."""
    import torch.nn.functional as F
    q = torch.randn(b, hq, sq, hd, generator=gen, device=DEV).bfloat16()
    k, v = (torch.randn(b, hkv, sq, hd, generator=gen, device=DEV).bfloat16() for _ in range(2))
    bound, by = flash_bound_ms(b, hq, hkv, sq, hd, causal=causal)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,  # noqa: E731
                                                  enable_gqa=hq != hkv)
    mask = "causal" if causal else "not causal"
    row = {
        "shape": (f"q, k, v: ({b}, {hq}, {sq}, {hd}) bfloat16, {mask}" if hq == hkv else
                  f"q ({b}, {hq}, {sq}, {hd}), k, v ({b}, {hkv}, {sq}, {hd}) bfloat16, {mask}"),
        "variant": fa_mod.variant(q.dtype, hd),
        "ms": time_ms(lambda: fa_mod.flash_attention(q, k, v, causal=causal), 50, warmup=5),
        "device_ms": device_ms(lambda: fa_mod.flash_attention(q, k, v, causal=causal),
                               calls=20, replays=3),
        "plain_ms": time_ms(lambda: fa_mod.plain(q, k, v, causal=causal), 3, warmup=1),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(sdpa, 50, warmup=5),
        "library_device_ms": device_ms(sdpa, calls=20, replays=3)}
    log(f"[timing] flash_attention {row['shape']}: {row['variant']} {row['ms']:.4f} ms per "
        f"call, device {row['device_ms']:.4f} ms ({bound / row['device_ms']:.0%} of the bound "
        f"{bound:.4f} ms, by {by}); plain {row['plain_ms']:.4f} ms; SDPA"
        f"{' (enable_gqa)' if hq != hkv else ''} {row['library_ms']:.4f} ms, device "
        f"{row['library_device_ms']:.4f} ms")
    return row


def phase_kernel_line(gen: torch.Generator, errs: dict, launches: dict) -> list[dict]:
    """Time each kernel at the main path's shape beside its bound, its plain
    version and one library call computing the same function."""
    import torch.nn.functional as F
    out = []
    n = PAPER_VECTOR_LEN
    a = torch.randn(n, generator=gen, device=DEV)
    b = torch.randn(n, generator=gen, device=DEV)
    bound, by = vmul_bound_ms(n)
    out.append({
        "name": "vmul_reduce", "route": "cuda",
        "source": "src/repro_torch/csrc/vmul_reduce.cu",
        "replaces": "src/repro/kernels/vmul_reduce.py:63",
        "launches": launches["vmul_reduce"],
        "launches_by_variant": {v_: launches[f"vmul_reduce/{v_}"]
                                for v_ in vr_mod.launches.variants},
        "max_abs_err": errs["vmul_reduce"],
        "ms": time_ms(lambda: vr_mod.vmul_reduce_cuda(a, b), 500),
        "device_ms": device_ms(lambda: vr_mod.vmul_reduce_cuda(a, b)),
        "plain_ms": time_ms(lambda: vr_mod.plain(a, b), 500),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(lambda: torch.dot(a, b), 500),
        "library_device_ms": device_ms(lambda: torch.dot(a, b)),
        "shape": f"a, b: ({n},) float32"})
    rows, d = BATCH, 3072                       # the decode step's norms
    x = torch.randn(rows, d, generator=gen, device=DEV).bfloat16()
    w = torch.ones(d, device=DEV)
    bound, by = rmsnorm_bound_ms(rows, d)
    out.append({
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:44",
        "launches": launches["rmsnorm"],
        "launches_by_variant": {v_: launches[f"rmsnorm/{v_}"] for v_ in rn_mod.VARIANTS},
        "max_abs_err": errs["rmsnorm"],
        "ms": time_ms(lambda: rn_mod.rmsnorm_cuda(x, w), 500),
        "device_ms": device_ms(lambda: rn_mod.rmsnorm_cuda(x, w)),
        "plain_ms": time_ms(lambda: rn_mod.plain(x, w), 500),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w.bfloat16(), 1e-6), 500),
        "library_device_ms": device_ms(lambda: F.rms_norm(x, (d,), w.bfloat16(), 1e-6)),
        "shape": f"x: ({rows}, {d}) bfloat16, w: ({d},) float32"})
    out[-1]["granite_shapes"] = []                # granite's decode rows and long prefill
    for rows, d in ((BATCH, GRANITE_D), (GRANITE_LONG, GRANITE_D)):
        x = torch.randn(rows, d, generator=gen, device=DEV).bfloat16()
        w = torch.ones(d, device=DEV)
        bound, by = rmsnorm_bound_ms(rows, d)
        out[-1]["granite_shapes"].append({
            "shape": f"x: ({rows}, {d}) bfloat16, w: ({d},) float32",
            "variant": rn_mod.variant(x, x),
            "ms": time_ms(lambda: rn_mod.rmsnorm_cuda(x, w), 500),
            "device_ms": device_ms(lambda: rn_mod.rmsnorm_cuda(x, w)),
            "plain_ms": time_ms(lambda: rn_mod.plain(x, w), 500),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w.bfloat16(), 1e-6), 500),
            "library_device_ms": device_ms(lambda: F.rms_norm(x, (d,), w.bfloat16(), 1e-6))})
    out[-1]["deepseek_shapes"] = []              # deepseek's decode rows and long prefill
    for rows in (BATCH, DEEPSEEK_LONG):
        for d in (DEEPSEEK_D, DEEPSEEK_Q_LORA, DEEPSEEK_KV_LORA):
            x = torch.randn(rows, d, generator=gen, device=DEV).bfloat16()
            w = torch.ones(d, device=DEV)
            bound, by = rmsnorm_bound_ms(rows, d)
            out[-1]["deepseek_shapes"].append({
                "shape": f"x: ({rows}, {d}) bfloat16, w: ({d},) float32",
                "variant": rn_mod.variant(x, x),
                "ms": time_ms(lambda: rn_mod.rmsnorm_cuda(x, w), 500),
                "device_ms": device_ms(lambda: rn_mod.rmsnorm_cuda(x, w)),
                "plain_ms": time_ms(lambda: rn_mod.plain(x, w), 500),
                "bound_ms": bound, "bound_by": by,
                "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w.bfloat16(), 1e-6), 500),
                "library_device_ms": device_ms(
                    lambda: F.rms_norm(x, (d,), w.bfloat16(), 1e-6))})
    out[-1]["seamless_shapes"] = []              # seamless's encoder rows at 4096 and 1024 frames
    for rows in (BATCH * n for n, _ in reversed(SEAMLESS_ROUNDS)):
        x = torch.randn(rows, SEAMLESS_D, generator=gen, device=DEV).bfloat16()
        w = torch.ones(SEAMLESS_D, device=DEV)
        bound, by = rmsnorm_bound_ms(rows, SEAMLESS_D)
        out[-1]["seamless_shapes"].append({
            "shape": f"x: ({rows}, {SEAMLESS_D}) bfloat16, w: ({SEAMLESS_D},) float32",
            "variant": rn_mod.variant(x, x),
            "ms": time_ms(lambda: rn_mod.rmsnorm_cuda(x, w), 500),
            "device_ms": device_ms(lambda: rn_mod.rmsnorm_cuda(x, w)),
            "plain_ms": time_ms(lambda: rn_mod.plain(x, w), 500),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lambda: F.rms_norm(x, (SEAMLESS_D,), w.bfloat16(), 1e-6), 500),
            "library_device_ms": device_ms(
                lambda: F.rms_norm(x, (SEAMLESS_D,), w.bfloat16(), 1e-6))})
    # pixtral's decode rows, its patch prefills at batch 2 (512 and 2048
    # tokens; the train launcher's and the training step's rows are 1024
    # and 4096 too) and its step graph's 2048 rows, all on the block kernel
    out[-1]["pixtral_shapes"] = []
    for rows in (BATCH, *(BATCH * n for n, _ in PIXTRAL_ROUNDS), PIXTRAL_FLASH[3]):
        x = torch.randn(rows, PIXTRAL_D, generator=gen, device=DEV).bfloat16()
        w = torch.ones(PIXTRAL_D, device=DEV)
        bound, by = rmsnorm_bound_ms(rows, PIXTRAL_D)
        out[-1]["pixtral_shapes"].append({
            "shape": f"x: ({rows}, {PIXTRAL_D}) bfloat16, w: ({PIXTRAL_D},) float32",
            "variant": rn_mod.variant(x, x),
            "ms": time_ms(lambda: rn_mod.rmsnorm_cuda(x, w), 500),
            "device_ms": device_ms(lambda: rn_mod.rmsnorm_cuda(x, w)),
            "plain_ms": time_ms(lambda: rn_mod.plain(x, w), 500),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lambda: F.rms_norm(x, (PIXTRAL_D,), w.bfloat16(), 1e-6), 500),
            "library_device_ms": device_ms(
                lambda: F.rms_norm(x, (PIXTRAL_D,), w.bfloat16(), 1e-6))})
    del x, w
    b, h, sq, hd = TRAIN_BATCH, 32, TRAIN_SEQ, 96      # the training path's attention
    q, k, v = (torch.randn(b, h, sq, hd, generator=gen, device=DEV).bfloat16()
               for _ in range(3))
    bound, by = flash_bound_ms(b, h, h, sq, hd)
    out.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:115",
        "launches": launches["flash_attention"],
        "launches_by_variant": {v_: launches[f"flash_attention/{v_}"] for v_ in fa_mod.VARIANTS},
        "max_abs_err": errs["flash_attention"],
        "ms": time_ms(lambda: fa_mod.flash_attention(q, k, v), 50, warmup=5),
        "device_ms": device_ms(lambda: fa_mod.flash_attention(q, k, v), calls=20, replays=3),
        "variant": fa_mod.variant(q.dtype, hd),
        "simt_ms": time_ms(lambda: fa_mod.flash_attention(q, k, v, kernel="simt"), 5, warmup=1),
        "plain_ms": time_ms(lambda: fa_mod.plain(q, k, v), 3, warmup=1),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                              50, warmup=5),
        "library_device_ms": device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), calls=20, replays=3),
        "shape": f"q, k, v: ({b}, {h}, {sq}, {hd}) bfloat16, causal"})
    del q, k, v
    # the cache-free forwards of zamba2 (head dim 112), granite (16 over 8
    # heads of 64) and pixtral (32 over 8 of 128, serving's 2048 and
    # training's 4096 tokens), and minicpm's training forward (36 heads of 64)
    out[-1]["zamba2_shape"] = flash_timing(gen, ZAMBA_FLASH[0], ZAMBA_FLASH[1], *ZAMBA_FLASH[1:])
    out[-1]["granite_shape"] = flash_timing(gen, *GRANITE_FLASH)
    out[-1]["pixtral_shape"] = flash_timing(gen, *PIXTRAL_FLASH)
    out[-1]["pixtral_train_shape"] = flash_timing(gen, *PIXTRAL_TRAIN_FLASH)
    out[-1]["minicpm_shape"] = flash_timing(gen, MINICPM_FLASH[0], MINICPM_FLASH[1],
                                            *MINICPM_FLASH[1:])
    # deepseek's MTP layer in training: 128 heads of 56 over 2047 positions,
    # on the CUDA-core kernel
    out[-1]["deepseek_mtp_shape"] = flash_timing(gen, *DEEPSEEK_MTP_FLASH)
    # seamless's training attention, 16 heads of 64 over 4096 positions: the
    # decoder's self-attention (causal), the encoder's and the cross (not)
    out[-1]["seamless_train_shapes"] = [flash_timing(gen, *SEAMLESS_TRAIN_FLASH, causal=c)
                                        for c in (True, False)]
    # seamless's encoder at 4096 and 1024 frames and a cache-free
    # cross-attention of 16 queries over 4096 keys: not causal, every (query,
    # key) pair; SDPA with is_causal=False beside each
    out[-1]["seamless_shapes"] = []
    h, hd = SEAMLESS_HEADS, SEAMLESS_HEAD_DIM
    for sq, sk in ((SEAMLESS_ROUNDS[1][0],) * 2, (SEAMLESS_ROUNDS[0][0],) * 2,
                   (SEAMLESS_CROSS_Q, SEAMLESS_ROUNDS[1][0])):
        q = torch.randn(BATCH, h, sq, hd, generator=gen, device=DEV).bfloat16()
        k, v = (torch.randn(BATCH, h, sk, hd, generator=gen, device=DEV).bfloat16()
                for _ in range(2))
        bound, by = flash_bound_ms(BATCH, h, h, sq, hd, sk=sk, causal=False)
        out[-1]["seamless_shapes"].append({
            "shape": f"q ({BATCH}, {h}, {sq}, {hd}), k, v ({BATCH}, {h}, {sk}, {hd}) bfloat16, "
                     f"not causal",
            "variant": fa_mod.variant(q.dtype, hd),
            "ms": time_ms(lambda: fa_mod.flash_attention(q, k, v, causal=False), 50, warmup=5),
            "device_ms": device_ms(lambda: fa_mod.flash_attention(q, k, v, causal=False),
                                   calls=20, replays=3),
            "plain_ms": time_ms(lambda: fa_mod.plain(q, k, v, causal=False), 3, warmup=1),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=False), 50, warmup=5),
            "library_device_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=False), calls=20, replays=3)})
        row = out[-1]["seamless_shapes"][-1]
        log(f"[timing] flash_attention {row['shape']}: {row['variant']} {row['ms']:.4f} ms per "
            f"call, device {row['device_ms']:.4f} ms ({bound / row['device_ms']:.0%} of the "
            f"bound {bound:.4f} ms, by {by}); plain {row['plain_ms']:.4f} ms; SDPA "
            f"(is_causal=False) {row['library_ms']:.4f} ms, device "
            f"{row['library_device_ms']:.4f} ms")
        del q, k, v
    bh, nc, L, p, n = SSD_PATH                          # a 4096-token mamba2 prefill or train row
    x = torch.randn(bh, nc, L, p, generator=gen, device=DEV).bfloat16()
    b, c = (torch.randn(bh, nc, L, n, generator=gen, device=DEV).bfloat16() for _ in range(2))
    a = -torch.rand(bh, nc, L, generator=gen, device=DEV) * (4.0 / L)
    bound, by = ssd_bound_ms(bh, nc, L, p, n)
    out.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:73",
        "launches": launches["ssd_chunk"],
        "launches_by_variant": {v_: launches[f"ssd_chunk/{v_}"] for v_ in ssd_mod.VARIANTS},
        "max_abs_err": errs["ssd_chunk"],
        "ms": time_ms(lambda: ssd_mod.ssd_chunk(x, a, b, c, chunk=L), 50),
        "device_ms": device_ms(lambda: ssd_mod.ssd_chunk(x, a, b, c, chunk=L), calls=20, replays=3),
        "variant": ssd_mod.variant(x, a, b, c),
        "simt_ms": time_ms(lambda: ssd_mod.ssd_chunk(x, a, b, c, chunk=L, kernel="simt"), 20),
        "simt_device_ms": device_ms(lambda: ssd_mod.ssd_chunk(x, a, b, c, chunk=L, kernel="simt"),
                                    calls=20, replays=3),
        "plain_ms": time_ms(lambda: ssd_mod.plain(x, a, b, c, chunk=L), 20),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "library_device_ms": None,
        "library_note": "no single PyTorch call computes the chunk-local SSD terms",
        "shape": f"x ({bh}, {nc}, {L}, {p}), b/c n {n} bfloat16, a float32"})
    del x, a, b, c
    bh, nc, L, p, n = ZAMBA_SSD                        # zamba2's 4096-token prefill, state 64
    x = torch.randn(bh, nc, L, p, generator=gen, device=DEV).bfloat16()
    b, c = (torch.randn(bh, nc, L, n, generator=gen, device=DEV).bfloat16() for _ in range(2))
    a = -torch.rand(bh, nc, L, generator=gen, device=DEV) * (4.0 / L)
    bound, by = ssd_bound_ms(bh, nc, L, p, n)
    out[-1]["zamba2_shape"] = {
        "shape": f"x ({bh}, {nc}, {L}, {p}), b/c n {n} bfloat16, a float32",
        "variant": ssd_mod.variant(x, a, b, c),
        "smem_bytes_a_block": ssd_mod.smem_bytes(L, p, n),
        "ms": time_ms(lambda: ssd_mod.ssd_chunk(x, a, b, c, chunk=L), 20),
        "device_ms": device_ms(lambda: ssd_mod.ssd_chunk(x, a, b, c, chunk=L), calls=20,
                               replays=3),
        "plain_ms": time_ms(lambda: ssd_mod.plain(x, a, b, c, chunk=L), 20),
        "bound_ms": bound, "bound_by": by,
        "library_ms": None, "library_device_ms": None}
    del x, a, b, c
    torch.cuda.empty_cache()
    time_ssd_cases(gen)
    time_chunk_states(gen)
    # flash_attention at the train-overlay phase's shape and, for reach, GQA at d 128
    for b, hq, hkv, s, hd in ((1, 32, 32, OVERLAY_SEQ, 96), (2, 8, 2, 2048, 128)):
        q = torch.randn(b, hq, s, hd, generator=gen, device=DEV).bfloat16()
        k, v = (torch.randn(b, hkv, s, hd, generator=gen, device=DEV).bfloat16() for _ in range(2))
        bound, by = flash_bound_ms(b, hq, hkv, s, hd)
        ms = time_ms(lambda: fa_mod.flash_attention(q, k, v), 50, warmup=5)
        simt = time_ms(lambda: fa_mod.flash_attention(q, k, v, kernel="simt"), 5, warmup=1)
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=hq != hkv), 50, warmup=5)
        log(f"[timing] flash_attention q ({b}, {hq}, {s}, {hd}) kv heads {hkv} bf16 causal: "
            f"{fa_mod.variant(q.dtype, hd)} {ms:.4f} ms ({bound / ms:.0%} of the bound "
            f"{bound:.4f} ms, by {by}), simt {simt:.4f} ms, SDPA {sdpa:.4f} ms")
        del q, k, v
    # flash_attention at gemma2-27b's shape: local layers (window 4096) and
    # global ones, softcap 50, scale 144^-0.5; SDPA has no softcap, so its
    # time is the causal product at the same shape, the nearest library call
    b, hq, hkv, s, hd = 1, 32, 16, 6144, 128
    q = torch.randn(b, hq, s, hd, generator=gen, device=DEV).bfloat16()
    k, v = (torch.randn(b, hkv, s, hd, generator=gen, device=DEV).bfloat16() for _ in range(2))
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True), 20, warmup=3)
    for window in (4096, None):
        kw = dict(window=window, softcap=50.0, scale=144 ** -0.5)
        bound, by = flash_bound_ms(b, hq, hkv, s, hd, window)
        ms = time_ms(lambda: fa_mod.flash_attention(q, k, v, **kw), 20, warmup=3)
        dev_ms = device_ms(lambda: fa_mod.flash_attention(q, k, v, **kw), calls=10, replays=3)
        plain = time_ms(lambda: fa_mod.plain(q, k, v, **kw), 3, warmup=1)
        log(f"[timing] flash_attention q ({b}, {hq}, {s}, {hd}) kv heads {hkv} bf16 causal, "
            f"window {window}, softcap 50: {fa_mod.variant(q.dtype, hd)} {ms:.4f} ms per call, "
            f"device {dev_ms:.4f} ms ({bound / dev_ms:.0%} of the bound {bound:.4f} ms, by "
            f"{by}); plain {plain:.4f} ms; SDPA (causal, no window, no softcap) {sdpa:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()
    # vmul_reduce: the two launch variants against each other (device time
    # alone), which sets vr_mod.CLUSTER_MAX_N, then the size that shows the
    # bandwidth
    for size in VMUL_SWEEP:
        a = torch.randn(size, generator=gen, device=DEV)
        b = torch.randn(size, generator=gen, device=DEV)
        plans = {f"cluster of {vr_mod.CLUSTER}": vr_mod.Plan(True, vr_mod.CLUSTER),
                 "grid": vr_mod.Plan(False, min(vr_mod.MAX_BLOCKS,
                                                -(-size // vr_mod.ELEMS_PER_BLOCK)))}
        row = {}
        for name in (*plans, *reversed(plans)):     # in turns: a, b, b, a
            row.setdefault(name, []).append(device_ms(
                lambda p=plans[name]: vr_mod.vmul_reduce_cuda(a, b, launch_plan=p), calls=200))
        row = {(f"grid of {plans[k].blocks}" if k == "grid" else k): min(v)
               for k, v in row.items()}
        picked = "cluster" if vr_mod.plan(size).cluster else "grid"
        log(f"[timing] vmul_reduce launch plans n={size} f32, device us per call: " +
            ", ".join(f"{k} {v * 1e3:.2f}" for k, v in row.items()) + f"; plan() picks {picked}")
        del a, b
    size = 1 << 26
    a = torch.randn(size, generator=gen, device=DEV)
    b = torch.randn(size, generator=gen, device=DEV)
    bound, _ = vmul_bound_ms(size)
    ms = time_ms(lambda: vr_mod.vmul_reduce_cuda(a, b), 20)
    dev_ms = device_ms(lambda: vr_mod.vmul_reduce_cuda(a, b), calls=10, replays=3)
    dot = time_ms(lambda: torch.dot(a, b), 20)
    dot_dev = device_ms(lambda: torch.dot(a, b), calls=10, replays=3)
    log(f"[timing] vmul_reduce n={size} f32: {ms:.4f} ms per call (device {dev_ms:.4f}), bound "
        f"{bound:.4f} ms ({bound / ms:.0%} of the byte bound; device {bound / dev_ms:.0%}), plain "
        f"{time_ms(lambda: vr_mod.plain(a, b), 20):.4f} ms, torch.dot {dot:.4f} ms "
        f"(device {dot_dev:.4f}, {bound / dot_dev:.0%})")
    del a, b
    # rmsnorm at every row shape of the paths: phi3's rows, then mamba2's (a
    # 4096-token prefill or train row, a decode batch)
    for rows, d in RMSNORM_TIMED:
        x = torch.randn(rows, d, generator=gen, device=DEV).bfloat16()
        w = torch.ones(d, device=DEV)
        bound, _ = rmsnorm_bound_ms(rows, d)
        ms = time_ms(lambda: rn_mod.rmsnorm_cuda(x, w), 100)
        dev_ms = device_ms(lambda: rn_mod.rmsnorm_cuda(x, w))
        lib = time_ms(lambda: F.rms_norm(x, (d,), w.bfloat16(), 1e-6), 100)
        lib_dev = device_ms(lambda: F.rms_norm(x, (d,), w.bfloat16(), 1e-6))
        log(f"[timing] rmsnorm ({rows}, {d}) bf16 on {rn_mod.variant(x, x)}: {ms:.4f} ms per "
            f"call, device {dev_ms:.4f} ms ({bound / dev_ms:.0%} of the bound {bound:.4f} ms); "
            f"plain {time_ms(lambda: rn_mod.plain(x, w), 100):.4f} ms; F.rms_norm {lib:.4f} ms "
            f"per call, device {lib_dev:.4f} ms ({bound / lib_dev:.0%})")
        del x, w
    return out


PHASE_SECONDS: dict[str, float] = {}


def run_phase(tag: str, fn, *args):
    """``gpu_state`` before the phase, its seconds after."""
    gpu_state(tag)
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[tag] = time.perf_counter() - t0
    log(f"[phase] {tag} {PHASE_SECONDS[tag]:.1f} s")
    return out


# paths whose every ssd_chunk launch is on the CUDA-core kernel (zamba2's
# state 64); every other path's (mamba2's) are on the tensor-core kernel
SIMT_SSD_PATHS = ("serve_zamba2", "step_graph_zamba2")
# how each call of a path splits its rmsnorm launches between the variants
# (every other path's are all on the warp kernel): gemma2's (serving and
# training) and mistral's all on the block kernel (d > MAX_WARP_D), as are
# pixtral's (d 5120: serving, training, the train launcher),
# deepseek's 9 on block (d 7168) and 8 on warp (its latents); deepseek's
# training step 16 on block (its 3 layers' ln1 and ln2 twice, the final norm,
# the MTP module's 3) and 12 on warp (the latents' norms twice)
NORM_SPLITS = {"serve_gemma2": {"block": 1}, "serve_mistral": {"block": 1},
               "train_gemma2": {"block": 1}, "train_gemma2_dots": {"block": 1},
               "train_pixtral": {"block": 1}, "launcher_train_pixtral": {"block": 1},
               "serve_pixtral": {"block": 1}, "serve_pixtral_patches": {"block": 1},
               "step_graph_pixtral": {"block": 1},
               "serve_deepseek": {"block": 9, "warp": 8},
               "step_graph_deepseek": {"block": 9, "warp": 8},
               "train_deepseek": {"block": 16, "warp": 12}}


def main() -> int:
    t_start = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    errs = run_phase("[kernels]", phase_kernel_checks, gen)
    phase_one_launch(gen)
    paper = run_phase("[overlay]", phase_overlay_paper, gen)
    async_fig3 = run_phase("[async-fig3]", phase_async_fig3, gen)
    mesh = run_phase("[mesh]", phase_mesh, gen)
    train_mesh = run_phase("[train-mesh]", phase_train_mesh)
    serve_mesh = run_phase("[serve-mesh]", phase_serve_mesh, gen)
    run_phase("[dryrun]", phase_dryrun)
    served = run_phase("[serve]", phase_serve, gen)
    trained = run_phase("[train]", phase_train)
    train_overlay = run_phase("[train-overlay]", phase_train_overlay)
    served_mamba = run_phase("[serve-mamba]", phase_serve_mamba, gen)
    trained_mamba = run_phase("[train-mamba]", phase_train_mamba)
    trained_gemma2 = run_phase("[train-gemma2]", phase_train_gemma2)
    trained_minicpm = run_phase("[train-minicpm]", phase_train_minicpm)
    trained_granite = run_phase("[train-granite]", phase_train_granite)
    trained_pixtral = run_phase("[train-pixtral]", phase_train_pixtral)
    trained_deepseek = run_phase("[train-deepseek]", phase_train_deepseek)
    trained_seamless = run_phase("[train-seamless]", phase_train_seamless)
    gemma2 = run_phase("[serve-gemma2]", phase_serve_gemma2, gen)
    archs = run_phase("[serve-archs]", phase_serve_archs, gen)
    zamba2 = run_phase("[serve-zamba2]", phase_serve_zamba2, gen)
    granite = run_phase("[serve-granite]", phase_serve_granite, gen)
    deepseek = run_phase("[serve-deepseek]", phase_serve_deepseek, gen)
    seamless = run_phase("[serve-seamless]", phase_serve_seamless, gen)
    pixtral = run_phase("[serve-pixtral]", phase_serve_pixtral, gen)
    step_graphs = run_phase("[step-graph]", phase_step_graph, gen)
    run_phase("[reference]", lambda: (phase_small_reference(), phase_small_train_reference(),
                                      phase_small_mamba_reference(),
                                      phase_small_gemma2_reference(),
                                      phase_small_zamba2_reference(),
                                      phase_small_granite_reference(),
                                      phase_small_deepseek_reference(),
                                      phase_small_seamless_reference(),
                                      phase_small_pixtral_reference()))
    launcher = run_phase("[launcher]", phase_launcher)
    booted = run_phase("[warm-restart]", phase_warm_restart)
    analysis = run_phase("[analysis]", phase_analysis)
    gpu_state("[timing]")
    by_path = {"fig3": paper["launches"], "async_fig3": async_fig3, "mesh": mesh,
               "train_mesh": train_mesh["launches"],
               "train_mesh_single": train_mesh["single_launches"],
               "serve_mesh_single": serve_mesh["single"], "serve_mesh": serve_mesh["default"],
               "serve_mesh_serve_rules": serve_mesh["serve"],
               "serve_mesh_chunked": serve_mesh["chunked"],
               "serve": served["launches"],
               "relocate": served["relocate"], "specialize": served["specialize"],
               "serve_loop": served["serve_loop"]["launches"],
               "serve_loop_sync_overlay": served["serve_loop"]["sync_overlay_launches"],
               **served["fleet"],
               "train": trained["launches"], "train_overlay": train_overlay,
               "serve_mamba": served_mamba["launches"],
               "serve_mamba_cost_model": served_mamba["launches_cost_model"],
               "train_mamba": trained_mamba["launches"],
               "train_gemma2": trained_gemma2["launches"],
               "train_gemma2_dots": trained_gemma2["launches_dots"],
               "train_minicpm": trained_minicpm["launches"],
               "train_granite": trained_granite["launches"],
               "train_pixtral": trained_pixtral["launches"],
               "train_deepseek": trained_deepseek["launches"],
               "train_seamless": trained_seamless["launches"],
               "serve_gemma2": gemma2["launches"],
               "serve_minicpm": archs["minicpm-2b"]["launches"],
               "serve_mistral": archs["mistral-large-123b"]["launches"],
               "serve_zamba2": zamba2["launches"],
               "serve_granite": granite["launches"],
               "serve_deepseek": deepseek["launches"],
               "serve_seamless": seamless["launches"],
               "serve_pixtral": pixtral["launches"],
               "serve_pixtral_patches": pixtral["launches_patches"],
               **step_graphs, "launcher_train_pixtral": launcher, **booted,
               "analysis": analysis}
    launches = {name: sum(p[name] for p in by_path.values()) for name in counts()}
    for path, n in by_path.items():
        split = NORM_SPLITS.get(path, {"warp": 1})
        check(all(n[f"rmsnorm/{v}"] * sum(split.values()) == n["rmsnorm"] * split.get(v, 0)
                  for v in rn_mod.VARIANTS),
              f"{path}: rmsnorm launches by variant {n} (they must split as {split} a call)")
        kind = "simt" if path in SIMT_SSD_PATHS else "mma"
        check(n[f"ssd_chunk/{kind}"] == n["ssd_chunk"],
              f"{path}: ssd_chunk launches by variant {n} (every one must be on the {kind} kernel)")
    kernels = phase_kernel_line(gen, errs, launches)
    for entry in kernels:
        entry["launches_by_path"] = {path: n[entry["name"]] for path, n in by_path.items()}
    smi = card_name_power()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s; seconds by phase "
        + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
