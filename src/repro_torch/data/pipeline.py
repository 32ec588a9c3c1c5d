"""Deterministic synthetic token pipeline (sharded, resumable, prefetching).

Port of ``repro/data/pipeline.py:28-126``.  No external datasets exist
offline, so the pipeline synthesizes a *learnable* token stream: a fixed
random Markov chain over the vocabulary.  Generation is numpy-driven with
the reference's seeds and draws, so a seed gives the reference's tokens
exactly; they arrive as int32 tensors on the requested device.

  * determinism: batch t is a pure function of (seed, step) — restart-safe,
  * sharding: each data-parallel host materializes only its slice,
  * resumability: ``state = step`` — checkpointing the cursor is trivial,
  * prefetch: a double-buffered iterator hides generation latency.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass
class SyntheticLM:
    """Markov-chain LM stream; batches land on ``device`` (default cuda)."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 4          # out-degree of the chain: lower = easier
    device: "str | torch.device | None" = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        self._next = rng.integers(0, v, size=(v, self.branching))

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """Batch for one data shard at one step — pure function of args."""
        if self.batch_size % num_shards:
            raise ValueError("batch not divisible by shards")
        local_b = self.batch_size // num_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        starts = rng.integers(0, self.vocab_size, size=(local_b,))
        choices = rng.integers(0, self.branching,
                               size=(local_b, self.seq_len))
        toks = np.empty((local_b, self.seq_len + 1), np.int32)
        toks[:, 0] = starts
        cur = starts
        for t in range(self.seq_len):
            cur = self._next[cur, choices[:, t]]
            toks[:, t + 1] = cur
        toks = torch.from_numpy(toks).to(self.device)
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}

    def iterate(self, start_step: int = 0, shard: int = 0,
                num_shards: int = 1) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step, shard, num_shards)
            step += 1


def _npatch(seq: int) -> int:
    """The vision stub's patch count for a sequence of ``seq`` tokens: the
    patches take at most 256 leading slots and at most half the sequence."""
    return min(256, seq // 2)


def make_batch(cfg: ArchConfig, batch: int, seq: int, step: int = 0,
               seed: int = 0, device: "str | torch.device | None" = None) -> dict:
    """Concrete batch for an arch: tokens and labels, and the stub
    frontends' inputs, the reference's numpy draws from
    ``default_rng(seed + 17 * step)`` after the tokens
    (``repro/data/pipeline.py:68-83``): for the vision stub
    ``patch_embeds`` (batch, min(256, seq // 2), frontend_dim) bf16, for
    the audio stub ``frames`` (batch, seq, frontend_dim) bf16."""
    ds = SyntheticLM(cfg.vocab_size, seq, batch, seed, device=device)
    out = ds.batch(step)
    rng = np.random.default_rng(seed + 17 * step)
    bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16).to(ds.device)
    if cfg.frontend == "vision":
        out["patch_embeds"] = bf16(rng.standard_normal((batch, _npatch(seq), cfg.frontend_dim)))
    elif cfg.frontend == "audio":
        out["frames"] = bf16(rng.standard_normal((batch, seq, cfg.frontend_dim)))
    return out


def batch_specs(cfg: ArchConfig, batch: int, seq: int,
                device: "str | torch.device | None" = None) -> dict:
    """The abstract batch of :func:`make_batch` as
    :class:`~repro_torch.core.graph.TensorSpec` on ``device`` (default
    cuda), as ``repro/data/pipeline.py::batch_specs``."""
    from repro_torch.core.graph import TensorSpec
    dev = resolve_device(device)
    spec = {"tokens": TensorSpec((batch, seq), torch.int32, dev),
            "labels": TensorSpec((batch, seq), torch.int32, dev)}
    if cfg.frontend == "vision":
        spec["patch_embeds"] = TensorSpec((batch, _npatch(seq), cfg.frontend_dim),
                                          torch.bfloat16, dev)
    elif cfg.frontend == "audio":
        spec["frames"] = TensorSpec((batch, seq, cfg.frontend_dim), torch.bfloat16, dev)
    return spec


class Prefetcher:
    """Double-buffered prefetch wrapper around a batch iterator."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = False

        def worker():
            for item in it:
                if self._stop:
                    return
                self._q.put(item)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop = True
