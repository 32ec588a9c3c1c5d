"""Top-level serving steps: KV-cache allocation, prefill, decode.

Port of ``repro/models/model.py`` (``init_cache`` :92, ``prefill`` :96,
``decode_step`` :150) for dense decoders.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.params import layer_kinds


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: "str | torch.device | None" = None) -> list[dict]:
    """Zeroed bf16 KV caches, one ``{"k", "v", "index"}`` dict per layer
    (the reference's cache is bf16 whatever the parameter dtype)."""
    dev = resolve_device(device)
    shape = (batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
             "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
             "index": torch.zeros((), dtype=torch.int32, device=dev)}
            for _ in layer_kinds(cfg)]


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor, caches: list):
    """Run the prompt through the decoder, filling caches.
    Returns (logits_last (B, V), caches)."""
    h, caches = tfm.forward(params, cfg, tokens, pos0=0, caches=caches)
    return tfm.unembed(params, h[:, -1:], cfg)[:, 0], caches


def decode_step(params: dict, cfg: ArchConfig, token: torch.Tensor,
                caches: list, *, positions: torch.Tensor | None = None):
    """One token for every sequence in the batch. token: (B, 1).

    ``positions=None`` reads the shared scalar cache index (uniform batch).
    Pass a (B,) int tensor to decode each row at its OWN KV position
    (ragged continuous batching)."""
    pos0 = caches[0]["index"] if positions is None else positions
    h, caches = tfm.forward(params, cfg, token, pos0=pos0, caches=caches)
    return tfm.unembed(params, h, cfg)[:, 0], caches
