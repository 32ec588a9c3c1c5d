"""Architecture configuration schema + registry (a copy of
``repro/configs/base.py``; the port imports nothing of ``repro``).

Every assigned architecture is one ``ArchConfig`` in ``configs/<id>.py``.
Heterogeneous layer stacks are expressed as ``blocks``: a list of
``(unit, repeat)`` pairs, where ``unit`` is a tuple of layer kinds repeated
``repeat`` times (e.g. gemma-2's local:global alternation is
``(("local", "global"), 23)``).  The reference scans each unit; the port
loops over the layers in Python.  The port serves the kinds of
``models/params.py::SERVED_KINDS`` (every kind below) with no frontend,
the audio stub or the vision stub; the schema keeps every field so
configs copy verbatim, and the analytic parameter counts
(:meth:`ArchConfig.param_count`, :meth:`ArchConfig.active_param_count`)
are the reference's.

Layer kinds:
  dense        — full attention + dense MLP
  local        — sliding-window attention + dense MLP (gemma2)
  global       — full attention + dense MLP (gemma2 pairing)
  moe          — full attention + MoE FFN
  mla_moe      — MLA attention + MoE FFN (deepseek-v3)
  mla_dense    — MLA attention + dense MLP (deepseek-v3 first layers)
  mamba        — Mamba-2 SSD block (attention-free)
  shared_attn  — full attention whose weights are SHARED across occurrences
                 (zamba2; the paper's "one bitstream, many tiles" reuse case)
  enc / dec    — encoder (bidirectional) / decoder (causal + cross-attn)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

_REGISTRY: dict[str, Callable[[], "ArchConfig"]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> "ArchConfig":
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    blocks: tuple[tuple[tuple[str, ...], int], ...]
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # --- attention options ---
    rope_theta: float = 10_000.0
    sliding_window: int | None = None          # for "local" layers
    attn_softcap: float | None = None          # gemma2
    final_softcap: float | None = None         # gemma2
    query_pre_attn_scalar: float | None = None # gemma2 scaling
    # --- MLA (deepseek-v3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_scoring: str = "softmax"            # softmax | sigmoid (deepseek)
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 64
    # --- enc-dec ---
    encoder_blocks: tuple[tuple[tuple[str, ...], int], ...] = ()
    # --- misc ---
    act: str = "silu"                          # silu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embed_scale: float = 1.0                   # gemma: sqrt(d); minicpm: 12
    residual_scale: float = 1.0                # minicpm depth scaling
    post_norms: bool = False                   # gemma2 post-sublayer norms
    mtp_depth: int = 0                         # deepseek multi-token prediction
    frontend: str | None = None                # "audio" | "vision" stub
    frontend_dim: int = 0                      # stub embedding feature size
    dtype: str = "bfloat16"
    # training-step options (hillclimb knobs — overridable per run)
    remat: str = "full"                        # full | none | dots
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def num_layers(self) -> int:
        return sum(len(u) * r for u, r in self.blocks) + \
            sum(len(u) * r for u, r in self.encoder_blocks)

    @property
    def is_encdec(self) -> bool:
        return bool(self.encoder_blocks)

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode is viable: a unit of the decoder holds
        a ``mamba`` layer (SSM or hybrid; ``repro/configs/base.py:123-126``)."""
        return any("mamba" in unit for unit, _ in self.blocks)

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        return _count_params(self)

    def active_param_count(self) -> int:
        """Params active per token (MoE: only routed-in experts)."""
        return _count_params(self, active_only=True)

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced config of the same family for CPU smoke tests."""
        return dataclasses.replace(self, **overrides)


def _ffn_params(cfg: ArchConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff  # SwiGLU w1/w3/w2


def _attn_params(cfg: ArchConfig) -> int:
    hd = cfg.resolved_head_dim
    if cfg.kv_lora_rank:  # MLA
        q = cfg.d_model * cfg.q_lora_rank + \
            cfg.q_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        kv = cfg.d_model * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) + \
            cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
        o = cfg.num_heads * cfg.v_head_dim * cfg.d_model
        return q + kv + o
    q = cfg.d_model * cfg.num_heads * hd
    kv = 2 * cfg.d_model * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * cfg.d_model
    return q + kv + o


def _mamba_params(cfg: ArchConfig) -> int:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    in_proj = cfg.d_model * (2 * d_inner + 2 * cfg.ssm_state + nheads)
    conv = cfg.ssm_conv_width * (d_inner + 2 * cfg.ssm_state)
    out = d_inner * cfg.d_model
    return in_proj + conv + out + 2 * nheads  # + A_log, D


def _layer_params(cfg: ArchConfig, kind: str) -> int:
    norms = 2 * cfg.d_model
    if kind == "mamba":
        return _mamba_params(cfg) + cfg.d_model
    if kind in ("dense", "local", "global", "enc", "shared_attn"):
        return _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + norms
    if kind == "dec":
        return 2 * _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + 3 * cfg.d_model
    if kind in ("moe", "mla_moe"):
        att = _attn_params(cfg)
        router = cfg.d_model * cfg.num_experts
        experts = cfg.num_experts * _ffn_params(cfg, cfg.moe_d_ff)
        shared = cfg.num_shared_experts * _ffn_params(cfg, cfg.moe_d_ff)
        return att + router + experts + shared + norms
    if kind == "mla_dense":
        return _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + norms
    raise ValueError(f"unknown layer kind {kind!r}")


def _count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    total = cfg.vocab_size * cfg.d_model            # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model       # lm head
    total += cfg.d_model                            # final norm
    for unit, rep in (*cfg.blocks, *cfg.encoder_blocks):
        for kind in unit:
            n = _layer_params(cfg, kind)
            if active_only and kind in ("moe", "mla_moe"):
                att = _attn_params(cfg)
                router = cfg.d_model * cfg.num_experts
                act_e = (cfg.experts_per_token + cfg.num_shared_experts) * \
                    _ffn_params(cfg, cfg.moe_d_ff)
                n = att + router + act_e + 2 * cfg.d_model
            if kind == "shared_attn":
                total += n          # weights shared across all repetitions
            else:
                total += n * rep
    return total

