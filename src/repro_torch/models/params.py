"""Parameter specification, initialization, and weights carried over from
the JAX package.

A model is described by a *spec tree*: nested dicts (and a list of layers)
whose leaves are :class:`ParamSpec` (shape + logical axes + init +
dtype).  Matrices are bf16 and norm scales f32, as in
``repro/models/params.py:32,52``.  The reference stacks each block's
layers for ``lax.scan``; the port keeps one dict per layer in
``spec["layers"]`` and loops over them, so a leaf's logical axes
(:func:`axes`, which ``sharding.tree_shardings`` and
``launch/steps.cell_shardings`` read) are the reference's without the
stacked leading ``None``.  A layer's spec
depends on its kind: ``dense``, ``local``, ``global`` or ``shared_attn``
(attention + MLP; gemma2's sliding-window and full-attention layers share
the dense spec), ``moe`` (attention + the mixture-of-experts FFN of
:mod:`repro_torch.models.moe`: a router and the experts' weights stacked
as (E, d, f)), ``mla_dense`` / ``mla_moe`` (deepseek-v3's Multi-head Latent
Attention, :func:`~repro_torch.models.layers.mla_spec`, + the MLP or the
mixture-of-experts FFN), ``mamba`` (the Mamba-2 mixer of
:mod:`repro_torch.models.ssm`), ``enc`` (an encoder layer: the dense spec,
its self-attention not causal) or ``dec`` (an encoder-decoder's decoder
layer: the dense spec plus ``ln_cross`` and the cross-attention set
``cross``, ``repro/models/transformer.py:45-47``).  An encoder-decoder
model (seamless-m4t-medium) also carries ``spec["enc_layers"]``, one dict
per encoder layer in execution order (:func:`encoder_kinds`), the encoder's
final norm ``enc_norm``.  A model with a frontend (seamless's audio
stub, pixtral's vision stub) carries the stub's ``frontend_proj``
(frontend_dim, d_model).  With ``cfg.post_norms`` an
attention layer also has the post-sublayer norms ``post_ln1`` and ``post_ln2``
(``repro/models/transformer.py:51-53``).  A config with ``mtp_depth``
(deepseek-v3) also carries the multi-token-prediction module ``spec["mtp"]``
(``proj``, a ``dense`` layer and ``norm``, ``transformer.py:86-90``):
initialized and counted as in the reference, run by neither package's
serving.

A ``shared_attn`` layer (zamba2) owns no entry of ``spec["layers"]``: each
group that has the kind holds ONE weight set, ``spec["shared"]["g<i>"]``,
which every occurrence in the group reads (the reference's ``group_spec``
keeps it outside the scanned stack, ``repro/models/transformer.py:57-69``).
:func:`layer_plan` says where each layer's weights are, so nothing is
aliased in the tree: a flattened tree holds the shared set once,
:func:`count` counts it once and a traced step takes it as one set of
inputs.

* :func:`init` materializes parameters from an explicit ``torch.Generator``
  on an explicit device;
* :func:`from_jax_numpy` turns the JAX package's parameter tree, passed as
  numpy arrays, into the port's parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

SERVED_KINDS = ("dense", "local", "global", "mamba", "shared_attn", "moe",
                "mla_dense", "mla_moe", "enc", "dec")
SERVED_FRONTENDS = (None, "audio", "vision")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis per dim (sharding.py)
    init: str = "normal"                  # normal | zeros | ones | ssm_a
    scale: float | None = None            # None -> 1/sqrt(fan_in)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def dense(d_in: int, d_out: int, in_axis: str | None, out_axis: str | None) -> ParamSpec:
    return ParamSpec((d_in, d_out), (in_axis, out_axis))


def embedding(vocab: int, d: int) -> ParamSpec:
    return ParamSpec((vocab, d), ("vocab", "embed"), "normal", 0.02)


def norm_scale(d: int) -> ParamSpec:
    return ParamSpec((d,), (None,), "ones", None, torch.float32)


def axes(spec_tree: Any) -> Any:
    """The tree's logical axes, one tuple a leaf (``sharding.tree_shardings``
    takes it)."""
    return _map_spec(spec_tree, lambda s: s.axes)


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The decoder's layer kinds in execution order (blocks unrolled)."""
    return _kinds(cfg, cfg.blocks)


def encoder_kinds(cfg: ArchConfig) -> list[str]:
    """The encoder's layer kinds in execution order (``cfg.encoder_blocks``
    unrolled; empty for a decoder-only model)."""
    return _kinds(cfg, cfg.encoder_blocks)


def _kinds(cfg: ArchConfig, blocks) -> list[str]:
    kinds = [k for unit, rep in blocks for _ in range(rep) for k in unit]
    every = {k for unit, _ in (*cfg.blocks, *cfg.encoder_blocks) for k in unit}
    if every - set(SERVED_KINDS) or cfg.frontend not in SERVED_FRONTENDS:
        raise NotImplementedError(
            f"{cfg.name}: the port serves layers of kinds {list(SERVED_KINDS)} "
            f"and the frontends {list(SERVED_FRONTENDS)} (got kinds {sorted(every)}, "
            f"frontend {cfg.frontend!r})")
    return kinds


def layer_plan(cfg: ArchConfig) -> list[tuple[str, "int | str"]]:
    """The decoder's layers in execution order as (kind, where its weights
    are): an int indexes ``params["layers"]``; a group key ``"g<i>"`` names
    ``params["shared"]["g<i>"]``, the one weight set that every
    ``shared_attn`` occurrence of group ``i`` reads."""
    layer_kinds(cfg)                       # refuses the kinds not ported
    plan: list[tuple[str, int | str]] = []
    own = 0
    for gi, (unit, rep) in enumerate(cfg.blocks):
        for _ in range(rep):
            for kind in unit:
                if kind == "shared_attn":
                    plan.append((kind, f"g{gi}"))
                else:
                    plan.append((kind, own))
                    own += 1
    return plan


def layer_params(params: dict, where: "int | str") -> dict:
    """The weights of one layer of :func:`layer_plan`."""
    return params["shared"][where] if isinstance(where, str) else params["layers"][where]


def layer_spec(cfg: ArchConfig, kind: str) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if kind == "mamba":
        from repro_torch.models.ssm import ssm_spec   # ssm imports this module
        return {"ln1": norm_scale(d), "mixer": ssm_spec(cfg)}
    if kind.startswith("mla"):
        from repro_torch.models.layers import mla_spec   # layers imports this module
        attn = mla_spec(cfg)
    else:
        attn = _attn_spec(cfg)
    spec = {"ln1": norm_scale(d), "attn": attn}
    if kind == "dec":
        spec["ln_cross"] = norm_scale(d)
        spec["cross"] = _attn_spec(cfg)
    spec["ln2"] = norm_scale(d)
    if kind in ("moe", "mla_moe"):
        from repro_torch.models.moe import moe_spec   # moe imports this module
        spec["ffn"] = moe_spec(cfg)
    else:
        spec["ffn"] = {"w_gate": dense(d, f, "embed", "ffn"),
                       "w_up": dense(d, f, "embed", "ffn"),
                       "w_down": dense(f, d, "ffn", "embed")}
    if cfg.post_norms:
        spec["post_ln1"] = norm_scale(d)
        spec["post_ln2"] = norm_scale(d)
    return spec


def _attn_spec(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"wq": dense(d, cfg.num_heads * hd, "embed", "heads"),
            "wk": dense(d, cfg.num_kv_heads * hd, "embed", "kv_heads"),
            "wv": dense(d, cfg.num_kv_heads * hd, "embed", "kv_heads"),
            "wo": dense(cfg.num_heads * hd, d, "heads", "embed")}


def model_spec(cfg: ArchConfig) -> dict:
    plan = layer_plan(cfg)
    spec: dict[str, Any] = {"embed": embedding(cfg.vocab_size, cfg.d_model)}
    if cfg.frontend:
        spec["frontend_proj"] = dense(cfg.frontend_dim, cfg.d_model, None, "embed")
    if cfg.is_encdec:
        spec["enc_layers"] = [layer_spec(cfg, kind) for kind in encoder_kinds(cfg)]
        spec["enc_norm"] = norm_scale(cfg.d_model)
    spec["layers"] = [layer_spec(cfg, kind) for kind, where in plan if isinstance(where, int)]
    shared = {where: layer_spec(cfg, kind) for kind, where in plan if isinstance(where, str)}
    if shared:
        spec["shared"] = shared
    spec["final_norm"] = norm_scale(cfg.d_model)
    if not cfg.tie_embeddings:
        spec["lm_head"] = dense(cfg.d_model, cfg.vocab_size, "embed", "vocab")
    if cfg.mtp_depth:
        spec["mtp"] = {"proj": dense(2 * cfg.d_model, cfg.d_model, "embed", None),
                       "layer": layer_spec(cfg, "dense"),
                       "norm": norm_scale(cfg.d_model)}
    return spec


def abstract(spec: Any, device: "str | torch.device | None" = None) -> Any:
    """The spec tree's leaves as :class:`~repro_torch.core.graph.TensorSpec`
    on ``device`` (default ``cuda``): the avals of a graph input that takes
    the parameters (``repro/models/params.py::abstract``).  Any pytree of
    specs will do: :func:`~repro_torch.optim.adamw.opt_state_spec`'s
    ``OptState`` too."""
    from repro_torch.core.graph import TensorSpec
    dev = resolve_device(device)
    return _map_spec(spec, lambda s: TensorSpec(s.shape, s.dtype, dev))


def _map_spec(spec: Any, fn) -> Any:
    """``fn`` of every :class:`ParamSpec` leaf of a pytree (dicts, lists,
    ``OptState``), the tree's structure kept."""
    return pytree.tree_map(fn, spec, is_leaf=is_spec)


def zeros(spec: Any, device: "str | torch.device | None" = None) -> Any:
    """Zeros of each leaf's shape and dtype on ``device`` (default
    ``cuda``): a decode cache from its specs."""
    dev = resolve_device(device)
    return _map_spec(spec, lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev))


def init(cfg: ArchConfig, generator: torch.Generator,
         device: "str | torch.device | None" = None) -> dict:
    """Random parameters for ``cfg``: N(0, 1/fan_in) matrices (0.02 for the
    embedding), unit norm scales, zero biases, and Mamba's ``a_log`` as the
    log of Uniform[1, 16] (``repro/models/params.py:67-77``).  Every draw
    comes from ``generator``, which must live on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)

    def make(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ssm_a":
            u = torch.rand(s.shape, generator=generator, dtype=torch.float32, device=dev)
            return torch.log(1.0 + 15.0 * u).to(s.dtype)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        scale = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w * scale).to(s.dtype)

    return _map_spec(model_spec(cfg), make)


def from_jax_numpy(tree: dict, cfg: ArchConfig,
                   device: "str | torch.device | None" = None, *,
                   dtype: torch.dtype | None = None) -> dict:
    """The JAX package's parameter tree (``repro.models.params.init`` of
    ``model_spec(cfg)``), passed as numpy arrays, as the port's parameters.

    The scanned ``g<i>["layers"]["<j>:<kind>"]`` stacks are unstacked into
    one dict per layer in execution order (``repro/models/transformer.py:
    57-72``): repeat ``r`` of a unit runs its kinds in order, so gemma2's
    ``"0:local"`` and ``"1:global"`` stacks interleave as (local, global) x
    23.  The post norms ride along with their layer.  A group's shared set,
    ``g<i>["shared"]["shared_attn"]``, is carried once to
    ``["shared"]["g<i>"]``; its stack holds only the other kinds, so the
    unstacking skips the ``shared_attn`` positions of each unit.  A ``moe``
    layer's stacked experts, ``(rep, E, d, f)``, and router, ``(rep, d,
    E)``, unstack like any other leaf, as do an MLA layer's projections and
    latent norms; deepseek's unstacked ``mtp`` module is carried as it is.
    An encoder-decoder's ``enc<i>["layers"]["<j>:enc"]`` stacks unstack the
    same way into ``enc_layers``; a ``dec`` layer's ``ln_cross`` and
    ``cross`` ride along with it; ``enc_norm`` and either stub's
    ``frontend_proj`` are carried as they are.  bf16 leaves
    arrive as float32 numpy (numpy has no bf16) and are cast back to each
    leaf's own dtype — an exact round trip.  ``dtype`` casts every leaf to
    one dtype instead (the float32 parity tests)."""
    dev = resolve_device(device)
    spec = model_spec(cfg)

    def conv(arr, s: ParamSpec) -> torch.Tensor:
        a = np.array(arr, dtype=np.float32)      # a writable copy
        if a.shape != s.shape:
            raise ValueError(f"shape {a.shape} where {s.shape} was expected")
        return torch.from_numpy(a).to(device=dev, dtype=dtype or s.dtype)

    def tree_conv(node, s):
        if isinstance(s, ParamSpec):
            return conv(node, s)
        return {k: tree_conv(node[k], v) for k, v in s.items()}

    def unstacked(prefix: str, blocks, specs: list) -> list:
        layers = []
        for gi, (unit, rep) in enumerate(blocks):
            stacked = tree[f"{prefix}{gi}"]["layers"]
            for r in range(rep):
                for j, kind in enumerate(unit):
                    if kind != "shared_attn":
                        one = _unstack(stacked[f"{j}:{kind}"], r)
                        layers.append(tree_conv(one, specs[len(layers)]))
        return layers

    out = {k: tree_conv(tree[k], s) for k, s in spec.items()
           if k not in ("layers", "shared", "enc_layers")}
    if "enc_layers" in spec:
        out["enc_layers"] = unstacked("enc", cfg.encoder_blocks, spec["enc_layers"])
    out["layers"] = unstacked("g", cfg.blocks, spec["layers"])
    if "shared" in spec:
        out["shared"] = {g: tree_conv(tree[g]["shared"]["shared_attn"], s)
                         for g, s in spec["shared"].items()}
    return out


def _unstack(node, r: int):
    if isinstance(node, dict):
        return {k: _unstack(v, r) for k, v in node.items()}
    return np.asarray(node)[r]


def count(params: Any) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, list):
        return sum(count(p) for p in params)
    return sum(count(p) for p in params.values())
