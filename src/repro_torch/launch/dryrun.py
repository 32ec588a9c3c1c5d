"""Dry run: every (arch x shape) cell's sharded step, once, on the production
mesh of 256 (or 512) ranks, with no card and nothing allocated at full size.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell's step under ``jax.jit`` on 512 placeholder host devices and reads
XLA's cost and memory analyses.  The port runs the cell's sharded step
(``launch/steps.py``: :func:`~repro_torch.launch.steps.
make_sharded_train_step`, ``make_sharded_prefill_step``,
``make_sharded_serve_step``) once, as rank 0 of a ``fake`` process group
(``launch/mesh.py::init_fake_group``: collectives return at once), on
DTensors whose local shards are fake tensors (``FakeTensorMode``: shapes
and dtypes, no storage), and counts what that one rank's local ops do
(:class:`CostCounter`):

* FLOPs per device: torch's flop formulas (``torch.utils.flop_counter``:
  the products and convolutions; elementwise ops count nothing) over the
  LOCAL shapes.  ``FlopCounterMode`` above DTensor would count every op's
  global shape;
* bytes accessed per device: each local op's input and output bytes,
  views and collectives' waits excluded — an unfused upper bound (XLA's
  figure counts a fused region once);
* collective bytes per device: the local result buffer of every
  ``_c10d_functional`` collective (DTensor's redistributions and the
  sharded cached attention's all-reduces), by kind, with a count, as the
  reference's ``collective_bytes``;
* memory: argument and output bytes are the local shards' bytes; temp
  bytes are the peak of the local bytes that the step's ops allocated and
  that were alive at once.

The reference corrects XLA's count of a ``while`` body, which its cost
analysis counts once whatever the trip count (``_body_costs``,
:80-161); the port's layers are a Python loop, every layer is counted, and
that correction has no counterpart.  ``lower_s`` is the seconds of the
counted run; nothing is compiled (``compile_s`` 0).

As the reference does (:30-35), the dry run computes attention with the
plain masked formulation (``layers.set_attn_impl("plain")``; the flash
kernel's op has no flop formula), for the cell's run only; the rmsnorm op
stays (it has a DTensor strategy).  Cells of a family that
``steps.check_sharded_family`` refuses are errors naming what is missing,
and the run exits 1.  So the reference's other two switches, the plain SSD
scan and ``USE_EP`` (which ``--optimized`` turns off for a decode cell
whose weights do not fit), have no counterpart yet: no cell the port runs
reaches an SSD or MoE layer.  They come with the sharded mamba and MoE
steps (ROADMAP queue 1 item 4).

    python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--multi-pod]
        [--remat full|dots|none] [--attn plain|chunked] [--no-fsdp]
        [--serve-rules] [--optimized] [--out FILE.jsonl]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import sys
import time
import traceback
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import sharding as shd
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS_BF16

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# the _c10d_functional ops by the reference's kind names
COLLECTIVE_KINDS = {"all_gather_into_tensor": "all-gather",
                    "all_gather_into_tensor_coalesced": "all-gather",
                    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "reduce_scatter_tensor_coalesced": "reduce-scatter",
                    "all_to_all_single": "all-to-all"}
# --optimized keeps TP-only serving where the bf16 weights fit one model
# shard in this share of the card (the reference's 12 of v5e's 16 GB)
FIT_SHARE = 0.75


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _in_sharding_propagation() -> bool:
    """Whether this op runs inside DTensor's sharding propagation, which
    runs each new op once on global-shape fake tensors for its output's
    metadata: no rank computes that."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class CostCounter(TorchDispatchMode):
    """Counts one rank's local ops (see the module docstring): ``flops``,
    ``bytes`` accessed, ``collectives`` (result bytes by kind and a
    ``count``) and ``peak`` live bytes allocated by the ops.  An op on
    DTensors is left to DTensor (``NotImplemented``), which then runs the
    local op that this mode counts."""

    def __init__(self) -> None:
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = dict.fromkeys(KINDS, 0) | {"count": 0}
        self.live = 0
        self.peak = 0
        # (kind, local result shape, dtype) -> count, for a caller that asks
        self.collective_shapes: collections.Counter = collections.Counter()

    def _freed(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            if name != "wait_tensor":
                kind = COLLECTIVE_KINDS.get(name, name)
                self.collectives[kind] = self.collectives.get(kind, 0) + \
                    sum(_nbytes(t) for t in _tensors(out))
                self.collectives["count"] += 1
                for t in _tensors(out):
                    self.collective_shapes[(kind, tuple(t.shape), str(t.dtype))] += 1
            return out
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        alias = [r.alias_info for r in func._schema.returns]
        if len(alias) == 1:                 # one tensor, or one list of tensors
            alias = alias * len(outs)
        fresh = [t for t, a in zip(outs, alias) if isinstance(t, torch.Tensor) and a is None]
        if fresh or any(a is not None and a.is_write for a in alias):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
                sum(_nbytes(t) for t in fresh)
        for t in fresh:
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._freed, n)
        self.peak = max(self.peak, self.live)
        return out


def collective_total(coll: dict) -> int:
    return sum(v for k, v in coll.items() if k != "count")


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    """Seconds at the card's data-sheet peaks (``launch/mesh.py``) and the
    largest of the three."""
    terms = {"compute_s": flops_per_dev / PEAK_FLOPS_BF16,
             "memory_s": bytes_per_dev / HBM_BW,
             "collective_s": coll_bytes_per_dev / LINK_BW}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k] if k.endswith("_s") else -1)
    return terms


def model_flops(cfg, shape: str) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); D = tokens.

    Train counts fwd+bwd (6ND); prefill counts forward only (2ND); decode
    counts one token per sequence."""
    info = steps_lib.SHAPES[shape]
    n_active = cfg.active_param_count()
    if info["kind"] == "train":
        return 6.0 * n_active * info["seq"] * info["batch"]
    if info["kind"] == "prefill":
        return 2.0 * n_active * info["seq"] * info["batch"]
    return 2.0 * n_active * info["batch"]


@contextlib.contextmanager
def lowering_modes(attn: str | None):
    """The plain attention (or ``attn``) for the block, the setting before
    put back after."""
    from repro_torch.models import layers as layers_lib

    before = layers_lib.ATTN_IMPL
    layers_lib.set_attn_impl(attn or "plain")
    try:
        yield
    finally:
        layers_lib.set_attn_impl(before)


def fake_dtensor(fake_mode, spec, sharding):
    """A DTensor of ``spec``'s shape and dtype at ``sharding``, whose local
    shard is a fake tensor of this rank's shape (the rules shard only
    dims their mesh axes divide)."""
    from torch.distributed.tensor import DTensor

    mesh, place = sharding.mesh, sharding.placements()
    local = list(spec.shape)
    for i, p in enumerate(place):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    with fake_mode:
        t = torch.empty(local, dtype=spec.dtype)
    stride = [math.prod(spec.shape[i + 1:]) for i in range(len(spec.shape))]
    return DTensor.from_local(t, mesh, place, run_check=False, shape=tuple(spec.shape),
                              stride=tuple(stride))


def cell_args(cfg, shape: str, mesh, rules, fake_mode) -> tuple:
    """The cell's step arguments as fake DTensors at ``cell_shardings``."""
    in_sh, _ = steps_lib.cell_shardings(cfg, shape, mesh, rules)
    specs = steps_lib.input_specs(cfg, shape, "meta")
    p_spec, o_spec = steps_lib.train_state_specs(cfg, "meta")
    kind = steps_lib.SHAPES[shape]["kind"]
    if kind == "train":
        trees = (p_spec, o_spec, specs["batch"])
    elif kind == "prefill":
        trees = (p_spec, specs["tokens"], specs["caches"], specs["extras"])
    else:
        trees = (p_spec, specs["tokens"], specs["caches"])
    place = lambda s, sh: fake_dtensor(fake_mode, s, sh)  # noqa: E731
    return tuple(pytree.tree_map(place, t, sh) for t, sh in zip(trees, in_sh))


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t) for t in _tensors(tree))


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             rules: shd.ShardingRules | None = None, remat: str | None = None,
             attn: str | None = None, cfg=None, mesh=None, costs: CostCounter | None = None,
             verbose: bool = True) -> dict:
    """One cell's result (the reference's JSON fields, ``fits_h100_80gb``
    for ``fits_v5e_16gb``).  ``cfg`` replaces ``arch``'s config and
    ``mesh`` the production mesh (a fake mesh of
    ``launch/mesh.py::make_fake_mesh``); the fake group must exist.  A
    caller's ``costs`` counter is the one filled (its
    ``collective_shapes`` say which buffers moved)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or get_config(arch)
    if remat is not None:
        cfg = cfg.scaled(remat=remat)
    ok, reason = steps_lib.applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "status": "skipped", "reason": reason}
    steps_lib.check_sharded_family(cfg)
    mesh = mesh or mesh_lib.make_production_mesh(multi_pod=multi_pod, fake=True)
    rules = rules or shd.DEFAULT_RULES
    kind = steps_lib.SHAPES[shape]["kind"]
    make = {"train": steps_lib.make_sharded_train_step,
            "prefill": steps_lib.make_sharded_prefill_step,
            "decode": steps_lib.make_sharded_serve_step}[kind]
    fake_mode = FakeTensorMode()
    with lowering_modes(attn):
        args = cell_args(cfg, shape, mesh, rules, fake_mode)
        step = make(cfg, mesh, rules)
        costs = costs or CostCounter()
        t0 = time.perf_counter()
        with fake_mode, costs:
            out = step(*args)
        t_lower = time.perf_counter() - t0
    coll = dict(costs.collectives)
    coll_total = collective_total(coll)
    terms = roofline_terms(costs.flops, costs.bytes, coll_total)
    chips = mesh.size()
    mf_dev = model_flops(cfg, shape) / chips
    arg_b, out_b, tmp_b = _local_bytes(args), _local_bytes(out), costs.peak
    result = {
        "arch": arch, "shape": shape, "status": "ok",
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "chips": chips,
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "hlo_flops_per_dev": float(costs.flops),
        "hlo_bytes_per_dev": float(costs.bytes),
        "collective_bytes_per_dev": float(coll_total),
        "collectives": coll,
        "terms": terms,
        "model_flops_per_dev": mf_dev,
        "useful_flops_ratio": (mf_dev / costs.flops) if costs.flops else None,
        "memory": {"argument_bytes": arg_b, "output_bytes": out_b, "temp_bytes": tmp_b,
                   "code_bytes": None,
                   "total_per_dev_gb": round((arg_b + tmp_b) / 2**30, 3)},
        "fits_h100_80gb": (arg_b + tmp_b) < HBM_BYTES,
    }
    if verbose:
        print(json.dumps(result, default=float), flush=True)
    return result


def _cell_settings(arch: str, shape: str, rules, attn, optimized: bool):
    """(rules, attn) of a cell under ``--optimized`` (the reference's
    per-cell choice, :302-326, without its EP switch): the chunked
    attention; a decode cell TP-only (``SERVE_RULES``) where the bf16
    weights fit one of 16 model shards in :data:`FIT_SHARE` of the card,
    else the default rules and the plain attention."""
    if not optimized:
        return rules, attn
    if steps_lib.SHAPES[shape]["kind"] != "decode":
        return rules, "chunked"
    params_gb_tp = get_config(arch).param_count() * 2 / 16 / 2**30
    if params_gb_tp < FIT_SHARE * HBM_BYTES / 2**30:
        return shd.SERVE_RULES, "chunked"
    return shd.DEFAULT_RULES, "plain"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry run on a fake production mesh")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=[None, *steps_lib.SHAPES],
                    help="default: all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default=None, choices=[None, "full", "dots", "none"])
    ap.add_argument("--attn", default=None, choices=[None, "plain", "chunked"],
                    help="the reference's xla / xla_chunked (default: plain)")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="paper-faithful static baseline (no FSDP)")
    ap.add_argument("--serve-rules", action="store_true",
                    help="TP-only + seq-sharded-cache serving topology")
    ap.add_argument("--optimized", action="store_true",
                    help="chunked attention for train/prefill + SERVE_RULES for decode shapes")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(steps_lib.SHAPES)
    rules = shd.NO_FSDP_RULES if args.no_fsdp else shd.DEFAULT_RULES
    if args.serve_rules:
        rules = shd.SERVE_RULES
    world = math.prod(mesh_lib.MULTI_POD_SHAPE if args.multi_pod else mesh_lib.PRODUCTION_SHAPE)
    mesh_lib.init_fake_group(world)
    failures = 0
    try:
        mesh = mesh_lib.make_production_mesh(multi_pod=args.multi_pod, fake=True)
        for arch in archs:
            for shape in shapes:
                cell_rules, attn = _cell_settings(arch, shape, rules, args.attn, args.optimized)
                try:
                    res = run_cell(arch, shape, rules=cell_rules, remat=args.remat, attn=attn,
                                   mesh=mesh)
                except Exception as e:  # a failing cell is a bug — surface it
                    failures += 1
                    res = {"arch": arch, "shape": shape, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(json.dumps(res), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(res, default=float) + "\n")
    finally:
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
