"""Run a function on N gloo ranks on the CPU, each in its own process.

:func:`spawn` starts N fresh interpreters (the ``spawn`` start method: the
test process may hold JAX's threads), joins them to one default process
group through a ``FileStore`` under the test's temporary directory (no
TCP port, so concurrent test workers cannot collide), calls
``fn(rank, world, *args)`` on every rank and returns each rank's result
(anything ``torch.save`` takes).  A rank that raises fails the test with
its traceback; ranks still running at the time limit are killed and fail
it too, so a hung collective cannot stall the suite.

This module imports torch and the port only: each rank imports it, and
nothing of JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pathlib
import time
import traceback

import torch

TIME_LIMIT_S = 180.0


def _rank_main(fn, rank: int, world: int, directory: str, args: tuple) -> None:
    import faulthandler

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

    # a rank killed by a signal leaves its Python stack here
    crash_log = open(os.path.join(directory, f"crash{rank}.txt"), "w")
    faulthandler.enable(crash_log)
    torch.set_num_threads(1)
    try:
        init_group("cpu", os.path.join(directory, "store"), rank=rank, world_size=world,
                   timeout_s=TIME_LIMIT_S)
        out = fn(rank, world, *args)
        dist.barrier()
        torch.save(out, os.path.join(directory, f"out{rank}.pt"))
    except BaseException:
        pathlib.Path(directory, f"err{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, fn, directory, *args, time_limit: float = TIME_LIMIT_S) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; each rank's result."""
    directory = pathlib.Path(directory) / f"ranks_{fn.__name__}_{time.monotonic_ns()}"
    directory.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, str(directory), args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + time_limit
    # the first rank to fail ends the run: its peers would wait in a collective
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline \
            and not any(p.exitcode for p in procs):
        time.sleep(0.02)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errors = {r: (directory / f"err{r}.txt").read_text()
              for r in range(world) if (directory / f"err{r}.txt").exists()}
    errors.update({r: (directory / f"crash{r}.txt").read_text() for r in range(world)
                   if (directory / f"crash{r}.txt").exists()
                   and (directory / f"crash{r}.txt").stat().st_size and r not in errors})
    if hung or errors or any(p.exitcode for p in procs):
        first = errors[min(errors)] if errors else ""
        raise AssertionError(
            f"{fn.__name__} on {world} gloo ranks: hung past {time_limit:.0f} s {hung}, "
            f"exit codes {[p.exitcode for p in procs]}, failed ranks {sorted(errors)}\n"
            f"{first[-4000:]}")
    return [torch.load(directory / f"out{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# rank bodies (module-level, so a spawned rank can import them)
# ---------------------------------------------------------------------------
def compressed_mean(rank: int, world: int, g) -> dict:
    """Each rank quantizes its own row of ``g`` (a ``(world, n)`` numpy
    array) and the dequantized rows are averaged over a 1-D ``"pod"`` mesh
    by ``all_reduce``: the reference's compressed psum test."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import dequantize, make_reduce_fn, quantize

    mesh = make_mesh("cpu", (world,), ("pod",))
    q, s = quantize({"g": torch.from_numpy(g[rank:rank + 1])})
    mean = make_reduce_fn(mesh, "pod")(dequantize(q, s))
    return {"mean": mean["g"].reshape(-1), "q": q["g"], "scale": s["g"]}


GRANITE = "granite-moe-1b-a400m"
EP_MESH = (2, 4)                 # ("data", "model"), the reference test's mesh


def ep_configs():
    """The reference EP test's config (granite's smoke config, 8 experts,
    top-2, capacity factor 8.0: nothing dropped) and the same at capacity
    factor 1.0, where slots are dropped."""
    from repro_torch.configs import smoke_config

    cfg = smoke_config(GRANITE).scaled(num_experts=8, experts_per_token=2,
                                       capacity_factor=8.0)
    return cfg, cfg.scaled(capacity_factor=1.0)


def ep_moe(rank: int, world: int, arrays: dict) -> dict:
    """``moe_fwd_ep`` on a ``(2, 4)`` mesh of 8 ranks from the numpy tree
    and tokens in ``arrays``: bf16 and f32 at capacity factor 8.0, f32 at
    1.0; and ``moe_fwd`` under the active mesh (f32, factor 8.0)."""
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import ep_layout, ep_shards, moe_fwd, moe_fwd_ep

    cfg, cfg_drop = ep_configs()
    mesh = make_mesh("cpu", EP_MESH, ("data", "model"))
    rules = shd.DEFAULT_RULES
    p32 = {k: torch.from_numpy(arrays[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x32 = torch.from_numpy(arrays["x"])
    pb = {k: v.bfloat16() for k, v in p32.items()}
    t = x32.shape[0]
    out = {"coord": tuple(mesh.get_coordinate()),
           "layout": ep_layout(cfg, mesh, rules, t, x32.shape[1]).__dict__,
           "layout_drop": ep_layout(cfg_drop, mesh, rules, t, x32.shape[1]).__dict__}
    for tag, c, p, x in (("bf16", cfg, pb, x32.bfloat16()), ("f32", cfg, p32, x32),
                         ("drop", cfg_drop, p32, x32)):
        shards = ep_shards(p, c, mesh, rules, t)
        out[f"{tag}_shard_shapes"] = {k: tuple(v.shape) for k, v in shards.items()}
        out[tag] = moe_fwd_ep(shards, x, c, mesh, rules)
    shd.set_active(mesh, rules)
    try:
        out["moe_fwd"] = moe_fwd(p32, x32, cfg)
    finally:
        shd.set_active(None)
    return out


FIG3_N = 4096
# VMUL's tile for each static placement of the fig3 graph (Reduce pinned at
# the LARGE tile (0, 0)): 0 to 3 pass-through tiles
FIG3_STATIC = (("static_0pass", (0, 1)), ("static_1pass", (0, 2)),
               ("static_2pass", (1, 2)), ("static_3pass", (2, 2)))


def fig3_placements():
    """``vmul_reduce_graph(4096)`` and its placements on a 3x3 grid:
    dynamic, and static with 0 to 3 pass-through tiles."""
    from repro_torch.core import TileGrid, place_dynamic, place_static, vmul_reduce_graph

    g = vmul_reduce_graph(FIG3_N)
    grid = TileGrid(3, 3)
    pls = {"dynamic": place_dynamic(g, grid)}
    for name, vmul in FIG3_STATIC:
        pls[name] = place_static(g, grid, fixed={2: vmul, 3: (0, 0)})
    return g, pls


def _counting_shifts():
    """Wrap ``dist.all_to_all_single`` (the ring shift's collective) with a
    counter; returns the count list and the restore function."""
    import torch.distributed as dist

    calls = [0]
    real = dist.all_to_all_single

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    dist.all_to_all_single = counted
    return calls, lambda: setattr(dist, "all_to_all_single", real)


def sharded_overlay(rank: int, world: int, a, b, x, w) -> dict:
    """On a 1-D ``"tiles"`` mesh: the fig3 graph through ``assemble_sharded``
    + ``wrap_sharded`` and the local ``assemble`` at every placement; then
    the reference's specialization test through ``Overlay(3, 3, mesh=)``."""
    from repro_torch.core import Overlay, assemble, assemble_sharded, wrap_sharded
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh("cpu", (world,), ("tiles",))
    g, pls = fig3_placements()
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    out = {}
    for name, pl in pls.items():
        acc = assemble_sharded(g, pl, mesh)
        out[name] = (wrap_sharded(acc, g)(a, b), assemble(g, pl)(a, b), acc.name)
    ov = Overlay(3, 3, mesh=mesh)
    jitted = ov.jit(lambda x, w: torch.sqrt((x * w) ** 2 + 1.0), name="sh")
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    y0 = jitted(x, w)
    jitted.specialize(x, w)
    entry = next(iter(jitted._entries.values()))
    out["spec"] = (y0, jitted(x, w), entry.record.tier, torch.sqrt((x * w) ** 2 + 1.0))
    return out


def hop_collectives(rank: int, world: int, a, b) -> dict:
    """Ring shifts one call issues, generic and route-constant, at every
    fig3 placement, with each placement's hop vector."""
    from repro_torch.core import (assemble_sharded, route_hops, wrap_sharded,
                                  wrap_sharded_specialized)
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh("cpu", (world,), ("tiles",))
    g, pls = fig3_placements()
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    calls, restore = _counting_shifts()
    out = {}
    try:
        for name, pl in pls.items():
            hops = route_hops(g, pl)
            fn = wrap_sharded(assemble_sharded(g, pl, mesh), g)
            spec = wrap_sharded_specialized(g, hops, mesh)
            before = calls[0]
            y = fn(a, b)
            mid = calls[0]
            ys = spec(None, a, b)
            out[name] = {"hops": hops, "generic": mid - before, "specialized": calls[0] - mid,
                         "equal": bool(torch.equal(y, ys))}
    finally:
        restore()
    return out


def mesh_overlay_modes(rank: int, world: int, store: str) -> dict:
    """``Overlay(mesh=)`` on a 1-rank mesh: ``async_downloads=True`` is
    forced off, a store is neither written nor read, and a call returns
    the local overlay's result."""
    from repro_torch.core import Overlay
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh("cpu", (world,), ("tiles",))
    x = torch.linspace(0.1, 1.0, 64)
    f = lambda v: torch.sin(v) * 2.0 + v   # noqa: E731
    ov = Overlay(3, 3, mesh=mesh, async_downloads=True, store_path=store)
    y = ov.jit(f, name="modes")(x)
    ov.close()
    local = Overlay(3, 3).jit(f, name="modes")(x)
    return {"async": ov.async_downloads, "scheduler": ov.scheduler.describe(),
            "store": ov.store.describe(), "y": y, "local": local,
            "tile_axis": ov.tile_axis, "downloads": ov.stats.downloads}


class _Capture:
    """Stands in for a captured CUDA graph (``interpreter.GraphKernel``),
    which the CPU cannot make: it runs the walk it wraps until released,
    and refuses to run after."""

    def __init__(self, kernel) -> None:
        self.kernel, self.released = kernel, False

    def __call__(self, *args):
        if self.released:
            raise RuntimeError("a released capture was called")
        return self.kernel(*args)

    def release(self) -> None:
        self.released = True


def mesh_overlay_close(rank: int, world: int) -> dict:
    """``Overlay(mesh=).close()`` after a specialization whose artifact is a
    :class:`_Capture`: what is left of the specialized tier, and whether
    the overlay still serves."""
    import gc

    from repro_torch.core import Overlay
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh("cpu", (world,), ("tiles",))
    ov = Overlay(3, 3, mesh=mesh)
    real = ov._compile_specialized_tier
    made = []

    def capture(pending):
        made.append(_Capture(real(pending)))
        return made[-1]

    ov._compile_specialized_tier = capture
    jitted = ov.jit(lambda x, w: torch.sqrt((x * w) ** 2 + 1.0), name="cl")
    x, w = torch.linspace(0.1, 1.0, 64), torch.linspace(-1.0, 1.0, 64)
    y0 = jitted(x, w)
    jitted.specialize(x, w)
    entry = next(iter(jitted._entries.values()))
    before = (entry.record.tier, ov.cache.specialized_count())
    y1 = jitted(x, w)
    ov.close()
    y2 = jitted(x, w)
    gc.collect()
    alive = [o for o in gc.get_objects() if isinstance(o, _Capture) and not o.released]
    return {"before": before, "made": len(made), "alive": len(alive),
            "after": (entry.record.tier, ov.cache.specialized_count()),
            "residents": [(r.tier, r.spec_fn is None) for r in ov.fabric.residents.values()],
            "despecializations": ov.cache.spec_stats.despecializations,
            "y": (y0, y1, y2)}


def host_mesh_facts(rank: int, world: int) -> dict:
    """``launch.mesh.make_host_mesh("cpu")`` on one gloo rank, and what the
    sharding rules read of it."""
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    mesh = make_host_mesh("cpu")
    out = {"names": mesh.mesh_dim_names, "shape": shd.mesh_shape(mesh),
           "spec": shd.logical_to_spec(mesh, shd.DEFAULT_RULES, ("batch", "embed"), (4, 8))}
    try:
        make_mesh("cpu", (2, 1), ("data", "model"))
    except RuntimeError as exc:
        out["wrong_world"] = str(exc)
    return out


# ---------------------------------------------------------------------------
# the sharded train step (DTensor)
# ---------------------------------------------------------------------------
SHARDED_BATCH, SHARDED_SEQ, SHARDED_LR = 4, 16, 3e-4


def sharded_cfg(arch: str, remat: str, wide: bool = False):
    """An arch's smoke config in float32 under ``remat``; ``wide`` takes
    d_model 128 (so every norm runs the rmsnorm op) and 2 kv heads of 32
    under 4 query heads (GQA)."""
    from repro_torch.configs import smoke_config

    cfg = smoke_config(arch).scaled(dtype="float32", remat=remat)
    return cfg.scaled(d_model=128, head_dim=32, num_kv_heads=2) if wide else cfg


def _count_custom_ops(calls: dict):
    """Wrap the rmsnorm and attention ops the autograd functions call with
    a counter of (op, whether a DTensor came in) and, for DTensors, of (op,
    the first input's placements); returns the restore function."""
    from repro_torch.kernels import ops as kops
    from repro_torch.sharding import is_dtensor

    real = {name: getattr(kops, name) for name in ("_rmsnorm_op", "_attention_op")}

    def counted(name):
        def call(*args):
            for key in ((name, any(is_dtensor(a) for a in args)),
                        (name, tuple(map(str, getattr(args[0], "placements", ()))))):
                calls[key] = calls.get(key, 0) + 1
            return real[name](*args)
        return call

    for name in real:
        setattr(kops, name, counted(name))
    return lambda: [setattr(kops, name, fn) for name, fn in real.items()]


def _placed(cfg, mesh, params, opt) -> bool:
    """Every state leaf a DTensor on ``mesh`` at its cell placements."""
    from torch.utils import _pytree as pytree

    from repro_torch.launch import steps
    from repro_torch.sharding import is_dtensor

    (p_sh, o_sh, _), _ = steps.cell_shardings(cfg, "train_4k", mesh)
    ok = lambda t, s: is_dtensor(t) and t.device_mesh == mesh and \
        tuple(t.placements) == s.placements()  # noqa: E731
    return all(pytree.tree_leaves(pytree.tree_map(ok, (params, opt), (p_sh, o_sh))))


def _whole_leaves(tree) -> list:
    from torch.utils import _pytree as pytree

    from repro_torch.sharding import is_dtensor
    return [t.full_tensor() if is_dtensor(t) else t for t in pytree.tree_leaves(tree)]


def sharded_train_steps(rank: int, world: int, shape: tuple, axes: tuple, cases: list) -> dict:
    """For each case ``(arch, remat, wide, tree)`` (``tree`` the JAX
    package's parameter tree as numpy): the port's single-device
    ``make_train_step`` and its gradients, then the same from
    ``make_sharded_train_step`` on a mesh of ``shape`` over ``axes`` (the
    gradients from ``_loss_and_grads`` under ``steps.on_mesh``); whether
    the state is placed as the cell says before and after, and how often
    the custom ops met DTensor and plain inputs.  Rank 0 returns the
    tensors whole; the others only the flags."""
    import torch

    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import _loss_and_grads
    from repro_torch.models import params as pm
    from repro_torch.optim import adamw_init

    mesh = make_mesh("cpu", shape, axes)
    calls: dict = {}
    restore = _count_custom_ops(calls)
    out = {}
    try:
        for arch, remat, wide, tree in cases:
            cfg = sharded_cfg(arch, remat, wide)
            params = pm.from_jax_numpy(tree, cfg, "cpu", dtype=torch.float32)
            batch = make_batch(cfg, SHARDED_BATCH, SHARDED_SEQ, step=0, seed=0, device="cpu")
            calls.clear()
            new, opt, m = steps.make_train_step(cfg, lr=SHARDED_LR)(params, adamw_init(params),
                                                                    batch)
            single_calls = dict(calls)
            grads = _loss_and_grads(cfg, params, batch)[2]
            sp, so = steps.shard_train_state(cfg, params, adamw_init(params), mesh)
            before = _placed(cfg, mesh, sp, so)
            calls.clear()
            snew, sopt, sm = steps.make_sharded_train_step(cfg, mesh, lr=SHARDED_LR)(sp, so, batch)
            sharded_calls = dict(calls)
            with steps.on_mesh(mesh):
                sgrads = _loss_and_grads(cfg, sp, steps.shard_batch(batch, mesh))[2]
            case = {"placed": (before, _placed(cfg, mesh, snew, sopt)),
                    "calls": (single_calls, sharded_calls),
                    "metric_items": {k: v.item() for k, v in sm.items()}}
            sharded = {"metrics": case["metric_items"], "grads": _whole_leaves(sgrads),
                       "params": _whole_leaves(snew), "mu": _whole_leaves(sopt.mu),
                       "nu": _whole_leaves(sopt.nu), "step": int(sopt.step.full_tensor())}
            if rank == 0:       # every rank gathers (a collective); rank 0 reports
                case["sharded"] = sharded
                case["single"] = {"metrics": {k: v.item() for k, v in m.items()},
                                  "grads": grads, "params": _whole_leaves(new),
                                  "mu": _whole_leaves(opt.mu), "nu": _whole_leaves(opt.nu),
                                  "step": int(opt.step)}
            out[(arch, remat, wide)] = case
    finally:
        restore()
    return out


def constrained_placements(rank: int, world: int, cases: list) -> list:
    """``sharding.constrain`` of DTensors on a ``(data 2, model 2)`` mesh
    under the default rules: for each ``(shape, logical axes)`` the
    placements it returns, and whether its values are the input's."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh("cpu", (2, 2), ("data", "model"))
    out = []
    for shape, axes in cases:
        x = torch.arange(float(torch.tensor(shape).prod())).reshape(shape)
        d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        c = shd.constrain(d, mesh, shd.DEFAULT_RULES, axes)
        shd.set_active(mesh)
        try:
            a = shd.constrain_logical(d, axes)
        finally:
            shd.set_active(None)
        out.append((tuple(c.placements), tuple(a.placements),
                    bool(torch.equal(c.full_tensor(), x))))
    return out


REMESH_STEPS, REMESH_FAIL_AT, REMESH_LR = 4, 3, 1e-3


def remesh_run(rank: int, world: int, directory: str) -> dict:
    """The port's ``Supervisor`` driving ``make_sharded_train_step`` of
    phi3's float32 smoke config on ``(data 2, model 2)``: step 3 fails 3
    times, the third failure calls ``on_remesh``, which re-lowers the step
    on ``(data 4, model 1)`` and returns the function that places the
    state there; the supervisor restores the step-2 checkpoint (each rank
    its own directory, every leaf whole) into that placement and runs on.
    Beside it an uninterrupted single-device run of the same steps, with
    each step's gradients.  Rank 0 returns the tensors whole."""
    import os

    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import _loss_and_grads
    from repro_torch.models import params as pm
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import FailureInjector, Supervisor, TrainLoopConfig

    cfg = sharded_cfg("phi3-mini-3.8b", "full")
    params = pytree.tree_map(lambda t: t.float(),
                             pm.init(cfg, torch.Generator().manual_seed(0), "cpu"))

    def batch_fn(step: int) -> dict:
        return make_batch(cfg, SHARDED_BATCH, SHARDED_SEQ, step=step, seed=0, device="cpu")

    first = make_mesh("cpu", (2, 2), ("data", "model"))
    now = {"mesh": first, "step": steps.make_sharded_train_step(cfg, first, lr=REMESH_LR)}
    remeshed = []

    def on_remesh(n: int):
        mesh = make_mesh("cpu", (4, 1), ("data", "model"))
        now.update(mesh=mesh, step=steps.make_sharded_train_step(cfg, mesh, lr=REMESH_LR))
        remeshed.append(n)
        return lambda state: steps.shard_train_state(cfg, *state, mesh)

    def step_fn(state, batch):
        p, o, m = now["step"](*state, batch)
        return (p, o), m

    sup = Supervisor(TrainLoopConfig(total_steps=REMESH_STEPS, ckpt_every=1, max_restarts=10,
                                     remesh_after_failures=3),
                     os.path.join(directory, f"ckpt_rank{rank}"),
                     injector=FailureInjector(fail_at=(REMESH_FAIL_AT,), repeat=3),
                     on_remesh=on_remesh)
    final = sup.run(steps.shard_train_state(cfg, params, adamw_init(params), first), step_fn,
                    batch_fn)
    out = {"remeshes": sup.remeshes, "restarts": sup.restarts, "calls": remeshed,
           "history": [h.step for h in sup.history],
           "losses": [h.metrics["loss"].item() for h in sup.history],
           "on_last_mesh": _placed(cfg, now["mesh"], *final)}
    whole = _whole_leaves(final[0])          # every rank gathers; rank 0 reports
    if rank == 0:
        single, grads, losses = (params, adamw_init(params)), [], []
        plain = steps.make_train_step(cfg, lr=REMESH_LR)
        for i in range(REMESH_STEPS):
            grads.append(_loss_and_grads(cfg, single[0], batch_fn(i))[2])
            p, o, m = plain(*single, batch_fn(i))
            single = (p, o)
            losses.append(m["loss"].item())
        out.update(params=whole, single_params=_whole_leaves(single[0]), single_grads=grads,
                   single_losses=losses)
    return out


# ---------------------------------------------------------------------------
# the sharded serve steps (DTensor)
# ---------------------------------------------------------------------------
SERVE_BATCH, SERVE_MAX_LEN, SERVE_PROMPT, SERVE_DECODES = 4, 16, 10, 3
SERVE_RULE_SETS = ("default", "no_fsdp", "serve")
# the odd case: 6 query heads over 3 kv heads (3 divides no model axis of 2,
# so SERVE_RULES shards the cache's seq dim) and a window of 4 (the local
# layers' mask inside each slice)
ODD = dict(num_heads=6, num_kv_heads=3, sliding_window=4)


def serve_cfg(arch: str, odd: bool = False):
    """An arch's smoke config in float32 (the caches stay bf16); ``odd``
    takes :data:`ODD`."""
    from repro_torch.configs import smoke_config

    cfg = smoke_config(arch).scaled(dtype="float32")
    return cfg.scaled(**ODD) if odd else cfg


def serve_tokens(vocab: int):
    """The prompt (B, P) and the decode tokens (D, B, 1), int32, from one
    numpy seed."""
    import numpy as np

    rng = np.random.default_rng(1)
    prompt = rng.integers(0, vocab, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    nxt = rng.integers(0, vocab, (SERVE_DECODES, SERVE_BATCH, 1), dtype=np.int32)
    return prompt, nxt


def _serve_rules(name: str):
    from repro_torch import sharding as shd
    return {"default": shd.DEFAULT_RULES, "no_fsdp": shd.NO_FSDP_RULES,
            "serve": shd.SERVE_RULES}[name]


def _serve_calls(prefill, serve, params, caches, prompt, nxt, check=None) -> list:
    """A prefill of ``prompt``, then a decode of each of ``nxt``: each
    call's (logits, caches), ``check(caches)`` after each call."""
    out = [prefill(params, prompt, caches)]
    for tok in nxt:
        out.append(serve(params, tok, out[-1][1]))
    if check is not None:
        for _, c in out:
            check(c)
    return out


def _cache_placements(caches) -> list:
    return [tuple(str(p) for p in leaf.placements) for leaf in _leaves(caches)]


def _leaves(tree) -> list:
    from torch.utils import _pytree as pytree
    return pytree.tree_leaves(tree)


def sharded_serve_steps(rank: int, world: int, shape: tuple, axes: tuple, cases: list) -> dict:
    """For each case ``(arch, odd, tree)`` (``tree`` the JAX package's
    parameter tree as numpy): the port's single-device prefill and
    :data:`SERVE_DECODES` decodes, then the same through
    ``make_sharded_prefill_step``/``make_sharded_serve_step`` on a mesh of
    ``shape`` over ``axes`` under each rule set, from
    ``shard_serve_state``.  After every call: whether every cache leaf and
    the logits are DTensors at the cell's placements; and the kinds for
    which the sharded steps built their shardings (``serve_shardings``).  Rank 0 returns the
    logits and caches whole; every rank the placements it saw."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.models import params as pm
    from repro_torch.sharding import is_dtensor

    mesh = make_mesh("cpu", shape, axes)
    out = {}
    for arch, odd, tree in cases:
        cfg = serve_cfg(arch, odd)
        params = pm.from_jax_numpy(tree, cfg, "cpu", dtype=torch.float32)
        prompt, nxt = serve_tokens(cfg.vocab_size)
        prompt, nxt = torch.from_numpy(prompt), [torch.from_numpy(t) for t in nxt]
        fresh = lambda: tmodel.init_cache(cfg, SERVE_BATCH, SERVE_MAX_LEN, "cpu")  # noqa: E731
        prefill = steps.make_prefill_step(cfg)
        single = _serve_calls(lambda p, t, c: prefill(p, t, c, {}), steps.make_serve_step(cfg),
                              params, fresh(), prompt, nxt) if rank == 0 else None
        for name in SERVE_RULE_SETS:
            rules = _serve_rules(name)
            (_, _, c_sh, _), (l_sh, _) = steps.serve_shardings(
                cfg, "prefill", SERVE_BATCH, SERVE_MAX_LEN, mesh, rules, SERVE_PROMPT)
            want = [s.placements() for s in _leaves(c_sh)]
            placed = []

            def check(caches, _want=want, _placed=placed):
                _placed.append(all(is_dtensor(t) and t.device_mesh == mesh
                                   and tuple(t.placements) == w
                                   for t, w in zip(_leaves(caches), _want)))

            sp, sc = steps.shard_serve_state(cfg, params, fresh(), mesh, rules)
            check(sc)
            built = []
            real = steps.serve_shardings
            steps.serve_shardings = lambda *a, **k: built.append(a[1]) or real(*a, **k)
            try:
                calls = _serve_calls(steps.make_sharded_prefill_step(cfg, mesh, rules),
                                     steps.make_sharded_serve_step(cfg, mesh, rules),
                                     sp, sc, prompt, nxt, check)
            finally:
                steps.serve_shardings = real
            logits_placed = all(tuple(lg.placements) == l_sh.placements() for lg, _ in calls)
            whole = [(lg.full_tensor(), [t.full_tensor() for t in _leaves(c)])
                     for lg, c in calls]        # every rank gathers; rank 0 reports
            case = {"placed": placed, "logits_placed": logits_placed, "built": built,
                    "placements": _cache_placements(calls[-1][1])}
            if rank == 0:
                case["sharded"] = whole
                case["single"] = [(lg, _leaves(c)) for lg, c in single]
            out[(arch, odd, name)] = case
    return out


SPLIT_CASES = (   # (Sq, Smax, index before the write, window, softcap, chunked)
    (1, 32, 20, None, None, False), (6, 32, 13, 5, 30.0, False),
    (48, 2048, 1000, None, None, True), (48, 2048, 1000, 300, 30.0, True))


def split_attention(rank: int, world: int, arrays: list) -> list:
    """``layers._sharded_cached_attention`` on a ``(data 2, model 2)`` mesh
    with the cache's ``seq`` dim over ``model`` (each rank holds half the
    keys): for each of :data:`SPLIT_CASES` (``arrays`` its q, new k/v and
    cache k/v as numpy, bf16 values in f32), the output and the written
    caches whole, and the single-device write and attention on the same
    tensors."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers

    mesh = make_mesh("cpu", (2, 2), ("data", "model"))
    out = []
    for (sq, smax, idx, window, softcap, chunked), arr in zip(SPLIT_CASES, arrays):
        q, k, v, ck, cv = (torch.from_numpy(a).bfloat16() for a in arr)
        index = torch.tensor(idx, dtype=torch.int32)
        opts = dict(window=window, softcap=softcap, scale=0.25)
        dt = lambda t, pl: distribute_tensor(t, mesh, pl)  # noqa: E731
        seq_pl, new_pl = (Shard(0), Shard(2)), (Shard(0), Replicate())
        cache = {"k": dt(ck, seq_pl), "v": dt(cv, seq_pl)}
        o, gk, gv = layers._sharded_cached_attention(
            dt(q, new_pl), dt(k, new_pl), dt(v, new_pl), cache,
            dt(index, (Replicate(), Replicate())), chunked=chunked, **opts)
        wk, wv = (layers.cache_update(c, n, index, axis=2) for c, n in ((ck, k), (cv, v)))
        want = layers._cached_attention(q, wk, wv, index, chunked=chunked, **opts)
        out.append({"placements": tuple(str(p) for p in gk.placements),
                    "got": (o.full_tensor(), gk.full_tensor(), gv.full_tensor()),
                    "want": (want, wk, wv)})
    return out


def cache_free_grads(rank: int, world: int, arrays: tuple) -> dict:
    """``multihead_attention`` under ``"plain"`` and ``"chunked"`` on a
    ``(data 2, model 2)`` mesh, as the model reaches it: q, k and v split
    into heads from (B, S, H * D) projections sharded over the batch and
    ``model`` (2 kv heads: one a rank), then the squared output summed and
    differentiated.  For each mode the output and the projections'
    gradients whole, beside the same on one device (float32, ``arrays``
    the three projections as numpy)."""
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers

    mesh = make_mesh("cpu", (2, 2), ("data", "model"))
    heads = (4, 2, 2)

    def run(xs):
        q, k, v = (layers._split_heads(x, h, 16).transpose(1, 2) for x, h in zip(xs, heads))
        o = layers.multihead_attention(q, k, v, causal=True, window=300, scale=0.25)
        o.float().square().sum().backward()
        return o

    out, before = {}, layers.ATTN_IMPL
    try:
        for mode in ("plain", "chunked"):
            layers.set_attn_impl(mode)
            plain = [torch.from_numpy(a).requires_grad_() for a in arrays]
            dist = [distribute_tensor(torch.from_numpy(a), mesh, (Shard(0), Shard(2)))
                    .requires_grad_() for a in arrays]
            want, got = run(plain), run(dist)
            out[mode] = {"got": (got.full_tensor(), *(x.grad.full_tensor() for x in dist)),
                         "want": (want.detach(), *(x.grad for x in plain))}
    finally:
        layers.set_attn_impl(before)
    return out


def serve_ranks(rank: int, world: int, shape: tuple, axes: tuple, cases: list,
                split_arrays: list | None = None, grad_arrays: tuple | None = None) -> dict:
    """:func:`sharded_serve_steps`, then on 4 ranks :func:`split_attention`
    and :func:`cache_free_grads` in the same processes."""
    out = {"serve": sharded_serve_steps(rank, world, shape, axes, cases)}
    if split_arrays is not None:
        out["split"] = split_attention(rank, world, split_arrays)
        out["grads"] = cache_free_grads(rank, world, grad_arrays)
    return out


# ---------------------------------------------------------------------------
# the dry run on fake groups (one process, no ranks to spawn)
# ---------------------------------------------------------------------------
DRY_DENSE = ("phi3-mini-3.8b", "minicpm-2b", "gemma2-27b", "mistral-large-123b")


def _single_device_flops(cfg, shape: str) -> int:
    """``FlopCounterMode`` over the single-device step of a cell, on fake
    tensors of the cell's shapes, with the dry run's attention and SSD."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils import _pytree as pytree
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun, steps

    fake = FakeTensorMode()
    make = lambda s: torch.empty(s.shape, dtype=s.dtype)  # noqa: E731
    with fake:
        specs = steps.input_specs(cfg, shape, "meta")
        p_spec, o_spec = steps.train_state_specs(cfg, "meta")
        kind = steps.SHAPES[shape]["kind"]
        if kind == "train":
            args = (p_spec, o_spec, specs["batch"])
            step = steps.make_train_step(cfg)
        elif kind == "prefill":
            args = (p_spec, specs["tokens"], specs["caches"], specs["extras"])
            step = steps.make_prefill_step(cfg)
        else:
            args = (p_spec, specs["tokens"], specs["caches"])
            step = steps.make_serve_step(cfg)
        args = tuple(pytree.tree_map(make, a) for a in args)
    counter = FlopCounterMode(display=False)
    with dryrun.lowering_modes(None), fake, counter:
        step(*args)
    return counter.get_total_flops()


def dryrun_small(out_path: str) -> None:
    """The dense family's smoke configs at every applicable cell on a fake
    ``(data 2, model 2)`` mesh (each result line), then on a fake ``(1, 1)``
    mesh each cell's counted FLOPs beside ``FlopCounterMode`` over the
    single-device step, and its collectives; ``torch.save`` to
    ``out_path``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import init_fake_group, make_fake_mesh

    out = {"cells": {}, "world1": {}}
    for world, shape in ((4, (2, 2)), (1, (1, 1))):
        init_fake_group(world)
        try:
            mesh = make_fake_mesh(shape, ("data", "model"))
            if world > 1:       # one kv head a rank: the attention's backward per shard
                cfg = smoke_config("gemma2-27b").scaled(num_kv_heads=2)
                out["one_kv_head"] = dryrun.run_cell("gemma2-27b", "train_4k", cfg=cfg,
                                                     mesh=mesh, verbose=False)
            for arch in DRY_DENSE:
                cfg = smoke_config(arch)
                for cell in steps.SHAPES:
                    r = dryrun.run_cell(arch, cell, cfg=cfg, mesh=mesh, verbose=False)
                    if world > 1:
                        out["cells"][(arch, cell)] = r
                    elif r["status"] == "ok":
                        out["world1"][(arch, cell)] = (r["hlo_flops_per_dev"],
                                                       _single_device_flops(cfg, cell),
                                                       r["collectives"])
        finally:
            dist.destroy_process_group()
    torch.save(out, out_path)


def dryrun_phi3(out_path: str) -> None:
    """phi3-mini-3.8b at full width on the fake ``(16, 16)`` production
    mesh: ``decode_32k`` (default rules) and ``train_4k`` (default and
    no-FSDP rules), each result with the shapes of its collectives;
    ``torch.save`` to ``out_path``."""
    import torch
    import torch.distributed as dist

    from repro_torch import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_group, make_production_mesh

    init_fake_group(256)
    out = {}
    try:
        mesh = make_production_mesh(fake=True)
        for cell, name, rules in (("decode_32k", "default", shd.DEFAULT_RULES),
                                  ("train_4k", "default", shd.DEFAULT_RULES),
                                  ("train_4k", "no_fsdp", shd.NO_FSDP_RULES)):
            costs = dryrun.CostCounter()
            r = dryrun.run_cell("phi3-mini-3.8b", cell, mesh=mesh, rules=rules, costs=costs,
                                verbose=False)
            out[(cell, name)] = (r, dict(costs.collective_shapes))
    finally:
        dist.destroy_process_group()
    torch.save(out, out_path)
