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
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_group

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
