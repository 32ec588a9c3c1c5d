"""The port's multi-device paths on gloo ranks on the CPU, against the JAX
package's on forced host devices.

Ranks: ``tests/torch_ranks.py`` spawns N processes joined through a
``FileStore`` under the test's temporary directory, each run under a
180 s limit.  The JAX side runs once for the module, in a subprocess with
9 forced host devices (``tests/test_distributed.py::run_with_devices``),
on the same numpy inputs, and writes its results to an ``.npz``.

* Expert-parallel MoE (``models/moe.py::moe_fwd_ep``) at the reference
  test's config (granite's smoke config, 8 experts, top-2, capacity factor
  8.0, 32 tokens) on a ``(2, 4)`` mesh of 8 ranks: in bf16 within 5e-2 of
  the JAX ``_moe_fwd_local`` (the reference test's tolerance, rtol = atol);
  in f32 within 1e-5 of the port's local path (``|got - want| <= 1e-5 *
  max|want|``: the same products, other f32 orders of the expert sums).
  At capacity factor 1.0, where slots are dropped, the f32 output within
  1e-5 of the JAX ``moe_fwd_ep`` on the same mesh shape, and each rank's aux
  loss within 1e-6 of the reference router's on that rank's rows.
* The overlay across a mesh (``core/interpreter.py::assemble_sharded``,
  ``wrap_sharded``) on 9 ranks: ``vmul_reduce_graph(4096)`` at the dynamic
  placement and static ones with 0 to 3 pass-through tiles, bit-identical to
  the port's local ``assemble`` (a shift moves bytes; nothing is computed
  on the way) and within ``1e-5 * sum|a * b|`` of the JAX package's sharded
  assembly (another f32 order of the sum).
* The specialized tier on a mesh is bit-identical to the generic one and
  to the plain function (the twin of ``tests/test_specialization.py::
  test_sharded_overlay_specializes_bit_identical``; the JAX package's
  ``Overlay.jit`` fails in this JAX, where ``jax.core.Literal`` is gone, so
  the port is held to itself there); a mesh forces the
  synchronous mode and skips the store (the twin of
  ``tests/test_scheduler.py::test_mesh_overlay_forces_synchronous_mode``).
* Hop counts: one call issues one collective for each forward hop plus one
  return shift for each edge whose hops are not a multiple of the ring.
* ``Overlay(mesh=).close()`` releases every specialized artifact (on the
  card a CUDA graph that captured the hops' collectives, which must not
  outlive the process group) and the overlay serves on, bit-identical.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.models import moe as tmoe
from tests.test_distributed import run_with_devices
from tests.torch_ranks import (EP_MESH, FIG3_N, GRANITE, ep_configs, ep_moe,
                               fig3_placements, hop_collectives, mesh_overlay_close,
                               mesh_overlay_modes, sharded_overlay, spawn)

TOKENS = 32


def _inputs() -> dict:
    cfg, _ = ep_configs()
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    rng = np.random.default_rng(0)
    n = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    return {"router": n(d, e, scale=d ** -0.5), "w_gate": n(e, d, f, scale=d ** -0.5),
            "w_up": n(e, d, f, scale=d ** -0.5), "w_down": n(e, f, d, scale=f ** -0.5),
            "x": n(TOKENS, d), "a": n(FIG3_N), "b": n(FIG3_N),
            "sx": np.linspace(0.1, 1.0, 64, dtype=np.float32),
            "sw": np.linspace(0.9, 1.1, 64, dtype=np.float32)}


JAX_ORACLES = """
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro import sharding as shd
    from repro.configs.archs import smoke_config
    from repro.models import moe as moe_lib
    from repro.core import (TileGrid, assemble, assemble_sharded,
                            place_dynamic, place_static, vmul_reduce_graph,
                            wrap_sharded)

    arr = dict(np.load(IN))
    res = {}
    cfg = smoke_config(GRANITE).scaled(num_experts=8, experts_per_token=2,
                                       capacity_factor=8.0)
    cfg_drop = cfg.scaled(capacity_factor=1.0)
    p = {k: jnp.asarray(arr[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(arr["x"])
    pb = jax.tree.map(lambda v: v.astype(jnp.bfloat16), p)
    res["local_bf16"] = np.float32(moe_lib._moe_fwd_local(pb, x.astype(jnp.bfloat16), cfg)[0])
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(EP_MESH), ("data", "model"))
    shd.set_active(mesh, shd.DEFAULT_RULES)
    with mesh:
        y, _ = jax.jit(lambda p, x: moe_lib.moe_fwd_ep(p, x, cfg_drop, mesh,
                                                       shd.DEFAULT_RULES))(p, x)
    shd.set_active(None)
    res["ep_drop_f32"] = np.asarray(y)
    t_loc = x.shape[0] // EP_MESH[0]
    res["aux_rows_drop"] = np.asarray([
        float(moe_lib.router_topk(x[c * t_loc:(c + 1) * t_loc] @ p["router"], cfg_drop)[2])
        for c in range(EP_MESH[0])], np.float32)

    g = vmul_reduce_graph(FIG3_N)
    grid = TileGrid(3, 3)
    pls = {"dynamic": place_dynamic(g, grid)}
    for name, vmul in FIG3_STATIC:
        pls[name] = place_static(g, grid, fixed={2: vmul, 3: (0, 0)})
    a, b = jnp.asarray(arr["a"]), jnp.asarray(arr["b"])
    mesh9 = jax.make_mesh((9,), ("tiles",))
    for name, pl in pls.items():
        res["local_" + name] = np.asarray(assemble(g, pl)(a, b))
        acc = assemble_sharded(g, pl, mesh9)
        with mesh9:
            res["sharded_" + name] = np.asarray(wrap_sharded(acc, g, mesh9)(a, b))
    np.savez(OUT, **res)
    print("ORACLES_OK")
"""


@pytest.fixture(scope="module")
def oracles(tmp_path_factory):
    """The inputs, and the JAX package's results on them (one subprocess,
    9 forced host devices)."""
    from tests.torch_ranks import FIG3_STATIC

    d = tmp_path_factory.mktemp("jax_oracles")
    arrays = _inputs()
    np.savez(d / "in.npz", **arrays)
    head = (f"IN, OUT = {os.fspath(d / 'in.npz')!r}, {os.fspath(d / 'out.npz')!r}\n"
            f"GRANITE, EP_MESH, FIG3_N = {GRANITE!r}, {EP_MESH!r}, {FIG3_N}\n"
            f"FIG3_STATIC = {FIG3_STATIC!r}\n")
    import textwrap
    out = run_with_devices(9, head + textwrap.dedent(JAX_ORACLES), timeout=300)
    assert "ORACLES_OK" in out
    return arrays, dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def ep_ranks(oracles, tmp_path_factory):
    """Every rank's results of ``tests/torch_ranks.py::ep_moe`` on 8 gloo
    ranks (180 s limit)."""
    arrays, _ = oracles
    return spawn(8, ep_moe, tmp_path_factory.mktemp("ep"), arrays)


def _close_normwise(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


def _rows(ranks, tag, layout_key="layout"):
    """The full output from the ranks' own rows: the rows of data
    coordinate c come from every model rank at c, which must agree."""
    lay = ranks[0][layout_key]
    rows = {}
    for res in ranks:
        c = res["coord"][0]
        y = res[tag][0]
        if c in rows:
            assert torch.equal(rows[c], y), f"{tag}: model ranks at data {c} disagree"
        rows[c] = y
    assert lay["t_loc"] == TOKENS // EP_MESH[0] and lay["batch_axes"] == ("data",)
    return torch.cat([rows[c] for c in range(EP_MESH[0])])


def test_ep_moe_matches_local_moe(oracles, ep_ranks):
    """The twin of ``tests/test_distributed.py::test_ep_moe_matches_local_moe``:
    EP on 8 ranks against the JAX local path (bf16) and the port's (f32)."""
    arrays, jres = oracles
    cfg, _ = ep_configs()
    lay = ep_ranks[0]["layout"]
    assert (lay["model_axis"], lay["e_loc"], lay["fsdp_axes"], lay["n_fsdp"]) == \
        ("model", 2, ("data",), 2)
    # each rank holds its 2 experts and half of d (FSDP over data)
    assert ep_ranks[0]["f32_shard_shapes"]["w_gate"] == (2, cfg.d_model // 2, cfg.moe_d_ff)
    assert ep_ranks[0]["f32_shard_shapes"]["w_down"] == (2, cfg.moe_d_ff, cfg.d_model // 2)
    np.testing.assert_allclose(_rows(ep_ranks, "bf16").float().numpy(), jres["local_bf16"],
                               rtol=5e-2, atol=5e-2)
    p = {k: torch.from_numpy(arrays[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    y_local, aux_local = tmoe._moe_fwd_local(p, torch.from_numpy(arrays["x"]), cfg)
    _close_normwise(_rows(ep_ranks, "f32").numpy(), y_local.numpy(), 1e-5, "EP f32")
    # moe_fwd under the active mesh: the rows gathered back on every rank
    for res in ep_ranks:
        y, aux = res["moe_fwd"]
        _close_normwise(y.numpy(), y_local.numpy(), 1e-5, "moe_fwd under a mesh")
        assert torch.isfinite(aux) and abs(aux.item() - aux_local.item()) < 0.5 * aux_local.item()


def test_ep_moe_with_drops_matches_jax_ep(oracles, ep_ranks):
    """At capacity factor 1.0 the per-rank capacity ``int(t_loc k / e *
    1.0) + 1`` = 5 drops slots, and which ones is EP's own choice: the port
    holds it to the JAX package's ``moe_fwd_ep`` on the same mesh shape."""
    arrays, jres = oracles
    _, cfg_drop = ep_configs()
    lay = ep_ranks[0]["layout_drop"]
    assert lay["cap"] == int(lay["t_loc"] * 2 / 8 * 1.0) + 1 == 5
    # slots are dropped: the local path at this capacity keeps fewer
    x = torch.from_numpy(arrays["x"])
    _, idx, _ = tmoe.router_topk(x[:lay["t_loc"]] @ torch.from_numpy(arrays["router"]), cfg_drop)
    assert int(torch.bincount(idx.reshape(-1), minlength=8).max()) > lay["cap"]
    _close_normwise(_rows(ep_ranks, "drop", "layout_drop").numpy(), jres["ep_drop_f32"], 1e-5,
                    "EP with drops")
    for res in ep_ranks:
        np.testing.assert_allclose(res["drop"][1].item(), jres["aux_rows_drop"][res["coord"][0]],
                                   rtol=1e-6)


def test_sharded_overlay_matches_local(oracles, tmp_path):
    """The twin of ``tests/test_distributed.py::test_sharded_overlay_matches_local``
    on 9 gloo ranks, at every fig3 placement, plus the specialization twin."""
    arrays, jres = oracles
    ranks = spawn(9, sharded_overlay, tmp_path, arrays["a"], arrays["b"], arrays["sx"],
                  arrays["sw"])
    _, pls = fig3_placements()
    bound = 1e-5 * float(np.abs(arrays["a"] * arrays["b"]).sum())
    for name in pls:
        for res in ranks:
            got, local, acc_name = res[name]
            assert acc_name == "vmul_reduce@tiles"
            assert torch.equal(got, local), name
            assert torch.equal(got, ranks[0][name][0]), name
        got = ranks[0][name][0].item()
        assert abs(got - float(jres["sharded_" + name])) <= bound, name
        assert abs(got - float(jres["local_" + name])) <= bound, name
    for res in ranks:
        y0, y1, tier, plain = res["spec"]
        assert tier == "specialized"
        assert torch.equal(y0, y1) and torch.equal(y0, plain)


def test_hop_collectives_are_the_placements_hops(oracles, tmp_path):
    """On a ring of 3: an edge of h hops is h forward shifts plus a return
    shift unless h is a multiple of 3 (static 2-pass: h = 3, none), in the
    generic and the route-constant kernel alike, whose outputs agree."""
    arrays, _ = oracles
    ranks = spawn(3, hop_collectives, tmp_path, arrays["a"], arrays["b"])
    for res in ranks:
        for name, row in res.items():
            want = sum(h + (h % 3 != 0) for h in row["hops"] if h)
            assert row["generic"] == row["specialized"] == want, (name, row)
            assert row["equal"], name
    assert {name: sum(r["hops"]) for name, r in ranks[0].items()} == \
        {"dynamic": 1, "static_0pass": 1, "static_1pass": 2, "static_2pass": 3,
         "static_3pass": 4}


def test_mesh_overlay_forces_synchronous_mode(tmp_path):
    """The twin of ``tests/test_scheduler.py::test_mesh_overlay_forces_synchronous_mode``
    on a 1-rank mesh: ``async_downloads=True`` is turned off, no scheduler
    job runs, the store is never written, and the output is the local
    overlay's."""
    (res,) = spawn(1, mesh_overlay_modes, tmp_path, os.fspath(tmp_path / "store"))
    assert res["async"] is False
    assert res["scheduler"]["submitted"] == 0
    assert res["store"]["entries"] == 0 and res["store"]["stats"]["saves"] == 0
    assert res["downloads"] == 1 and res["tile_axis"] == "tiles"
    assert torch.equal(res["y"], res["local"])


def test_mesh_overlay_close_releases_the_specialized_tier(tmp_path):
    """``close()`` on a mesh overlay: the capture its specialization made is
    released and no unreleased one is left in the rank, the cache holds no
    specialized artifact, the resident and its dispatch record are back on
    the generic tier, and a call after ``close()`` gives the same bits."""
    (res,) = spawn(1, mesh_overlay_close, tmp_path)
    assert res["before"] == ("specialized", 1) and res["made"] == 1
    assert res["alive"] == 0
    assert res["after"] == ("generic", 0)
    assert res["residents"] == [("generic", True)]
    assert res["despecializations"] == 1
    y0, y1, y2 = res["y"]
    assert torch.equal(y0, y1) and torch.equal(y0, y2)
