"""The dry run (``launch/dryrun.py``) and the fake production meshes
(``launch/mesh.py``): against the JAX package's configs, cell rules and
shardings; the runs themselves on fake groups in two subprocesses started
together (``tests/torch_ranks.py::dryrun_small`` and ``dryrun_phi3``).

The reference's dry run is not imported here: it sets ``XLA_FLAGS`` and its
attention mode on import.  Its ``model_flops`` is 6·N·D (train), 2·N·D
(prefill) or 2·N·B (decode) from ``active_param_count()``, held here by
that formula.
"""

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as jshd
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro_torch import sharding as shd
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as mesh_lib
from tests.torch_ranks import DRY_DENSE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_archs()
REFUSED = {"granite-moe-1b-a400m": "MoE", "deepseek-v3-671b": "MLA",
           "mamba2-130m": "mamba/hybrid", "zamba2-7b": "mamba/hybrid",
           "seamless-m4t-medium": "encoder-decoder", "pixtral-12b": "vlm"}
RUN_LIMIT_S = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both fake-group runs, started together; each one's saved results."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.join(ROOT, "src"), ROOT])}
    procs = {}
    for name in ("dryrun_small", "dryrun_phi3"):
        path = str(tmp / f"{name}.pt")
        code = f"from tests.torch_ranks import {name}; {name}({path!r})"
        procs[name] = (path, subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                              text=True))
    out = {}
    try:
        for name, (path, proc) in procs.items():
            log, _ = proc.communicate(timeout=RUN_LIMIT_S)
            assert proc.returncode == 0, f"{name} exited {proc.returncode}:\n{log[-4000:]}"
            out[name] = torch.load(path, weights_only=False)
    finally:
        for _, proc in procs.values():
            proc.kill()
    return out


# ---------------------------------------------------------------------------
# the formulas, against the JAX package's configs and rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(steps.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_applicability_are_the_references(arch, shape):
    jcfg = jax_get_config(arch)
    info = steps.SHAPES[shape]
    n = jcfg.active_param_count()
    want = {"train": 6.0 * n * info["seq"] * info["batch"],
            "prefill": 2.0 * n * info["seq"] * info["batch"],
            "decode": 2.0 * n * info["batch"]}[info["kind"]]
    assert dryrun.model_flops(get_config(arch), shape) == want
    assert steps.applicable(get_config(arch), shape) == jsteps.applicable(jcfg, shape)


def test_roofline_terms_pick_the_largest():
    peak, hbm, link = mesh_lib.PEAK_FLOPS_BF16, mesh_lib.HBM_BW, mesh_lib.LINK_BW
    assert (peak, hbm, link) == (989e12, 3.35e12, 450e9)
    for flops, nbytes, coll, want in ((peak, hbm / 2, link / 2, "compute_s"),
                                      (peak / 2, hbm, link / 2, "memory_s"),
                                      (peak / 2, hbm / 2, link, "collective_s")):
        t = dryrun.roofline_terms(flops, nbytes, coll)
        assert t["bottleneck"] == want
        assert t["compute_s"] == flops / peak and t["memory_s"] == nbytes / hbm
        assert t["collective_s"] == coll / link


def test_optimized_settings_keep_the_references_choice():
    """``--optimized``: chunked attention off decode; a decode cell TP-only
    under ``SERVE_RULES`` where the bf16 weights fit one of 16 model shards
    in 0.75 of the card (60 GiB), else the default rules and the plain
    attention."""
    assert dryrun._cell_settings("phi3-mini-3.8b", "train_4k", shd.NO_FSDP_RULES, None,
                                 False) == (shd.NO_FSDP_RULES, None)
    assert dryrun._cell_settings("phi3-mini-3.8b", "prefill_32k", shd.DEFAULT_RULES, None,
                                 True) == (shd.DEFAULT_RULES, "chunked")
    assert dryrun._cell_settings("phi3-mini-3.8b", "decode_32k", shd.DEFAULT_RULES, None,
                                 True) == (shd.SERVE_RULES, "chunked")
    big = get_config("deepseek-v3-671b").param_count() * 2 / 16 / 2**30
    assert big >= 60 and dryrun._cell_settings("deepseek-v3-671b", "decode_32k",
                                               shd.DEFAULT_RULES, None, True) == \
        (shd.DEFAULT_RULES, "plain")


# ---------------------------------------------------------------------------
# fake groups in this process (cheap) and the command line
# ---------------------------------------------------------------------------
def test_fake_meshes_and_their_refusals():
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="fake group"):
        mesh_lib.make_fake_mesh((2, 2), ("data", "model"))
    mesh_lib.init_fake_group(512)
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            mesh_lib.init_fake_group(512)
        m = mesh_lib.make_production_mesh(multi_pod=True, fake=True)
        assert (m.mesh_dim_names, tuple(m.shape), m.device_type) == \
            (("pod", "data", "model"), (2, 16, 16), "cpu")
        with pytest.raises(RuntimeError, match="256 ranks"):
            mesh_lib.make_production_mesh(fake=True)
        with pytest.raises(RuntimeError, match="already exists"):
            dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "decode_32k"])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", sorted(REFUSED))
def test_other_families_are_errors_and_exit_1(arch, capsys):
    """A family the sharded steps refuse reports each applicable cell as
    an error naming what it needs, and the run exits 1; the fake group
    is gone after."""
    import json

    import torch.distributed as dist

    assert dryrun.main(["--arch", arch]) == 1
    assert not dist.is_initialized()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    applicable = [s for s in steps.SHAPES if steps.applicable(get_config(arch), s)[0]]
    assert [r["shape"] for r in lines] == applicable
    for r in lines:
        assert r["status"] == "error" and "NotImplementedError" in r["error"]
        assert REFUSED[arch] in r["error"] and "sharded steps" in r["error"]


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DRY_DENSE)
def test_dense_smoke_cells_run_ok_on_a_small_fake_mesh(runs, arch):
    """Each applicable cell of the dense smoke configs is ``ok`` on a fake
    ``(2, 2)`` mesh with the reference's fields; long_500k is skipped."""
    cells = runs["dryrun_small"]["cells"]
    for shape in steps.SHAPES:
        r = cells[(arch, shape)]
        if shape == "long_500k":
            assert r["status"] == "skipped"
            continue
        assert r["status"] == "ok" and r["chips"] == 4 and r["mesh"] == {"data": 2, "model": 2}
        for key in ("lower_s", "compile_s", "hlo_flops_per_dev", "hlo_bytes_per_dev",
                    "collective_bytes_per_dev", "collectives", "terms", "model_flops_per_dev",
                    "useful_flops_ratio", "memory", "fits_h100_80gb"):
            assert key in r, key
        assert r["hlo_flops_per_dev"] > 0 and r["hlo_bytes_per_dev"] > 0
        assert r["memory"]["argument_bytes"] > 0 and r["memory"]["temp_bytes"] > 0
        assert r["terms"]["bottleneck"] in ("compute_s", "memory_s", "collective_s")


def test_one_kv_head_a_rank_trains(runs):
    """gemma2's smoke config with 2 kv heads on the (2, 2) mesh (one a
    rank) runs its train cell: the plain attention's backward per shard."""
    assert runs["dryrun_small"]["one_kv_head"]["status"] == "ok"


@pytest.mark.parametrize("arch", DRY_DENSE)
def test_one_rank_counts_what_flop_counter_counts_single_device(runs, arch):
    """On a mesh of size 1 the counted FLOPs are ``FlopCounterMode``'s over
    the single-device step (so DTensor's sharding propagation, which runs
    each op once at global shape, is not counted), and nothing moves."""
    world1 = runs["dryrun_small"]["world1"]
    shapes = [s for s in steps.SHAPES if s != "long_500k"]
    for shape in shapes:
        got, want, coll = world1[(arch, shape)]
        assert got == want > 0, (shape, got, want)
        assert dryrun.collective_total(coll) == 0 and coll["count"] == 0, (shape, coll)


def _reference_arg_bytes(shape: str, rules) -> int:
    """Local-shard bytes of a cell's arguments on an abstract (16, 16) mesh
    by the reference's ``cell_shardings``."""
    import jax

    jcfg = jax_get_config("phi3-mini-3.8b")
    in_sh, _ = jsteps.cell_shardings(jcfg, shape, AbstractMesh((16, 16), ("data", "model")),
                                     rules)
    specs = jsteps.input_specs(jcfg, shape)
    p, o = jsteps.train_state_specs(jcfg)
    kind = steps.SHAPES[shape]["kind"]
    args = (p, o, specs["batch"]) if kind == "train" else (p, specs["tokens"], specs["caches"])
    leaves, shardings = jax.tree.leaves(args), jax.tree.leaves(in_sh[:len(args)])
    assert len(leaves) == len(shardings)
    return sum(math.prod(sh.shard_shape(s.shape)) * jnp.dtype(s.dtype).itemsize
               for s, sh in zip(leaves, shardings))


@pytest.mark.parametrize("cell,rules", [("decode_32k", "default"), ("train_4k", "default"),
                                        ("train_4k", "no_fsdp")])
def test_phi3_on_the_production_mesh(runs, cell, rules):
    """phi3 at full width on the fake (16, 16) mesh: ``ok``, 256 chips, the
    argument bytes the reference's shardings imply, the model FLOPs per
    device, and the memory fields."""
    r, _ = runs["dryrun_phi3"][(cell, rules)]
    assert r["status"] == "ok" and r["chips"] == 256
    jrules = {"default": jshd.DEFAULT_RULES, "no_fsdp": jshd.NO_FSDP_RULES}[rules]
    assert r["memory"]["argument_bytes"] == _reference_arg_bytes(cell, jrules)
    assert r["model_flops_per_dev"] == dryrun.model_flops(get_config("phi3-mini-3.8b"),
                                                          cell) / 256
    mem = r["memory"]
    assert mem["total_per_dev_gb"] == round((mem["argument_bytes"] + mem["temp_bytes"]) / 2**30,
                                            3)
    assert r["fits_h100_80gb"] == (mem["argument_bytes"] + mem["temp_bytes"] < 80 * 2**30)
    assert r["useful_flops_ratio"] == r["model_flops_per_dev"] / r["hlo_flops_per_dev"]


def _fsdp_gathers() -> set:
    """(elements, dtype) of each layer weight gathered whole over ``data``:
    its local shard under the no-FSDP rules, where the default rules also
    shard it over ``data``.  Elements, not a shape: DTensor gathers a
    shard of dim i > 0 into a buffer stacked along dim 0."""
    from torch.utils import _pytree as pytree

    from repro_torch.models import params as pm

    sizes = {"data": 16, "model": 16}
    out = set()
    layer = pm.model_spec(get_config("phi3-mini-3.8b"))["layers"][0]
    for s in pytree.tree_leaves(layer, is_leaf=pm.is_spec):
        fsdp = shd.named_sharding(sizes, shd.DEFAULT_RULES, s.axes, s.shape)
        flat = shd.named_sharding(sizes, shd.NO_FSDP_RULES, s.axes, s.shape)
        if fsdp.spec != flat.spec:
            shards = math.prod(sizes[a] for e in flat.spec for a in shd.axes_tuple(e))
            out.add((math.prod(s.shape) // shards, str(s.dtype)))
    return out


def test_train_gathers_weights_only_under_fsdp(runs):
    """``train_4k`` moves all-gather and reduce-scatter bytes under the
    default rules, among them every FSDP'd layer weight gathered whole
    over ``data``; under the no-FSDP rules no all-gather gives such a
    weight."""
    gathers = _fsdp_gathers()
    assert gathers
    default, by_shape = runs["dryrun_phi3"][("train_4k", "default")]
    assert default["collectives"]["all-gather"] > 0
    assert default["collectives"]["reduce-scatter"] > 0
    seen = {(math.prod(shape), dtype) for kind, shape, dtype in by_shape if kind == "all-gather"}
    assert gathers <= seen, gathers - seen
    _, flat = runs["dryrun_phi3"][("train_4k", "no_fsdp")]
    seen = {(math.prod(shape), dtype) for kind, shape, dtype in flat if kind == "all-gather"}
    assert not gathers & seen, gathers & seen


def test_decode_is_memory_bound_and_fits(runs):
    """phi3's ``decode_32k`` reads its weights and caches once a token:
    the memory term leads, and the cell fits the card."""
    r, _ = runs["dryrun_phi3"][("decode_32k", "default")]
    assert r["terms"]["bottleneck"] == "memory_s" and r["fits_h100_80gb"]
    assert np.isclose(r["terms"]["memory_s"], r["hlo_bytes_per_dev"] / 3.35e12)
