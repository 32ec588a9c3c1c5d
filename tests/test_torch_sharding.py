"""The port's sharding rules (``sharding.py``) and meshes
(``launch/mesh.py``) against the JAX package's ``repro/sharding.py``.

``logical_to_spec`` is held to the reference's entry for entry on every
parameter spec of every arch (the logical axes and shapes of the JAX
package's ``model_spec``; the port's own specs carry the same axes, which
``tests/test_torch_sharded_train.py`` holds to these), under the three
rule sets, with and without shapes, on meshes of the production
shape ``{data: 16, model: 16}``, the multi-pod ``{pod: 2, data: 16,
model: 16}`` and ``{data: 1, model: 1}``.  The JAX side's mesh is a
``jax.sharding.AbstractMesh``, the port's a plain ``{axis: size}`` map: no
devices and no ranks are needed.  The rule tests of
``tests/test_integration.py`` have their twins here; a ``DeviceMesh``
runs on one gloo rank (``tests/torch_ranks.py``, 180 s limit).
"""

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as jshd
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import params as jparams
from repro.models.transformer import model_spec as jax_model_spec
from repro_torch import sharding as shd
from repro_torch.configs import list_archs
from repro_torch.launch import mesh as mesh_lib
from tests.torch_ranks import host_mesh_facts, spawn

MESHES = {"1x1": {"data": 1, "model": 1}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = {"default": (shd.DEFAULT_RULES, jshd.DEFAULT_RULES),
         "no_fsdp": (shd.NO_FSDP_RULES, jshd.NO_FSDP_RULES),
         "serve": (shd.SERVE_RULES, jshd.SERVE_RULES)}


def _abstract(sizes: dict) -> AbstractMesh:
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def test_rules_are_the_references():
    for ours, theirs in RULES.values():
        for field in ("batch", "seq", "embed", "heads", "kv_heads", "ffn", "vocab",
                      "experts", "ssm_in", "expert_capacity", "head_dim", "layers"):
            assert ours.axis(field) == theirs.axis(field), field
    assert list_archs() == jax_list_archs()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", sorted(RULES))
def test_logical_to_spec_matches_the_reference_on_every_param(mesh, rules):
    ours, theirs = RULES[rules]
    sizes = MESHES[mesh]
    jmesh = _abstract(sizes)
    n = 0
    for arch in jax_list_archs():
        spec = jax_model_spec(jax_get_config(arch))
        for s in jax.tree.leaves(spec, is_leaf=jparams.is_spec):
            for shape in (None, s.shape):
                got = shd.logical_to_spec(sizes, ours, s.axes, shape)
                want = jshd.logical_to_spec(jmesh, theirs, s.axes, shape)
                assert tuple(got) == tuple(want), (arch, s.shape, s.axes, shape)
                n += 1
    assert n > 500


def test_logical_to_spec_divisibility_dropping():
    # axis of size 1 -> dropped entirely
    spec = shd.logical_to_spec({"data": 1, "model": 1}, shd.DEFAULT_RULES,
                               ("batch", None), (4, 8))
    assert spec == shd.PartitionSpec() == ()


def test_spec_drops_nondivisible_dims():
    sizes = {"data": 16, "model": 16}
    for shape, want in (((122753, 2304), (None, "data")), ((122880, 2304), ("model", "data"))):
        got = shd.logical_to_spec(sizes, shd.DEFAULT_RULES, ("vocab", "embed"), shape)
        assert got == want
        assert tuple(got) == tuple(jshd.logical_to_spec(
            _abstract(sizes), jshd.DEFAULT_RULES, ("vocab", "embed"), shape))
    # a mesh axis shards at most one dim: the first dim that asks wins
    assert shd.logical_to_spec(sizes, shd.DEFAULT_RULES, ("heads", "ffn")) == ("model",)


def test_param_specs_have_mesh_compatible_axes():
    """Every parameter's logical axes map, under the port's rules, to mesh
    axes that divide its dims on the production shape (16, 16), where the
    rules do not drop them: the reference test's contract."""
    rules = shd.DEFAULT_RULES
    mesh_shape = MESHES["16x16"]
    bad = []
    for arch in jax_list_archs():
        for s in jax.tree.leaves(jax_model_spec(jax_get_config(arch)), is_leaf=jparams.is_spec):
            for dim, ax in zip(s.shape, s.axes):
                size = 1
                for p in shd.axes_tuple(rules.axis(ax)):
                    size *= mesh_shape.get(p, 1)
                if dim % size and ax in ("heads", "kv_heads", "ffn", "embed", "experts"):
                    bad.append((arch, s.shape, s.axes, ax))
    for arch, shape, axes, ax in bad:
        assert ax == "kv_heads" or shape[0] % 8 == 0, (arch, shape, axes)


def test_filter_axes_and_the_active_mesh():
    sizes = {"pod": 1, "data": 4, "model": 2}
    assert shd.filter_axes(sizes, ("pod", "data")) == "data"
    assert shd.filter_axes(sizes, "model") == "model"
    assert shd.filter_axes(sizes, ("pod",)) is None and shd.filter_axes(sizes, None) is None
    assert shd.filter_axes({"pod": 2, "data": 4}, ("pod", "data")) == ("pod", "data")
    assert shd.active() is None
    shd.set_active(sizes)
    try:
        assert shd.active() == (sizes, shd.DEFAULT_RULES)
    finally:
        shd.set_active(None)
    assert shd.active() is None


def test_meshes_refuse_without_cuda_or_a_group():
    """The mesh entry points never fall back: without CUDA a mesh on
    ``"cuda"`` raises, and without a process group a mesh raises."""
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.make_host_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh("cpu", (1, 1), ("data", "model"))
    with pytest.raises(ValueError):
        mesh_lib.backend_for("meta")
    assert mesh_lib.backend_for("cpu") == "gloo"


def test_host_mesh_on_one_gloo_rank(tmp_path):
    (res,) = spawn(1, host_mesh_facts, tmp_path)
    assert res["names"] == ("data", "model")
    assert res["shape"] == {"data": 1, "model": 1}
    assert res["spec"] == ()
    assert "needs a world of 2 ranks; this one has 1" in res["wrong_world"]
