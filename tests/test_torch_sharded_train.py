"""The sharded train step (``launch/steps.py``: ``cell_shardings``,
``shard_train_state``, ``make_sharded_train_step``) and what it reads
(``sharding.named_sharding``, ``tree_shardings``, ``constrain``, the
``ParamSpec`` axes, ``opt_state_spec``'s axes) against the JAX package.

Specs: held to the reference entry for entry, with no ranks: the JAX
side's mesh is a ``jax.sharding.AbstractMesh``, the port's an ``{axis:
size}`` map, on ``{data 1, model 1}``, ``{data 16, model 16}`` and ``{pod
2, data 16, model 16}`` under the three rule sets.  The reference stacks a
block's layers under a leading ``None`` axis; the port keeps one entry a
layer, so the reference's stacked leaves are compared without that entry.

The step: on gloo ranks on the CPU (``tests/torch_ranks.py``), the dense
family's smoke configs in float32 under remat ``"full"`` and ``"dots"``,
on ``(data 2, model 2)`` (4 ranks) and, for phi3, ``(pod 2, data 2, model
2)`` (8 ranks), each mesh in one spawn; phi3 also at d_model 128 with 2 kv
heads of 32 (every norm then runs the rmsnorm op, and GQA's kv heads shard
over ``model``).  Held to the port's single-device ``make_train_step`` on
the same numpy-seeded weights and batch, and to the JAX package's
single-device ``value_and_grad(loss_fn)`` and ``adamw_update``.
Tolerances (a sharded contraction sums in another order, so the results
need not be bit-identical): the loss, ce, aux and grad norm within a
relative 1e-5, acc exactly; each gradient and both moments within 1e-5 of
the leaf's largest; each new parameter within that plus 0.1 x lr, except a
layer's vectors, where nothing is added (``test_torch_steps.py`` holds the
single-device step so), and except where the gradient is below 1e-6: the
first AdamW step is ``lr * g / (|g| + eps)``, which a rounding of such a
gradient moves by up to lr, so there the parameter is held within lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

from repro import sharding as jshd
from repro.configs import get_config as jax_get_config
from repro.configs.archs import smoke_config as jax_smoke_config
from repro.data import pipeline as jpipeline
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro.optim import adamw_init as jadamw_init
from repro.optim import opt_state_spec as jopt_state_spec
from repro_torch import sharding as shd
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.launch import steps
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.optim import opt_state_spec
from tests.torch_ranks import (SHARDED_BATCH, SHARDED_LR, SHARDED_SEQ, constrained_placements,
                               sharded_cfg, sharded_train_steps, spawn)

ARCHS = list_archs()
DENSE = ("phi3-mini-3.8b", "minicpm-2b", "gemma2-27b", "mistral-large-123b")
REFUSED = {"granite-moe-1b-a400m": "MoE", "deepseek-v3-671b": "MLA",
           "mamba2-130m": "mamba/hybrid", "zamba2-7b": "mamba/hybrid",
           "seamless-m4t-medium": "encoder-decoder", "pixtral-12b": "vlm"}
REMATS = ("full", "dots")
MESHES = {"1x1": {"data": 1, "model": 1}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = {"default": (shd.DEFAULT_RULES, jshd.DEFAULT_RULES),
         "no_fsdp": (shd.NO_FSDP_RULES, jshd.NO_FSDP_RULES),
         "serve": (shd.SERVE_RULES, jshd.SERVE_RULES)}
CELLS = [(a, s) for a in ARCHS for s in steps.SHAPES if steps.applicable(get_config(a), s)[0]]
STEP_TOL = 1e-5


def _abstract(sizes: dict) -> AbstractMesh:
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


# ---------------------------------------------------------------------------
# the reference's trees in the port's layout
# ---------------------------------------------------------------------------
def _is_ref_leaf(x) -> bool:
    return isinstance(x, (jparams.ParamSpec, jax.sharding.NamedSharding))


def _entries(leaf, stacked: bool) -> tuple:
    """A reference leaf as the port's: a spec's axes or a sharding's spec
    entries, the stacked leading entry dropped (it is always None)."""
    ent = tuple(leaf.axes) if isinstance(leaf, jparams.ParamSpec) else tuple(leaf.spec)
    if stacked:
        assert not ent or ent[0] is None, ent
        ent = ent[1:]
    return ent


def _layers(tree, prefix: str, blocks, keep_shared: bool) -> list:
    out = []
    for gi, (unit, rep) in enumerate(blocks):
        group = tree[f"{prefix}{gi}"]
        stacked = group.get("layers", group)
        for _ in range(rep):
            for j, kind in enumerate(unit):
                if kind != "shared_attn" or keep_shared:
                    out.append(jax.tree.map(lambda s: _entries(s, True),
                                            stacked[f"{j}:{kind}"], is_leaf=_is_ref_leaf))
    return out


def _params_as_port(tree, cfg) -> dict:
    """A reference parameter-shaped tree (specs or shardings) in the port's
    layout, each leaf as its entries."""
    grouped = lambda k: (k.startswith("g") and k[1:].isdigit()) or \
        (k.startswith("enc") and k[3:].isdigit())  # noqa: E731
    out = {k: jax.tree.map(lambda s: _entries(s, False), v, is_leaf=_is_ref_leaf)
           for k, v in tree.items() if not grouped(k)}
    out["layers"] = _layers(tree, "g", cfg.blocks, keep_shared=False)
    if cfg.is_encdec:
        out["enc_layers"] = _layers(tree, "enc", cfg.encoder_blocks, keep_shared=False)
    shared = {f"g{gi}": jax.tree.map(lambda s: _entries(s, False),
                                     tree[f"g{gi}"]["shared"]["shared_attn"],
                                     is_leaf=_is_ref_leaf)
              for gi in range(len(cfg.blocks)) if "shared" in tree[f"g{gi}"]}
    if shared:
        out["shared"] = shared
    return out


def _opt_as_port(opt, cfg) -> dict:
    return {"step": _entries(opt.step, False), "mu": _params_as_port(opt.mu, cfg),
            "nu": _params_as_port(opt.nu, cfg)}


def _flat(tree) -> dict:
    """{path: leaf} over dicts and lists; tuples are leaves."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k, sub in tree.items() for p, v in _flat(sub).items()}
    if isinstance(tree, list):
        return {f"{i}/{p}": v for i, sub in enumerate(tree) for p, v in _flat(sub).items()}
    return {"": tree}


def _port_entries(tree):
    """The port's tree of specs, axes or shardings as plain entry tuples."""
    def leaf(x):
        if isinstance(x, tparams.ParamSpec):
            return tuple(x.axes)
        if isinstance(x, shd.NamedSharding):
            return tuple(x.spec)
        return tuple(x)
    def is_leaf(x) -> bool:
        return isinstance(x, (tparams.ParamSpec, shd.NamedSharding)) or (
            isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x))
    return pytree.tree_map(leaf, tree, is_leaf=is_leaf)


def _opt_port(opt) -> dict:
    return {"step": _port_entries(opt.step), "mu": _port_entries(opt.mu),
            "nu": _port_entries(opt.nu)}


# ---------------------------------------------------------------------------
# logical axes of the specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_are_the_references(arch):
    """Every leaf's ``ParamSpec.axes`` (and ``params.axes``) is the
    reference's, without the stacked leading ``None``."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    spec = tparams.model_spec(cfg)
    want = _flat(_params_as_port(jtfm.model_spec(jcfg), jcfg))
    assert _flat(_port_entries(spec)) == want
    assert _flat(_port_entries(tparams.axes(spec))) == want
    assert all(len(s.axes) == len(s.shape) for s in pytree.tree_leaves(
        spec, is_leaf=tparams.is_spec))


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_axes_are_the_references(arch):
    """``opt_state_spec`` keeps each parameter's axes on both moments; the
    step has none."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    got = _opt_port(opt_state_spec(tparams.model_spec(cfg)))
    want = _opt_as_port(jopt_state_spec(jtfm.model_spec(jcfg)), jcfg)
    assert got["step"] == want["step"] == ()
    assert _flat(got) == _flat(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_are_the_references(arch):
    """``model.cache_param_spec``: the reference's ``layer_cache_spec``
    axes (and shapes) for every layer, shared_attn occurrences included."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    got = tmodel.cache_param_spec(cfg, 2, 64)
    want = _layers(jtfm.cache_spec(jcfg, 2, 64), "g", jcfg.blocks, keep_shared=True)
    assert _flat(_port_entries(got)) == _flat(want)
    assert tmodel.init_cache(cfg, 2, 64, "meta")[0].keys() == got[0].keys()


def test_param_spec_checks_its_axes():
    with pytest.raises(ValueError, match="vs axes"):
        tparams.ParamSpec((2, 3), ("embed",))
    assert tparams.dense(4, 8, "embed", "ffn").axes == ("embed", "ffn")


# ---------------------------------------------------------------------------
# named_sharding, tree_shardings, constrain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", sorted(RULES))
def test_named_sharding_spec_matches_the_reference(mesh, rules):
    """``named_sharding(...).spec`` on every parameter spec of every arch
    (the reference's stacked axes and shapes), with and without shapes."""
    ours, theirs = RULES[rules]
    sizes = MESHES[mesh]
    jmesh = _abstract(sizes)
    n = 0
    for arch in ARCHS:
        for s in jax.tree.leaves(jtfm.model_spec(jax_get_config(arch)), is_leaf=jparams.is_spec):
            for shape in (None, s.shape):
                got = shd.named_sharding(sizes, ours, s.axes, shape)
                assert isinstance(got, shd.NamedSharding) and got.mesh is sizes
                assert tuple(got.spec) == tuple(jshd.named_sharding(jmesh, theirs, s.axes,
                                                                    shape).spec)
                n += 1
    assert n > 600


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", sorted(RULES))
def test_tree_shardings_match_the_reference(mesh, rules):
    """``tree_shardings`` of every arch's axes tree, with and without its
    shapes tree, leaf for leaf the reference's."""
    ours, theirs = RULES[rules]
    sizes = MESHES[mesh]
    jmesh = _abstract(sizes)
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        spec, jspec = tparams.model_spec(cfg), jtfm.model_spec(jcfg)
        for with_shapes in (False, True):
            shapes = pytree.tree_map(lambda s: s.shape, spec, is_leaf=tparams.is_spec)
            got = shd.tree_shardings(sizes, ours, tparams.axes(spec),
                                     shapes if with_shapes else None)
            want = jshd.tree_shardings(jmesh, theirs, jparams.axes(jspec),
                                       jparams.shapes(jspec) if with_shapes else None)
            assert _flat(_port_entries(got)) == _flat(_params_as_port(want, jcfg)), arch


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_shardings_match_the_reference(arch, shape, mesh):
    """``cell_shardings`` (its ``batch_shardings`` included) for every
    arch x applicable shape, under the three rule sets: the parameters,
    AdamW's state, the batch, the tokens, the caches (one dict a layer),
    the extras and the logits, in and out."""
    sizes = MESHES[mesh]
    jmesh = _abstract(sizes)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    kind = steps.SHAPES[shape]["kind"]
    for ours, theirs in RULES.values():
        got_in, got_out = steps.cell_shardings(cfg, shape, sizes, ours)
        want_in, want_out = jsteps.cell_shardings(jcfg, shape, jmesh, theirs)
        assert _flat(_port_entries(got_in[0])) == _flat(_params_as_port(want_in[0], jcfg))
        if kind == "train":
            assert _flat(_opt_port(got_in[1])) == _flat(_opt_as_port(want_in[1], jcfg))
            assert _flat(_opt_port(got_out[1])) == _flat(_opt_as_port(want_out[1], jcfg))
            assert _port_entries(got_in[2]) == {k: tuple(v.spec) for k, v in want_in[2].items()}
            assert got_out[2] is None and want_out[2] is None
            continue
        assert tuple(got_in[1].spec) == tuple(want_in[1].spec)              # tokens
        caches = _layers(want_in[2], "g", jcfg.blocks, keep_shared=True)
        assert _flat(_port_entries(got_in[2])) == _flat(caches)
        assert tuple(got_out[0].spec) == tuple(want_out[0].spec)            # logits
        assert _flat(_port_entries(got_out[1])) == _flat(caches)
        if kind == "prefill":
            assert _port_entries(got_in[3]) == {k: tuple(v.spec) for k, v in want_in[3].items()}


def test_batch_shardings_take_tensors():
    """``batch_shardings`` reads only shapes: a real batch's tensors give
    the specs of the reference's on the same shapes."""
    cfg = smoke_config("pixtral-12b")
    from repro_torch.data.pipeline import make_batch
    batch = make_batch(cfg, 32, 16, step=0, seed=0, device="cpu")
    jmesh = _abstract(MESHES["2x16x16"])
    want = jsteps.batch_shardings(jmesh, jshd.DEFAULT_RULES,
                                  {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
                                   for k, v in batch.items()})
    got = steps.batch_shardings(MESHES["2x16x16"], shd.DEFAULT_RULES, batch)
    assert _port_entries(got) == {k: tuple(v.spec) for k, v in want.items()}
    assert got["tokens"].spec == shd.PartitionSpec(("pod", "data"))


def test_a_tuple_out_of_the_mesh_order_is_refused():
    """DTensor lays a dim sharded over several mesh dims out in the mesh's
    order: a tuple entry in another order is refused, so is an axis the
    mesh lacks."""
    sizes = MESHES["2x16x16"]
    with pytest.raises(ValueError, match="not in the mesh's order"):
        shd.NamedSharding(sizes, shd.PartitionSpec(("data", "pod")))
    backwards = shd.ShardingRules(batch=("data", "pod"))
    with pytest.raises(ValueError, match="not in the mesh's order"):
        shd.named_sharding(sizes, backwards, ("batch", None), (64, 8))
    with pytest.raises(ValueError, match="lacks"):
        shd.NamedSharding({"data": 2}, shd.PartitionSpec("model"))
    assert shd.named_sharding(sizes, shd.DEFAULT_RULES, ("batch", None), (64, 8)).spec == \
        shd.PartitionSpec(("pod", "data"))


def test_placements_follow_the_spec():
    sizes = {"pod": 2, "data": 2, "model": 2}
    s = shd.NamedSharding(sizes, shd.PartitionSpec(("pod", "data"), None, "model"))
    assert s.placements() == (Shard(0), Shard(0), Shard(2))
    assert shd.NamedSharding(sizes, shd.PartitionSpec(None, "data")).placements() == \
        (Replicate(), Shard(1), Replicate())
    assert shd.NamedSharding(sizes, shd.PartitionSpec()).placements() == (Replicate(),) * 3


def test_constrain_leaves_plain_tensors_and_no_mesh_alone():
    """Without a mesh, and on a tensor that is not a DTensor (the
    expert-parallel path runs on plain tensors under an active mesh), both
    constraints return their input."""
    x = torch.ones(4, 8)
    assert shd.constrain(x, None, shd.DEFAULT_RULES, ("batch", None)) is x
    assert shd.constrain(x, {"data": 2}, shd.DEFAULT_RULES, ("batch", None)) is x
    assert shd.constrain_logical(x, ("batch", None)) is x
    shd.set_active({"data": 2, "model": 2})
    try:
        assert shd.constrain_logical(x, ("batch", None)) is x
    finally:
        shd.set_active(None)


CONSTRAINED = [((4, 8), ("batch", None)), ((4, 6, 8), ("batch", None, "vocab")),
               ((3, 8), ("batch", "embed")), ((4, 2, 8, 4), ("batch", "heads", None, None)),
               ((2, 8), (None, "ffn"))]


def _placements_of(spec, names) -> tuple:
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[names.index(a)] = Shard(i)
    return tuple(out)


def test_constrain_redistributes_to_the_references_spec(tmp_path):
    """``constrain`` and ``constrain_logical`` of a replicated DTensor on a
    ``(data 2, model 2)`` gloo mesh land on the placements of the
    reference's spec for its shape (a dim that does not divide stays
    whole), the values untouched."""
    got = spawn(4, constrained_placements, tmp_path, CONSTRAINED)
    jmesh = _abstract({"data": 2, "model": 2})
    for (shape, axes), (c, a, same) in zip(CONSTRAINED, got[0]):
        want = _placements_of(jshd.logical_to_spec(jmesh, jshd.DEFAULT_RULES, axes, shape),
                              ("data", "model"))
        assert c == a == want, (shape, axes)
        assert same
    assert got[0][2][0] == (Shard(1), Replicate())      # 3 rows do not split over data


# ---------------------------------------------------------------------------
# the family the sharded step covers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(REFUSED))
def test_sharded_step_refuses_the_other_families(arch):
    """MoE, MLA, mamba/hybrid, the encoder-decoder and the vlm are refused
    by name, before any mesh is read: none runs unsharded in silence."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 4") as err:
        steps.make_sharded_train_step(smoke_config(arch), mesh=None)
    assert REFUSED[arch] in str(err.value)


@pytest.mark.parametrize("arch", DENSE)
def test_sharded_step_takes_the_dense_family(arch):
    steps.check_sharded_family(get_config(arch))
    steps.check_sharded_family(smoke_config(arch))


# ---------------------------------------------------------------------------
# the step on gloo ranks
# ---------------------------------------------------------------------------
def _leaf(rng, spec):
    if spec.init == "ones":
        return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    return (scale * rng.standard_normal(spec.shape)).astype(np.float32)


def _jax_cfg(arch: str, remat: str, wide: bool):
    cfg = jax_smoke_config(arch).scaled(dtype="float32", remat=remat)
    return cfg.scaled(d_model=128, head_dim=32, num_kv_heads=2) if wide else cfg


def _tree(arch: str, wide: bool = False) -> dict:
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(_jax_cfg(arch, "full", wide)),
                        is_leaf=jparams.is_spec)


FOUR = [(arch, remat, False) for arch in DENSE for remat in REMATS] + \
    [("phi3-mini-3.8b", "full", True)]
EIGHT = [("phi3-mini-3.8b", remat, False) for remat in REMATS]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    cases = [(a, r, w, _tree(a, w)) for a, r, w in FOUR]
    return spawn(4, sharded_train_steps, tmp_path_factory.mktemp("four"), (2, 2),
                 ("data", "model"), cases, time_limit=300)


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    cases = [(a, r, w, _tree(a, w)) for a, r, w in EIGHT]
    return spawn(8, sharded_train_steps, tmp_path_factory.mktemp("eight"), (2, 2, 2),
                 ("pod", "data", "model"), cases, time_limit=300)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's single-device gradients and train step, per arch
    (the remat policy does not change them), in the port's leaf order."""
    out = {}
    for arch in DENSE:
        jcfg, tcfg = _jax_cfg(arch, "full", False), sharded_cfg(arch, "full")
        jp = jax.tree.map(jnp.asarray, _tree(arch))
        batch = jpipeline.make_batch(jcfg, SHARDED_BATCH, SHARDED_SEQ, step=0, seed=0)
        _, grads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(jp, batch, jcfg)
        new, opt, metrics = jsteps.make_train_step(jcfg, lr=SHARDED_LR)(jp, jadamw_init(jp),
                                                                        batch)
        as_port = lambda t: pytree.tree_leaves(tparams.from_jax_numpy(  # noqa: E731
            jax.tree.map(np.asarray, t), tcfg, "cpu", dtype=torch.float32))
        out[arch] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "grads": as_port(grads), "params": as_port(new),
                     "mu": as_port(opt.mu), "nu": as_port(opt.nu), "step": int(opt.step)}
    return out


def _names(arch: str, wide: bool) -> list[str]:
    """The leaf paths of the parameters, in the order the ranks' trees
    (``from_jax_numpy``) hold them."""
    params = tparams.from_jax_numpy(_tree(arch, wide), sharded_cfg(arch, "full", wide), "cpu",
                                    dtype=torch.float32)
    flat, _ = pytree.tree_flatten_with_path(params)
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in flat]


def _layer_vector(name: str, t: torch.Tensor) -> bool:
    return t.dim() == 1 and name.split("/")[0] in ("layers", "enc_layers")


NEAR_EPS = 1e-6     # |g| below this: AdamW's first step lr * g / (|g| + 1e-8) turns on rounding


def _close(got, want, what, extra=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=STEP_TOL * max(float(np.abs(want).max()), 1e-30) + extra,
                               err_msg=what)


def _hold(got: dict, want: dict, arch: str, wide: bool) -> None:
    """``got`` (a step's metrics, gradients, new parameters, moments and
    step count) within the stated tolerances of ``want``.  A parameter
    whose gradient is below ``NEAR_EPS`` moved by ``lr * g / (|g| +
    eps)``, which a rounding of ``g`` changes by up to ``lr``: there it is
    held within ``lr``; elsewhere as the moments, plus ``0.1 * lr`` except
    on a layer's vectors (where that would hide a missed weight decay)."""
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5,
                                   atol=1e-30, err_msg=k)
    assert got["metrics"]["acc"] == want["metrics"]["acc"]
    assert got["step"] == want["step"] == 1
    names = _names(arch, wide)
    for which in ("grads", "mu", "nu"):
        assert len(got[which]) == len(want[which]) == len(names)
        for name, g, w in zip(names, got[which], want[which]):
            _close(g, w, f"{which} {name}")
    for name, g, w, grad in zip(names, got["params"], want["params"], want["grads"]):
        near = np.abs(np.asarray(grad, np.float32)) < NEAR_EPS
        extra = 0.0 if _layer_vector(name, w) else 0.1 * SHARDED_LR
        _close(np.where(near, 0, g), np.where(near, 0, w), f"params {name}", extra)
        _close(np.where(near, g, 0), np.where(near, w, 0), f"params {name} near eps",
               SHARDED_LR)


def _case(results, arch, remat, wide=False) -> dict:
    return results[0][(arch, remat, wide)]


@pytest.mark.parametrize("arch,remat,wide", FOUR)
def test_sharded_step_matches_single_device_on_four_ranks(four_ranks, arch, remat, wide):
    c = _case(four_ranks, arch, remat, wide)
    _hold(c["sharded"], c["single"], arch, wide)


@pytest.mark.parametrize("arch,remat", [(a, r) for a, r, _ in EIGHT])
def test_sharded_step_matches_single_device_on_eight_ranks(eight_ranks, arch, remat):
    c = _case(eight_ranks, arch, remat)
    _hold(c["sharded"], c["single"], arch, False)


@pytest.mark.parametrize("arch,remat", [(a, r) for a, r, w in FOUR if not w])
def test_sharded_step_matches_the_jax_step(four_ranks, jax_steps, arch, remat):
    """The sharded step against the JAX package's single-device
    ``value_and_grad(loss_fn)`` and ``adamw_update`` (the port's
    single-device step against the same, as ``test_torch_steps.py``)."""
    c = _case(four_ranks, arch, remat)
    _hold(c["sharded"], jax_steps[arch], arch, False)
    _hold(c["single"], jax_steps[arch], arch, False)


@pytest.mark.parametrize("arch,remat", [(a, r) for a, r, _ in EIGHT])
def test_eight_rank_step_matches_the_jax_step(eight_ranks, jax_steps, arch, remat):
    _hold(_case(eight_ranks, arch, remat)["sharded"], jax_steps[arch], arch, False)


@pytest.mark.parametrize("ranks", ["four_ranks", "eight_ranks"])
def test_state_stays_dtensors_at_the_cell_placements(request, ranks):
    """On every rank, before and after the step, every parameter and
    moment is a DTensor on the mesh at its ``cell_shardings`` placements,
    and every metric is a replicated DTensor whose ``item()`` is the same
    on every rank."""
    results = request.getfixturevalue(ranks)
    for rank in results:
        for case in rank.values():
            assert case["placed"] == (True, True)
    for key in results[0]:
        items = [rank[key]["metric_items"] for rank in results]
        assert all(i == items[0] for i in items)


# the placements each op's first input comes in at: the batch over the data
# axes and, for attention, the heads over "model" (4 and 2 kv heads divide 2)
OP_PLACEMENTS = {"four_ranks": {"_attention_op": ("S(0)", "S(1)"), "_rmsnorm_op": ("S(0)", "R")},
                 "eight_ranks": {"_attention_op": ("S(0)", "S(0)", "S(1)")}}


@pytest.mark.parametrize("ranks", ["four_ranks", "eight_ranks"])
def test_custom_ops_run_on_dtensors(request, ranks):
    """The sharded step dispatches the attention op (and, at d_model 128,
    the rmsnorm op) as often as the single-device step, every time with
    DTensor inputs (no wrapper turns a DTensor into a plain computation),
    at the placements the model's pins give: each rank's kernel runs on
    its own rows and heads."""
    for (arch, remat, wide), case in request.getfixturevalue(ranks)[0].items():
        single, sharded = case["calls"]
        ops = ("_attention_op", "_rmsnorm_op") if wide else ("_attention_op",)
        for op in ops:
            n = single.get((op, False), 0)
            assert n > 0, (arch, remat, op)
            assert sharded.get((op, True), 0) == n, (arch, remat, op)
            assert sharded.get((op, False), 0) == 0 and single.get((op, True), 0) == 0
            assert sharded.get((op, OP_PLACEMENTS[ranks][op]), 0) == n, (arch, remat, op,
                                                                          sharded)
