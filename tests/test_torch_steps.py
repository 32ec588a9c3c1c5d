"""``launch/steps.py`` in the port against the JAX package's single-device
half (``repro/launch/steps.py:1-101``): the four shapes, the skip rule,
the abstract inputs and train state of every arch and shape, and the
``make_*_step`` functions.

The specs are compared at the full configs (nothing is allocated: the
reference's are ``ShapeDtypeStruct``, the port's ``TensorSpec``); the
reference's stacked per-block trees are unstacked into the port's one
entry a layer as ``models/params.py::from_jax_numpy`` does.  The steps run
at the smoke configs in float32 on numpy draws from a seed.

Tolerances: one train step's metrics within a relative 1e-5 (``acc``
exactly: both count the same argmax hits), both moments within 1e-5 of
each leaf's largest (f32 gradients summed in other orders), each new
parameter within that plus 0.1 x lr: the first AdamW step divides each
gradient by its own magnitude, so a gradient near zero, whose rounding
differs by a large part of itself, moves its update by up to lr (chip_smoke's
small mamba2 reference holds parameters so too); the prefill and serve steps
bit-identical to ``model.prefill`` and ``model.decode_step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.configs.archs import smoke_config as jax_smoke_config
from repro.data import pipeline as jpipeline
from repro.launch import steps as jsteps
from repro.models import params as jparams
from repro.models import transformer as jtfm
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core.graph import TensorSpec
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import steps
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.optim import adamw_init, decay_mask

ARCHS = list_archs()
SHAPES = tuple(steps.SHAPES)
STEP_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _described(leaf):
    """(shape, dtype name) of a ``ShapeDtypeStruct`` or a ``TensorSpec``."""
    if isinstance(leaf, TensorSpec):
        return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    return tuple(leaf.shape), jnp.dtype(leaf.dtype).name


def _unstack(node):
    """A stacked subtree as one subtree a repeat (the leading axis dropped)."""
    leaves, treedef = jax.tree.flatten(node)
    rep = leaves[0].shape[0]
    return [jax.tree.unflatten(treedef, [jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
                                         for leaf in leaves]) for _ in range(rep)]


def _per_layer(tree, prefix, blocks, keep_shared):
    """The reference's ``<prefix><i>["layers"]`` stacks (or the cache tree's
    ``<prefix><i>`` dicts) as a list in execution order."""
    out = []
    for gi, (unit, rep) in enumerate(blocks):
        group = tree[f"{prefix}{gi}"]
        stacked = group.get("layers", group)
        for r in range(rep):
            for j, kind in enumerate(unit):
                if kind != "shared_attn" or keep_shared:
                    out.append(_unstack(stacked[f"{j}:{kind}"])[r])
    return out


def _params_as_port(tree, cfg):
    """The reference's abstract parameter tree in the port's layout."""
    out = {k: v for k, v in tree.items()
           if not (k.startswith("g") and k[1:].isdigit())
           and not (k.startswith("enc") and k[3:].isdigit())}
    out["layers"] = _per_layer(tree, "g", cfg.blocks, keep_shared=False)
    if cfg.is_encdec:
        out["enc_layers"] = _per_layer(tree, "enc", cfg.encoder_blocks, keep_shared=False)
    shared = {f"g{gi}": tree[f"g{gi}"]["shared"]["shared_attn"]
              for gi in range(len(cfg.blocks)) if "shared" in tree[f"g{gi}"]}
    if shared:
        out["shared"] = shared
    return out


def _flat(tree, described):
    """{path: (shape, dtype)} of a port-layout tree of either package."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k, sub in tree.items() for p, v in _flat(sub, described).items()}
    if isinstance(tree, (list, tuple)):
        return {f"{i}/{p}": v for i, sub in enumerate(tree)
                for p, v in _flat(sub, described).items()}
    return {"": described(tree)}


def _all_specs(tree) -> bool:
    return all(isinstance(leaf, TensorSpec) for leaf in pytree.tree_leaves(tree))


# ---------------------------------------------------------------------------
# shapes and the skip rule
# ---------------------------------------------------------------------------
def test_shapes_are_the_references():
    assert steps.SHAPES == jsteps.SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_subquadratic_is_the_references(arch):
    assert get_config(arch).subquadratic == jax_get_config(arch).subquadratic
    assert smoke_config(arch).subquadratic == jax_smoke_config(arch).subquadratic


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_is_the_references(arch, shape):
    assert steps.applicable(get_config(arch), shape) == \
        jsteps.applicable(jax_get_config(arch), shape)


def test_long500k_applicability_rules():
    """The twin of the reference's ``tests/test_archs_smoke.py::
    test_long500k_applicability_rules``: only mamba2 and zamba2 decode at
    500k tokens."""
    runnable = {a: steps.applicable(get_config(a), "long_500k")[0] for a in ARCHS}
    assert runnable["mamba2-130m"] and runnable["zamba2-7b"]
    assert sum(runnable.values()) == 2


# ---------------------------------------------------------------------------
# abstract inputs and state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_the_references(arch, shape):
    """Every input of the cell has the reference's shape and dtype, the
    caches layer by layer; every leaf is a spec on the asked device."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    got = steps.input_specs(cfg, shape, "cpu")
    want = dict(jsteps.input_specs(jcfg, shape))
    assert got.keys() == want.keys()
    assert _all_specs(got)
    assert all(leaf.device == torch.device("cpu") for leaf in pytree.tree_leaves(got))
    if "caches" in want:
        want["caches"] = _per_layer(want["caches"], "g", jcfg.blocks, keep_shared=True)
        assert len(got["caches"]) == len(tparams.layer_kinds(cfg))
    assert _flat(got, _described) == _flat(want, _described)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_are_the_references(arch):
    """The parameters and AdamW's state (int32 step, f32 moments) as specs,
    leaf for leaf the reference's once its stacks are unstacked."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params, opt = steps.train_state_specs(cfg, "cpu")
    jp, jopt = jsteps.train_state_specs(jcfg)
    assert _all_specs((params, opt))
    want = _flat(_params_as_port(jp, jcfg), _described)
    assert _flat(params, _described) == want
    assert _described(opt.step) == ((), "int32") == _described(jopt.step)
    for got, ref in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        assert _flat(got, _described) == _flat(_params_as_port(ref, jcfg), _described)
        assert {d for _, d in _flat(got, _described).values()} == {"float32"}


def test_specs_default_to_cuda_and_refuse_without_it():
    cfg = smoke_config("phi3-mini-3.8b")
    if torch.cuda.is_available():
        assert steps.input_specs(cfg, "decode_32k")["tokens"].device.type == "cuda"
    else:
        for fn in (lambda: steps.input_specs(cfg, "train_4k"),
                   lambda: steps.train_state_specs(cfg)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                fn()


# ---------------------------------------------------------------------------
# the make_*_step functions
# ---------------------------------------------------------------------------
def _leaf(rng, spec):
    if spec.init == "ones":
        return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
    if spec.init == "ssm_a":
        return np.log(1 + 15 * rng.random(spec.shape)).astype(np.float32)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else fan_in ** -0.5
    return (scale * rng.standard_normal(spec.shape)).astype(np.float32)


def _models(arch):
    jcfg = jax_smoke_config(arch).scaled(dtype="float32")
    tcfg = smoke_config(arch).scaled(dtype="float32")
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: _leaf(rng, s), jtfm.model_spec(jcfg), is_leaf=jparams.is_spec)
    return jcfg, tcfg, tree, tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32)


def _close_normwise(got, want, what, extra=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=STEP_TOL * max(float(np.abs(want).max()), 1e-30) + extra,
                               err_msg=what)


LR = 3e-4


def _layer_vector(name: str, t: torch.Tensor) -> bool:
    """A 1-D leaf of a scanned layer: the reference stacks it over its
    block's repeats, where it is 2-D and decayed."""
    return t.dim() == 1 and name.split("/")[0] in ("layers", "enc_layers")


@pytest.mark.parametrize("arch,undecayed", [
    ("phi3-mini-3.8b", {"final_norm/"}),
    ("seamless-m4t-medium", {"enc_norm/", "final_norm/"}),
    ("deepseek-v3-671b", {"final_norm/", "mtp/layer/ln1/", "mtp/layer/ln2/", "mtp/norm/"}),
])
def test_decay_mask_decays_what_the_reference_stacks(arch, undecayed):
    """``adamw.decay_mask`` on a model's tree: every matrix and every
    vector of a scanned layer (``layers/``, ``enc_layers/``) is decayed;
    the shared set's vectors and the unstacked ``mtp`` module's are not."""
    cfg = smoke_config(arch)
    params = tparams.init(cfg, torch.Generator().manual_seed(0), "cpu")
    mask = _flat(decay_mask(params), lambda d: d)
    leaves = _flat(params, lambda t: t)
    assert mask.keys() == leaves.keys()
    assert {name for name, d in mask.items() if not d} == undecayed
    vectors = {name for name, t in leaves.items() if _layer_vector(name, t)}
    assert vectors and all(mask[name] for name in vectors)
    assert all(mask[name] for name, t in leaves.items() if t.dim() >= 2)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "phi3-mini-3.8b"])
def test_make_train_step_matches_the_references(arch):
    """One step of each package's ``make_train_step`` from the same weights
    and batch (seamless's frames included): the reference's metric keys
    and values, the step count, every new parameter and both moments.

    Both packages decay the leaves the reference holds as matrices: a
    layer's norm scales and biases are stacked over repeats there, and the
    port's decay mask (``adamw.decay_mask``) decays them too, so every
    leaf, vectors included, is held to the reference with no added term.
    A parameter's tolerance carries ``0.1 * lr`` (the first step is ``lr *
    g / (|g| + eps)``, which turns on a gradient near ``eps``), except on a
    layer's vectors, where it would hide the decay (``lr * 0.1 * p``, |p|
    near 1) if the port missed it."""
    jcfg, tcfg, tree, tp = _models(arch)
    jbatch = jpipeline.make_batch(jcfg, 2, 24, step=0, seed=0)
    tbatch = tpipeline.make_batch(tcfg, 2, 24, step=0, seed=0, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    jnew, jopt, jm = jsteps.make_train_step(jcfg, lr=LR)(jp, jadamw_init(jp), jbatch)
    new, opt, m = steps.make_train_step(tcfg, lr=LR)(tp, adamw_init(tp), tbatch)
    assert sorted(m) == sorted(jm) == ["acc", "aux", "ce", "grad_norm", "loss"]
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    assert m["acc"].item() == float(jm["acc"])
    assert int(opt.step) == int(jopt.step) == 1
    for which, got, ref in (("params", new, jnew), ("mu", opt.mu, jopt.mu),
                            ("nu", opt.nu, jopt.nu)):
        want = tparams.from_jax_numpy(jax.tree.map(np.asarray, ref), tcfg, "cpu",
                                      dtype=torch.float32)
        got_flat, want_flat = _flat(got, lambda t: t), _flat(want, lambda t: t)
        assert got_flat.keys() == want_flat.keys()
        for name, t in got_flat.items():
            w = want_flat[name]
            extra = 0.1 * LR if which == "params" and not _layer_vector(name, t) else 0.0
            _close_normwise(t.numpy(), w.numpy(), name, extra)
    moved = [not torch.equal(a, b) for a, b in zip(pytree.tree_leaves(tp),
                                                    pytree.tree_leaves(new))]
    assert all(moved)


@pytest.mark.parametrize("arch,stub", [("seamless-m4t-medium", "enc_in"),
                                       ("pixtral-12b", "patch_embeds"),
                                       ("phi3-mini-3.8b", None)])
def test_prefill_and_serve_steps_are_the_model_api(arch, stub):
    """``make_prefill_step`` with the stub's extra (seamless's frames,
    pixtral's patches) and ``make_serve_step`` give ``model.prefill``'s and
    ``model.decode_step``'s logits and caches bit for bit."""
    cfg = smoke_config(arch)
    params = tparams.init(cfg, torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32))
    extras = {}
    if stub == "enc_in":
        extras[stub] = torch.from_numpy(rng.standard_normal((2, 20, cfg.frontend_dim))
                                        .astype(np.float32)).to(torch.bfloat16)
    elif stub == "patch_embeds":
        extras[stub] = torch.from_numpy(rng.standard_normal((2, 8, cfg.frontend_dim))
                                        .astype(np.float32)).to(torch.bfloat16)
    prefill, serve = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    with torch.no_grad():
        lg, cg = prefill(params, toks, tmodel.init_cache(cfg, 2, 32, "cpu"), extras)
        lw, cw = tmodel.prefill(params, cfg, toks, tmodel.init_cache(cfg, 2, 32, "cpu"),
                                **extras)
        nxt = toks[:, -1:]
        dg, cg = serve(params, nxt, cg)
        dw, cw = tmodel.decode_step(params, cfg, nxt, cw)
    assert torch.equal(lg, lw) and torch.equal(dg, dw)
    for a, b in zip(pytree.tree_leaves(cg), pytree.tree_leaves(cw)):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(lg).all())
