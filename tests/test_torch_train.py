"""The port's training path against the JAX package: ``loss_fn`` with its
gradients, AdamW and the schedules, the synthetic data stream, the
checkpoint, the supervisor, the overlay-traced train step and the launcher.

The model is a phi3-mini config cut to d_model 128 (so both kernels are on
the JAX path: ``repro/models/layers.py:74,242``), 2 layers, 4 heads of 32,
vocab 256, at seq 128.  Weights, batches and optimizer leaves are made from
a seed with numpy and fed to both packages; the JAX side runs its Pallas
kernels in interpret mode.  Everything is float32 unless a test says
otherwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs.archs import smoke_config as jax_smoke_config
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models.transformer import model_spec as jax_model_spec
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from repro_torch.configs import smoke_config
from repro_torch.core import Overlay
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.optim import (OptState, adamw_init, adamw_update, adamw_update_,
                               constant, cosine, wsd)
from repro_torch.optim import adamw as adamw_mod
from repro_torch.runtime import FailureInjector, Supervisor, TrainLoopConfig

SMALL = dict(d_model=128, head_dim=32)
SEQ = 128


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _configs(dtype="float32"):
    return (jax_smoke_config("phi3-mini-3.8b").scaled(dtype=dtype, **SMALL),
            smoke_config("phi3-mini-3.8b").scaled(dtype=dtype, **SMALL))


def _numpy_params(jcfg, seed=0):
    """The JAX parameter tree's structure, filled with numpy draws."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        if spec.init == "ones":
            return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None else fan_in ** -0.5
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    return jax.tree.map(leaf, jax_model_spec(jcfg), is_leaf=jparams.is_spec)


def _clone(tree):
    return pytree.tree_map(lambda t: t.clone(), tree)


def _small_state(cfg, seed=0):
    params = tparams.init(cfg, torch.Generator().manual_seed(seed), "cpu")
    return params, adamw_init(params)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
def test_loss_and_grads_match_jax():
    """Loss, accuracy and every gradient of a 2-layer f32 phi3 at seq 128
    against ``jax.value_and_grad(loss_fn)`` — the flash attention and
    rmsnorm kernels on the JAX side (interpret mode), their plain versions
    on the port's.  Loss rtol 1e-5; gradients rtol 1e-4 with an absolute
    floor of 1e-4 of the largest gradient of each leaf: f32 sums in other
    orders through the backward's products."""
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg)
    batch = jpipe.make_batch(jcfg, 2, SEQ, step=3, seed=1)
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), batch, jcfg)
    tp = tparams.from_jax_numpy(tree, tcfg, "cpu", dtype=torch.float32)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, metrics, grads, spec = train_cli._loss_and_grads(tcfg, tp, tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["acc"].item(), float(jm["acc"]), rtol=1e-6)
    want = tparams.from_jax_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                                  dtype=torch.float32)
    got = pytree.tree_unflatten(grads, spec)
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def test_cross_entropy_matches_jax_with_mask():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    jl, ja = jmodel.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    tl, ta = tmodel.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                  torch.from_numpy(mask))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma2-27b", "granite-moe-1b-a400m",
                                  "pixtral-12b"])
def test_remat_policies_give_bit_identical_loss_and_gradients(arch):
    """``"full"``, ``"dots"`` and ``"none"`` run the same ops on the same
    inputs, the first two again in the backward: loss and every gradient
    bit-identical (gemma2: its local and global layers, window 32 against
    seq 128, softcaps and post norms; granite: the routers' aux loss, each
    checkpointed layer returning its own, and the backward through the
    sort-based dispatch; pixtral: the vision stub's ``frontend_proj``
    outside the checkpointed layers, its 64 patch positions masked out of
    the loss)."""
    tcfg = smoke_config(arch).scaled(dtype="bfloat16", **SMALL)
    if arch == "gemma2-27b":
        tcfg = tcfg.scaled(query_pre_attn_scalar=32.0, sliding_window=32)
    params = tparams.init(tcfg, torch.Generator().manual_seed(1), "cpu")
    batch = tpipe.make_batch(tcfg, 1, SEQ, device="cpu")
    outs = [train_cli._loss_and_grads(tcfg.scaled(remat=r), params, batch)
            for r in ("full", "dots", "none")]
    if arch == "pixtral-12b":
        assert tuple(batch["patch_embeds"].shape) == (1, 64, tcfg.frontend_dim)
        stub = next(i for i, t in enumerate(pytree.tree_leaves(params))
                    if t is params["frontend_proj"])
        assert bool(outs[0][2][stub].abs().max() > 0)
    for out in outs[1:]:
        assert torch.equal(outs[0][0], out[0])
        assert torch.equal(outs[0][1]["aux"], out[1]["aux"])
        for a, b in zip(outs[0][2], out[2]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# AdamW and schedules
# ---------------------------------------------------------------------------
def _opt_leaves(seed):
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32),
         "layers": [{"k": rng.standard_normal((3, 4)).astype(np.float32)}]}
    gs = [jax.tree.map(lambda a: (3 * rng.standard_normal(a.shape)).astype(np.float32), p)
          for _ in range(3)]
    return p, gs


def _to_torch(tree):
    return pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("max_norm", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_adamw_matches_jax(max_norm):
    """Three AdamW steps on the same leaves.  The global norm sums the leaves
    in another order (JAX sorts dict keys), and pow/sqrt may round
    differently: f32 rounding only, rtol 1e-5 with atol 1e-6."""
    p, gs = _opt_leaves(0)
    jp, js = jax.tree.map(jnp.asarray, p), jadamw.adamw_init(jax.tree.map(jnp.asarray, p))
    tp = _to_torch(p)
    ts = adamw_init(tp)
    for i, g in enumerate(gs):
        lr = 1e-2 * (i + 1)
        jp, js, jm = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, lr=lr,
                                         max_grad_norm=max_norm)
        tp, ts, tm = adamw_update(tp, _to_torch(g), ts, lr=lr, max_grad_norm=max_norm)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for tree_t, tree_j in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for name in ("w", "b"):
            np.testing.assert_allclose(tree_t[name].numpy(), np.asarray(tree_j[name]),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tree_t["layers"][0]["k"].numpy(),
                                   np.asarray(tree_j["layers"][0]["k"]), rtol=1e-5, atol=1e-6)


def test_adamw_in_place_equals_functional_bf16():
    """The in-place update writes the functional update's exact bits, for
    bf16 parameters (cast back from the f32 update) and f32 norms."""
    p, gs = _opt_leaves(1)
    base = pytree.tree_map(lambda t: t.bfloat16() if t.dim() >= 2 else t, _to_torch(p))
    fp, fs = _clone(base), adamw_init(base)
    ip, is_ = _clone(base), adamw_init(base)
    for g in gs:
        tg = pytree.tree_map(lambda q, t: t.to(q.dtype), base, _to_torch(g))
        fp, fs, fm = adamw_update(fp, tg, fs, lr=3e-3)
        im = adamw_update_(ip, pytree.tree_leaves(tg), is_, lr=3e-3)
        assert torch.equal(fm["grad_norm"], im["grad_norm"])
    for a, b in zip(pytree.tree_leaves((fp, fs)), pytree.tree_leaves((ip, is_))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ip["w"].dtype == torch.bfloat16 and is_.mu["w"].dtype == torch.float32


def test_adamw_in_place_in_slices_equals_functional(monkeypatch):
    """With the slice lowered to 7 elements the in-place update walks each
    leaf in slices of its flat view (the (6, 5) matrix in five, the (3, 4)
    one in two, each with its weight decay): the functional update's exact
    bits, for bf16 and f32 parameters."""
    monkeypatch.setattr(adamw_mod, "SLICE_ELEMENTS", 7)
    p, gs = _opt_leaves(2)
    for dtype in (torch.bfloat16, torch.float32):
        base = pytree.tree_map(lambda t: t.to(dtype), _to_torch(p))
        fp, fs = _clone(base), adamw_init(base)
        ip, is_ = _clone(base), adamw_init(base)
        for g in gs:
            tg = pytree.tree_map(lambda q, t: t.to(dtype), base, _to_torch(g))
            fp, fs, _ = adamw_update(fp, tg, fs, lr=3e-3)
            adamw_update_(ip, pytree.tree_leaves(tg), is_, lr=3e-3)
        for a, b in zip(pytree.tree_leaves((fp, fs)), pytree.tree_leaves((ip, is_))):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_schedules_match_jax(name):
    make = {"constant": lambda m: m.constant(3e-3),
            "cosine": lambda m: m.cosine(3e-3, warmup=5, total=50),
            "wsd": lambda m: m.wsd(3e-3, warmup=5, stable=30, decay=10)}[name]
    jf = make(jsched)
    tf = {"constant": constant, "cosine": cosine, "wsd": wsd}[name]
    tf = make(type("m", (), {name: staticmethod(tf)}))
    for step in (0, 1, 4, 5, 6, 20, 34, 35, 36, 40, 44, 45, 50, 60):
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(jf(step)), rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,shard,shards", [(0, 0, 0, 1), (3, 7, 1, 2),
                                                    (11, 100, 3, 4)])
def test_synthetic_tokens_equal_jax(seed, step, shard, shards):
    j = jpipe.SyntheticLM(512, 33, 8, seed).batch(step, shard, shards)
    t = tpipe.SyntheticLM(512, 33, 8, seed, device="cpu").batch(step, shard, shards)
    for key in ("tokens", "labels"):
        assert t[key].dtype == torch.int32
        np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))


def test_make_batch_and_prefetcher_equal_jax():
    jcfg, tcfg = _configs()
    for step in (0, 5):
        j = jpipe.make_batch(jcfg, 2, 16, step=step, seed=4)
        t = tpipe.make_batch(tcfg, 2, 16, step=step, seed=4, device="cpu")
        np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
    ds = tpipe.SyntheticLM(64, 8, 2, seed=2, device="cpu")
    pf = tpipe.Prefetcher(ds.iterate(start_step=3))
    got = [next(pf) for _ in range(3)]
    pf.close()
    for i, b in enumerate(got):
        assert torch.equal(b["tokens"], ds.batch(3 + i)["tokens"])


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    _, tcfg = _configs("bfloat16")
    params, opt = _small_state(tcfg, seed=3)
    opt.step.fill_(7)
    opt.mu["embed"].normal_(generator=torch.Generator().manual_seed(1))
    state = (params, opt)
    path = save_checkpoint(str(tmp_path), 7, state, extra={"note": "x"})
    like = pytree.tree_map(torch.zeros_like, state)
    back, manifest = load_checkpoint(path, like)
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    assert back is like and isinstance(back[1], OptState)   # restored in place
    assert manifest["files"]["0/embed"]["dtype"] == "bfloat16"
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_rejects_a_tree_of_other_shapes_or_dtypes(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, {"w": torch.ones(4)})
    for other in (torch.zeros(5), torch.zeros(4, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="checkpoint holds float32"):
            load_checkpoint(path, {"w": other})
        assert not other.any()


def test_checkpoint_detects_corruption_and_falls_back(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32), "b": torch.ones(2, dtype=torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for step in (1, 2, 3):
        mgr.save(step, pytree.tree_map(lambda t, s=step: t * s, tree))
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002", "step_0000000003"]
    with open(tmp_path / "step_0000000003" / "b.npy", "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\x80\x7f\x80\x7f")           # the last leaf: two bf16 infs
    live = pytree.tree_map(torch.zeros_like, tree)
    with pytest.raises(IOError, match="checksum"):
        load_checkpoint(str(tmp_path / "step_0000000003"), live)
    assert not any(t.any() for t in live.values())   # checked before any write
    back, manifest = mgr.restore_latest(live)
    assert manifest["step"] == 2 and back is live
    for name in tree:
        assert torch.equal(live[name], tree[name] * 2)


def test_checkpoint_save_copies_before_an_in_place_step(tmp_path):
    t = {"w": torch.zeros(4)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, t)
    t["w"].add_(1.0)                      # an in-place step right after
    back, _ = mgr.restore_latest({"w": torch.empty(4)})
    assert torch.equal(back["w"], torch.zeros(4))


# ---------------------------------------------------------------------------
# supervisor, overlay step, launcher
# ---------------------------------------------------------------------------
def _train(cfg, steps, tmp, fail_at=(), overlay=None):
    params, opt = _small_state(cfg)
    step_fn = train_cli.make_step(cfg, cosine(3e-3, warmup=1, total=steps), overlay=overlay)
    sup = Supervisor(TrainLoopConfig(total_steps=steps, ckpt_every=2), str(tmp),
                     injector=FailureInjector(fail_at=tuple(fail_at)))
    state = sup.run((params, opt), step_fn,
                    lambda s: tpipe.make_batch(cfg, 2, SEQ, step=s, device="cpu"))
    return state, sup


def test_supervisor_restart_reproduces_the_run_without_failure(tmp_path):
    _, tcfg = _configs("bfloat16")
    clean, sup0 = _train(tcfg, 5, tmp_path / "a")
    failed, sup1 = _train(tcfg, 5, tmp_path / "b", fail_at=(3, 5))
    assert (sup0.restarts, sup1.restarts) == (0, 2)
    assert [h.step for h in sup1.history] == [1, 2, 3, 4, 5]
    for a, b in zip(pytree.tree_leaves(clean), pytree.tree_leaves(failed)):
        assert torch.equal(a, b)


def test_overlay_train_step_equals_eager_step():
    """Two steps through ``Overlay.jit`` (functional, traced with the
    backward and the optimizer) and eagerly in place, from the same state,
    under remat ``"full"`` and ``"dots"``: the traced graph replays the
    eager run's aten ops, so losses and updated parameters are
    bit-identical.  While traced, ``"dots"`` checkpoints as ``"full"``
    (under a tracer's proxy mode torch's selective checkpoint would save
    every op's output), so its graph also recomputes every layer in the
    backward: bounded memory, the same numbers."""
    _, base = _configs("bfloat16")
    for remat in ("full", "dots"):
        tcfg = base.scaled(remat=remat)
        sched = cosine(3e-3, warmup=1, total=4)
        ov = Overlay(3, 3)
        traced = train_cli.make_step(tcfg, sched, overlay=ov)
        eager = train_cli.make_step(tcfg, sched)
        s_ov = _small_state(tcfg, seed=2)
        s_eg = _clone(s_ov[0]), adamw_init(s_ov[0])
        for step in range(2):
            batch = tpipe.make_batch(tcfg, 2, SEQ, step=step, device="cpu")
            s_ov, m_ov = traced(s_ov, batch)
            s_eg, m_eg = eager(s_eg, batch)
            assert torch.equal(m_ov["loss"], m_eg["loss"])
            assert torch.equal(m_ov["grad_norm"], m_eg["grad_norm"])
        for a, b in zip(pytree.tree_leaves(s_ov), pytree.tree_leaves(s_eg)):
            assert torch.equal(a, b)
        assert ov.stats.traces == 1 and ov.stats.downloads == 1
        names = [n.name for n in traced.lower(s_ov, batch).graph.op_nodes()]
        # the forward and the backward's recompute: one attention a layer
        # each, and the layer norms again
        assert names.count("kernels/attention") == 2 * tcfg.num_layers
        assert names.count("kernels/rmsnorm") == 4 * tcfg.num_layers + 1


def test_train_launcher_on_cpu_restarts_after_failure(tmp_path, capsys):
    rc = train_cli.main(["--arch", "phi3-mini-3.8b", "--smoke", "--steps", "4",
                         "--batch", "2", "--seq", "128", "--ckpt-every", "2",
                         "--fail-at", "3", "--log-every", "1", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "restarts=1" in out and "4 steps" in out
    assert sorted(os.listdir(tmp_path))[-1] == "step_0000000004"


def test_train_launcher_cuts_gemma2_to_two_layers_and_restarts(tmp_path, capsys):
    """``--layers 2`` keeps one (local, global) unit of gemma2 at its
    (smoke) width; the run restarts from its step-2 checkpoint after the
    failure at step 3."""
    rc = train_cli.main(["--arch", "gemma2-27b", "--smoke", "--layers", "2", "--steps", "4",
                         "--batch", "1", "--seq", "64", "--ckpt-every", "2",
                         "--fail-at", "3", "--log-every", "1", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "2 layers" in out and "restarts=1" in out and "4 steps" in out
    assert sorted(os.listdir(tmp_path))[-1] == "step_0000000004"


def test_train_launcher_refuses_a_part_of_a_unit(tmp_path):
    with pytest.raises(ValueError, match=r"3 layers is not a whole number of its units "
                                         r"\[\('local', 'global'\)\]"):
        train_cli.main(["--arch", "gemma2-27b", "--smoke", "--layers", "3", "--steps", "1",
                        "--device", "cpu", "--ckpt-dir", str(tmp_path)])


def test_train_launcher_through_the_overlay_on_cpu(tmp_path, capsys):
    assert train_cli.main(["--arch", "phi3-mini-3.8b", "--smoke", "--steps", "2",
                           "--batch", "1", "--seq", "128", "--device", "cpu",
                           "--assemble-overlay", "--ckpt-dir", str(tmp_path)]) == 0
    assert "'downloads': 1" in capsys.readouterr().out


def test_train_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only failure mode")
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.make_batch(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.SyntheticLM(16, 8, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "phi3-mini-3.8b", "--smoke", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])
