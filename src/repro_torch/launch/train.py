"""End-to-end training driver.

Builds the model from ``--arch`` with random weights from ``--seed``, the
synthetic data pipeline, AdamW + schedule, wraps the train step in the
fault-tolerant Supervisor (checkpoint-restart, straggler watchdog) and runs
``--steps`` steps.  Runs on ``cuda`` unless ``--device cpu``.  ``--layers
N`` keeps the full width and cuts the depth to the first N layers, a whole
number of the config's units (``configs.cut_layers``, as the serve
launcher): gemma2-27b's 46 layers with their f32 moments need ~330 GB,
2 of them fit one card.  A vlm (pixtral-12b) trains on ``make_batch``'s
patches, min(256, seq // 2) of them over the leading slots, which leave
the loss; its 40 layers need ~147 GB, 8 of them fit.  An encoder-decoder
(seamless-m4t-medium) trains on ``make_batch``'s frames, ``--seq`` of them
a row, which its encoder reads; its 12 + 12 layers fit whole::

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi3-mini-3.8b --smoke --steps 50 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gemma2-27b --layers 2 --steps 4 --batch 1 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch pixtral-12b --smoke --device cpu --steps 4 --batch 2 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch pixtral-12b --layers 8 --steps 4 --batch 1 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-medium --smoke --device cpu --steps 4 --batch 2 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-medium --steps 4 --batch 1 --seq 4096

Mirrors ``repro/launch/train.py:29-121``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import cut_layers, get_config, smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import model as mdl
from repro_torch.models import params as pm
from repro_torch.optim import (adamw_init, adamw_update, adamw_update_, cosine, decay_mask,
                               wsd)
from repro_torch.runtime import FailureInjector, Supervisor, TrainLoopConfig


def _loss_and_grads(cfg, params, batch):
    """(loss, metrics, grads in leaf order) of ``mdl.loss_fn``.  The
    gradients are taken with respect to detached aliases of the parameters,
    so the caller's tensors never require grad (and a traced step needs no
    ``requires_grad`` on its inputs)."""
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss, metrics = mdl.loss_fn(pytree.tree_unflatten(leaves, spec), batch, cfg)
        grads = list(torch.autograd.grad(loss, leaves))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads, spec


def make_step(cfg, schedule, *, overlay=None):
    """The train step ``(state, batch) -> (state, metrics)``, state being
    ``(params, opt_state)``.

    Without ``overlay`` the step runs eagerly and updates the state IN
    PLACE (:func:`adamw_update_`): a functional step would hold two copies
    of the f32 moments.  With ``overlay`` the step is functional and
    JIT-assembled instead, as ``overlay.jit(train_step,
    donate_argnums=(0,))`` (the reference's form): traced by the overlay
    frontend (forward, the backward autograd runs, and the optimizer),
    lowered onto the operator library (kernels as LARGE nodes, everything
    else residue) and cached as a bitstream — the same aten ops, so the
    same numbers.  The state is donated: each new state leaf lands in the
    storage of the leaf it replaces once the walk has read that leaf for
    the last time, so the step holds one copy of the state, and the
    returned state is the caller's tensors."""
    def train_step(state, batch):
        params, opt_state = state
        loss, metrics, grads, spec = _loss_and_grads(cfg, params, batch)
        lr = schedule(opt_state.step)
        params, opt_state, om = adamw_update(
            params, pytree.tree_unflatten(grads, spec), opt_state, lr=lr,
            decay=decay_mask(params))
        return (params, opt_state), {"loss": loss, "lr": lr, **metrics, **om}

    if overlay is not None:
        return overlay.jit(train_step, strict=False, name=f"{cfg.name}.train_step",
                           donate_argnums=(0,))

    def train_step_inplace(state, batch):
        params, opt_state = state
        loss, metrics, grads, _ = _loss_and_grads(cfg, params, batch)
        lr = schedule(opt_state.step)
        om = adamw_update_(params, grads, opt_state, lr=lr, decay=decay_mask(params))
        return state, {"loss": loss, "lr": lr, **metrics, **om}

    return train_step_inplace


def make_schedule(name: str, lr: float, steps: int):
    """The launcher's schedule over ``steps``: ``"wsd"`` (a 5% warmup, 70%
    at the peak, a 20% decay) or ``"cosine"`` (the same warmup)."""
    if name == "wsd":
        return wsd(lr, warmup=max(steps // 20, 1), stable=steps * 7 // 10,
                   decay=max(steps // 5, 1))
    return cosine(lr, warmup=max(steps // 20, 1), total=steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="train only the first N decoder layers (a whole "
                         "number of the config's units), at full width")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default="cosine")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject simulated node failures at these steps")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--assemble-overlay", action="store_true",
                    help="run the train step through the overlay JIT-assembly "
                         "frontend instead of eagerly")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = cut_layers(cfg, args.layers)
    params = pm.init(cfg, torch.Generator(device=device).manual_seed(args.seed),
                     device)
    print(f"[train] {cfg.name} on {device}: {pm.count(params) / 1e6:.2f}M params, "
          f"{cfg.num_layers} layers")
    opt_state = adamw_init(params)

    schedule = make_schedule(args.schedule, args.lr, args.steps)

    overlay = None
    if args.assemble_overlay:
        from repro_torch.core import Overlay
        overlay = Overlay(3, 3)
    step_fn = make_step(cfg, schedule, overlay=overlay)

    def batch_fn(step: int) -> dict:
        return make_batch(cfg, args.batch, args.seq, step=step,
                          seed=args.seed, device=device)

    losses = []

    def logged_step(state, batch):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        n = len(losses)
        if n % args.log_every == 0 or n == 1:
            print(f"  step {n:5d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
        return state, metrics

    sup = Supervisor(
        TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every),
        args.ckpt_dir,
        injector=FailureInjector(fail_at=tuple(args.fail_at)))

    t0 = time.perf_counter()
    sup.run((params, opt_state), logged_step, batch_fn)
    dt = time.perf_counter() - t0
    print(f"[train] done: {args.steps} steps in {dt:.1f}s "
          f"({dt / max(args.steps, 1) * 1000:.0f} ms/step), "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"restarts={sup.restarts} stragglers={sup.straggler_steps}")
    if overlay is not None:
        print(f"[train] overlay: {overlay.describe()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
