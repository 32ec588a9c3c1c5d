"""Serving launcher: batched requests through the port's ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3-mini-3.8b --overlay --requests 4 --batch 2 --max-new 8

``--overlay`` serves through the JIT-assembled accelerator path: prefill and
decode are traced by the overlay frontend, placed on a 3x3 tile grid and
cached as bitstreams instead of running as plain PyTorch calls.  Weights are
random, drawn from ``--seed``.  Runs on ``cuda`` unless ``--device cpu``.

``--event-loop`` serves through the :class:`EventLoopEngine`: chunked
power-of-two-bucketed prefill interleaved with decode ticks plus SLO-aware
admission — ``--chunk`` sets the prefill chunk size, ``--max-queue`` bounds
the queue depth, and ``--max-queue-delay`` (seconds) sheds requests that
would miss their delay budget.  Shed requests and the engine's latency
histograms are reported after the drain.

Mirrors ``repro/launch/serve.py``; its fleet and store flags belong to
later slices of the port.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.overlay import Overlay
from repro_torch.device import resolve_device
from repro_torch.models import params as pm
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.loop import EventLoopEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overlay", action="store_true",
                    help="serve through the JIT-assembled overlay path")
    ap.add_argument("--event-loop", action="store_true",
                    help="serve through the EventLoopEngine (chunked "
                         "bucketed prefill + SLO-aware admission)")
    ap.add_argument("--chunk", type=int, default=64,
                    help="prefill chunk size (power of two; event loop only)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="shed submissions beyond this queue depth")
    ap.add_argument("--max-queue-delay", type=float, default=None,
                    help="shed requests queued longer than this (seconds)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = pm.init(cfg, gen, device)
    overlay = Overlay(3, 3) if args.overlay else None
    if args.event_loop:
        engine = EventLoopEngine(params, cfg, batch=args.batch, max_len=args.max_len,
                                 overlay=overlay, chunk=args.chunk,
                                 max_queue=args.max_queue,
                                 max_queue_delay=args.max_queue_delay, device=device)
    else:
        engine = ServeEngine(params, cfg, batch=args.batch, max_len=args.max_len,
                             overlay=overlay, device=device)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=(args.prompt_len,)).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new))
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0

    tokens = sum(len(r.out) for r in done)
    print(f"[serve] {cfg.name} on {device}: {len(done)}/{args.requests} "
          f"requests, {tokens} tokens in {dt:.2f}s ({tokens / dt:.1f} tok/s)")
    if args.event_loop:
        if engine.shed:
            print(f"[serve] shed {len(engine.shed)} request(s): "
                  f"{[(r.rid, r.shed_reason) for r in engine.shed]}")
        print(f"[serve] metrics: {engine.metrics()}")
    if overlay is not None:
        print(f"[serve] overlay: {overlay.describe()}")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out[:8]}...")
    if overlay is not None:
        overlay.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
