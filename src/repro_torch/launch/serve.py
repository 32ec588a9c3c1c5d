"""Serving launcher: batched requests through the port's ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3-mini-3.8b --overlay --requests 4 --batch 2 --max-new 8

``--arch`` takes any registered config: phi3-mini-3.8b, mamba2-130m, the
dense family gemma2-27b (sliding-window and global layers, softcaps, post
norms), minicpm-2b and mistral-large-123b, the hybrid zamba2-7b (68
mamba layers and 13 occurrences of one shared attention+MLP weight set,
each with its own KV cache; not with ``--event-loop``, which refuses
every config with mamba layers), and the mixture-of-experts
granite-moe-1b-a400m (32 experts, top-8, capacity factor 1.25; with
``--event-loop`` each padded prefill chunk is routed with a capacity of
its own, so its streams need not equal ``ServeEngine``'s, as in the
reference), and deepseek-v3-671b (Multi-head Latent Attention over a
latent cache, 256 experts, top-8, a shared expert, sigmoid scoring; serve
it with ``--layers 4``).  ``--smoke`` serves the tiny same-family config;
``--layers N`` keeps the full width and cuts the depth to the first N
layers (mistral-large-123b's 88 layers are 245 GB in bf16 and
deepseek-v3-671b's 61 are 1.34 TB, more than one card holds; deepseek's
first 4, its 3 ``mla_dense`` layers and one ``mla_moe``, are 31.6 GB).
The vlm pixtral-12b (40 dense layers, 24.5 GB) is served as a text
model: the reference's launcher refuses only encoder-decoders
(``repro/launch/serve.py:71``) and its engine passes no patches, so
patches reach the model only through ``models.model.prefill(...,
patch_embeds=)``.

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

``--fleet N`` serves through a :class:`FleetOverlay` of N member fabrics
(implies ``--overlay``): prefill and decode are placed across members by the
fleet's score, hot ones replicate, and each dispatch goes to the least
loaded live copy.  The members share the one device.

``--store DIR`` attaches a persistent bitstream store (implies
``--overlay``; with ``--fleet`` the members share it): the engine's ``warmup`` pays every download before traffic,
kernels are written to ``DIR`` on the overlay's low lane and the close
saves the measurement ledger; a second run on the same ``DIR`` loads the
kernels instead of building them (a warm restart).  ``REPRO_SANITIZE=1``
runs the invariant checkers at every overlay mutation.

The last line of standard output is one JSON object: the token streams by
request id, the seconds to the first token (from process start and from
overlay construction, and their split into init, trace, assembly or load,
and the first call), the overlay's downloads and ``describe()["store"]``,
the cache's ``store_hits``, the kernels this process built or loaded, the
kernel launches by name and variant, and (with the sanitizer on) how many
checks it ran and their seconds.  Overlay counters are summed over a
fleet's members.

Mirrors ``repro/launch/serve.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import cut_layers, get_config, smoke_config
from repro_torch.core import interpreter as interp
from repro_torch.core.fleet import FleetOverlay
from repro_torch.core.overlay import Overlay
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import params as pm
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.loop import EventLoopEngine


def process_seconds() -> float:
    """Seconds since this process started (Linux ``/proc``; else since this
    module was imported)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


class _Counted:
    """A serving step that counts its calls (the launcher's ``calls``)."""

    def __init__(self, fn) -> None:
        self.fn = fn
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)

    def __getattr__(self, name):
        return getattr(self.fn, name)


def _launches() -> dict[str, int]:
    out = {c.name: c.count for c in ops.LAUNCH_COUNTERS}
    for c in ops.LAUNCH_COUNTERS:
        out.update({f"{c.name}/{v}": n for v, n in c.by_variant.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="a registered config, e.g. phi3-mini-3.8b, gemma2-27b, "
                         "granite-moe-1b-a400m, or deepseek-v3-671b with --layers 4")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="serve only the first N decoder layers (a whole "
                         "number of the config's units), at full width")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--prompt-lens", default=None, metavar="N,N,...",
                    help="prompt lengths the requests cycle through "
                         "(overrides --prompt-len)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overlay", action="store_true",
                    help="serve through the JIT-assembled overlay path")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve through a FleetOverlay of N member fabrics "
                         "(implies --overlay)")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="persistent bitstream store directory: built overlay "
                         "kernels are written there and a restarted server "
                         "loads them instead of building (implies --overlay)")
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
    lens = ([int(n) for n in args.prompt_lens.split(",")] if args.prompt_lens
            else [args.prompt_len])
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encdec:
        raise SystemExit("serve launcher targets decoder LMs; serve an encoder-decoder "
                         "through models.model.prefill(..., enc_in=) and decode_step")
    if args.layers is not None:
        cfg = cut_layers(cfg, args.layers)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = pm.init(cfg, gen, device)
    t_overlay = time.perf_counter()
    if args.fleet > 0:
        overlay = FleetOverlay(args.fleet, rows=3, cols=3, store_path=args.store)
    elif args.overlay or args.store is not None:
        overlay = Overlay(3, 3, store_path=args.store)
    else:
        overlay = None
    members = (overlay.members if isinstance(overlay, FleetOverlay)
               else [overlay] if overlay is not None else [])
    if args.event_loop:
        engine = EventLoopEngine(params, cfg, batch=args.batch, max_len=args.max_len,
                                 overlay=overlay, chunk=args.chunk,
                                 max_queue=args.max_queue,
                                 max_queue_delay=args.max_queue_delay, device=device)
    else:
        engine = ServeEngine(params, cfg, batch=args.batch, max_len=args.max_len,
                             overlay=overlay, device=device)

    sanity = [0, 0.0]         # sanitizer checks run, and their seconds
    for member in members:
        if member.sanitize:
            def timed_check(check_overlay=member._sanity_check):
                t = time.perf_counter()
                try:
                    check_overlay()
                finally:
                    sanity[0] += 1
                    sanity[1] += time.perf_counter() - t

            member._sanity_check = timed_check
    t_init = process_seconds()
    t_warm = time.perf_counter()
    if args.store is not None:
        # the warm-restart entry point: every download (or store load)
        # before traffic
        engine.warmup(() if args.event_loop else tuple(sorted(set(lens))))
    steps = {"decode": _Counted(engine._decode)}
    engine._decode = steps["decode"]
    if args.event_loop:
        steps["prefill"] = engine._prefill_chunk = _Counted(engine._prefill_chunk)
    else:
        steps["prefill"] = engine._prefill = _Counted(engine._prefill)

    rng = np.random.default_rng(args.seed)
    reqs = []
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=(lens[rid % len(lens)],)).tolist()
        reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new))
    # the first token: the first prefill's stripe install (its argmax has
    # already been read on the host)
    first: list[float] = []
    install = engine._install_stripe

    def timed_install(*args):
        install(*args)
        if not first:
            first.append(time.perf_counter())
            first.append(process_seconds())
            if overlay is not None:
                first.append(sum(m.stats.trace_seconds for m in members))
                first.append(sum(e.assemble_seconds for m in members
                                 for w in list(m._wrappers)
                                 for e in list(w._entries.values())))

    engine._install_stripe = timed_install
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
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
        # drains queued persists and saves the measurement ledger when a
        # --store directory is attached
        overlay.close()
    result = {
        "arch": cfg.name, "device": str(device),
        "streams": {r.rid: r.out for r in sorted(done, key=lambda r: r.rid)},
        "calls": {k: c.calls for k, c in steps.items()},
        "launches": _launches(),
        "kernels_built": interp.kernel_builds(),
    }
    if first:
        ttft = {"from_process_start": first[1],
                "from_overlay_construction": first[0] - t_overlay,
                "init": t_init}
        if overlay is not None:
            trace_s, assemble_s = first[2], first[3]
            ttft.update(trace=trace_s, assemble_or_load=assemble_s,
                        first_call=first[0] - t_warm - trace_s - assemble_s)
        else:
            ttft["first_call"] = first[0] - t_warm
        result["first_token_seconds"] = ttft
    if overlay is not None:
        descs = [m.describe() for m in members]
        cache = {k: sum(d["cache"][k] for d in descs) for k in descs[0]["cache"]}
        store = overlay.store.describe() if overlay.store is not None else None
        result.update(downloads=sum(d["downloads"] for d in descs), store=store,
                      store_hits=cache["store_hits"], cache=cache,
                      sanitize=any(m.sanitize for m in members),
                      sanitizer_checks=sanity[0], sanitizer_seconds=sanity[1])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
