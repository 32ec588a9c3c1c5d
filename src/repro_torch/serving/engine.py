"""Batched serving engine: slot-based continuous batching over a shared
decode step.

The engine owns a fixed pool of ``batch`` sequence slots backed by one cache
per layer (KV for attention, conv windows and SSD state for mamba), so
decode is a single batched ``decode_step`` call.
Requests are admitted into free slots, prefilled one at a time into their
slot's cache stripe, then decoded jointly; finished slots are recycled.
Greedy sampling (argmax) keeps the engine deterministic.

Passing ``overlay=`` routes BOTH serving steps through the JIT-assembly
frontend: prefill and decode become two *separate accelerators resident on
one shared fabric*, each traced, lowered onto the operator library, placed
into its own tiles under a footprint budget (``tile_budget``, default a
quarter of the fabric) and held in the overlay's bitstream cache.  With
``overlay=None`` the steps run as plain PyTorch calls.

Decode is *ragged*: every slot carries its own KV position (``slot_pos``
feeds ``decode_step(positions=...)``).  Each decode tick performs ONE fused
on-device update (sample + advance positions) and ONE device-to-host copy.

The fabric controls of the reference come along: :meth:`ServeEngine.compact`
closes holes left by departed co-tenants and :meth:`ServeEngine.resize`
changes the footprint cap, both by relocation (no re-download), and
:meth:`ServeEngine.warmup` pays the downloads before traffic arrives.

On an overlay with ``async_downloads=True`` the engine also overlaps the
two downloads: the moment the first prefill starts (the earliest point the
decode-step shapes are known) it *prefetches* the decode accelerator and
requests its route-constant specialized tier on the scheduler's low lane,
so decode's kernel builds (and, on the card, its CUDA graph is captured)
while the prefill runs.

``overlay=`` also accepts a :class:`~repro_torch.core.fleet.FleetOverlay`:
the two accelerators are then placed across member fabrics by the fleet's
score, prompt-length prefill variants spread over members instead of
fighting for one fabric's tiles, and a hot decode accelerator is
replicated and routed to its least-loaded copy.  The engine code is the
same: the fleet exposes the single-overlay surface.

:class:`repro_torch.serving.loop.EventLoopEngine` extends this engine with
the serving-under-load path: priority admission with SLO-aware shedding
and chunked, power-of-two-bucketed prefill interleaved with decode ticks.

An encoder-decoder (seamless-m4t) is refused: the reference's engine
passes no encoder input to prefill (``repro/serving/engine.py:112``) and
fails there.  Serve one through ``models.model.prefill(..., enc_in=)``
and ``decode_step``.  A vlm (pixtral) is served as a text model: the
reference's engine passes no patches to prefill (the same line), and
neither does this one; patches reach the model only through
``models.model.prefill(..., patch_embeds=)``.

Port of ``ServeEngine`` in ``repro/serving/engine.py``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
from repro_torch.core.fleet import FleetOverlay
from repro_torch.core.graph import TensorSpec
from repro_torch.core.overlay import Overlay
from repro_torch.device import resolve_device
from repro_torch.models import model as mdl


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    decode_steps: int = 0     # batched decode ticks this request has taken
    done: bool = False
    # SLO / event-loop fields (serving/loop.py); inert on the FIFO engine
    priority: int = 0                     # lower value = served first
    submit_time: float | None = None      # engine clock at submit()
    first_token_time: float | None = None
    shed: bool = False
    shed_reason: str | None = None


def _fused_tick_update(logits, cur_tokens, slot_pos, live):
    """One on-device update for a decode tick: greedy-sample every live
    slot, advance its position, and pack (token, new_position) per slot
    into one (2, B) int32 tensor so the host reads the whole tick with ONE
    copy (``engine.py:81``).  Dead slots keep their token/position."""
    live_b = live.bool()
    tok = torch.where(live_b, torch.argmax(logits, dim=-1).to(torch.int32),
                      cur_tokens[:, 0])
    new_pos = slot_pos + live
    return tok[:, None], new_pos, torch.stack([tok, new_pos])


class ServeEngine:
    def __init__(self, params: Any, cfg: ArchConfig, *, batch: int,
                 max_len: int, overlay: "Overlay | FleetOverlay | None" = None,
                 tile_budget: int | None = None,
                 device: "str | torch.device | None" = None):
        if cfg.is_encdec:
            raise NotImplementedError(
                f"{cfg.name}: the engine's prefill passes no encoder input (the "
                f"reference's fails on it too); serve an encoder-decoder through "
                f"models.model.prefill(..., enc_in=) and decode_step")
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.overlay = overlay
        self.device = resolve_device(device)
        self.caches = mdl.init_cache(cfg, batch, max_len, self.device)
        self.slot_req: list[Request | None] = [None] * batch
        self.slot_pos = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        self.queue: collections.deque[Request] = collections.deque()
        # ragged decode: every slot decodes at its own KV position
        step = lambda p, t, c, pos: mdl.decode_step(p, cfg, t, c, positions=pos)
        pf = lambda p, toks, c: mdl.prefill(p, cfg, toks, c)
        if overlay is not None:
            # by default a quarter of the fabric each, so engines and
            # prompt-length variants co-reside
            if tile_budget is None:
                tile_budget = max(1, overlay.grid.num_tiles // 4)
            self._decode = overlay.jit(step, name=f"{cfg.name}.decode",
                                       tile_budget=tile_budget)
            self._prefill = overlay.jit(pf, name=f"{cfg.name}.prefill",
                                        tile_budget=tile_budget)
        else:
            self._decode, self._prefill = step, pf
        self.tile_budget = tile_budget
        self.cur_tokens = torch.zeros((batch, 1), dtype=torch.int32, device=self.device)
        self._live_mask = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        self._decode_prefetched = False

    # -- fabric management (relocatable bitstreams) --------------------------
    def compact(self) -> int:
        """Close occupancy holes left by departed co-tenants.  Moves are
        relocations — the engine's prefill/decode kernels survive, so
        compaction is safe between ticks.  Returns residents moved (0
        without an overlay)."""
        if self.overlay is None:
            return 0
        return self.overlay.defragment()

    def overlay_failures(self) -> "dict | None":
        """The backing overlay's failure ledger — retries, breaker states,
        dispatch fallbacks (``None`` without an overlay).  Failures never
        surface as dropped tokens on this engine; they surface here (and
        as latency): an admitted request always completes, served by a
        retried download or the fallback."""
        if self.overlay is None:
            return None
        return self.overlay.failure_ledger()

    def resize(self, tile_budget: int) -> None:
        """Change the engine's per-accelerator footprint cap in place.  The
        next prefill/decode dispatch repacks each resident under the new
        budget via relocation (no re-download): grow when co-tenants leave,
        shrink to make room before admitting another engine."""
        if self.overlay is None:
            raise ValueError("resize() needs an overlay-backed engine")
        if tile_budget < 1:
            raise ValueError("tile_budget must be >= 1")
        self.tile_budget = tile_budget
        self._decode.tile_budget = tile_budget
        self._prefill.tile_budget = tile_budget

    def _prefetch_decode(self) -> None:
        """Hide the decode download behind prefill: request it once, as soon
        as traffic arrives (asynchronous overlays only — on a synchronous
        overlay the first decode tick pays its download).  Decode is the
        per-token hot path, so the engine also requests its route-constant
        *specialized* tier: the low-lane build lands behind the generic
        download, and later ticks dispatch the specialized artifact."""
        if self._decode_prefetched or self.overlay is None or \
                not self.overlay.async_downloads:
            return
        self._decode_prefetched = True
        args = (self.params, self.cur_tokens, self.caches, self.slot_pos)
        self._decode.prefetch(*args)
        self._decode.specialize(*args)

    def warmup(self, prompt_lens: "tuple[int, ...]" = ()) -> None:
        """Download the engine's kernels before traffic arrives: the ragged
        decode step, plus one prefill per prompt length given.  Shapes only
        (:class:`TensorSpec` pytrees): nothing executes and no engine state
        changes.  No-op without an overlay."""
        if self.overlay is None:
            return
        spec = lambda t: TensorSpec(tuple(t.shape), t.dtype, t.device)
        params = pytree.tree_map(spec, self.params)
        # the device as a tensor reports it (cuda:0, not cuda): it is part
        # of the signature the calls will look up
        ints = lambda *shape: TensorSpec(shape, torch.int32, self.slot_pos.device)
        self._decode.prefetch(params, ints(self.batch, 1),
                              pytree.tree_map(spec, self.caches), ints(self.batch))
        if prompt_lens:
            c1 = pytree.tree_map(spec, mdl.init_cache(self.cfg, 1, self.max_len,
                                                      self.device))
            for n in prompt_lens:
                self._prefill.prefetch(params, ints(1, int(n)), c1)

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request.  The prompt must fit in ``max_len`` with one
        decode step of headroom (checked here, at the API boundary)."""
        self._validate_request(req)
        self.queue.append(req)

    def _validate_request(self, req: Request) -> None:
        n = len(req.prompt)
        if n == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if n + 1 > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt of {n} tokens does not fit in "
                f"max_len={self.max_len} with decode headroom (the engine "
                f"needs len(prompt) + 1 <= max_len; got {n + 1})")

    def _admit(self) -> None:
        for slot in range(self.batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            self._prefill_slot(slot, self.queue.popleft())

    def _prefill_slot(self, slot: int, req: Request) -> None:
        """Prefill a single slot with a batch-1 cache, then scatter the
        stripe into the pooled cache."""
        self._prefetch_decode()      # decode downloads during the prefill
        prompt = torch.tensor([req.prompt], dtype=torch.int32, device=self.device)
        c1 = mdl.init_cache(self.cfg, 1, self.max_len, self.device)
        logits, c1 = self._prefill(self.params, prompt, c1)
        self._install_stripe(slot, req, c1, int(torch.argmax(logits[0])))

    def _install_stripe(self, slot: int, req: Request, c1: list, tok: int) -> None:
        """Scatter a finished batch-1 prefill cache into the pooled cache
        and mark the slot live for decode (``place`` in
        ``repro/serving/engine.py:248-262``).  Every cache leaf has the batch
        on axis 0 except the scalar per-layer ``index``."""
        at = torch.tensor([slot], device=self.device)

        def place(pool: torch.Tensor, one: torch.Tensor) -> torch.Tensor:
            if pool.dim() == 0:
                # shared per-layer scalar index: keep the max; ragged decode
                # never reads it (it uses the per-slot positions)
                return torch.maximum(pool, one.to(pool.dtype))
            return pool.index_copy(0, at, one.to(pool.dtype))

        self.caches = pytree.tree_map(place, self.caches, c1)
        self.slot_pos[slot] = len(req.prompt)
        req.out.append(tok)
        self.cur_tokens[slot, 0] = tok
        self.slot_req[slot] = req
        self._live_mask[slot] = 1

    # -- decode --------------------------------------------------------------
    def step(self) -> list[Request]:
        """One engine tick: admit, batched-decode, retire. Returns finished."""
        self._admit()
        live = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not live:
            return []
        return self._decode_tick(live)

    def _decode_tick(self, live: list[int]) -> list[Request]:
        """Batched ragged decode over ``live`` slots with ONE host transfer."""
        logits, self.caches = self._decode(
            self.params, self.cur_tokens, self.caches, self.slot_pos)
        self.cur_tokens, self.slot_pos, packed = _fused_tick_update(
            logits, self.cur_tokens, self.slot_pos, self._live_mask)
        toks, poss = packed.tolist()            # the tick's one device->host

        finished: list[Request] = []
        for slot in live:
            req = self.slot_req[slot]
            req.out.append(toks[slot])
            req.decode_steps += 1
            # retire on decode steps, not len(out): out already holds the
            # prefill-produced token, which is not a decode step
            if req.decode_steps >= req.max_new_tokens or \
                    poss[slot] + 1 >= self.max_len:
                req.done = True
                finished.append(req)
                self._release_slot(slot)
        return finished

    def _release_slot(self, slot: int) -> None:
        self.slot_req[slot] = None
        self._live_mask[slot] = 0

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        """Tick until every queued and resident request retires.  Raises
        :class:`RuntimeError` if ``max_ticks`` runs out with work left."""
        done: list[Request] = []
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                return done
            done.extend(self.step())
        queued = len(self.queue)
        resident = sum(1 for r in self.slot_req if r is not None)
        if queued or resident:
            raise RuntimeError(
                f"run_until_drained: {max_ticks} ticks exhausted with {queued} "
                f"request(s) still queued and {resident} still resident "
                f"({len(done)} finished)")
        return done
