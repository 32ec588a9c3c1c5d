"""Event-loop serving engine: chunked bucketed prefill + SLO admission.

:class:`EventLoopEngine` extends the slot-based :class:`ServeEngine` with
the serving-under-load path:

* **Chunked, bucketed prefill** — prompts are prefilled in fixed-size
  chunks (``chunk`` tokens, a power of two), one chunk per engine tick,
  interleaved with the batched decode tick.  A long prompt therefore never
  blocks decode for the slots already resident.  The final partial chunk
  is right-padded to the next power of two, so the overlay sees a small
  STABLE set of prefill signatures — ``{1, 2, 4, …, chunk}``, bounded by
  the bucket set, not by the number of distinct prompt lengths.  Fewer
  signatures means fewer traces and downloads and less reclaim churn (the
  synchronous engine traces one prefill per distinct prompt length).

* **SLO-aware admission** — the queue is a priority heap (lower
  ``Request.priority`` first, FIFO within a class).  ``submit`` sheds
  instead of queueing when the queue is full (``max_queue``) or when the
  estimated wait (queue depth × measured tick p50) already exceeds
  ``max_queue_delay``; admission re-checks the delay bound and sheds
  requests that expired while queued.  Shed requests are marked
  (``shed``/``shed_reason``), collected on ``self.shed`` and reported by
  ``metrics()`` — never silently dropped.

* **Feedback from measurement** — per-tick latency, time to first token
  and queue delay are recorded into fixed-bucket histograms
  (:mod:`repro_torch.serving.metrics`); the tick histogram drives the
  predicted-delay shed above, as the overlays' dispatch-latency histograms
  feed a :class:`~repro_torch.core.fleet.FleetOverlay`'s placement score
  when ``overlay=`` is a fleet.

Token streams of admitted requests equal the synchronous engine's for
models of attention layers: chunking changes only *when* KV entries are
written, ragged decode reads every slot at its own position either way, and
padded chunk positions are causally masked, then overwritten by decode
before any query can attend to them.  That argument does not hold for a
mamba layer: the padded positions are real token-0 inputs that advance the
conv and SSD state ``prefill_chunk`` carries on, so from the second token
on the streams of a prompt whose last chunk was padded differ from the
synchronous engine's — in the reference too (``repro/serving/loop.py``,
ROADMAP queue 3).  The port refuses configs with mamba layers rather than
serve wrong tokens.  It refuses encoder-decoders too: the reference's loop
prefills through ``prefill_chunk``, which runs no encoder, so its ``dec``
layers would cross-attend to an empty cross cache and serve garbage; the
port raises instead.  A vlm (pixtral) is served as a text model: the
reference's loop passes no patches to ``prefill_chunk``
(``repro/serving/loop.py:82``), and neither does this one; patches reach
the model only through ``models.model.prefill(..., patch_embeds=)``.

Port of ``repro/serving/loop.py``.
"""

from __future__ import annotations

import heapq
import time
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.fleet import FleetOverlay
from repro_torch.core.overlay import Overlay
from repro_torch.models import model as mdl
from repro_torch.models.params import layer_kinds
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.metrics import Histogram


class EventLoopEngine(ServeEngine):
    """Event-driven engine: one tick = admit → one prefill chunk → one
    fused decode step.  See the module docstring for the admission
    policy."""

    def __init__(self, params: Any, cfg: ArchConfig, *, batch: int,
                 max_len: int, overlay: "Overlay | FleetOverlay | None" = None,
                 tile_budget: int | None = None, chunk: int = 64,
                 max_queue: int | None = None,
                 max_queue_delay: float | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 device: "str | torch.device | None" = None):
        if chunk < 1 or chunk & (chunk - 1):
            raise ValueError(f"chunk must be a power of two, got {chunk}")
        if cfg.is_encdec:
            raise NotImplementedError(
                f"{cfg.name}: the event loop prefills in chunks and runs no encoder, so "
                f"the dec layers would cross-attend to an empty cross cache (the "
                f"reference's loop serves such garbage); serve an encoder-decoder through "
                f"models.model.prefill(..., enc_in=) and decode_step")
        if "mamba" in layer_kinds(cfg):
            raise NotImplementedError(
                f"{cfg.name}: the event loop pads a prompt's last chunk with "
                f"token 0, and those positions advance a mamba layer's conv "
                f"and SSD state, so the streams would differ from the "
                f"synchronous engine's (a fault of the reference too, ROADMAP "
                f"queue 3); serve this model with ServeEngine")
        super().__init__(params, cfg, batch=batch, max_len=max_len,
                         overlay=overlay, tile_budget=tile_budget, device=device)
        self.chunk = chunk
        self.max_queue = max_queue
        self.max_queue_delay = max_queue_delay
        self.clock = clock
        # priority heap of (priority, seq, Request); seq keeps FIFO order
        # within a priority class and makes entries totally ordered
        self.queue: list[tuple[int, int, Request]] = []
        self._seq = 0
        self.shed: list[Request] = []
        self._prefilling: dict[int, dict] = {}   # slot -> {req, c1, off}
        self._pf_rr = 0
        self.tick_hist = Histogram()         # whole-tick latency, us
        self.ttft_hist = Histogram()         # submit -> first token, us
        self.queue_delay_hist = Histogram()  # submit -> admission, us
        pc = lambda p, toks, c, li: mdl.prefill_chunk(p, cfg, toks, c, li)
        if overlay is not None:
            self._prefill_chunk = overlay.jit(
                pc, name=f"{cfg.name}.prefill_chunk", tile_budget=self.tile_budget)
        else:
            self._prefill_chunk = pc

    def resize(self, tile_budget: int) -> None:
        super().resize(tile_budget)
        self._prefill_chunk.tile_budget = tile_budget

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue a request, or shed it against the SLO bounds.

        Returns ``True`` if queued.  A shed request is returned with
        ``shed=True`` / ``shed_reason`` set and is also appended to
        ``self.shed`` — the caller always learns the outcome."""
        self._validate_request(req)
        if req.submit_time is None:
            req.submit_time = self.clock()
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return self._shed(req, "queue_full")
        if self.max_queue_delay is not None and self.tick_hist.count:
            est = (len(self.queue) + 1) * self.tick_hist.percentile(0.5) * 1e-6
            if est > self.max_queue_delay:
                return self._shed(req, "predicted_delay")
        heapq.heappush(self.queue, (req.priority, self._seq, req))
        self._seq += 1
        return True

    def _shed(self, req: Request, reason: str) -> bool:
        req.shed = True
        req.shed_reason = reason
        self.shed.append(req)
        return False

    def _pop_admissible(self) -> Request | None:
        """Pop the next request, shedding any that outlived the delay SLO
        while queued (better to shed at admission than to burn prefill on a
        request whose client has already timed out)."""
        while self.queue:
            _, _, req = heapq.heappop(self.queue)
            delay = (self.clock() - req.submit_time
                     if req.submit_time is not None else 0.0)
            if self.max_queue_delay is not None and delay > self.max_queue_delay:
                self._shed(req, "queue_delay")
                continue
            self.queue_delay_hist.record(delay * 1e6)
            return req
        return None

    def _admit(self) -> None:
        for slot in range(self.batch):
            if self.slot_req[slot] is not None:
                continue
            req = self._pop_admissible()
            if req is None:
                return
            self._begin_prefill(slot, req)

    # -- chunked prefill -----------------------------------------------------
    def _begin_prefill(self, slot: int, req: Request) -> None:
        self._prefetch_decode()
        self._prefilling[slot] = {
            "req": req,
            "c1": mdl.init_cache(self.cfg, 1, self.max_len, self.device),
            "off": 0,
        }
        # resident (occupies the slot) but not yet live for decode: the
        # live mask stays 0 until the stripe is installed
        self.slot_req[slot] = req

    def _chunk_size(self, remaining: int) -> int:
        """Bucket the next chunk: full ``chunk`` while the prompt lasts,
        then the final remainder padded up to the next power of two."""
        if remaining >= self.chunk:
            return self.chunk
        return 1 << (remaining - 1).bit_length()

    def _prefill_tick(self) -> None:
        """Advance ONE in-prefill slot by one chunk (round-robin), so no
        single long prompt monopolizes the tick budget."""
        if not self._prefilling:
            return
        slots = sorted(self._prefilling)
        slot = slots[self._pf_rr % len(slots)]
        self._pf_rr += 1
        st = self._prefilling[slot]
        req, off = st["req"], st["off"]
        n = len(req.prompt)
        size = self._chunk_size(n - off)
        toks = req.prompt[off:off + size]
        last = len(toks) - 1          # last REAL token within this chunk
        toks = toks + [0] * (size - len(toks))
        logits, st["c1"] = self._prefill_chunk(
            self.params, torch.tensor([toks], dtype=torch.int32, device=self.device),
            st["c1"], torch.tensor(last, dtype=torch.int32, device=self.device))
        st["off"] = off + (last + 1)
        if st["off"] >= n:
            del self._prefilling[slot]
            self._install_stripe(slot, req, st["c1"], int(torch.argmax(logits[0])))
            req.first_token_time = self.clock()
            if req.submit_time is not None:
                self.ttft_hist.record((req.first_token_time - req.submit_time) * 1e6)

    # -- the event loop tick -------------------------------------------------
    def step(self) -> list[Request]:
        """One tick: admit, one prefill chunk, one fused decode, retire."""
        t0 = time.perf_counter()
        self._admit()
        self._prefill_tick()
        decoding = [s for s, r in enumerate(self.slot_req)
                    if r is not None and s not in self._prefilling]
        finished = self._decode_tick(decoding) if decoding else []
        self.tick_hist.record((time.perf_counter() - t0) * 1e6)
        return finished

    # -- observability -------------------------------------------------------
    def metrics(self) -> dict:
        """JSON-serializable engine metrics (histograms + shed ledger)."""
        return {
            "tick_us": self.tick_hist.summary(),
            "ttft_us": self.ttft_hist.summary(),
            "queue_delay_us": self.queue_delay_hist.summary(),
            "shed": len(self.shed),
            "shed_reasons": {r: sum(1 for q in self.shed if q.shed_reason == r)
                             for r in {q.shed_reason for q in self.shed}},
            "queued": len(self.queue),
            "failures": self.overlay_failures(),
        }
