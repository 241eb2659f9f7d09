"""Async front end bridging the asyncio serving surface to the
synchronous engine + scheduler loop (the port of ``repro.serving.frontend``).

Threading model — one rule: **the engine and scheduler are only ever
touched from one executor thread**, the front end's own single-thread
pool, where the serve-loop tick runs (``await loop.run_in_executor(
self._executor, self._tick)``) so kernel launches and the fused
device→host read never block the event loop.  One thread, not a pool: the
kernels launch on the thread's current CUDA stream, and the kernel
libraries are loaded without a lock, so every engine call stays on the
thread that built them (``start`` builds them there before the server
takes a request).  Everything crossing the boundary is plain data:

  * submissions: the async side validates against read-only engine config
    (prompt length, known policy group), stamps arrival, and appends the
    ``Request`` to a lock-protected pending list the tick drains;
  * results: the tick returns a flat list of ``(rid, StreamEvent)`` pairs
    (committed-token deltas from ``engine.poll_progress``, preemption
    remainders, stitched finish records) that the async side fans out to
    per-request ``asyncio.Queue`` streams.

Token streams are **exactly-once and in order**: progress polling emits
committed tokens as they land each group step; a preempted request's
unstreamed segment remainder is forwarded at eviction time (its
continuation re-admits with those tokens inside the prompt, so polling
never re-emits them); the finish record's unstreamed tail is emitted
before the ``done`` event.  Summed, the streamed tokens are byte-identical
to ``FinishedRequest.tokens`` — the SLO harness gates on this.

On a mesh the front end, its engine thread and the scheduler run on rank
0; each tick's engine calls reach the other ranks as plans from that
thread (``ContinuousBatchingEngine.follow``), an idle tick sends them a
heartbeat now and then (``keep_alive``), and whoever stops the front end
releases them afterwards (``release_followers``).

Back-pressure is explicit at admission: ``submit`` raises ``Backpressure``
(HTTP 429 + Retry-After upstream) when the wait queue is saturated.  The
page pool's ``PagePoolExhausted`` feeds the same signal — pool-starved
requests requeue and hold the wait queue open, so a saturated pool
surfaces as a full queue instead of unbounded buffering.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.types import Request

__all__ = ["Backpressure", "Draining", "StreamEvent", "Frontend"]


class Backpressure(RuntimeError):
    """Admission refused: the wait queue (or the page pool behind it) is
    saturated.  ``retry_after_s`` is the server's service-rate-informed
    resubmission hint (the HTTP layer sends it as ``Retry-After``)."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class Draining(RuntimeError):
    """Admission refused: the server is draining toward shutdown — no new
    requests, but everything already in flight runs to completion (the
    HTTP layer maps this to 503 so load balancers fail over)."""


@dataclasses.dataclass
class StreamEvent:
    """One per-request stream item.

    kind = "tokens": ``data`` is a 1-D int array of newly committed tokens.
    kind = "done":   ``data`` is the ``FinishedRequest`` (stitched across
                     preemptions); the stream ends after it.
    """

    kind: str
    data: Any


class Frontend:
    """Asyncio facade over a ``Scheduler``: submit() → per-request event
    stream, driven by a single background serve loop."""

    def __init__(self, scheduler: Scheduler, *, max_queue: int = 16,
                 idle_sleep_s: float = 0.005):
        self.scheduler = scheduler
        self.engine = scheduler.engine
        self.max_queue = max_queue
        self.idle_sleep_s = idle_sleep_s
        self._rid = itertools.count(1)
        self._lock = threading.Lock()       # guards _pending
        self._pending: List[Request] = []
        self._streams: Dict[int, asyncio.Queue] = {}
        self._emitted: Dict[int, int] = {}  # rid -> tokens streamed so far
        self._task: Optional[asyncio.Task] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._running = False
        self._ready = False
        self._draining = False
        # service counters (on top of scheduler/engine ones) for /metrics
        self.requests_total = 0
        self.rejected_total = 0
        self.tokens_streamed = 0
        self.finished_total = 0

    # -- lifecycle -----------------------------------------------------------

    def _run(self, fn):
        """Run ``fn`` on the engine thread."""
        return asyncio.get_running_loop().run_in_executor(self._executor, fn)

    def _warm(self) -> None:
        """On the engine thread: build the CUDA kernels (a no-op on the
        CPU), then one no-op tick."""
        if self.engine.session.device.type == "cuda":
            from repro_torch.kernels import _build

            _build.build()
        self._tick()

    async def start(self) -> None:
        if self._task is not None:
            return
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="engine")
        self._running = True
        # readiness = the serving path works from the engine thread: the
        # kernels are built there and one no-op tick runs before the serve
        # loop (and so any request) starts
        await self._run(self._warm)
        self._task = asyncio.ensure_future(self._serve_loop())
        self._ready = True

    async def stop(self) -> None:
        self._running = False
        if self._task is not None:
            await self._task
            self._task = None
        self._ready = False
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    async def drain(self) -> None:
        """Graceful drain: stop admission immediately (``submit`` raises
        ``Draining``; readiness goes false so load balancers route away),
        let every in-flight request — queued, parked in the KV handoff,
        or mid-decode — run to completion with its SSE tail flushed
        through the normal stream path, then stop the serve loop.

        Idempotent and safe to call concurrently with traffic: the serve
        loop itself detects quiescence (between ticks, so it never races
        the engine) and exits; this coroutine just awaits it.
        """
        self._draining = True
        self._ready = False
        if self._task is not None:
            await self._task
            self._task = None
        self._running = False
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    @property
    def ready(self) -> bool:
        return self._ready

    @property
    def draining(self) -> bool:
        return self._draining

    # -- admission -----------------------------------------------------------

    def queue_depth(self) -> int:
        with self._lock:
            npend = len(self._pending)
        return npend + len(self.scheduler.queue)

    def _retry_after_s(self) -> float:
        """Resubmission hint: time for the backlog to drain one queue slot
        at the observed service rate, floored at 1s so clients never
        hot-spin against a cold estimator."""
        tpot = self.scheduler.tpot_est
        if tpot <= 0.0:
            return 1.0
        queued = self.scheduler.queue
        mean_new = (sum(r.max_new for r in queued) / len(queued)
                    if queued else self.engine.ecfg.max_new_cap)
        slots = max(self.engine.ecfg.num_slots, 1)
        return max(1.0, tpot * mean_new / slots)

    def submit(self, prompt, max_new: int, *, policy: Optional[str] = None,
               priority: int = 0, deadline_s: Optional[float] = None,
               src=None) -> Tuple[int, asyncio.Queue]:
        """Admit a request; returns ``(rid, event_queue)``.

        Raises ``Backpressure`` when the wait queue is saturated and
        ``ValueError`` for invalid prompts/policies — both decided here,
        synchronously, so a rejected request never occupies queue space.
        ``deadline_s`` is relative (seconds from now); it becomes the
        absolute monotonic deadline the scheduler preempts for.
        """
        if self._draining:
            self.rejected_total += 1
            raise Draining("server is draining: no new admissions")
        if self.queue_depth() >= self.max_queue:
            self.rejected_total += 1
            raise Backpressure(
                f"wait queue is full ({self.max_queue} requests): the slot "
                f"slab and page pool are saturated — retry later",
                self._retry_after_s())
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p, cap = len(prompt), self.engine.ecfg.max_prompt_len
        if not 0 < p <= cap:
            raise ValueError(f"prompt length {p} outside (0, {cap}]")
        self.engine.group_for(policy)   # unknown policy -> ValueError (read-only)
        now = time.monotonic()
        req = Request(
            rid=next(self._rid), prompt=prompt, max_new=int(max_new),
            arrival=now, policy=policy, src=src, priority=int(priority),
            deadline=None if deadline_s is None else now + float(deadline_s))
        q: asyncio.Queue = asyncio.Queue()
        self._streams[req.rid] = q
        self._emitted[req.rid] = 0
        with self._lock:
            self._pending.append(req)
        self.requests_total += 1
        return req.rid, q

    # -- serve loop ----------------------------------------------------------

    def _tick(self) -> List[Tuple[int, StreamEvent]]:
        """One scheduler step, run on the engine thread — the ONLY place
        the engine/scheduler state is touched after start()."""
        with self._lock:
            drained, self._pending = self._pending, []
        for req in drained:
            self.scheduler.submit(req)
        if self.scheduler.drained():
            self.engine.keep_alive()    # a mesh's other ranks wait on rank 0
            return []
        finished = self.scheduler.step()
        events: List[Tuple[int, StreamEvent]] = []
        # committed-token deltas for every live slot (one extra host pull
        # per active group; see engine.poll_progress)
        for req, toks in self.engine.poll_progress():
            self._emitted[req.rid] += len(toks)
            events.append((req.rid, StreamEvent("tokens", toks)))
        # preempted segments: forward the unstreamed remainder NOW — the
        # continuation carries these tokens inside its prompt, so progress
        # polling will never emit them again
        for rec in self.scheduler.take_preempt_events():
            rem = rec.tokens[rec.streamed:]
            if len(rem):
                self._emitted[rec.req.rid] += len(rem)
                events.append((rec.req.rid, StreamEvent("tokens", rem)))
        for f in finished:
            tail = f.tokens[self._emitted.pop(f.rid, 0):]
            if len(tail):
                events.append((f.rid, StreamEvent("tokens", tail)))
            events.append((f.rid, StreamEvent("done", f)))
        return events

    async def _serve_loop(self) -> None:
        while self._running:
            events = await self._run(self._tick)
            for rid, ev in events:
                if ev.kind == "tokens":
                    self.tokens_streamed += len(ev.data)
                q = self._streams.get(rid)
                if q is not None:
                    q.put_nowait(ev)
                    if ev.kind == "done":
                        self.finished_total += 1
                        del self._streams[rid]
            if not events:
                if self._draining and not self._streams:
                    with self._lock:
                        idle = not self._pending
                    # quiescence read between ticks, on the engine thread
                    if idle and await self._run(self.scheduler.drained):
                        return      # drain complete: the loop retires itself
                await asyncio.sleep(self.idle_sleep_s)

    # -- observability -------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        """Flat counter/gauge snapshot for the /metrics endpoint."""
        sch, eng = self.scheduler, self.engine
        return {
            "requests_total": self.requests_total,
            "rejected_total": self.rejected_total,
            "finished_total": self.finished_total,
            "tokens_streamed_total": self.tokens_streamed,
            "preemptions_total": sch.preemptions,
            "backpressure_requeues_total": sch.backpressure_events,
            "queue_depth": self.queue_depth(),
            "active_slots": (eng.ecfg.num_slots - len(eng.free_slots())),
            "num_slots": eng.ecfg.num_slots,
            "engine_steps_total": eng.num_steps,
            "engine_admits_total": eng.num_admits,
            "host_syncs_total": eng.num_host_syncs,
            "stream_syncs_total": eng.num_stream_syncs,
            "tpot_estimate_seconds": sch.tpot_est,
            "draining": int(self._draining),
            # disaggregated prefill/decode + async-stream attribution
            "disaggregated": int(eng.disaggregated),
            "prefill_batches_total": eng.num_prefill_batches,
            "handoff_backlog": eng.handoff_backlog(),
            "attach_backpressure_total": eng.num_attach_backpressure,
            "overlap_harvests_total": eng.num_overlap_harvests,
            "time_in_prefill_seconds": eng.time_in_prefill,
            "time_in_decode_dispatch_seconds": eng.time_in_decode_dispatch,
            "time_in_harvest_seconds": eng.time_in_harvest,
        }
