"""Admission scheduler for the continuous-batching engine (the port of
``repro.serving.scheduler``): ordering, priorities, deadlines, preemption
and back-pressure.

The scheduler owns the request queue and the admission policy; the engine
owns the device slots.  One ``step()`` is the unit of serving work a
production loop would run: admit every eligible queued request into free
slots, preempt where a deadline demands it, then run one BPD iteration
over every active policy slot group and retire whatever finished.

Ordering (within a policy slot group):

  * requests sort by **priority first** (higher served first), then by the
    base policy:
  * ``fcfs`` — first come, first served: ``(arrival, rid)``.
  * ``sjf``  — shortest job first: ``(max_new, arrival, rid)``; reduces
               mean latency under mixed-length traffic at the cost of
               fairness.  The ``(arrival, rid)`` tie-break makes the order
               fully deterministic — two equal-length jobs pop in arrival
               order, and two simultaneous arrivals pop in rid order.

Back-pressure (``PagePoolExhausted``): when the paged KV pool cannot cover
an admission, the request is requeued with its ``backpressured`` flag set,
which moves it AHEAD of every same-priority request of its group until it
is admitted.  Under ``sjf`` this is the anti-starvation guarantee: a large
request that keeps losing the pool race would otherwise lose to every
later-arriving small request forever; the flag gives it head-of-line
ownership of the next pages that free up.

Deadlines + priority preemption: a queued request with a ``deadline`` may
evict a strictly-lower-priority mid-flight request from its policy group
when waiting for a natural slot would miss that deadline (estimated from
an EWMA of observed seconds-per-token).  The victim's committed tokens are
pulled, its slot evicted, and a CONTINUATION request — same rid, prompt
extended by the committed tokens, budget reduced by them — goes back to
the queue, re-admitting through the ordinary padded-prefill path.  On
finish the scheduler stitches the carried segments back together, so a
preempted request retires with the same tokens, original prompt length,
and a ``preempted`` count.  Token identity holds for every policy whose
commit stream is a deterministic function of the committed context — all
registered built-ins: exact-acceptance policies commit greedy tokens
regardless of drafter/schedule state, and the non-exact built-ins draft
from context-deterministic state (custom policies carrying loop state that
influences *which* tokens commit are the documented exception).

``run()`` drives a whole workload to completion on a real clock: requests
with future arrival times are invisible until the clock reaches them
(open-loop traffic).  The async
HTTP front end (``serving.frontend``) drives ``step()`` itself and drains
``take_preempt_events()`` for stream bookkeeping.

On a mesh the scheduler runs on rank 0 alone (its admission reads rank 0's
clock); its engine calls reach the other ranks as plans, which they replay
in ``ContinuousBatchingEngine.follow`` until ``release_followers``, and an
idle ``run`` sends them heartbeats (``keep_alive``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.engine import (HEARTBEAT_S, ContinuousBatchingEngine,
                                        PagePoolExhausted, PolicyGroup)
from repro_torch.serving.types import (FinishedRequest, PreemptedRequest,
                                       Request, percentile)

POLICIES = ("fcfs", "sjf")


class Scheduler:
    def __init__(self, engine: ContinuousBatchingEngine,
                 policy: str = "fcfs", *, preempt_margin_s: float = 0.0):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.engine = engine
        self.policy = policy
        self.queue: List[Request] = []
        self.finished: List[FinishedRequest] = []
        # deadline risk estimate: EWMA of observed seconds-per-token.
        # Seeded at 0 so preemption starts conservative (only fires once a
        # deadline is actually reached) and sharpens as finishes stream in.
        self.tpot_est = 0.0
        self.preempt_margin_s = preempt_margin_s
        self.preemptions = 0            # evict-and-requeue events
        self.backpressure_events = 0    # PagePoolExhausted requeues
        # rid -> stitched-progress of preempted segments
        self._carried: Dict[int, dict] = {}
        self._preempt_events: List[PreemptedRequest] = []

    # -- queue ---------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request; invalid requests are rejected here, before
        they can abort the serving loop mid-drain — including requests
        whose decode policy the engine has no slot group for."""
        p = len(req.prompt)
        cap = self.engine.ecfg.max_prompt_len
        if not 0 < p <= cap:
            raise ValueError(
                f"request {req.rid}: prompt length {p} outside (0, {cap}]")
        self.engine.group_for(req.policy)   # unknown policy -> ValueError
        if req.arrival is None:
            req.arrival = time.monotonic()
        self.queue.append(req)

    def pending(self, now: Optional[float] = None) -> List[Request]:
        """Requests that have arrived and await a slot."""
        if now is None:
            now = time.monotonic()
        return [r for r in self.queue if r.arrival <= now]

    def _key(self, r: Request):
        """Deterministic admission order within a group: priority first
        (higher wins), then backpressured head-of-line, then fcfs/sjf."""
        base = ((r.max_new, r.arrival, r.rid) if self.policy == "sjf"
                else (r.arrival, r.rid))
        return (-r.priority, 0 if r.backpressured else 1) + base

    def _pop_next(self, now: float,
                  group: Optional[str] = None) -> Optional[Request]:
        """Best eligible request — optionally only those routed to the
        ``group`` policy slot group."""
        eligible = [r for r in self.queue if r.arrival <= now]
        if group is not None:
            # delegate routing to the engine — one source of truth for
            # which group a request's policy lands in
            eligible = [r for r in eligible
                        if self.engine.group_for(r.policy).name == group]
        if not eligible:
            return None
        pick = min(eligible, key=self._key)
        self.queue.remove(pick)
        return pick

    # -- preemption ----------------------------------------------------------

    def est_service_s(self, req: Request) -> float:
        """Pessimistic-enough finish estimate for deadline-risk checks."""
        return req.max_new * self.tpot_est + self.preempt_margin_s

    def take_preempt_events(self) -> List[PreemptedRequest]:
        """Drain preemption records since the last call (the streaming
        front end forwards each record's unstreamed token remainder)."""
        out, self._preempt_events = self._preempt_events, []
        return out

    def _pick_victim(self, g: PolicyGroup, req: Request,
                     generated: np.ndarray) -> Optional[int]:
        """Lowest-priority feasible victim in ``g`` (local slot index).

        Feasible = strictly lower priority than ``req``, its continuation
        prompt (prompt + committed tokens) still fits ``max_prompt_len``,
        and it is not about to finish anyway (remaining budget >= 1).
        Ties break toward the victim with the MOST remaining work (evicting
        it wastes the least imminent completion), then the highest slot —
        fully deterministic.
        """
        cap = self.engine.ecfg.max_prompt_len
        cands = []
        for i in range(g.num_slots):
            meta = g.slot_meta[i]
            if not (g.status[i] & 1) or meta is None:
                continue
            victim: Request = meta["req"]
            remaining = meta["max_new"] - int(generated[i])
            if (victim.priority < req.priority
                    and meta["prompt_len"] + int(generated[i]) <= cap
                    and remaining >= 1):
                cands.append((victim.priority, -remaining, -i, i))
        return min(cands)[3] if cands else None

    def _maybe_preempt(self, t: float) -> None:
        """Evict-and-requeue pass: for each queued deadline-bearing request
        (best first) whose group is full and whose deadline would be missed
        by waiting, preempt one strictly-lower-priority victim and admit
        the urgent request into the freed slot."""
        at_risk = sorted((r for r in self.queue
                          if r.arrival <= t and r.deadline is not None),
                         key=self._key)
        for r in at_risk:
            g = self.engine.group_for(r.policy)
            if g.free_local():
                continue            # normal admission will take it
            if t + self.est_service_s(r) < r.deadline:
                continue            # not at risk yet
            pulled = self.engine.pull_group(g)
            tokens, text_len, generated, invocations = pulled
            slot = self._pick_victim(g, r, generated)
            if slot is None:
                continue            # nobody strictly lower / feasible
            rec = self.engine.preempt(g, slot, pulled=pulled)
            self.preemptions += 1
            self._preempt_events.append(rec)
            self._requeue_continuation(rec)
            self.queue.remove(r)
            try:
                self.engine.admit(r, now=t)
            except PagePoolExhausted:
                r.backpressured += 1
                self.backpressure_events += 1
                self.queue.append(r)

    def _requeue_continuation(self, rec: PreemptedRequest) -> None:
        """Queue the evicted request's continuation: same rid/priority/
        deadline/policy, prompt extended by the committed tokens, budget
        reduced by them; stitch bookkeeping accumulates across repeated
        preemptions."""
        prev = rec.req
        carried = self._carried.get(prev.rid)
        if carried is None:
            carried = {"tokens": np.zeros((0,), np.int32),
                       "prompt_len": len(prev.prompt),
                       "invocations": 0, "count": 0}
            self._carried[prev.rid] = carried
        carried["tokens"] = np.concatenate([carried["tokens"], rec.tokens])
        carried["invocations"] += rec.invocations
        carried["count"] += 1
        # budget against the CLAMPED cap: re-admission clamps afresh, so a
        # request with max_new > max_new_cap must not win a new cap per
        # segment
        budget = min(prev.max_new, self.engine.ecfg.max_new_cap)
        cont = Request(
            rid=prev.rid,
            prompt=np.concatenate([prev.prompt, rec.tokens]),
            max_new=budget - rec.generated,
            arrival=prev.arrival,           # keeps its fcfs position
            policy=prev.policy, src=prev.src,
            priority=prev.priority, deadline=prev.deadline)
        self.queue.append(cont)

    def _stitch(self, f: FinishedRequest) -> FinishedRequest:
        """Fold carried preempted segments back into a finished record so
        callers see one request: full token stream, original prompt
        length, summed invocations, recomputed k̂."""
        carried = self._carried.pop(f.rid, None)
        if carried is None:
            return f
        f.tokens = np.concatenate([carried["tokens"], f.tokens])
        f.generated += len(carried["tokens"])
        f.prompt_len = carried["prompt_len"]
        f.invocations += carried["invocations"]
        f.preempted = carried["count"]
        # one prefill per segment: iterations = invocations - (count + 1)
        iters = max(f.invocations - (carried["count"] + 1), 1)
        f.mean_accepted = f.generated / iters
        return f

    # -- serving loop --------------------------------------------------------

    def step(self, now: Optional[float] = None) -> List[FinishedRequest]:
        """Admit eligible requests into each group's free slots (preempting
        where a deadline demands it), then one engine step (= one BPD
        iteration per active group)."""
        t = time.monotonic() if now is None else now
        # preemption runs BEFORE admission/staging: a deadline-at-risk
        # request must claim its slot while it is still in the queue — the
        # disaggregated staging loop below would otherwise move it into
        # the handoff queue, where it waits behind the very decode it was
        # entitled to evict (groups with free slots are skipped, so this
        # never steals an admission a natural free slot would satisfy)
        self._maybe_preempt(t)
        if self.engine.disaggregated:
            # disaggregated admission: stage arrivals for the prefill
            # workers while handoff capacity lasts — admission never waits
            # for (or serializes behind) a decode slot — then dispatch the
            # worker batches and install parked rows into freed slots.
            # Page-pool back-pressure is handled at attach inside the
            # engine (head-of-line wait in the handoff queue).
            while self.engine.handoff_free() > 0:
                req = self._pop_next(t)
                if req is None:
                    break
                self.engine.queue_prefill(req, now=now)
            self.engine.run_prefills(now=now)
            self.engine.attach_ready(now=now)
        else:
            for name in self.engine.policy_names():
                for _ in range(len(self.engine.free_slots(name))):
                    req = self._pop_next(t, group=name)
                    if req is None:
                        break
                    try:
                        self.engine.admit(req, now=now)
                    except PagePoolExhausted:
                        # back-pressure: the paged KV pool can oversubscribe
                        # the slot slab — requeue with head-of-line ownership
                        # and stop admitting to this group until decode steps
                        # retire requests and free pages
                        req.backpressured += 1
                        self.backpressure_events += 1
                        self.queue.append(req)
                        break
        if not self.engine.has_active():
            return []
        done = [self._stitch(f) for f in self.engine.step(now=now)]
        for f in done:
            if f.generated > 0:
                obs = (f.finish_time - f.admit_time) / f.generated
                self.tpot_est = (obs if self.tpot_est == 0.0
                                 else 0.5 * self.tpot_est + 0.5 * obs)
        self.finished.extend(done)
        return done

    def drained(self) -> bool:
        return (not self.queue and not self.engine.has_active()
                and self.engine.handoff_backlog() == 0)

    def run(self, max_steps: int = 100_000) -> List[FinishedRequest]:
        """Drive until every submitted request has been served."""
        steps = 0
        while not self.drained():
            if steps >= max_steps:
                raise RuntimeError(f"scheduler did not drain in {max_steps} "
                                   f"steps ({len(self.queue)} queued)")
            now = time.monotonic()
            if (not self.engine.has_active() and not self.pending(now)
                    and self.engine.handoff_backlog() == 0):
                # idle: sleep until the next arrival (drained() was false
                # with nothing in flight, so the queue is non-empty), a
                # mesh's other ranks kept waiting on rank 0's heartbeats
                nxt = min(r.arrival for r in self.queue)
                time.sleep(min(max(nxt - now, 0.0), HEARTBEAT_S))
                self.engine.keep_alive()
                continue
            self.step()
            steps += 1
        return self.finished


def aggregate_stats(finished: List[FinishedRequest],
                    wall_seconds: float) -> Dict:
    """Serving-level summary: aggregate throughput + latency percentiles."""
    lat = [f.latency for f in finished]
    total_tokens = sum(f.generated for f in finished)
    total_inv = sum(f.invocations for f in finished)
    return {
        "requests": len(finished),
        "total_tokens": total_tokens,
        "total_invocations": total_inv,
        "tokens_per_sec": total_tokens / wall_seconds if wall_seconds else 0.0,
        "mean_accepted": (sum(f.mean_accepted for f in finished)
                          / len(finished)) if finished else 0.0,
        "latency_p50_s": percentile(lat, 50),
        "latency_p95_s": percentile(lat, 95),
        "preempted_requests": sum(1 for f in finished if f.preempted),
        "preemptions": sum(f.preempted for f in finished),
        "wall_seconds": wall_seconds,
    }
