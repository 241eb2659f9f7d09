"""Continuous-batching engine on top of the BPD decode loop (the port of
``repro.serving.engine``, on one device or a process mesh).

The run-to-completion ``bpd_decode`` keeps a whole batch resident until its
slowest row finishes — dead rows still cost a model invocation per
iteration.  This engine generalizes ``BPDState`` to a slot-based
``SlotBatch`` (see serving/types.py): a *static* device batch of
``num_slots`` rows where

  * finished rows are evicted (``active`` goes False) and their KV rows are
    invalidated (``pos = -1``) so the slot is immediately reusable,
  * a queued request is admitted mid-flight by a single-row prefill that is
    copied into the freed slot (``models.cache.scatter_row``, in place)
    while the other slots keep decoding,
  * every slot carries its own prompt length, generation budget and
    statistics, so a decode step is one ``bpd_iteration`` over a slot
    group with a per-slot ``active`` mask and per-slot ``max_new``.

**Per-request decode policies (policy slot grouping).**  The engine's slot
slab is partitioned into per-policy *slot groups*: ``policies={"exact": 2,
"topk_tree": 2}`` gives each named policy its own contiguous range of the
``num_slots`` slab, materialized as a group-local ``SlotBatch`` view with
its own init/admit/step/evict from ``DecodeSession.serving_fns(policy=
...)``, built once per distinct (policy, geometry) and shared between
groups through the session's ``DecodePolicy.cache_key``-keyed cache.  An
admitted request routes to
the group running its ``Request.policy`` (``None`` = the session default);
the host loop round-robins the active groups each ``step()``, dispatching
every group's step before reading any status back, so device work overlaps
and each *group step* costs exactly ONE fused device→host sync.

The engine itself is a **scheduler + slot-metadata shell**: all device
functions are owned by a ``serving.session.DecodeSession`` and built once
per (policy, geometry) (padded prompts, static slot counts).

**On a mesh** (``mesh=``, or a ``session=`` on one: a ("data", "model") or
("pod", "data", "model") ``launch.mesh.Mesh`` of processes) each rank
keeps its slots of every group (``ServingFns.local``) and the whole
host mirror: after each group step the status is gathered over the slots
(``comm.data_gather``), so ``free_slots`` / ``has_active`` / harvest read
the same global view on every rank, and every rank steps each group that
is active anywhere on the mesh (its model-axis sums and a window's ``go``
need all of its ranks).  Harvest gathers the group's rows; every rank
makes the same finish records.  The reference has one controller; here
rank 0 alone runs the scheduler and the front end, whose admission reads
``time.monotonic()``: rank 0's engine broadcasts each call the scheduler
makes (``_planned``), with its arguments and its clock, over the gloo
control group (``comm.broadcast_plan``) before it runs it.
The other ranks run ``follow()``: they replay each call on their engine,
so their allocators and mirrors take the same decisions, until rank 0's
``release_followers()``.  While a server idles, rank 0 sends an empty
plan every ``HEARTBEAT_S`` seconds (``keep_alive``), so the others' wait
never nears the collectives' time limit and a stuck collective still
fails the run.  Every group's policy runs on a mesh as on one device: a
draft_model group drafts with the session's sharded draft (its cache rows
ride admission and eviction with the rest of the per-row state), a
locality group's ``grid`` and ``pos`` shard with the slots, and a
request's ``src`` travels in the plan with its prompt.

The host loop performs exactly ONE device→host read per group step: the
step returns a (S,) int8 status (bit 0 = active, bit 1 = harvestable) and
the window's iteration count, which travel to the host in one transfer,
and ``free_slots`` / ``has_active`` / a no-finish ``harvest`` read the
host-side mirror (``num_host_syncs`` counts the transfers per GROUP STEP,
never per slot).  On the card that transfer is queued right behind the
group's step into pinned memory and awaited through its own event, so a
group's status arrives without waiting for the groups dispatched after
it.

Padded prefill is safe because cache visibility is governed by absolute
positions: a stale entry with stored position p is only attended when
``p < length + k``, and the decode step with that length rewrites position
p in ``cache_write`` *before* attending (see models/cache.py).  That
argument covers KV caches only — recurrent-state families (rwkv6 / hymba)
would fold pad tokens into their final state, so the engine is gated to
``block_type == "attn"``, for its auxiliary bundles (``bundles=``, e.g. the
``draft_model`` policy's draft, whose cache is prefilled from the same
padded prompt) as for the primary model.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import time
from collections import deque
from typing import (Any, Deque, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.config import DecodeConfig, ModelConfig
from repro_torch.core.policy import resolve_policy
from repro_torch.serving.pages import PageAllocator, PagePoolExhausted
from repro_torch.serving.session import DecodeSession, ServingFns
from repro_torch.serving.types import (EngineConfig, FinishedRequest,
                                       PreemptedRequest, Request, SlotBatch)
from repro_torch.sharding import comm

__all__ = ["ContinuousBatchingEngine", "PolicyGroup", "SlotBatch",
           "PagePoolExhausted", "PreemptedRequest", "HandoffRecord"]

I32 = torch.int32
# seconds between rank 0's empty plans while a mesh server idles
HEARTBEAT_S = 5.0


class _GroupRef(NamedTuple):
    """A ``PolicyGroup`` argument of a planned call, by its index."""
    gid: int


class _PullRef(NamedTuple):
    """A ``pull_group`` result passed back to ``preempt``: each rank's own
    last pull of the group."""
    gid: int


class _Raised(NamedTuple):
    """Rank 0's word after a planned call that raised ``PagePoolExhausted``
    (the one error the scheduler recovers from): the other ranks' replay,
    on allocators that are its twins, is to raise it too."""
    error: str


def _planned(method):
    """An engine call the other ranks of a mesh replay.  On rank 0 the
    call is broadcast to them with its arguments (and, where it takes a
    ``now`` left None, rank 0's clock, so every rank stamps the same
    times) over the control group, then run; every rank runs its device
    work at once.  A call that finds the page pool full on rank 0 is
    followed by a ``_Raised``, so the others take the same error of their
    replay for rank 0's; any other error ends rank 0, and with it the run.
    One device, the other ranks and calls made inside a planned call run
    as they are."""
    timed = "now" in inspect.signature(method).parameters

    @functools.wraps(method)
    def inner(self, *args, **kwargs):
        if not self._leads or self._in_plan:
            return method(self, *args, **kwargs)
        if timed and kwargs.get("now") is None:
            kwargs["now"] = time.monotonic()
        self._broadcast((method.__name__, tuple(map(self._encode, args)),
                         {k: self._encode(v) for k, v in kwargs.items()}))
        self._in_plan = True
        try:
            return method(self, *args, **kwargs)
        except PagePoolExhausted as exc:
            self._broadcast(_Raised(type(exc).__name__))
            raise
        finally:
            self._in_plan = False

    return inner


class _Pending:
    """A device→host transfer in flight: on the card a non-blocking copy
    into pinned memory and the event after it, so waiting for it does not
    wait for work queued later on the stream."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclasses.dataclass
class PolicyGroup:
    """Host-side record of one policy slot group: a contiguous view of the
    engine's slot slab ([offset, offset + num_slots)) stepped by its own
    built functions under its own decode policy."""

    gid: int                    # group index (== SlotBatch.group rows)
    name: str                   # registered policy name (routing key)
    policy: object              # the bound DecodePolicy
    offset: int                 # first global slot id of this group
    num_slots: int              # slots in this group's view
    fns: ServingFns             # built init/admit/step/evict
    state: SlotBatch            # the group-local device state
    status: np.ndarray          # host mirror, (num_slots,) int8
    slot_meta: List[Optional[dict]]
    pages: Optional[PageAllocator] = None  # host page allocator (paged only)
    num_steps: int = 0          # decode iterations that did work
    num_forwards: int = 0       # forwards dispatched (steps_per_sync a step)
    num_prefills: int = 0       # prefill forwards dispatched (admits and
                                # prefill-worker batches)

    def free_local(self) -> List[int]:
        """Group-local indices of free slots (host mirror, bit 0 clear) —
        the one definition of "free" shared by admission and the engine's
        global free-slot view."""
        return [i for i in range(self.num_slots) if not self.status[i] & 1]


@dataclasses.dataclass
class HandoffRecord:
    """One finished prefill parked in the KV-handoff queue: row ``row`` of
    the device-side ``packet`` (a ``session.PrefillPacket``, shared by up
    to ``prefill_slots`` records from the same worker batch) plus the host
    metadata ``attach`` needs to install it into a freed slot."""

    req: Request
    packet: Any                 # device PrefillPacket (shared per batch)
    row: int                    # this request's row inside the packet
    prompt_len: int
    max_new: int
    prefill_time: float         # when the prefill batch was dispatched


def _normalize_groups(policies, default_name: str,
                      num_slots: int) -> List[Tuple[str, int]]:
    """policies: None | {name: slots} | [(name, slots), ...] -> ordered
    [(name, slots)] partitioning ``num_slots``."""
    if policies is None:
        return [(default_name, num_slots)]
    items = (list(policies.items()) if isinstance(policies, dict)
             else [tuple(p) for p in policies])
    if not items:
        raise ValueError("policies must name at least one slot group")
    names = [n for n, _ in items]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate policy group names in {names}: one "
                         f"slot group per policy")
    for n, sl in items:
        if sl <= 0:
            raise ValueError(f"policy group {n!r} has {sl} slots: every "
                             f"group needs at least one")
    total = sum(sl for _, sl in items)
    if total != num_slots:
        raise ValueError(
            f"policy groups {dict(items)} cover {total} slots but "
            f"EngineConfig.num_slots={num_slots}: groups must partition "
            f"the slot slab exactly")
    return items


def check_engine_supported(cfg: ModelConfig) -> None:
    """The families the engine serves, on one device and on a mesh alike:
    decoder-only text models with attention caches (the dense trunk and
    the MoE models); anything else raises before any work."""
    if cfg.block_type != "attn":
        raise NotImplementedError(
            f"serving engine requires an attention-cache family "
            f"(block_type='attn'), got {cfg.block_type!r}: recurrent "
            f"states cannot be prefilled from a padded prompt")
    if cfg.modality != "text":
        raise NotImplementedError(
            "serving engine v1 is text-only (per-request vision prefixes "
            "would make the prefill shape dynamic)")
    if cfg.is_encoder_only or cfg.is_encoder_decoder:
        raise NotImplementedError("serving engine is decoder-only")


class ContinuousBatchingEngine:
    """Slot-based continuous batching for the decoder-only BPD loop,
    with per-request decode policies via policy slot groups."""

    def __init__(self, params, cfg: ModelConfig, dec: DecodeConfig,
                 ecfg: EngineConfig, *, mesh=None,
                 session: Optional[DecodeSession] = None, policy=None,
                 bundles=None,
                 policies: Union[None, Dict[str, int],
                                 Sequence[Tuple[str, int]]] = None):
        check_engine_supported(cfg)
        self.session = session if session is not None else DecodeSession(
            params, cfg, dec, mesh=mesh, policy=policy, bundles=bundles)
        for name, b in self.session.bundles.items():
            if b.cfg.block_type != "attn":
                raise NotImplementedError(
                    f"auxiliary bundle {name!r} has block_type="
                    f"{b.cfg.block_type!r}: the engine's padded admission "
                    f"prefill is only sound for attention caches (same "
                    f"argument as the primary model)")
        self.mesh = mesh = self.session.mesh
        ecfg.validate(dec=self.session.dec, mesh=mesh)
        self.policy = self.session.policy
        # rank 0 of a mesh plans; the others replay its plans (follow)
        self._leads = mesh is not None and mesh.index == 0
        self._in_plan = False
        self.num_plans = 0          # plans rank 0 sent / another received
        self._last_plan = time.monotonic()
        self._last_pull: Dict[int, Tuple] = {}   # gid -> last pull_group

        # the session is the source of truth for model/decode config — a
        # caller-provided session may differ from the cfg/dec args, and the
        # device functions are built from the session's copies
        self.cfg = cfg = self.session.cfg
        self.dec = dec = self.session.dec
        self.ecfg = ecfg
        self.block_k = dec.block_k or cfg.bpd_k
        self.prefix = cfg.num_meta_tokens
        self.context_len = self.prefix + ecfg.max_prompt_len + ecfg.max_new_cap
        self.buf_len = ecfg.max_prompt_len + ecfg.max_new_cap + self.block_k

        # -- policy slot groups: partition the slab, one built fns set per
        # distinct (policy, geometry), one state view per group ------------
        self.default_policy = self.policy.name
        specs = _normalize_groups(policies, self.default_policy,
                                  ecfg.num_slots)
        self.groups: List[PolicyGroup] = []
        offset = 0
        for gid, (name, slots) in enumerate(specs):
            gecfg = dataclasses.replace(ecfg, num_slots=slots)
            # each group's view shards the data axes on its own
            gecfg.validate(dec=dec, mesh=mesh)
            # the default group (policies=None) serves the session's BOUND
            # policy object — re-resolving its name through the registry
            # would silently replace a caller-supplied / hand-built
            # DecodePolicy with the registry default of the same name
            pol_arg = None if policies is None else name
            fns = self.session.serving_fns(gecfg, policy=pol_arg)
            # each group owns its page pool (its SlotBatch holds a separate
            # kp/vp buffer), so the host allocator is per-group too
            pages = None
            if fns.paged is not None:
                geom = fns.paged
                pages = PageAllocator(geom.num_pages, geom.page_size,
                                      geom.pages_per_row,
                                      prefix_len=geom.prefix_len)
            self.groups.append(PolicyGroup(
                gid=gid, name=name,
                policy=self.session.bound_policy(pol_arg),
                offset=offset, num_slots=slots, fns=fns,
                state=fns.init(gid),
                status=np.zeros((slots,), np.int8),
                slot_meta=[None] * slots,
                pages=pages))
            offset += slots
        self._by_name = {g.name: g for g in self.groups}
        self._rr = 0            # round-robin pointer over group steps

        # -- disaggregated prefill/decode (prefill_slots > 0): dedicated
        # prefill workers batch prompt prefills and park the finished KV
        # state in a bounded handoff queue; decode groups pull rows into
        # freed slots without ever serializing admission behind a step ----
        self.disaggregated = ecfg.prefill_slots > 0
        self.prefill_width = max(ecfg.prefill_slots, 1)
        self.handoff_cap = ecfg.handoff_cap or max(2 * ecfg.num_slots,
                                                   ecfg.prefill_slots)
        self._staged: Dict[str, List[Tuple[Request, float]]] = {
            g.name: [] for g in self.groups}         # awaiting a prefill
        self._handoff: Dict[str, Deque[HandoffRecord]] = {
            g.name: deque() for g in self.groups}    # awaiting a slot

        self.num_admits = 0     # requests entering a slot (admit or attach)
        self.num_steps = 0      # decode ITERATIONS that did work (a
                                # windowed step adds the iterations before
                                # and including its first harvestable row)
        self.num_forwards = 0   # decode forwards dispatched: steps_per_sync
                                # per group step, the masked no-op
                                # iterations of a window included
        self.num_host_syncs = 0  # device->host readbacks (regression guard)
        self.num_stream_syncs = 0  # poll_progress readbacks (streaming only)
        self.num_prefill_batches = 0   # prefill-worker forwards dispatched
        self.num_attach_backpressure = 0  # attach stalls (page pool full)
        # per-phase host wall-clock attribution (the speedup ledger):
        # where the serving loop actually spends its host time
        self.time_in_prefill = 0.0          # prefill dispatch (admit incl.)
        self.time_in_decode_dispatch = 0.0  # group-step dispatch, no sync
        self.time_in_harvest = 0.0          # status pulls + retirement
        # harvest of one group completed while ANOTHER stepped group's
        # status was still unpulled (its device step still in flight) —
        # the async per-group stream overlap, asserted in tests
        self.num_overlap_harvests = 0

    @property
    def params(self):
        """The parameters (owned by the DecodeSession)."""
        return self.session.params

    @property
    def aux_params(self):
        """The auxiliary bundles' parameters (e.g. the draft model's), owned
        by the DecodeSession."""
        return self.session.aux_params

    # -- the mesh: plans and gathers -----------------------------------------

    def _encode(self, v):
        """A planned call's argument as the other ranks can read it back:
        a group by its index, a ``pull_group`` result by its group."""
        if isinstance(v, PolicyGroup):
            return _GroupRef(v.gid)
        for gid, pulled in self._last_pull.items():
            if v is pulled:
                return _PullRef(gid)
        return v

    def _decode(self, v):
        if isinstance(v, _GroupRef):
            return self.groups[v.gid]
        if isinstance(v, _PullRef):
            return self._last_pull[v.gid]
        return v

    def _broadcast(self, plan) -> None:
        comm.broadcast_plan(self.mesh, plan)
        self.num_plans += 1
        self._last_plan = time.monotonic()

    def keep_alive(self) -> None:
        """On rank 0 of a mesh, between ticks of an idle server: an empty
        plan to the other ranks once ``HEARTBEAT_S`` has passed since the
        last plan, so their wait in ``follow`` stays far inside the
        collectives' time limit; a no-op elsewhere."""
        if (self._leads
                and time.monotonic() - self._last_plan >= HEARTBEAT_S):
            self._broadcast(None)

    def _read_rows(self, g: PolicyGroup, tensors) -> np.ndarray:
        """One device→host read of int tensors of group ``g``'s slots
        (concatenated as int32 columns): every slot of the group, gathered
        from the ranks that keep them under a mesh.  The caller counts
        it."""
        cols = torch.cat([t.reshape(t.shape[0], -1).to(I32) for t in tensors],
                         dim=1)
        if self.mesh is not None:
            cols = comm.data_gather(self.mesh, cols, g.num_slots)
        return cols.cpu().numpy()

    def _receive(self):
        plan = comm.broadcast_plan(self.mesh)
        self.num_plans += 1
        return plan

    def follow(self) -> List[FinishedRequest]:
        """The serving loop of a mesh rank other than 0: replay rank 0's
        calls on this engine until its ``release_followers``.  Returns the
        finish records of every step and harvest, in order: the records
        rank 0's engine made."""
        if self.mesh is None or self._leads:
            raise RuntimeError("follow() runs on a mesh rank other than 0")
        done: List[FinishedRequest] = []
        while True:
            plan = self._receive()
            if plan is None:                # rank 0 idles: a heartbeat
                continue
            if isinstance(plan, _Raised):
                raise RuntimeError(f"rank 0's last call raised "
                                   f"{plan.error}; this rank's replay did not")
            name, args, kwargs = plan
            if name == "release_followers":
                return done
            try:
                out = getattr(self, name)(
                    *map(self._decode, args),
                    **{k: self._decode(v) for k, v in kwargs.items()})
            except PagePoolExhausted as exc:
                if self._receive() != _Raised(type(exc).__name__):
                    raise
                continue        # rank 0's call raised the same: it goes on
            if name in ("step", "harvest"):
                done += out

    @_planned
    def release_followers(self) -> None:
        """On rank 0 of a mesh: end the other ranks' ``follow`` (after the
        scheduler drained, or the server shut down); a no-op elsewhere."""

    @property
    def state(self) -> SlotBatch:
        """The slot state — single-group engines only (the historical
        engine API).  Multi-group engines expose per-group views via
        ``groups`` / ``group_for``."""
        if len(self.groups) != 1:
            raise AttributeError(
                f"engine has {len(self.groups)} policy slot groups — read "
                f"engine.groups[gid].state (or group_for(policy).state) "
                f"instead of the single-group .state shorthand")
        return self.groups[0].state

    # -- group routing -------------------------------------------------------

    def group_for(self, policy: Optional[str]) -> PolicyGroup:
        """The slot group serving ``policy`` (None = the session default).
        Raises ValueError for policies the engine was not configured with,
        resolving the name through ``config.registry`` first so unknown
        names fail with the registry's message."""
        name = policy or self.default_policy
        g = self._by_name.get(name)
        if g is None:
            resolve_policy(self.dec, name)  # unknown name -> registry error
            raise ValueError(
                f"request policy {name!r} has no slot group in this engine "
                f"(groups: {sorted(self._by_name)}): configure it via "
                f"ContinuousBatchingEngine(policies={{{name!r}: n, ...}})")
        return g

    def policy_names(self) -> List[str]:
        return [g.name for g in self.groups]

    # -- host-side API -------------------------------------------------------

    def free_slots(self, policy: Optional[str] = None) -> List[int]:
        """Global ids of free slots — all groups (default), or the single
        group serving ``policy`` (a name; pass the default policy's name
        to query the default group alone)."""
        groups = self.groups if policy is None else [self.group_for(policy)]
        return [g.offset + i for g in groups for i in g.free_local()]

    def has_active(self) -> bool:
        return any(bool(np.any(g.status & 1)) for g in self.groups)

    def _padded(self, req: Request) -> Tuple[np.ndarray, int, np.ndarray, int]:
        """Pad a request's prompt/src rows to the admission geometry (the
        one definition shared by unified admit and the prefill workers)."""
        p = len(req.prompt)
        if not 0 < p <= self.ecfg.max_prompt_len:
            raise ValueError(
                f"prompt length {p} outside (0, {self.ecfg.max_prompt_len}]")
        prompt = np.zeros((self.ecfg.max_prompt_len,), np.int32)
        prompt[:p] = req.prompt
        # source tokens for drafting policies: the request's src (padded /
        # truncated to the admission geometry), defaulting to the prompt
        src_toks = req.prompt if req.src is None else req.src
        src = np.zeros((self.ecfg.max_prompt_len,), np.int32)
        n_src = min(len(src_toks), self.ecfg.max_prompt_len)
        src[:n_src] = src_toks[:n_src]
        max_new = int(np.clip(req.max_new, 1, self.ecfg.max_new_cap))
        return prompt, p, src, max_new

    @_planned
    def admit(self, req: Request, *, now: Optional[float] = None) -> int:
        """Admit a request into a free slot of its policy's group; returns
        the global slot index."""
        g = self.group_for(req.policy)
        free = g.free_local()
        if not free:
            raise RuntimeError(
                f"no free slot in policy group {g.name!r} — poll "
                f"step()/harvest first")
        slot = free[0]
        prompt, p, src, max_new = self._padded(req)
        extra = ()
        if g.pages is not None:
            # host-side page plan first: raises PagePoolExhausted (back-
            # pressure, the scheduler requeues) before any device work, and
            # reuses pooled pages for identical prompt prefixes (CoW)
            tbl_row, write_mask = g.pages.plan_admit(
                slot, req.prompt, p, max_new, self.block_k)
            extra = (tbl_row, write_mask)
        t0 = time.monotonic()
        g.state = g.fns.admit(self.params, g.state, slot, prompt, p, max_new,
                              src, *extra, aux=self.aux_params)
        g.num_prefills += 1
        self.time_in_prefill += time.monotonic() - t0
        g.status[slot] = 1          # known host-side: no readback needed
        self.num_admits += 1
        admit_time = time.monotonic() if now is None else now
        if req.arrival is None:
            req.arrival = admit_time
        g.slot_meta[slot] = {
            "req": req, "prompt_len": p, "max_new": max_new,
            "admit_time": admit_time, "emitted": 0,
        }
        return g.offset + slot

    # -- disaggregated prefill/decode ----------------------------------------

    def handoff_backlog(self) -> int:
        """Requests staged for prefill plus rows parked in the KV-handoff
        queue — work admitted to the engine that holds no slot yet."""
        return (sum(len(v) for v in self._staged.values())
                + sum(len(v) for v in self._handoff.values()))

    def handoff_free(self) -> int:
        """Remaining capacity of the bounded handoff pipeline (staged +
        parked share one bound so prefill output can never pile up
        unboundedly when decode stalls)."""
        return self.handoff_cap - self.handoff_backlog()

    @_planned
    def queue_prefill(self, req: Request, *, now: Optional[float] = None) -> None:
        """Stage a request for the prefill workers (disaggregated mode
        only).  Validates geometry now so malformed requests fail at
        submission, not inside a worker batch; raises RuntimeError when the
        handoff pipeline is full (back-pressure — callers check
        ``handoff_free()`` first, exactly like ``free_slots`` for admit)."""
        if not self.disaggregated:
            raise RuntimeError(
                "queue_prefill requires a disaggregated engine "
                "(EngineConfig.prefill_slots > 0); unified engines admit "
                "directly")
        g = self.group_for(req.policy)
        self._padded(req)           # geometry validation only
        if self.handoff_free() <= 0:
            raise RuntimeError(
                f"KV-handoff queue full ({self.handoff_cap} staged+parked) "
                f"— poll attach_ready()/step() first")
        t = time.monotonic() if now is None else now
        if req.arrival is None:
            req.arrival = t
        self._staged[g.name].append((req, t))

    @_planned
    def run_prefills(self, *, now: Optional[float] = None) -> int:
        """Dispatch prefill-worker batches for everything staged: each
        batch prefills up to ``prefill_slots`` prompts in ONE forward
        (short batches are padded with inert dummy rows — same static
        shape, so the worker is built once) and parks its rows in the
        handoff queue as ``HandoffRecord``s sharing the device packet.
        Dispatch-only — no device→host sync.  Returns rows parked."""
        t0 = time.monotonic()
        parked = 0
        w = self.prefill_width
        for g in self.groups:
            staged = self._staged[g.name]
            while staged:
                if (len(staged) < w
                        and (self._handoff[g.name]
                             or not g.free_local())):
                    # coalesce: parked rows already cover the free slots
                    # (or none are free), so a partial batch buys no TTFT
                    # — hold the stage until a full-width batch forms.
                    # The moment a slot opens with nothing parked, the
                    # next call dispatches whatever is staged: deferring
                    # past that point idles decode slots, which costs
                    # more than the padded partial forward saves
                    break
                batch, self._staged[g.name] = staged[:w], staged[w:]
                staged = self._staged[g.name]
                prompts = np.zeros((w, self.ecfg.max_prompt_len), np.int32)
                plens = np.ones((w,), np.int32)   # dummy rows: 1-token prompt
                srcs = np.zeros((w, self.ecfg.max_prompt_len), np.int32)
                rows = []
                for r, (req, _) in enumerate(batch):
                    prompt, p, src, max_new = self._padded(req)
                    prompts[r], plens[r], srcs[r] = prompt, p, src
                    rows.append((req, r, p, max_new))
                packet = g.fns.prefill(self.params, prompts, plens, srcs,
                                       aux=self.aux_params)
                self.num_prefill_batches += 1
                g.num_prefills += 1
                t = time.monotonic() if now is None else now
                for req, r, p, max_new in rows:
                    self._handoff[g.name].append(HandoffRecord(
                        req=req, packet=packet, row=r, prompt_len=p,
                        max_new=max_new, prefill_time=t))
                    parked += 1
        self.time_in_prefill += time.monotonic() - t0
        return parked

    @_planned
    def attach_ready(self, *, now: Optional[float] = None) -> int:
        """Install parked handoff rows into freed decode slots (the
        prefill→decode KV handoff).  FIFO per group;
        a page-pool-exhausted head waits in place (head-of-line, so
        admission order within a group is preserved).

        Consecutive records sharing one prefill packet install in ONE
        ``attach_many`` dispatch (a per-record attach call would hand
        back the dispatch overhead that batching the prefill amortized).
        Returns the number of requests attached."""
        attached = 0
        w = self.prefill_width
        for g in self.groups:
            q = self._handoff[g.name]
            while q:
                free = g.free_local()
                if not free:
                    break
                # gather up to W head records from the SAME packet that
                # have both a free slot and (if paged) a page plan
                pkt = q[0].packet
                batch, blocked = [], False
                while (q and q[0].packet is pkt and len(batch) < len(free)
                       and len(batch) < w):
                    rec, slot = q[0], free[len(batch)]
                    extra = None
                    if g.pages is not None:
                        try:
                            extra = g.pages.plan_admit(
                                slot, rec.req.prompt, rec.prompt_len,
                                rec.max_new, self.block_k)
                        except PagePoolExhausted:
                            # head-of-line: the failed record waits for a
                            # release; whatever fit still attaches below
                            self.num_attach_backpressure += 1
                            blocked = True
                            break
                    q.popleft()
                    batch.append((rec, slot, extra))
                if not batch:
                    break
                rows = np.zeros((w,), np.int32)
                slots = np.zeros((w,), np.int32)
                maxn = np.zeros((w,), np.int32)
                valid = np.zeros((w,), bool)
                for i, (rec, slot, _) in enumerate(batch):
                    rows[i], slots[i] = rec.row, slot
                    maxn[i], valid[i] = rec.max_new, True
                pextra = ()
                if g.pages is not None:
                    P_ = g.fns.paged.pages_per_row
                    tbls = np.zeros((w, P_), np.int32)
                    masks = np.zeros((w, P_), bool)
                    for i, (_, _, (tbl_row, write_mask)) in enumerate(batch):
                        tbls[i], masks[i] = tbl_row, write_mask
                    pextra = (tbls, masks)
                g.state = g.fns.attach_many(g.state, pkt, rows, slots, maxn,
                                            valid, *pextra)
                t = time.monotonic() if now is None else now
                for rec, slot, _ in batch:
                    g.status[slot] = 1  # known host-side: no readback needed
                    self.num_admits += 1
                    g.slot_meta[slot] = {
                        "req": rec.req, "prompt_len": rec.prompt_len,
                        "max_new": rec.max_new, "admit_time": t, "emitted": 0,
                    }
                attached += len(batch)
                if blocked:
                    break
        return attached

    @_planned
    def step(self, *, now: Optional[float] = None) -> List[FinishedRequest]:
        """One BPD iteration over every active slot group, then
        harvest+evict.

        Groups step round-robin (the starting group rotates so no policy
        is systematically served first), ALL group steps are dispatched
        before any status is read back, and each stepped group is then
        pulled AND harvested in dispatch order, so the host-side harvest
        of group A overlaps group B's still-in-flight device step (counted
        in ``num_overlap_harvests``).  Each group step costs exactly one
        fused device→host read: its status and its window's iteration
        count in one tensor, gathered from every rank's slots under a mesh.
        """
        t0 = time.monotonic()
        n = len(self.groups)
        order = [self.groups[(self._rr + i) % n] for i in range(n)]
        self._rr = (self._rr + 1) % n
        stepped = []
        for g in order:
            if not np.any(g.status & 1):
                continue                     # idle group: no device work
            g.state, status, iters = g.fns.step(self.params, g.state,
                                                aux=self.aux_params)
            # the group's one read, queued right behind its own step (under
            # a mesh, a gather over the slots when it is read)
            readout = iters if self.mesh is not None else _Pending(
                torch.cat([status.to(I32), iters.reshape(1)]))
            stepped.append((g, status, readout))
        self.time_in_decode_dispatch += time.monotonic() - t0
        # the ONE per-group-step device->host round-trip: a fused (S,) int8
        # array carrying both the active and the finished bits (the harvest
        # decision) — pulled only after every group's step is in flight,
        # and each group's harvest runs before the NEXT group's pull
        out: List[FinishedRequest] = []
        t1 = time.monotonic()
        spd = self.ecfg.steps_per_sync
        for idx, (g, status, readout) in enumerate(stepped):
            # one fused pull: the (S,) status plus the window's iteration
            # count (a windowed step dispatches steps_per_sync forwards, of
            # which the count did work)
            if self.mesh is None:
                host = readout.wait()
                g.status = host[:-1].astype(np.int8)     # writable host copy
                it = int(host[-1])
            else:       # every rank's statuses, the window's count beside
                host = self._read_rows(g, [status,
                                           readout.expand(len(status))])
                g.status = host[:, 0].astype(np.int8)
                it = int(host[0, 1])
            self.num_steps += it
            g.num_steps += it
            self.num_forwards += spd
            g.num_forwards += spd
            self.num_host_syncs += 1
            out += self._harvest_group(g, now=now, status=status)
            if idx < len(stepped) - 1:
                # host work above ran while the later stepped groups'
                # statuses were still unpulled (their device steps free to
                # proceed) — the measurable async-stream overlap
                self.num_overlap_harvests += 1
        self.time_in_harvest += time.monotonic() - t1
        return out

    @_planned
    def harvest(self, *, now: Optional[float] = None) -> List[FinishedRequest]:
        """Retire finished slots of every group: copy outputs out, free
        the slots (host-cached status decides — a no-finish group costs
        zero additional device syncs)."""
        out: List[FinishedRequest] = []
        for g in self.groups:
            out += self._harvest_group(g, now=now)
        return out

    def _harvest_group(self, g: PolicyGroup, *, now: Optional[float] = None,
                       status: Optional[torch.Tensor] = None
                       ) -> List[FinishedRequest]:
        """Retire the finished slots of ONE group.

        Decides from the host-cached status — the common no-finish group
        step costs zero additional device syncs; the per-slot arrays are
        only pulled when something actually finished (one pull per
        finishing group, counted in ``num_host_syncs``).  ``status`` is the
        step's device status, from which the evict mask is made on the
        device (no host-to-device copy behind the later groups' steps; this
        rank's slots under a mesh).
        """
        done_mask = (g.status & 2).astype(bool)
        if not done_mask.any():
            return []
        t = time.monotonic() if now is None else now
        out: List[FinishedRequest] = []
        # one FUSED transfer for all four arrays
        tokens, text_len, generated, invocations = self._pull(g)
        self.num_host_syncs += 1  # one harvest pull per finishing group
        for i in np.nonzero(done_mask)[0]:
            meta = g.slot_meta[i]
            req: Request = meta["req"]
            p = meta["prompt_len"]
            iters = max(int(invocations[i]) - 1, 1)  # minus the prefill
            out.append(FinishedRequest(
                rid=req.rid, prompt_len=p,
                tokens=tokens[i, p:int(text_len[i])].copy(),
                generated=int(generated[i]),
                invocations=int(invocations[i]),
                mean_accepted=float(generated[i]) / iters,
                arrival=req.arrival, admit_time=meta["admit_time"],
                finish_time=t, policy=g.name))
            g.slot_meta[i] = None
            if g.pages is not None:
                g.pages.release(int(i))
        mask = done_mask if status is None else (status & 2) > 0
        g.state = g.fns.evict(g.state, mask)
        g.status[done_mask] = 0     # known host-side: freed, inactive
        return out

    # -- streaming + preemption (serving front end) --------------------------

    @_planned
    def poll_progress(self) -> List[Tuple[Request, np.ndarray]]:
        """Committed-but-unstreamed tokens per ACTIVE slot since the last
        poll: ``[(request, new_tokens), ...]``.

        This is the streaming read the HTTP/SSE front end runs after each
        ``step()``; it costs one extra device→host pull per group with
        active slots (counted in ``num_stream_syncs``, separate from the
        engine's one-fused-sync-per-group-step contract — callers that
        never stream never pay it).  A slot that finished in the preceding
        step was already harvested (its meta is gone); its tail tokens
        reach the front end through ``FinishedRequest.tokens`` instead.
        Under a mesh the live rows are gathered from the ranks that keep
        them, and every rank keeps the same ``emitted`` counts.
        """
        out: List[Tuple[Request, np.ndarray]] = []
        for g in self.groups:
            live = [i for i in range(g.num_slots)
                    if (g.status[i] & 1) and g.slot_meta[i] is not None]
            if not live:
                continue
            host = self._read_rows(g, [g.state.tokens, g.state.text_len])
            tokens, text_len = host[:, :-1], host[:, -1]
            self.num_stream_syncs += 1
            for i in live:
                meta = g.slot_meta[i]
                start = meta["prompt_len"] + meta["emitted"]
                end = int(text_len[i])
                if end > start:
                    out.append((meta["req"], tokens[i, start:end].copy()))
                    meta["emitted"] = end - meta["prompt_len"]
        return out

    @_planned
    def pull_group(self, g: PolicyGroup) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray]:
        """One host pull of group ``g``'s per-slot progress arrays
        ``(tokens, text_len, generated, invocations)`` — the scheduler
        reads these to pick a preemption victim (feasibility needs
        ``generated``), then hands them back to ``preempt`` so choosing
        and evicting cost a single sync together."""
        pulled = self._pull(g)
        self.num_host_syncs += 1
        self._last_pull[g.gid] = pulled
        return pulled

    def _pull(self, g: PolicyGroup):
        """(tokens, text_len, generated, invocations) of group ``g`` in one
        device→host transfer."""
        st = g.state
        host = self._read_rows(g, [st.tokens, st.text_len, st.generated,
                                   st.invocations])
        return host[:, :-3], host[:, -3], host[:, -2], host[:, -1]

    @_planned
    def preempt(self, g: PolicyGroup, slot: int,
                pulled=None) -> PreemptedRequest:
        """Evict the ACTIVE request in group ``g``'s local ``slot`` and
        return its committed progress for requeueing.

        Mirrors harvest's cleanup exactly (evict + page release + status/
        meta clear) but for one mid-flight slot: the committed tokens
        survive in the returned record, uncommitted block proposals are
        discarded (they live beyond ``text_len`` and were never part of
        the result stream).  The caller (scheduler) re-admits the request
        as a continuation whose prompt is ``prompt + tokens`` — the same
        padded-prefill path as any admission, so the continuation's stream
        is the decode of the identical committed context.

        ``pulled`` is an optional ``pull_group(g)`` result to reuse (victim
        selection already paid the sync); None pulls fresh.
        """
        if not g.status[slot] & 1 or g.slot_meta[slot] is None:
            raise RuntimeError(
                f"preempt: slot {slot} of group {g.name!r} holds no active "
                f"request")
        tokens, text_len, generated, invocations = (
            pulled if pulled is not None else self.pull_group(g))
        meta = g.slot_meta[slot]
        rec = PreemptedRequest(
            req=meta["req"],
            tokens=tokens[slot, meta["prompt_len"]:int(text_len[slot])].copy(),
            generated=int(generated[slot]),
            invocations=int(invocations[slot]),
            streamed=meta["emitted"])
        mask = np.zeros((g.num_slots,), bool)
        mask[slot] = True
        g.state = g.fns.evict(g.state, mask)
        g.status[slot] = 0
        g.slot_meta[slot] = None
        if g.pages is not None:
            g.pages.release(slot)
        return rec

    # -- diagnostics ---------------------------------------------------------

    def compile_counts(self) -> dict:
        """Builds of each called serving function: the twin of the
        reference's jit-cache sizes, and the rebuild regression guard.
        Each entry counts how often the session built the function's
        (policy, geometry) set and must read 1 after any amount of
        traffic.  Distinct (policy, geometry) sets are counted once even
        when several groups share them; multi-group engines prefix entries
        with the policy name.  Functions a run never called are left out
        (unified engines do not call the prefill/attach pair,
        disaggregated ones reach admit only through preemption).  Each call
        still launches its kernels from the host; once ``step`` is captured
        as a CUDA graph (ROADMAP.md §1 item 1) this counts captures."""
        single = len(self.groups) == 1
        out, seen = {}, set()
        for g in self.groups:
            if id(g.fns) in seen:
                continue
            seen.add(id(g.fns))
            for part in ("admit", "prefill", "attach", "attach_many",
                         "step", "evict"):
                if getattr(g.fns, part).calls == 0:
                    continue
                key = part if single else f"{g.name}/{part}"
                out[key] = self.session.builds[g.fns.key]
        return out
