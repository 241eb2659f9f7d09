"""Request/response and configuration types of the continuous-batching BPD
serving engine, and the device-side ``SlotBatch`` state (twins of
``repro.serving.types``).

A ``Request`` is one decode job (prompt + generation budget).  The engine
holds ``EngineConfig.num_slots`` requests in flight at once; finished slots
are evicted and refilled from the scheduler queue without rebuilding
anything (static batch shape, per-slot active mask).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class SlotBatch(NamedTuple):
    """Device-side state: ``BPDState`` generalized to reusable slots.

    The slot dimension is the decode batch dimension.  With per-request
    decode policies the engine's slot slab is partitioned into per-policy
    slot groups; each group's ``SlotBatch`` is the group-local view (its
    ``group`` field records which group the rows belong to), stepped by
    that group's own functions.  The caches are written in place, as the
    port's decode caches always are; the other fields are replaced by each
    step.
    """

    tokens: torch.Tensor       # (S, buf) per-slot prompt+output buffer
    text_len: torch.Tensor     # (S,) valid tokens in the buffer
    prompt_len: torch.Tensor   # (S,) prompt portion of text_len
    proposals: torch.Tensor    # (S, k) next-block proposals
    caches: Any                # per-layer caches (batch dim = S)
    active: torch.Tensor       # (S,) bool: slot holds a live request
    finished: torch.Tensor     # (S,) bool: request hit EOS / budget
    generated: torch.Tensor    # (S,) accepted tokens so far
    max_new: torch.Tensor      # (S,) per-slot generation budget
    invocations: torch.Tensor  # (S,) model calls spent on this request
    policy_state: Any = ()     # per-slot DecodePolicy state (reset on
                               # admit/evict)
    group: Any = ()            # (S,) int32 policy slot-group id


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static shapes of the serving engine (fixed when its functions are
    built)."""

    num_slots: int = 4          # concurrent requests in the device batch
    max_prompt_len: int = 32    # prompts are padded to this for admission
    max_new_cap: int = 64       # hard per-request generation budget
    page_pool_pages: int = 0    # paged backend: physical pages in the pool
                                # (incl. the trash page); 0 = auto worst
                                # case (1 + num_slots * pages_per_slot)
    prefill_slots: int = 0      # disaggregated prefill/decode: prompts per
                                # prefill-worker forward, handed to decode
                                # groups through the KV-handoff queue;
                                # 0 = unified engine (admission prefills
                                # inline)
    handoff_cap: int = 0        # bound on requests staged for / parked in
                                # the KV-handoff queue (back-pressure once
                                # full); 0 = auto (max(2 * num_slots,
                                # prefill_slots))
    steps_per_sync: int = 1     # decode iterations per step() dispatch:
                                # >1 runs that many forwards before the one
                                # status read, the iterations after the
                                # first harvestable row masked to no-ops
                                # on the device, so tokens, counts and
                                # slot refill timing are those of one
                                # iteration per sync; only the admission
                                # of new arrivals can lag by at most
                                # steps_per_sync - 1 iterations

    def validate(self, dec=None, mesh=None) -> None:
        """Fail at construction with a clear message instead of a shape
        error downstream.

        dec  : optional DecodeConfig: ``max_new_cap`` must fit inside its
               ``max_new_tokens``; its ``cache_backend`` / ``page_size``
               gate the page-pool geometry checks.
        mesh : optional ``launch.mesh.Mesh``: ``num_slots`` must shard over
               its batch axes (pod×data, or data alone:
               ``sharding.policy.batch_axes``) wherever they have more
               than one shard.
        """
        if self.num_slots <= 0:
            raise ValueError(
                f"EngineConfig.num_slots must be positive, got "
                f"{self.num_slots}")
        if self.max_prompt_len <= 0:
            raise ValueError(
                f"EngineConfig.max_prompt_len must be positive, got "
                f"{self.max_prompt_len}")
        if self.max_new_cap <= 0:
            raise ValueError(
                f"EngineConfig.max_new_cap must be positive, got "
                f"{self.max_new_cap}")
        if self.prefill_slots < 0:
            raise ValueError(
                f"EngineConfig.prefill_slots must be >= 0, got "
                f"{self.prefill_slots} (0 = unified engine)")
        if self.handoff_cap < 0:
            raise ValueError(
                f"EngineConfig.handoff_cap must be >= 0, got "
                f"{self.handoff_cap} (0 = auto)")
        if self.steps_per_sync < 1:
            raise ValueError(
                f"EngineConfig.steps_per_sync must be >= 1, got "
                f"{self.steps_per_sync}")
        if (self.prefill_slots > 0 and self.handoff_cap > 0
                and self.handoff_cap < self.prefill_slots):
            raise ValueError(
                f"EngineConfig.handoff_cap={self.handoff_cap} is smaller "
                f"than one prefill batch (prefill_slots="
                f"{self.prefill_slots}): the prefill worker could never "
                f"fill a batch — raise the cap or shrink the width")
        if dec is not None and self.max_new_cap > dec.max_new_tokens:
            raise ValueError(
                f"EngineConfig.max_new_cap={self.max_new_cap} exceeds "
                f"DecodeConfig.max_new_tokens={dec.max_new_tokens}: the "
                f"decode loop bound would truncate requests below their "
                f"advertised budget")
        if dec is not None and getattr(dec, "cache_backend", "dense") == "paged":
            ps = dec.page_size
            if ps <= 0 or ps % 8 != 0:
                raise ValueError(
                    f"DecodeConfig.page_size={ps} must be a positive "
                    f"multiple of 8: the paged attention kernel takes pages "
                    f"of whole 8-row tiles")
            if self.page_pool_pages:
                # lower bound on the pages one max-size request maps (the
                # true span adds the model prefix and the block slack,
                # which the session knows)
                per_slot = -(-(self.max_prompt_len + self.max_new_cap) // ps)
                if self.page_pool_pages < 1 + per_slot:
                    raise ValueError(
                        f"EngineConfig.page_pool_pages={self.page_pool_pages}"
                        f" cannot admit even one request: a max-size request "
                        f"maps >= ceil((max_prompt_len + max_new_cap) / "
                        f"page_size) = ceil(({self.max_prompt_len} + "
                        f"{self.max_new_cap}) / {ps}) = {per_slot} pages, "
                        f"plus the reserved trash page 0.  Raise "
                        f"page_pool_pages to at least {1 + per_slot} (or to "
                        f"1 + num_slots * pages_per_slot = "
                        f"{1 + self.num_slots * per_slot} to rule out "
                        f"admission back-pressure entirely; 0 auto-sizes to "
                        f"the worst case)")
        if mesh is not None:
            from repro_torch.sharding.policy import batch_axes, data_axis_size

            # batch_axes is the one rule for how the slot batch shards (it
            # falls back from pod×data to data alone): refuse only what it
            # cannot shard at all, which would replicate the whole slab
            dsz = data_axis_size(mesh)
            if dsz > 1 and batch_axes(mesh, self.num_slots) is None:
                raise ValueError(
                    f"EngineConfig.num_slots={self.num_slots} is not "
                    f"divisible by the mesh data axes (data-axis product "
                    f"{dsz}, mesh axes {dict(mesh.shape)}): the slot "
                    f"batch cannot shard and would be replicated — pick "
                    f"num_slots as a multiple of the data axis size")


@dataclasses.dataclass
class Request:
    """One decode job submitted to the scheduler.

    ``arrival`` is an absolute ``time.monotonic()`` instant; ``None`` means
    "now" (the scheduler or engine stamps it).  ``policy`` names the
    registered decode policy the request wants (``None``: the engine's
    session default); only policies the engine has a slot group for are
    admissible.  ``src`` optionally carries source tokens for
    source-drafting policies (``input_copy``); ``None`` defaults to the
    prompt.  ``priority`` orders admission (higher first within a group);
    ``deadline`` is an absolute monotonic instant by which the request
    should finish, and may preempt a strictly-lower-priority slot of its
    group (``serving.scheduler``).
    """

    rid: int
    prompt: np.ndarray          # (P,) int32 token ids, P <= max_prompt_len
    max_new: int                # requested tokens, clamped to max_new_cap
    arrival: Optional[float] = None
    policy: Optional[str] = None  # registered policy name; None = default
    src: Optional[np.ndarray] = None  # source tokens for drafting policies
    priority: int = 0           # admission priority (higher wins)
    deadline: Optional[float] = None  # absolute finish deadline (monotonic)
    backpressured: int = 0      # times requeued by PagePoolExhausted

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.src is not None:
            self.src = np.asarray(self.src, np.int32).reshape(-1)


@dataclasses.dataclass
class FinishedRequest:
    """A retired request with its serving statistics."""

    rid: int
    prompt_len: int
    tokens: np.ndarray          # generated tokens only (no prompt)
    generated: int              # accepted tokens
    invocations: int            # model calls spent (prefill + iterations)
    mean_accepted: float        # k̂ for this request (generated / iterations)
    arrival: float
    admit_time: float
    finish_time: float
    policy: str = ""            # decode policy that served this request
    preempted: int = 0          # times this request was evicted + requeued

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival

    @property
    def queue_delay(self) -> float:
        return self.admit_time - self.arrival


@dataclasses.dataclass
class PreemptedRequest:
    """A mid-flight request evicted from its slot by the scheduler.

    ``tokens`` are the committed tokens of the evicted segment only (the
    continuation re-admits with ``prompt + tokens`` as its prompt);
    ``streamed`` counts how many of them progress polling already emitted.
    """

    req: Request                # the evicted request (original fields)
    tokens: np.ndarray          # committed tokens of this segment
    generated: int              # == len(tokens)
    invocations: int            # model calls spent on this segment
    streamed: int               # tokens of this segment already streamed


def percentile(values, q: float) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))
