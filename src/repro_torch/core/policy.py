"""Decode policies: Drafter × Acceptor × BlockSchedule (base layer of
``repro.core.policy``).

  * ``Acceptor``      — (proposals, verify p_1 logits) -> per-position
    accepts.  ``ExactAcceptor`` is §3 (token-identical to greedy),
    ``TopKAcceptor`` §5.1, ``DistanceAcceptor`` §5.2.
  * ``BlockSchedule`` — accept mask -> per-row block size k̂.
    ``StaticSchedule`` is §5.3's minimum block size; ``AdaptiveSchedule``
    caps k̂ per row from the running acceptance rate.
  * ``Drafter``       — the next block of k proposals from the verify
    forward.  ``HeadsDrafter`` is the paper's prediction heads;
    ``InputCopyDrafter`` copies the source (seq2seq);
    ``TopKTreeDrafter`` drafts a candidate tree verified in one forward;
    ``LocalityDrafter`` interpolates an image's committed neighbours
    (with ``LocalitySchedule``, the ``locality`` policy);
    ``core.draft.DraftModelDrafter`` runs a second, small model (an
    auxiliary ``core.bundle.ModelBundle``, bound by ``DecodePolicy.bind``).

Index convention (0-based within a block): ``proposals[:, i]`` proposes the
token at ``text_len + i``, and slot 0 of a fresh draft is the model's own
verified greedy token (k̂ >= 1 is unconditional), so drafts change
iteration counts, never tokens.

Registered: ``exact``, ``topk``, ``distance``, ``adaptive``,
``input_copy``, ``topk_tree``, ``locality`` and ``draft_model``: every
policy the reference registers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.config import DecodeConfig
from repro_torch.data.synthetic import locality_plan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.tree_mask import default_tree
from repro_torch.models.attention import tree_tables
from repro_torch.models.model import greedy_token

I32 = torch.int32


class PolicyState(NamedTuple):
    """Loop-carried policy state; leaves are batch-leading (B, …) tensors,
    ``()`` means stateless."""

    drafter: Any = ()
    schedule: Any = ()


class DraftInputs(NamedTuple):
    """What one verify forward exposes to a ``Drafter``.

    The reference hands drafters every head's logits (B, k, K, V).  The port
    hands them the verify forward's hidden states and p_1 logits, plus
    ``head_topk``, which projects heads p_2.. at one position through the
    fused-heads kernel and returns their top-T ids, so the heads' logits
    are never materialized, and ``head_logits``, which computes every
    head's logits at the positions it is given (the reference's
    ``all_head_logits``) for a drafter that needs them: only the
    accepted slot's, (B, K, Vp), and only when the drafter calls it.
    ``aux`` carries the session's auxiliary bundles' parameters to a drafter
    that runs a model of its own (``core.draft.DraftModelDrafter``).
    """

    hidden: torch.Tensor        # (B, k, d) final hidden states at every slot
    p1_logits: torch.Tensor     # (B, k, Vp) p_1 logits at every slot
    khat: torch.Tensor          # (B,) accepted block size this iteration
    slot: torch.Tensor          # (B,) accepted slot index = max(k̂ - 1, 0)
    text_len: torch.Tensor      # (B,) text length AFTER accepting this block
    old_proposals: torch.Tensor  # (B, k) the block that was just verified
    head_topk: Callable         # (hidden (B, d), n, top_t=1) -> (B, n, top_t)
                                # top-T ids of heads p_2..p_{n+1}
    prev_token: Optional[torch.Tensor] = None  # (B,) committed token at
                                # text_len - 1 (for a frozen row too)
    head_logits: Optional[Callable] = None  # (hidden (B, d)) -> (B, K, Vp)
                                # logits of heads p_1..p_K
    aux: Any = ()               # {bundle name: params} of the session's
                                # auxiliary models (model-backed drafters)


def _gather_slot(x: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """x: (B, k, ...) gathered at per-row slot -> (B, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), slot.long()]


# ---------------------------------------------------------------------------
# Acceptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Acceptor:
    """Per-position acceptance rule; slot 0 is always accepted (k̂ >= 1).

    On the card ``accepts`` runs the fused-verify kernel whenever the
    acceptor has a fused form.  On the CPU ``fused=True``
    (``DecodeConfig.fused_verify``) takes the kernel's plain version and
    ``False`` the ``position_ok`` path; the two are token-identical.
    """

    fused: bool = False

    def accepts(self, proposals: torch.Tensor,
                p1_logits: torch.Tensor) -> torch.Tensor:
        """proposals (B, k) int32, p1_logits (B, k, V) -> (B, k) bool."""
        b, k = proposals.shape
        spec = self.fused_spec()
        if spec is not None and (self.fused or p1_logits.is_cuda):
            acc, _, _, _ = ops.fused_verify(p1_logits[:, :k], proposals, **spec)
            return acc
        ok = self.position_ok(proposals[:, 1:], p1_logits[:, :k - 1])
        return torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                     device=ok.device), ok], dim=1)

    def fused_spec(self) -> Optional[Dict]:
        """kwargs for ``kernels.ops.fused_verify`` (None: no fused form)."""
        return None

    def position_ok(self, cand, ver_logits):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ExactAcceptor(Acceptor):
    """§3: accept while the proposal equals the model's greedy token."""

    def position_ok(self, cand, ver_logits):
        return cand == greedy_token(ver_logits)

    def fused_spec(self):
        return {"criterion": "exact"}


@dataclasses.dataclass(frozen=True)
class TopKAcceptor(Acceptor):
    """§5.1: accept any proposal inside the verifier's top-k set (ties
    ranked by lowest id, as ``lax.top_k``)."""

    top_k: int = 1

    def position_ok(self, cand, ver_logits):
        _, ids = ref.top_t_ids(ver_logits, self.top_k)
        return torch.any(ids == cand[..., None], dim=-1)

    def fused_spec(self):
        return {"criterion": "topk", "top_k": self.top_k}


@dataclasses.dataclass(frozen=True)
class DistanceAcceptor(Acceptor):
    """§5.2: ordinal vocabularies — accept proposals within ``epsilon`` of
    the greedy token id."""

    epsilon: float = 0.0

    def position_ok(self, cand, ver_logits):
        return (cand - greedy_token(ver_logits)).abs() <= self.epsilon

    def fused_spec(self):
        return {"criterion": "distance", "epsilon": self.epsilon}


# ---------------------------------------------------------------------------
# Block schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockSchedule:
    """Turns per-position accepts into a per-row block size k̂."""

    def init_state(self, b: int, device=None) -> Any:
        return ()

    def block_size(self, accepts, remaining, state):
        """accepts (B, k) bool, remaining (B,) int32 ->
        (k̂ (B,) int32 in [1, min(k, remaining)], new state)."""
        raise NotImplementedError


def _prefix_len(accepts: torch.Tensor) -> torch.Tensor:
    """Longest accepted prefix per row: (B, k) bool -> (B,) int32."""
    return torch.cumprod(accepts.to(I32), dim=1).sum(dim=1).to(I32)


@dataclasses.dataclass(frozen=True)
class StaticSchedule(BlockSchedule):
    """§5.3 minimum block size: k̂ = max(prefix, min_block), clamped to the
    remaining budget."""

    min_block: int = 1

    def block_size(self, accepts, remaining, state):
        khat = _prefix_len(accepts)
        if self.min_block > 1:
            khat = torch.clamp(khat, min=min(self.min_block, accepts.shape[1]))
        return torch.clamp(torch.minimum(khat, remaining), min=1).to(I32), state


@dataclasses.dataclass(frozen=True)
class AdaptiveSchedule(BlockSchedule):
    """Dynamic §5.3: a per-row cap on k̂ driven by the running acceptance
    rate.  An fp32 EMA of k̂/cap grows the cap by one above ``grow`` and
    shrinks it by one below ``shrink``.

    State (per row): ``rate`` fp32 EMA, ``cap`` int32 (starts at int32 max,
    clipped into [floor, k] at use)."""

    min_block: int = 1
    decay: float = 0.7
    grow: float = 0.8
    shrink: float = 0.4

    def init_state(self, b: int, device=None) -> Any:
        return {"rate": torch.ones((b,), dtype=torch.float32, device=device),
                "cap": torch.full((b,), torch.iinfo(I32).max, dtype=I32,
                                  device=device)}

    def block_size(self, accepts, remaining, state):
        k = accepts.shape[1]
        floor = max(min(self.min_block, k), 1)
        cap = torch.clamp(state["cap"], floor, k)
        accepted = torch.minimum(torch.clamp(_prefix_len(accepts), min=floor),
                                 cap)
        khat = torch.clamp(torch.minimum(accepted, remaining), min=1).to(I32)
        # rate tracks the un-clamped acceptance (the budget clamp at the end
        # of a row's generation says nothing about proposal quality)
        rate = (self.decay * state["rate"]
                + (1 - self.decay) * accepted.float() / cap.float())
        cap = torch.where(rate >= self.grow, torch.clamp(cap + 1, max=k),
                          torch.where(rate <= self.shrink,
                                      torch.clamp(cap - 1, min=floor), cap))
        return khat, {"rate": rate, "cap": cap.to(I32)}


# ---------------------------------------------------------------------------
# Drafters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Drafter:
    """Produces the next block of proposals from the verify forward.

    ``init_state`` sees the decode's batch (or the engine's zeroed
    admission batch) and returns batch-leading tensors, or ``()``.  ``aux``
    holds the auxiliary bundles' parameters where the caller has them
    (decode prefill, engine admission); the engine's init and evict pass
    ``()``, and a model-backed drafter makes state of the same shapes
    either way.  ``bind`` attaches the static half of the session's
    bundles before any decode; the default needs no second model."""

    def init_state(self, cfg, dec: DecodeConfig, batch: Optional[Dict],
                   b: int, aux: Any = ()) -> Any:
        return ()

    def bind(self, bundles: Dict, cfg) -> "Drafter":
        """bundles: {name: core.bundle.ModelBundle}; cfg: the PRIMARY
        model's config (for the cross-model checks)."""
        return self

    def tree_topology(self, block_k: int):
        """The static ``kernels.tree_mask.TreeTopology`` this drafter's
        proposals form, or None for chain drafts.  Non-None switches
        ``bpd_iteration`` to tree verification."""
        return None

    def draft(self, inputs: DraftInputs, state: Any):
        """-> (proposals (B, k) int32 with slot 0 = verified token, state).
        For a tree drafter slot n is the token of tree node n."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class HeadsDrafter(Drafter):
    """The paper's proposal mechanism at the accepted slot: slot 0 is p_1's
    argmax (the routine greedy decoding uses, on the same logits), slot i
    is head p_{i+1}'s top-1 from the fused-heads kernel.  Gathering the
    slot before the heads gives the reference's ids, since the heads act
    per position."""

    def draft(self, inputs: DraftInputs, state: Any):
        k = inputs.old_proposals.shape[1]
        first = greedy_token(_gather_slot(inputs.p1_logits, inputs.slot))
        if k == 1:
            return first[:, None], state
        rest = inputs.head_topk(_gather_slot(inputs.hidden, inputs.slot), k - 1)
        return torch.cat([first[:, None], rest[:, :, 0]], dim=1), state


@dataclasses.dataclass(frozen=True)
class InputCopyDrafter(Drafter):
    """Aggressive-Decoding-style drafts for seq2seq (arXiv:2205.10350):
    slot 0 is p_1's argmax at the accepted slot, as in ``HeadsDrafter``;
    slot i >= 1 copies the source token aligned with its output position,
    ``src[text_len - 1 + offset + i]`` clipped into the source (decoder
    position 0 is BOS, so output index = position - 1).  Lossless under
    exact acceptance."""

    offset: int = 0

    def init_state(self, cfg, dec, batch, b, aux=()):
        if batch is None or "src" not in batch:
            raise ValueError(
                "InputCopyDrafter drafts from batch['src'] and is only "
                "meaningful for seq2seq decoding — use HeadsDrafter (or a "
                "custom drafter) for decoder-only models")
        return {"src": batch["src"].to(I32)}

    def draft(self, inputs: DraftInputs, state):
        src = state["src"]
        k = inputs.old_proposals.shape[1]
        first = greedy_token(_gather_slot(inputs.p1_logits, inputs.slot))
        out_idx = (inputs.text_len[:, None] - 1 + self.offset
                   + torch.arange(k, dtype=I32, device=src.device)[None, :])
        copied = torch.gather(src, 1, out_idx.clamp(0, src.shape[1] - 1).long())
        return torch.cat([first[:, None], copied[:, 1:]], dim=1), state


@dataclasses.dataclass(frozen=True)
class TopKTreeDrafter(Drafter):
    """Drafts a candidate tree that the verifier scores in one forward
    (tree verification, arXiv:2404.09221): node 0 is p_1's argmax at the
    accepted slot (the verified token), and the node at depth d >= 1 with
    sibling rank r carries head p_{d+1}'s r-th id there (one fused-heads
    launch for every depth).  The topology is ``default_tree(block_k,
    fanout)``: ``fanout`` children of the root, then a top-1 chain below
    the first, so the heads chain is always a subtree.  Stateless and
    lossless under exact acceptance."""

    fanout: int = 4

    def tree_topology(self, block_k: int):
        return default_tree(block_k, self.fanout)

    def draft(self, inputs: DraftInputs, state: Any):
        k = inputs.old_proposals.shape[1]
        topo = self.tree_topology(k)
        first = greedy_token(_gather_slot(inputs.p1_logits, inputs.slot))
        if k == 1:
            return first[:, None], state
        need = int(topo.ranks.max()) + 1
        ids = inputs.head_topk(_gather_slot(inputs.hidden, inputs.slot),
                               topo.max_depth, need)      # (B, D, need)
        tables = tree_tables(topo, ids.device)
        head = tables["depths"][1:].long() - 1            # p_{d+1} is row d-1
        rest = ids[:, head, tables["ranks"][1:]]
        return torch.cat([first[:, None], rest], dim=1), state


# ---------------------------------------------------------------------------
# Locality-aware image decoding (arXiv:2507.01957)
# ---------------------------------------------------------------------------


class _LocalityTables(NamedTuple):
    order: np.ndarray          # (H*W,) generation slot -> raster index
    boundaries: np.ndarray     # class-end offsets (block cut points)
    next_boundary: np.ndarray  # (H*W + 1,) smallest boundary > p
    n1: np.ndarray             # (H*W,) committed-neighbor generation index
    n2: np.ndarray
    coarse_len: int            # boundaries[0] — the coarse-lattice prefix


@functools.lru_cache(maxsize=None)
def _locality_tables(height: int, width: int, stride: int) -> _LocalityTables:
    order, bounds, n1, n2 = locality_plan(height, width, stride)
    n = order.size
    nb = np.full(n + 1, n + (1 << 20), np.int64)   # "no boundary left"
    for p in range(n + 1):
        j = int(np.searchsorted(bounds, p, side="right"))
        if j < bounds.size:
            nb[p] = bounds[j]
    return _LocalityTables(order, bounds, nb.astype(np.int32), n1, n2,
                           int(bounds[0]))


@functools.lru_cache(maxsize=None)
def _locality_device_tables(height: int, width: int, stride: int,
                            device) -> Dict[str, torch.Tensor]:
    """``n1``, ``n2`` and ``next_boundary`` as int64 tensors on ``device``,
    made once per geometry and device (callers never write to them)."""
    t = _locality_tables(height, width, stride)
    return {name: torch.as_tensor(getattr(t, name), dtype=torch.int64,
                                  device=device)
            for name in ("n1", "n2", "next_boundary")}


@dataclasses.dataclass(frozen=True)
class LocalityDrafter(Drafter):
    """Locality-aware image drafts (arXiv:2507.01957).

    The token stream is an (height, width) raster serialized in the
    progressive-lattice order of ``data.synthetic.locality_plan`` (coarse
    lattice first, then non-adjacent refinement classes), so every
    refinement position has committed spatial neighbours: the drafter
    proposes their rounded average, then (``window`` > 0) re-ranks the
    ±window neighbourhood of that average by each slot's head logits at
    the accepted slot (``DraftInputs.head_logits``; head p_{i+1} scores
    slot i, the last head the slots beyond).  State is the committed
    stream in generation order, ``grid`` (B, H*W + k), re-built from each
    verified block.  Slot 0 stays p_1's argmax, so exact acceptance is
    lossless on any prompt.
    """

    height: int = 0
    width: int = 0
    stride: int = 4
    window: int = 1

    def init_state(self, cfg, dec, batch, b, aux=()):
        n = self.height * self.width
        k = dec.block_k or getattr(cfg, "bpd_k", 1)
        dev = batch["tokens"].device if batch and "tokens" in batch else None
        buf = torch.zeros((b, n + max(int(k), 1)), dtype=I32, device=dev)
        if batch is not None and "tokens" in batch:
            toks = batch["tokens"][:, :n]
            buf[:, :toks.shape[1]] = toks
        return {"grid": buf}

    def draft(self, inputs: DraftInputs, state):
        buf = state["grid"]
        b, k = inputs.old_proposals.shape
        cap = buf.shape[1]
        dev = buf.device
        tables = _locality_device_tables(self.height, self.width, self.stride,
                                         dev)
        n1, n2 = tables["n1"], tables["n2"]
        # 1. commit the just-verified block into the generation-order
        #    buffer; slot k̂-1 carries prev_token (on the prefill call, with
        #    the old proposals zero and k̂ = 1, the last prompt token)
        offs = torch.arange(k, device=dev)[None, :]
        khat = inputs.khat.long()[:, None]
        idx = torch.clamp(inputs.text_len.long()[:, None] - khat + offs,
                          0, cap - 1)
        vals = torch.where(offs == khat - 1, inputs.prev_token[:, None].to(I32),
                           inputs.old_proposals.to(I32))
        buf = buf.scatter(1, idx, torch.where(offs < khat, vals,
                                              buf.gather(1, idx)))
        # 2. propose: each next position interpolates its committed parents
        pos = torch.clamp(inputs.text_len.long()[:, None] + offs, 0,
                          n1.shape[0] - 1)
        a = buf.gather(1, torch.clamp(n1[pos], 0, cap - 1))
        c = buf.gather(1, torch.clamp(n2[pos], 0, cap - 1))
        proposals = torch.div(a + c + 1, 2, rounding_mode="floor")
        if self.window:
            hl = inputs.head_logits(_gather_slot(inputs.hidden, inputs.slot))
            hl = hl[:, :k]                                   # (B, heads, Vp)
            vocab = hl.shape[-1]
            hidx = torch.clamp(torch.arange(k, device=dev), max=hl.shape[1] - 1)
            deltas = torch.arange(-self.window, self.window + 1, device=dev)
            cands = torch.clamp(proposals[..., None] + deltas, 0, vocab - 1)
            scores = torch.gather(hl[:, hidx, :], -1, cands.long())
            pick = torch.argmax(scores, dim=-1, keepdim=True)   # first max
            proposals = torch.gather(cands, -1, pick)[..., 0]
        first = greedy_token(_gather_slot(inputs.p1_logits, inputs.slot))
        proposals = torch.cat([first[:, None], proposals[:, 1:].to(I32)], dim=1)
        return proposals, {"grid": buf}


@dataclasses.dataclass(frozen=True)
class LocalitySchedule(BlockSchedule):
    """Clamps each accepted block at the next offset-class boundary of the
    progressive-lattice order, so a block never commits positions whose
    spatial parents are still uncommitted.  State: a per-row generation
    cursor ``pos`` starting at ``start`` (the coarse prompt length in the
    image workload; another prompt length only cuts blocks at other
    places, still lossless under exact acceptance)."""

    height: int = 0
    width: int = 0
    stride: int = 4
    start: int = 0

    def init_state(self, b: int, device=None) -> Any:
        return {"pos": torch.full((b,), self.start, dtype=I32, device=device)}

    def block_size(self, accepts, remaining, state):
        nb = _locality_device_tables(self.height, self.width, self.stride,
                                     accepts.device)["next_boundary"]
        pos = state["pos"]
        room = nb[torch.clamp(pos, 0, nb.shape[0] - 1).long()] - pos
        khat = torch.minimum(_prefix_len(accepts),
                             torch.minimum(remaining, room))
        khat = torch.clamp(khat, min=1).to(I32)
        return khat, {"pos": (pos + khat).to(I32)}


# ---------------------------------------------------------------------------
# The composed policy + registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecodePolicy:
    """Drafter × Acceptor × BlockSchedule behind every decode path."""

    drafter: Drafter
    acceptor: Acceptor
    schedule: BlockSchedule
    name: str = "custom"

    def init_state(self, cfg, dec: DecodeConfig, batch: Optional[Dict],
                   b: int, aux: Any = ()) -> PolicyState:
        """Fresh per-row state for ``b`` rows.  ``batch`` is the decode's
        batch, or the serving engine's zeroed ``{"tokens", "src"}`` of its
        admission geometry (the state's device and shapes come from it);
        ``aux`` the auxiliary bundles' parameters, where the caller has
        them."""
        device = next(iter(batch.values())).device if batch else None
        return PolicyState(
            drafter=self.drafter.init_state(cfg, dec, batch, b, aux=aux),
            schedule=self.schedule.init_state(b, device))

    def bind(self, bundles: Dict, cfg) -> "DecodePolicy":
        """Attach the session's auxiliary ``ModelBundle``s (their static
        half) to the drafter: a no-op for single-model policies, while a
        model-backed drafter checks and absorbs its bundle here, so a
        missing or incompatible draft model fails before any decode.  On a
        mesh every policy binds as on one device: a drafter reads the
        model through ``DraftInputs`` (whole logits, whole hidden states,
        ids merged over the vocab shards) and keeps its per-row state
        batch-leading, so it sees a rank's rows as one device sees its
        batch; a draft model's bundle arrives sharded
        (``sharding.shard_bundles``)."""
        drafter = self.drafter.bind(bundles or {}, cfg)
        if drafter is self.drafter:
            return self
        return dataclasses.replace(self, drafter=drafter)

    @property
    def cache_key(self):
        """Hashable structural identity: two policies with equal drafter /
        acceptor / schedule parameters share the serving functions built
        for them, while ``topk(top_k=2)`` and ``topk(top_k=3)`` (same
        ``name``) key apart."""
        return policy_cache_key(self)


def policy_cache_key(obj):
    """Reduce a policy (or any of its components) to a hashable tuple:
    frozen dataclasses flatten to ``(type, (field, value), ...)``
    recursively; everything else must already be hashable."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, policy_cache_key(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(policy_cache_key(x) for x in obj)
    return obj


POLICY_BUILDERS: Dict[str, Callable[[DecodeConfig], DecodePolicy]] = {}


def register_policy(name: str,
                    builder: Callable[[DecodeConfig], DecodePolicy]) -> None:
    if name in POLICY_BUILDERS:
        raise ValueError(f"duplicate policy registration: {name!r}")
    POLICY_BUILDERS[name] = builder


def list_policies() -> list:
    return sorted(POLICY_BUILDERS)


def resolve_policy(dec: DecodeConfig,
                   policy: Union[None, str, DecodePolicy] = None
                   ) -> DecodePolicy:
    """Precedence: an explicit ``DecodePolicy`` > an explicit name >
    ``dec.policy`` > the legacy ``dec.criterion`` alias."""
    if isinstance(policy, DecodePolicy):
        return policy
    name = policy or dec.policy or dec.criterion
    builder = POLICY_BUILDERS.get(name)
    if builder is None:
        raise ValueError(f"unknown decode policy {name!r}; "
                         f"registered: {list_policies()}")
    return builder(dec)


def _maybe_fused(acceptor: Acceptor, dec: DecodeConfig) -> Acceptor:
    """Honor ``DecodeConfig.fused_verify`` (the CPU path's choice)."""
    if dec.fused_verify:
        return dataclasses.replace(acceptor, fused=True)
    return acceptor


def _schedule_for(dec: DecodeConfig) -> BlockSchedule:
    return StaticSchedule(min_block=dec.min_block)


register_policy("exact", lambda dec: DecodePolicy(
    HeadsDrafter(), _maybe_fused(ExactAcceptor(), dec), _schedule_for(dec),
    name="exact"))
register_policy("topk", lambda dec: DecodePolicy(
    HeadsDrafter(), _maybe_fused(TopKAcceptor(top_k=dec.top_k), dec),
    _schedule_for(dec), name="topk"))
register_policy("distance", lambda dec: DecodePolicy(
    HeadsDrafter(), _maybe_fused(DistanceAcceptor(epsilon=dec.epsilon), dec),
    _schedule_for(dec), name="distance"))
register_policy("adaptive", lambda dec: DecodePolicy(
    HeadsDrafter(), _maybe_fused(ExactAcceptor(), dec),
    AdaptiveSchedule(min_block=dec.min_block), name="adaptive"))
register_policy("input_copy", lambda dec: DecodePolicy(
    InputCopyDrafter(), _maybe_fused(ExactAcceptor(), dec), _schedule_for(dec),
    name="input_copy"))
register_policy("topk_tree", lambda dec: DecodePolicy(
    TopKTreeDrafter(fanout=max(dec.top_k, 2)),
    _maybe_fused(ExactAcceptor(), dec), _schedule_for(dec), name="topk_tree"))


def _locality_policy(dec: DecodeConfig) -> DecodePolicy:
    h, w = dec.image_height, dec.image_width
    if h <= 0 or w <= 0:
        raise ValueError(
            "policy 'locality' needs the 2-D raster geometry: set "
            "DecodeConfig.image_height / image_width (and optionally "
            "locality_stride) to the grid shape of the token stream")
    tables = _locality_tables(h, w, dec.locality_stride)
    return DecodePolicy(
        LocalityDrafter(height=h, width=w, stride=dec.locality_stride),
        _maybe_fused(ExactAcceptor(), dec),
        LocalitySchedule(height=h, width=w, stride=dec.locality_stride,
                         start=tables.coarse_len),
        name="locality")


register_policy("locality", _locality_policy)

# the model-backed drafter lives in core.draft (it pulls in the decode
# backend); importing it registers "draft_model", as the reference does
from repro_torch.core import draft as _draft  # noqa: E402,F401  (registration)
