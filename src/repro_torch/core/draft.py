"""Draft-model speculative drafting, as ``repro.core.draft``: a small causal
LM proposes the block, the verifier checks it in one invocation.

``DraftModelDrafter`` is a ``core.policy.Drafter`` backed by an auxiliary
``core.bundle.ModelBundle``, bound at session construction through
``DecodePolicy.bind``; the bundle's parameters arrive per call in
``DraftInputs.aux``.  Its loop-carried state is the draft model's own
dense KV cache, a per-row policy state like any other: it freezes with
finished rows, and the serving engine scatters it on admission and resets
it on eviction.  Slot 0 of every draft is the verifier's greedy token, the
routine every port drafter takes for slot 0, so exact acceptance emits
greedy's tokens for ANY draft model; draft quality moves iteration counts
only.

Cache discipline (why one catch-up token is enough): the chain drafted at
text length L covers positions L-1..L+k-2 (the catch-up token, slot 0,
the chain), and the verifier commits a prefix of that chain, so after
k̂ accepted tokens the draft cache holds the committed stream except,
when k̂ = k, position L+k-1.  Each draft therefore re-feeds the committed
token at ``text_len - 1`` first; entries beyond ``text_len`` are stale and
hidden by the absolute-position masking that rolls back BPD's own cache
(``models/cache.py``).  That argument holds for KV caches only, hence the
attention-family restriction on the draft config.

One departure from the reference, forced by in-place caches: the
reference keeps a frozen row's old draft cache functionally, while here
every forward writes the cache in place.  A frozen row (k̂ = 0: finished,
an empty engine slot, or a window's masked iteration) therefore re-drafts
the block it already holds, from the committed token at ``text_len - 1``
and its current slot-0 proposal, which rewrites the entries it wrote when
it drafted that block with the same values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import policy as policy_lib
from repro_torch.models import model as model_lib
from repro_torch.models.layers import embed_apply

I32 = torch.int32

DRAFT_BUNDLE = "draft"  # the session bundle name this drafter reads


@dataclasses.dataclass(frozen=True)
class DraftModelDrafter(policy_lib.Drafter):
    """Propose ``block_k`` tokens with a small causal draft LM.

    Unbound (``cfg is None``) until ``DecodePolicy.bind`` attaches the
    session's ``bundles["draft"]``; the parameters arrive per call through
    ``DraftInputs.aux["draft"]``.  ``carry_over`` folds the catch-up token
    into the first extension as one width-2 forward, so an iteration makes
    ``block_k - 1`` sequential draft forwards instead of ``block_k``, with
    the same tokens: the rewrite at ``text_len - 1`` is value-identical and
    masking by absolute position hides the stale ``text_len`` entry from it.
    """

    cfg: Optional[ModelConfig] = None      # the DRAFT model's config
    kv_chunk: int = 0
    backend_factory: Optional[Callable] = None
    bundle: str = DRAFT_BUNDLE
    carry_over: bool = True

    # -- binding --------------------------------------------------------------

    def bind(self, bundles: Dict, cfg) -> "DraftModelDrafter":
        if cfg is not None and cfg.num_meta_tokens:
            raise NotImplementedError(
                f"the 'draft_model' policy cannot verify for {cfg.name!r}: "
                f"its {cfg.num_meta_tokens} meta tokens prefix every "
                f"sequence, so the primary's positions run "
                f"{cfg.num_meta_tokens} ahead of the draft's output-stream "
                f"positions (the reference fails on that meta prefix offset "
                f"with a broadcast error)")
        b = (bundles or {}).get(self.bundle)
        if b is None:
            raise ValueError(
                f"the 'draft_model' policy runs a second model: pass "
                f"bundles={{{self.bundle!r}: ModelBundle(draft_params, "
                f"draft_cfg)}} to the DecodeSession / decode entry point "
                f"(got bundles={sorted(bundles or {})})")
        d = b.cfg
        if d.block_type != "attn":
            raise NotImplementedError(
                f"draft model {d.name!r} has block_type={d.block_type!r}: "
                f"the draft cache rolls back rejected speculation by "
                f"absolute-position masking, which only KV caches support "
                f"— recurrent draft states would keep rejected tokens")
        if d.is_encoder_decoder or d.is_encoder_only:
            raise ValueError(
                f"draft model {d.name!r} must be decoder-only: it drafts "
                f"the output token stream autoregressively")
        if d.num_meta_tokens or d.modality != "text":
            raise NotImplementedError(
                f"draft model {d.name!r} must be a plain text LM (no meta "
                f"tokens / modality prefixes): draft positions are output-"
                f"stream positions")
        if cfg is not None and d.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft model vocab_size={d.vocab_size} != primary model "
                f"vocab_size={cfg.vocab_size}: proposals are token ids in "
                f"the primary vocabulary")
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(DraftModelDrafter)}
        fields.update(cfg=d, kv_chunk=b.kv_chunk,
                      backend_factory=b.backend_factory)
        rank_cfg = model_lib.cache_config(b.params, d)
        if rank_cfg is d:
            return DraftModelDrafter(**fields)
        return ShardedDraftModelDrafter(rank_cfg=rank_cfg, **fields)

    @property
    def cache_cfg(self) -> Optional[ModelConfig]:
        """The config the draft's caches are laid out under: ``cfg``."""
        return self.cfg

    def _require_bound(self):
        if self.cfg is None:
            raise ValueError(
                "DraftModelDrafter is unbound — resolve the 'draft_model' "
                "policy through a DecodeSession (or call DecodePolicy.bind) "
                "with a 'draft' ModelBundle before decoding")

    def _backend(self):
        from repro_torch.core.decode import causal_lm_backend  # decode <- policy

        if self.backend_factory is not None:
            return self.backend_factory(self.cfg, self.kv_chunk)
        return causal_lm_backend(self.cfg)

    # -- state ----------------------------------------------------------------

    def init_state(self, cfg, dec, batch, b, aux=()) -> Any:
        """The draft's dense KV cache for ``b`` rows at ``prompt_len +
        max_new + block_k`` positions (a rank's KV heads of the draft when
        its bundle is sharded), prefilled on ``batch["tokens"]`` when
        ``aux`` holds the draft's parameters.  Its geometry never
        depends on ``aux``, so the engine's paramless init and evict states
        match its admission prefill's.  Without ``tokens`` (seq2seq) the
        draft stream starts at BOS, position 0, with nothing to prefill."""
        self._require_bound()
        block_k = dec.block_k or cfg.bpd_k
        tokens = batch.get("tokens") if isinstance(batch, dict) else None
        dev = next(iter(batch.values())).device if batch else None
        prompt_len = 1 if tokens is None else tokens.shape[1]
        context = prompt_len + dec.max_new_tokens + block_k
        caches = model_lib.init_caches(self.cache_cfg, b, context, 1,
                                       device=dev)
        params = aux.get(self.bundle) if aux else None
        if params is not None and tokens is not None:
            h = embed_apply(params["embed"], tokens.to(I32))
            h = h.to(self.cfg.compute_dtype)
            positions = torch.arange(h.shape[1], dtype=I32, device=h.device)
            _, caches = model_lib.forward_hidden(
                params, self.cfg, h, positions=positions, caches=caches,
                kv_chunk=self.kv_chunk, moe_full_capacity=True)
        return {"caches": caches}

    # -- drafting -------------------------------------------------------------

    def draft(self, inputs: policy_lib.DraftInputs, state: Any):
        self._require_bound()
        if not (inputs.aux and self.bundle in inputs.aux):
            raise ValueError(
                f"DraftModelDrafter needs its params in DraftInputs.aux"
                f"[{self.bundle!r}] — this decode path was not built with "
                f"the session's auxiliary bundles threaded through")
        params = inputs.aux[self.bundle]
        be = self._backend()
        b, k = inputs.old_proposals.shape
        dev = inputs.old_proposals.device
        ones = torch.ones((b,), dtype=I32, device=dev)
        caches = state["caches"]

        def forward(toks, caches, pos):
            """Feed ``toks`` (B, w) at per-row positions ``pos``..; the
            draft's greedy token after the last of them."""
            h = be.embed_tokens(params, toks)
            hidden, staged = be.decode_block(params, h, caches, pos)
            caches = be.commit(staged, ones)
            logits = be.p1_logits(params, hidden[:, -1])
            return model_lib.greedy_token(logits), caches

        # slot 0: the verifier's greedy token at the accepted slot, the
        # token every drafter proposes there; a frozen row keeps its own
        verified = model_lib.greedy_token(
            policy_lib._gather_slot(inputs.p1_logits, inputs.slot))
        verified = torch.where(inputs.khat == 0, inputs.old_proposals[:, 0],
                               verified)
        prev = inputs.prev_token.to(I32)
        pos0 = torch.clamp(inputs.text_len - 1, min=0).to(I32)

        props = [verified]
        if self.carry_over and k > 1:
            # the catch-up token and slot 0 in one width-2 forward at
            # [text_len-1, text_len]
            tok, caches = forward(torch.stack([prev, verified], dim=1),
                                  caches, pos0)
            props.append(tok)
            start = 2
        else:
            # catch-up: re-feed the committed token at text_len - 1; its
            # prediction is discarded (slot 0 is the verifier's)
            _, caches = forward(prev[:, None], caches, pos0)
            tok = verified
            start = 1
        for i in range(start, k):
            tok, caches = forward(tok[:, None], caches, pos0 + i)
            props.append(tok)
        return torch.stack(props, dim=1), {"caches": caches}

    def draft_steps_per_iter(self, block_k: int) -> int:
        """Sequential draft-model forwards per BPD iteration."""
        if self.carry_over and block_k > 1:
            return block_k - 1
        return block_k


@dataclasses.dataclass(frozen=True)
class ShardedDraftModelDrafter(DraftModelDrafter):
    """A ``DraftModelDrafter`` bound to a bundle sharded over a mesh
    (``sharding.shard_bundles``): its forwards run on the rank's blocks of
    the draft, and its caches hold the draft's KV heads of this rank,
    ``rank_cfg`` (``model.cache_config``).  A subclass rather than a field
    of ``DraftModelDrafter``, so that the registry's unbound drafter keeps
    the reference's fields exactly (``tests/test_torch_policy.py`` compares
    every field of each registered policy with the reference's)."""

    rank_cfg: Optional[ModelConfig] = None

    @property
    def cache_cfg(self) -> Optional[ModelConfig]:
        return self.rank_cfg


policy_lib.register_policy("draft_model", lambda dec: policy_lib.DecodePolicy(
    DraftModelDrafter(),
    policy_lib._maybe_fused(policy_lib.ExactAcceptor(), dec),
    policy_lib._schedule_for(dec), name="draft_model"))
