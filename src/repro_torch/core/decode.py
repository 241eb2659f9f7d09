"""Blockwise parallel decoding (paper §3–§5) and the greedy baseline, as in
``repro.core.decode``: the decoder-only model (``bpd_decode``,
``greedy_decode``) and the encoder-decoder (``bpd_decode_seq2seq``,
``greedy_decode_seq2seq``).

One model invocation per iteration verifies the current block and drafts
the next (§4 combined scoring), so an output of length m costs
(m / mean-k̂) + 1 invocations instead of m.  The reference's
``lax.while_loop`` is a Python loop here with the same condition; per-row
accepted block sizes let every batch row advance at its own rate.

One departure from the reference's structure, at the drafter seam: the
reference materializes every head's logits (B, k, K, V) each iteration and
the drafter takes their argmax.  Here ``Backend.head_logits`` is replaced by
``p1_logits`` (p_1 at every slot, for the acceptor and for proposal slot 0)
and ``head_topk`` (heads p_2.. at the accepted slot only, through the
fused-heads kernel, logits never written).  The tokens are the reference's:
the heads act per position, and slot 0 is the argmax of the same p_1
logits greedy decoding reads.  A drafter that needs the heads' full logits
(``locality``'s window re-ranking) calls ``Backend.head_logits`` on the
accepted slot's hidden state alone, (B, K, V): the other policies never
call it, so they launch what they launched before.

``kv_chunk`` > 0 (``bpd_decode``, ``greedy_decode``, ``prefill_and_draft``)
bounds the prefill's attention to (S, kv_chunk) scores a layer, as the
reference's long-prefill path.  The verify blocks stay on the verify
kernels: their (k, L) scores need no bound.  A tree-drafting policy with
``kv_chunk`` raises, as the reference's does.

``bpd_decode`` and ``bpd_decode_seq2seq`` run through a
``serving.DecodeSession``, as the reference's do: ``bundles=`` (auxiliary
``core.bundle.ModelBundle``s, e.g. the ``draft_model`` policy's draft) are
bound into the policy there, and their parameters reach the loop as
``aux_params``, which the drafter reads from ``DraftInputs.aux``.
``mesh=`` (every entry point) shards the decode over a ("data", "model")
process mesh there: on sharded parameters the loop's host read becomes the
world-wide "all finished" flag (``sharding.comm.all_finished``), so every
rank runs the single-device iteration count and no rank leaves its peers
waiting in a collective.  Caches, the seq2seq decoder's and a draft
model's included, hold a rank's KV heads (``model.cache_config``).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import DecodeConfig, ModelConfig
from repro_torch.core import policy as policy_lib
from repro_torch.core.policy import DecodePolicy, DraftInputs, PolicyState
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as model_lib
from repro_torch.models import seq2seq as seq2seq_lib
from repro_torch.models.attention import tree_tables
from repro_torch.models.blocks import check_tree_supported
from repro_torch.models.layers import embed_apply
from repro_torch.sharding import comm

I32 = torch.int32


class Backend(NamedTuple):
    """Model functions the BPD loop needs."""

    embed_tokens: Callable  # (params, tokens (B,S)) -> (B,S,d)
    decode_block: Callable  # (params, h, caches, length, tree=None) -> (hidden, staged_caches)
    commit: Callable        # (caches, khat) -> caches
    p1_logits: Callable     # (params, hidden (..., d)) -> (..., Vp)
    head_topk: Callable     # (params, hidden (B, d), n, top_t=1) -> (B, n, top_t) int32
    head_logits: Callable   # (params, hidden (..., d)) -> (..., K, Vp)


def causal_lm_backend(cfg: ModelConfig) -> Backend:
    return Backend(
        embed_tokens=lambda p, t: embed_apply(p["embed"], t).to(cfg.compute_dtype),
        decode_block=lambda p, h, c, ln, tree=None: model_lib.decode_block_step(
            p, cfg, h, c, ln, tree=tree),
        commit=lambda c, kh: model_lib.commit_caches(cfg, c, kh),
        p1_logits=lambda p, h: model_lib.base_logits(p, cfg, h),
        head_topk=lambda p, h, n, top_t=1: model_lib.head_topk(p, cfg, h, n,
                                                               top_t),
        head_logits=lambda p, h: model_lib.all_head_logits(p, cfg, h),
    )


def seq2seq_backend(cfg: ModelConfig, enc_kvs, block_k: int) -> Backend:
    """The encoder-decoder's ``Backend`` over one encoded source
    (``seq2seq.encode``).  The cross attention's (B, block_k) zero
    ``q_pos`` is made here, once per decode."""
    k0 = enc_kvs[0].k
    q_pos = torch.zeros((k0.shape[0], block_k), dtype=I32, device=k0.device)
    return Backend(
        embed_tokens=lambda p, t: embed_apply(p["embed"], t).to(cfg.compute_dtype),
        decode_block=lambda p, h, c, ln, tree=None: seq2seq_lib.decode_block_step(
            p, cfg, h, c, ln, enc_kvs, q_pos, tree=tree),
        commit=lambda c, kh: model_lib.commit_caches(cfg, c, kh),
        p1_logits=lambda p, h: seq2seq_lib.base_logits(p, cfg, h),
        head_topk=lambda p, h, n, top_t=1: seq2seq_lib.head_topk(p, cfg, h, n,
                                                                 top_t),
        head_logits=lambda p, h: model_lib.all_head_logits(p, cfg, h),
    )


# ---------------------------------------------------------------------------
# One BPD iteration (predict+verify merged — paper §4, Fig. 2)
# ---------------------------------------------------------------------------


class BPDState(NamedTuple):
    tokens: torch.Tensor       # (B, buf) generated+prompt token buffer
    text_len: torch.Tensor     # (B,) tokens valid in the buffer
    proposals: torch.Tensor    # (B, k) next block proposals
    caches: Any                # per-layer caches
    finished: torch.Tensor     # (B,) bool
    iters: int                 # model invocations in the loop
    generated: torch.Tensor    # (B,) int32 — accepted tokens so far
    policy_state: PolicyState = PolicyState()


def _freeze_rows(frozen, old, new):
    """Keep the old policy-state rows where ``frozen`` is True.  A tensor
    the drafter wrote in place (``new is old``, the draft model's cache)
    is its own to keep: ``DraftModelDrafter`` rewrites a frozen row's
    entries with their own values."""
    if new is old:
        return new
    if isinstance(new, torch.Tensor):
        mask = frozen.reshape((-1,) + (1,) * (new.dim() - 1))
        return torch.where(mask, old, new)
    if isinstance(new, dict):
        return {k: _freeze_rows(frozen, old[k], v) for k, v in new.items()}
    return type(new)(_freeze_rows(frozen, o, n) for o, n in zip(old, new))


def bpd_iteration(params, cfg: ModelConfig, dec: DecodeConfig,
                  backend: Backend, state: BPDState, *, prefix_offset: int,
                  max_new, active=None,
                  policy: Optional[DecodePolicy] = None,
                  aux_params=None) -> BPDState:
    """One combined predict/verify/accept step.

    max_new : int or (B,) int32 — per-row generation budget.
    active  : optional (B,) bool — rows with ``active == False`` accept
              nothing and keep their state frozen, like finished rows.
    aux_params : optional {bundle name: params} of the session's auxiliary
              bundles, handed to the drafter as ``DraftInputs.aux``.
    The attention caches are written in place (see ``attn_cached``).
    """
    pol = policy_lib.resolve_policy(dec, policy)
    block_k = dec.block_k or cfg.bpd_k
    dev = state.proposals.device
    slots = torch.arange(block_k, dtype=I32, device=dev)[None, :]
    pos_len = state.text_len + prefix_offset
    topo = pol.drafter.tree_topology(block_k)
    if topo is not None and getattr(pol.schedule, "min_block", 1) > 1:
        raise NotImplementedError(
            "tree verification with min_block > 1 would commit tokens "
            "beyond the accepted root-to-leaf path")
    if topo is not None:
        check_tree_supported(cfg)

    # ---- parallel scoring of the k proposals (verify ∧ next-predict) ------
    h = backend.embed_tokens(params, state.proposals)
    hidden, staged = backend.decode_block(params, h, state.caches, pos_len,
                                          tree=topo)
    p1_logits = backend.p1_logits(params, hidden)           # (B, k, Vp)

    # ---- verify ------------------------------------------------------------
    if topo is None:
        accepts = pol.acceptor.accepts(state.proposals, p1_logits)
        commit_tokens = state.proposals
    else:
        accepts, path_nodes = _tree_accepts(pol, topo, state.proposals,
                                            p1_logits)
        commit_tokens = torch.gather(
            state.proposals, 1, path_nodes.clamp(0, block_k - 1).long())
    remaining = torch.clamp(max_new - state.generated, min=1)
    khat, sched_state = pol.schedule.block_size(
        accepts, remaining, state.policy_state.schedule)    # (B,) in [1, k]
    frozen = state.finished if active is None else (state.finished | ~active)
    khat = torch.where(frozen, 0, khat).to(I32)

    # ---- EOS handling -------------------------------------------------------
    if dec.eos_id >= 0:
        iseos = (commit_tokens == dec.eos_id) & (slots < khat[:, None])
        has_eos = iseos.any(dim=1)
        first_eos = torch.argmax(iseos.to(I32), dim=1)
        khat = torch.where(has_eos, first_eos + 1, khat).to(I32)
    else:
        has_eos = torch.zeros_like(state.finished)

    # ---- accept -------------------------------------------------------------
    widx = (state.text_len[:, None] + slots).long()
    wmask = slots < khat[:, None]
    tokens = state.tokens.clone()
    tokens.scatter_(1, widx, torch.where(wmask, commit_tokens,
                                         tokens.gather(1, widx)))
    caches = backend.commit(staged, khat)
    if topo is not None:
        # move the accepted path's K/V into chain slots so later iterations
        # see an ordinary committed chain
        caches = model_lib.commit_tree_path(cfg, caches, path_nodes, khat,
                                            pos_len, block_k)
    generated = state.generated + khat
    finished = state.finished | has_eos | (generated >= max_new)

    # ---- next-block proposals (drafted from this same invocation) ----------
    slot = torch.clamp(khat - 1, min=0)
    if topo is not None:
        # the accepted slot is the path's node at depth k̂-1 (root for k̂=0)
        slot = torch.gather(path_nodes, 1, slot.long()[:, None])[:, 0]
        slot = torch.clamp(slot, min=0)
    # the committed token at the new text_len - 1: the last accepted slot,
    # or for a frozen row the token it already holds there
    text_len = state.text_len + khat
    prev_token = tokens.gather(
        1, torch.clamp(text_len - 1, min=0).long()[:, None])[:, 0]
    draft_in = DraftInputs(
        hidden=hidden, p1_logits=p1_logits, khat=khat,
        slot=slot, text_len=text_len,
        old_proposals=commit_tokens, prev_token=prev_token,
        head_topk=functools.partial(backend.head_topk, params),
        head_logits=functools.partial(backend.head_logits, params),
        aux=aux_params or {})
    proposals, draft_state = pol.drafter.draft(
        draft_in, state.policy_state.drafter)
    proposals = torch.where(frozen[:, None], state.proposals, proposals)
    policy_state = PolicyState(
        drafter=_freeze_rows(frozen, state.policy_state.drafter, draft_state),
        schedule=_freeze_rows(frozen, state.policy_state.schedule,
                              sched_state))

    return BPDState(
        tokens=tokens,
        text_len=text_len,
        proposals=proposals,
        caches=caches,
        finished=finished,
        iters=state.iters + 1,
        generated=generated,
        policy_state=policy_state,
    )


def _tree_accepts(pol: DecodePolicy, topo, proposals, p1_logits):
    """Tree verify: node n is checked by p_1 at its PARENT node (each node's
    logits are conditioned on its own ancestor chain by the tree mask), so
    permuting p_1's slots by parent turns the tree accept into the ordinary
    chain accept (fused kernel included); the trailing slot of the
    permutation only feeds the always-true column 0.  The accepted path is
    the deepest node whose whole root path is accepted (lowest node id on
    ties).  Returns (chain-shaped accepts (B, k) for the schedule, the
    path's node at each depth (B, k), -1 past its end)."""
    b, k = proposals.shape
    tables = tree_tables(topo, proposals.device)
    acc_nodes = pol.acceptor.accepts(
        proposals, p1_logits[:, tables["verify_perm"]])           # (B, N)
    reach = [acc_nodes[:, 0]]                    # root: always accepted
    for n in range(1, k):
        reach.append(acc_nodes[:, n] & reach[topo.parents[n]])
    reach = torch.stack(reach, dim=1)
    depth = tables["depths"][None, :]
    path_len = torch.where(reach, depth + 1, 0).amax(dim=1)
    # deepest reached node; torch.argmax returns the first maximum
    chosen = torch.argmax(torch.where(reach, depth, -1), dim=1)
    accepts = tables["nodes"][None, :] < path_len[:, None]
    return accepts, tables["paths"][chosen]


def initial_draft(pol: DecodePolicy, hidden: torch.Tensor,
                  p1_logits: torch.Tensor, text_len, block_k: int, state, *,
                  prev_token, head_topk: Callable, head_logits: Callable,
                  aux_params=None):
    """Draft the FIRST block from a prefill's last position.

    ``hidden`` (B, d) and ``p1_logits`` (B, Vp) at the last context
    position are presented to the drafter as a single pseudo block slot
    (slot 0, k̂ = 1), so the same ``draft`` covers prefill and loop
    iterations.  ``text_len`` is an int or a (B,) tensor of per-row
    lengths (the serving engine's padded admission prefill);
    ``prev_token`` (B,) the committed token at ``text_len - 1`` (the last
    prompt token; BOS for seq2seq).  ``head_topk`` / ``head_logits`` are
    the ``Backend``'s with the params bound; ``aux_params`` the auxiliary
    bundles' parameters (model-backed drafters).
    """
    b = hidden.shape[0]
    dev = hidden.device
    din = DraftInputs(
        hidden=hidden[:, None], p1_logits=p1_logits[:, None],
        khat=torch.ones((b,), dtype=I32, device=dev),
        slot=torch.zeros((b,), dtype=I32, device=dev),
        text_len=torch.as_tensor(text_len, dtype=I32, device=dev).expand(b),
        old_proposals=torch.zeros((b, block_k), dtype=I32, device=dev),
        prev_token=prev_token.to(I32),
        head_topk=head_topk, head_logits=head_logits, aux=aux_params or {})
    proposals, new_state = pol.drafter.draft(din, state)
    return proposals.to(I32), new_state


# ---------------------------------------------------------------------------
# Run-to-completion entry points
# ---------------------------------------------------------------------------


def _all_finished(params, finished) -> bool:
    """The loop's exit test: every row finished, on every rank of the mesh
    when ``params`` are sharded (``comm.all_finished``), so the ranks step
    in lock-step and a data rank whose rows are done keeps stepping them
    frozen, as one device does."""
    mesh = getattr(params, "mesh", None)
    return bool(finished.all()) if mesh is None else comm.all_finished(
        mesh, finished)


def decode_stats(final) -> Dict:
    """``mean_accepted`` is the paper's headline k̂; ``invocations`` counts
    model calls (prefill + loop iterations)."""
    b = final.generated.shape[0]
    return {
        "iterations": final.iters,
        "generated": final.generated,
        "mean_accepted": float(final.generated.sum()) / max(final.iters, 1) / b,
        "invocations": final.iters + 1,
        "text_len": final.text_len,
    }


def _check_decoder(cfg: ModelConfig) -> None:
    """An encoder-only model has no decode path (the reference fails on
    its missing ``frame_embeds``; its serve launcher refuses it so)."""
    if cfg.is_encoder_only:
        raise NotImplementedError(f"{cfg.name} is encoder-only — no decode "
                                  f"path")


@torch.no_grad()
def prefill_and_draft(params, cfg: ModelConfig, dec: DecodeConfig,
                      pol: DecodePolicy, batch: Dict, caches, plens,
                      block_k: int, *, kv_chunk: int = 0, aux_params=None):
    """Prefill ``caches`` from ``batch["tokens"]`` (B, S) in one forward and
    draft each row's first block from its last real position,
    ``prefix + plens - 1``: ``plens`` is an int (every row holds S real
    tokens) or a (B,) int32 tensor (rows padded past their lengths, as the
    serving engine's admission prefill pads them; padded positions write
    K/V that stays masked until decode overwrites it).  The policy state
    is fresh, built from ``batch`` (a model-backed drafter prefills its own
    cache on ``batch["tokens"]`` with its parameters from ``aux_params``).
    ``kv_chunk`` > 0 runs the prefill's attention in chunks of that many
    keys.  Returns (caches, proposals (B, k), policy state)."""
    if kv_chunk and pol.drafter.tree_topology(block_k) is not None:
        raise ValueError(
            "tree verification is incompatible with kv_chunk, as in the "
            "reference (its chunked attention has no per-column mask "
            "override for a tree's nodes)")
    prompt = batch["tokens"]
    b = prompt.shape[0]
    dev = prompt.device
    prefix = model_lib.prefix_len(cfg, batch)
    h = model_lib.embed_inputs(params, cfg, batch)          # (B, S, d)
    positions = torch.arange(h.shape[1], dtype=I32, device=dev)
    hidden, caches = model_lib.forward_hidden(params, cfg, h,
                                              positions=positions,
                                              caches=caches, kv_chunk=kv_chunk,
                                              moe_full_capacity=True)
    if isinstance(plens, int):
        last = hidden[:, prefix + plens - 1, :]
        last_tok = prompt[:, plens - 1]
    else:
        rows = torch.arange(b, device=dev)
        last = hidden[rows, (prefix + plens - 1).long()]
        last_tok = prompt[rows, torch.clamp(plens - 1, min=0).long()]
    be = causal_lm_backend(cfg)
    ps = pol.init_state(cfg, dec, batch, b, aux=aux_params or {})
    proposals, dstate = initial_draft(
        pol, last, be.p1_logits(params, last), plens, block_k,
        ps.drafter, prev_token=last_tok,
        head_topk=functools.partial(be.head_topk, params),
        head_logits=functools.partial(be.head_logits, params),
        aux_params=aux_params)
    return caches, proposals, ps._replace(drafter=dstate)


@torch.no_grad()
def bpd_prefill_causal_lm(params, cfg: ModelConfig, dec: DecodeConfig,
                          batch: Dict, *, max_new: int, kv_chunk: int = 0,
                          policy: Optional[DecodePolicy] = None,
                          aux_params=None):
    """Prefill the caches from the prompt and produce the first proposals.
    The prompt's device is the decode's device."""
    _check_decoder(cfg)
    pol = policy_lib.resolve_policy(dec, policy)
    block_k = dec.block_k or cfg.bpd_k
    prompt = batch["tokens"]
    b, prompt_len = prompt.shape
    dev = prompt.device
    prefix = model_lib.prefix_len(cfg, batch)
    context_len = prefix + prompt_len + max_new
    caches = model_lib.init_caches(model_lib.cache_config(params, cfg), b,
                                   context_len, block_k, device=dev,
                                   backend=cache_lib.get_backend(dec))
    caches, proposals, ps = prefill_and_draft(params, cfg, dec, pol, batch,
                                              caches, prompt_len, block_k,
                                              kv_chunk=kv_chunk,
                                              aux_params=aux_params)

    buf = prompt_len + max_new + block_k
    tokens = torch.zeros((b, buf), dtype=I32, device=dev)
    tokens[:, :prompt_len] = prompt
    state = BPDState(
        tokens=tokens,
        text_len=torch.full((b,), prompt_len, dtype=I32, device=dev),
        proposals=proposals,
        caches=caches,
        finished=torch.zeros((b,), dtype=torch.bool, device=dev),
        iters=0,
        generated=torch.zeros((b,), dtype=I32, device=dev),
        policy_state=ps,
    )
    return state, prefix


@torch.no_grad()
def _bpd_decode_impl(params, cfg: ModelConfig, dec: DecodeConfig,
                     batch: Dict, *, max_new_rows=None,
                     policy: Optional[DecodePolicy] = None, kv_chunk: int = 0,
                     aux_params=None) -> Tuple[torch.Tensor, Dict]:
    """Prefill + the iteration loop for the decoder-only model, under a
    resolved (and bound) policy; ``DecodeSession.decode`` runs it."""
    max_new = dec.max_new_tokens
    pol = policy_lib.resolve_policy(dec, policy)
    state, prefix = bpd_prefill_causal_lm(params, cfg, dec, batch,
                                          max_new=max_new, kv_chunk=kv_chunk,
                                          policy=pol, aux_params=aux_params)
    be = causal_lm_backend(cfg)
    budget = max_new if max_new_rows is None else torch.as_tensor(
        max_new_rows, dtype=I32, device=state.text_len.device)
    while not _all_finished(params, state.finished) and state.iters < max_new:
        state = bpd_iteration(params, cfg, dec, be, state,
                              prefix_offset=prefix, max_new=budget, policy=pol,
                              aux_params=aux_params)
    return state.tokens, decode_stats(state)


def _session_for(params, cfg, dec, *, mesh=None, session=None, kv_chunk=0,
                 policy=None, bundles=None):
    """The ``DecodeSession`` a decode wrapper runs through: ``session``
    when given (its parameters then stand in for ``params``; cfg, dec and
    policy must match its own, and its bundles were fixed at
    construction), else a new one on ``params``' device (sharded over
    ``mesh`` when given)."""
    if session is not None:
        if session.cfg is not cfg and session.cfg != cfg:
            raise ValueError(
                f"session was built for model config {session.cfg.name!r}, "
                f"called with {cfg.name!r}: build one DecodeSession per model")
        if session.dec != dec:
            raise ValueError(
                f"session was built with {session.dec}, called with {dec}: "
                f"a session's decode config is fixed at construction — "
                f"build a new session (or call its methods directly)")
        if bundles is not None:
            raise ValueError(
                "bundles are fixed at DecodeSession construction — build "
                "the session with bundles= instead of passing them to the "
                "decode wrapper")
        if policy is not None and policy_lib.resolve_policy(dec, policy).bind(
                session.bundles, cfg) != session.policy:
            raise ValueError(
                f"session was built with policy {session.policy.name!r}, "
                f"called with {policy!r}: a session's decode policy is "
                f"fixed at construction — build a new session")
        return session
    from repro_torch.serving.session import DecodeSession  # session <- decode

    return DecodeSession(params, cfg, dec, mesh=mesh, kv_chunk=kv_chunk,
                         policy=policy, bundles=bundles)


def bpd_decode(params, cfg: ModelConfig, dec: DecodeConfig, batch: Dict, *,
               max_new_rows=None, policy=None, kv_chunk: int = 0,
               bundles=None, mesh=None,
               session=None) -> Tuple[torch.Tensor, Dict]:
    """Full blockwise parallel decode for the decoder-only model.

    Returns (tokens (B, buf), stats).  max_new_rows: optional (B,) per-row
    budgets <= dec.max_new_tokens (buffers stay sized by max_new_tokens).
    kv_chunk: > 0 bounds the prefill's score matrix (see the module).
    bundles: optional {name: core.bundle.ModelBundle} of auxiliary models
    (``{"draft": ModelBundle(draft_params, draft_cfg)}`` for the
    ``draft_model`` policy).  mesh: this rank's ``launch.mesh.Mesh``: the
    decode runs sharded over it (``DecodeSession(mesh=)``) and returns the
    whole batch on every rank.  session: a ``DecodeSession`` to run through
    (its parameters, policy and bundles; see ``_session_for``).
    """
    sess = _session_for(params, cfg, dec, mesh=mesh, session=session,
                        kv_chunk=kv_chunk, policy=policy, bundles=bundles)
    return sess.decode(batch, max_new_rows=max_new_rows)


# ---------------------------------------------------------------------------
# Seq2seq decode (the paper's MT experiments): encode once, BPD the decoder.
# ---------------------------------------------------------------------------


@torch.no_grad()
def bpd_prefill_seq2seq(params, cfg: ModelConfig, dec: DecodeConfig,
                        batch: Dict, *,
                        policy: Optional[DecodePolicy] = None,
                        aux_params=None):
    """Encode ``batch["src"]`` (B, Se), prefill the decoder's caches with BOS
    (token 0, decoder position 0) and draft the first block.  Returns
    (state, backend); the source's device is the decode's device.  A draft
    model drafts the output stream from BOS at position 0, with nothing of
    the source to prefill."""
    pol = policy_lib.resolve_policy(dec, policy)
    block_k = dec.block_k or cfg.bpd_k
    max_new = dec.max_new_tokens
    src = batch["src"]
    b = src.shape[0]
    dev = src.device
    enc_kvs = seq2seq_lib.encode(params, cfg, src)
    be = seq2seq_backend(cfg, enc_kvs, block_k)
    caches = seq2seq_lib.init_caches(model_lib.cache_config(params, cfg), b,
                                     1 + max_new, block_k, device=dev)
    bos = torch.zeros((b, 1), dtype=I32, device=dev)
    hidden, caches = seq2seq_lib.forward_hidden(params, cfg, bos, enc_kvs,
                                                caches=caches)
    last = hidden[:, -1, :]
    ps = pol.init_state(cfg, dec, batch, b, aux=aux_params or {})
    # the committed token at text_len - 1 is BOS
    proposals, dstate = initial_draft(
        pol, last, be.p1_logits(params, last), 1, block_k, ps.drafter,
        prev_token=bos[:, 0], head_topk=functools.partial(be.head_topk, params),
        head_logits=functools.partial(be.head_logits, params),
        aux_params=aux_params)
    state = BPDState(
        tokens=torch.zeros((b, 1 + max_new + block_k), dtype=I32, device=dev),
        text_len=torch.ones((b,), dtype=I32, device=dev),
        proposals=proposals,
        caches=caches,
        finished=torch.zeros((b,), dtype=torch.bool, device=dev),
        iters=0,
        generated=torch.zeros((b,), dtype=I32, device=dev),
        policy_state=ps._replace(drafter=dstate),
    )
    return state, be


@torch.no_grad()
def _bpd_decode_seq2seq_impl(params, cfg: ModelConfig, dec: DecodeConfig,
                             batch: Dict, *,
                             policy: Optional[DecodePolicy] = None,
                             aux_params=None) -> Tuple[torch.Tensor, Dict]:
    """Encode, prefill BOS and loop, under a resolved (and bound) policy;
    ``DecodeSession.decode_seq2seq`` runs it."""
    pol = policy_lib.resolve_policy(dec, policy)
    max_new = dec.max_new_tokens
    state, be = bpd_prefill_seq2seq(params, cfg, dec, batch, policy=pol,
                                    aux_params=aux_params)
    while not _all_finished(params, state.finished) and state.iters < max_new:
        state = bpd_iteration(params, cfg, dec, be, state, prefix_offset=0,
                              max_new=max_new, policy=pol,
                              aux_params=aux_params)
    return state.tokens[:, 1:], decode_stats(state)


def bpd_decode_seq2seq(params, cfg: ModelConfig, dec: DecodeConfig,
                       batch: Dict, *, policy=None, bundles=None, mesh=None,
                       session=None) -> Tuple[torch.Tensor, Dict]:
    """batch: {"src": (B, Se) int32}.  The decoder stream is BOS + output;
    returns (tokens (B, max_new + block_k) without BOS, stats).  Source
    drafters (``input_copy``) draw their state from ``batch["src"]``; the
    ``draft_model`` policy's causal draft LM (``bundles``, as in
    ``bpd_decode``) runs over the output stream.  ``mesh`` shards the decode as ``bpd_decode``'s does: the source rows
    over the batch axes, both stacks' heads over ``model``."""
    sess = _session_for(params, cfg, dec, mesh=mesh, session=session,
                        policy=policy, bundles=bundles)
    return sess.decode_seq2seq(batch)


def greedy_decode_seq2seq(params, cfg: ModelConfig, dec: DecodeConfig,
                          batch: Dict, *, mesh=None,
                          session=None) -> Tuple[torch.Tensor, Dict]:
    """The greedy baseline through the BPD machinery at block size 1;
    ``session`` (built with ``block_k=1``) or ``mesh`` as in
    ``bpd_decode_seq2seq``."""
    if session is not None:
        if (session.dec.block_k or session.cfg.bpd_k) != 1:
            raise ValueError(
                f"greedy_decode_seq2seq needs a session built with "
                f"block_k=1, got block_k="
                f"{session.dec.block_k or session.cfg.bpd_k}")
        return session.decode_seq2seq(batch)
    return bpd_decode_seq2seq(params, cfg, dec.replace(block_k=1), batch,
                              mesh=mesh)


# ---------------------------------------------------------------------------
# Greedy baseline (paper §2): block size 1, p_1 only.
# ---------------------------------------------------------------------------


class GreedyState(NamedTuple):
    tokens: torch.Tensor       # (B, buf) prompt+output token buffer
    text_len: torch.Tensor     # (B,) tokens valid in the buffer
    tok: torch.Tensor          # (B,) next token to commit
    caches: Any
    finished: torch.Tensor     # (B,) bool
    iters: int                 # decode steps taken
    generated: torch.Tensor    # (B,) int32 — committed tokens so far


def greedy_decode(params, cfg: ModelConfig, dec: DecodeConfig,
                  batch: Dict, *, kv_chunk: int = 0, mesh=None,
                  session=None) -> Tuple[torch.Tensor, Dict]:
    """Greedy decoding with p_1 (the paper's baseline); ``kv_chunk`` as in
    ``bpd_decode``.  ``mesh`` / ``session`` run it through a
    ``DecodeSession`` (sharded over the mesh), as ``bpd_decode`` does."""
    if mesh is None and session is None:
        return _greedy_decode_impl(params, cfg, dec, batch, kv_chunk=kv_chunk)
    return _session_for(params, cfg, dec, mesh=mesh, session=session,
                        kv_chunk=kv_chunk).greedy(batch)


@torch.no_grad()
def _greedy_decode_impl(params, cfg: ModelConfig, dec: DecodeConfig,
                        batch: Dict, *,
                        kv_chunk: int = 0) -> Tuple[torch.Tensor, Dict]:
    """Prefill + the greedy loop; ``DecodeSession.greedy`` runs it."""
    _check_decoder(cfg)
    max_new = dec.max_new_tokens
    prompt = batch["tokens"]
    b, prompt_len = prompt.shape
    dev = prompt.device
    prefix = model_lib.prefix_len(cfg, batch)
    context_len = prefix + prompt_len + max_new
    caches = model_lib.init_caches(model_lib.cache_config(params, cfg), b,
                                   context_len, 1, device=dev,
                                   backend=cache_lib.get_backend(dec))

    h = model_lib.embed_inputs(params, cfg, batch)
    positions = torch.arange(h.shape[1], dtype=I32, device=dev)
    hidden, caches = model_lib.forward_hidden(params, cfg, h,
                                              positions=positions,
                                              caches=caches, kv_chunk=kv_chunk,
                                              moe_full_capacity=True)
    logits = model_lib.base_logits(params, cfg, hidden[:, -1, :])

    buf = prompt_len + max_new + 1
    tokens = torch.zeros((b, buf), dtype=I32, device=dev)
    tokens[:, :prompt_len] = prompt
    s = GreedyState(
        tokens=tokens,
        text_len=torch.full((b,), prompt_len, dtype=I32, device=dev),
        tok=model_lib.greedy_token(logits),
        caches=caches,
        finished=torch.zeros((b,), dtype=torch.bool, device=dev),
        iters=0,
        generated=torch.zeros((b,), dtype=I32, device=dev),
    )

    while not _all_finished(params, s.finished) and s.iters < max_new:
        live = ~s.finished
        adv = live.to(I32)
        idx = s.text_len.long()[:, None]
        tokens = s.tokens.clone()
        tokens.scatter_(1, idx, torch.where(live[:, None], s.tok[:, None],
                                            tokens.gather(1, idx)))
        h = embed_apply(params["embed"], s.tok[:, None]).to(cfg.compute_dtype)
        hidden, staged = model_lib.decode_block_step(params, cfg, h, s.caches,
                                                     s.text_len + prefix)
        caches = model_lib.commit_caches(cfg, staged, adv)
        new_tok = model_lib.greedy_token(
            model_lib.base_logits(params, cfg, hidden[:, 0, :]))
        text_len = s.text_len + adv
        finished = s.finished
        if dec.eos_id >= 0:
            finished = finished | (s.tok == dec.eos_id)
        finished = finished | (text_len - prompt_len >= max_new)
        s = GreedyState(tokens=tokens, text_len=text_len,
                        tok=torch.where(finished, s.tok, new_tok),
                        caches=caches, finished=finished, iters=s.iters + 1,
                        generated=s.generated + adv)
    return s.tokens, decode_stats(s)
