"""Mixture-of-Experts MLP with capacity-bounded top-k routing, as
``repro.models.moe`` (olmoe-1b-7b: 64 experts top-8; qwen2-moe-a2.7b: 60
experts padded to 64, top-4, plus a shared MLP behind a sigmoid gate).

Routing runs in fp32: softmax over the router's logits, the top K
probabilities (ties to the lower expert id, as ``jax.lax.top_k`` breaks
them), renormalised to sum to 1.  Two ways to apply the experts:

* **capacity-bounded** (training): each batch row is a dispatch group in
  which an expert takes at most ``capacity`` assignments, in the row's
  flattened (S, K) order; the rest are dropped and contribute zero.  The
  kept ones go through the reference's (B, E, C, d) buffer.
* **full capacity** (every decode, prefill and engine step): nothing is
  dropped, so each token's output is Σ_k ĝ_k·FFN_{e_k}(x).  Every token goes
  through every real expert, (E, T, d) × (E, d, ff) batched products, and
  the outputs are summed with the gates as weights (zero where an expert
  was not chosen).  Shapes depend on the batch alone and nothing syncs
  with the host, so the launches are a function of the shapes.  Pad
  experts are never chosen and are not computed.

On a ``model``-sharded ``ParamTree`` the experts lie over ``model`` (the
reference's ``maybe_shard_expert``: ``w1`` / ``w2`` / ``w3`` cut by
expert): the router stays whole and runs on the whole ``x`` on every
rank, so every rank chooses the same experts; a rank computes only its
own real experts (the last rank's pad experts never), each capacity slot
from the whole row's ``assignment_ranks`` (so drops are one device's), and
the routed partial and the shared expert's row-parallel partial (``shared
/w2`` cut over its hidden width) are added in fp32 and summed in one
``all_reduce`` (``comm.partial_sum``).  The metrics and the router's
logits are whole on every rank.

``ROUTER_TRACE``: when set to a callable, every MoE layer calls it as
``ROUTER_TRACE(layer_idx, positions (B, S) int, logits (B, S, E) fp32)``
(``models.blocks``), so a caller can see which experts each decode chose
at each position.  None (the default) costs one test per layer.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import (
    GATED_ACTIVATIONS,
    activation,
    dense_apply,
    dense_init,
    mlp_apply,
    normal,
)
from repro_torch.sharding import comm

ROUTER_TRACE: Optional[Callable] = None


def moe_init(gen, cfg: ModelConfig, *, dtype=torch.float32,
             device=None) -> Dict:
    """The reference's leaves and shapes: ``router.w`` (d, E); ``w1`` /
    ``w3`` (E_pad, d, ff) and ``w2`` (E_pad, ff, d); with shared experts
    ``shared.{w1,w3,w2,gate}.w``."""
    d, ff, ep = cfg.d_model, cfg.d_ff, cfg.padded_num_experts
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": dense_init(gen, d, cfg.num_experts, **kw),
        "w1": normal(gen, (ep, d, ff), std=1.0 / math.sqrt(d), **kw),
        "w2": normal(gen, (ep, ff, d), std=1.0 / math.sqrt(ff), **kw),
    }
    if cfg.activation in GATED_ACTIVATIONS:
        p["w3"] = normal(gen, (ep, d, ff), std=1.0 / math.sqrt(d), **kw)
    if cfg.num_shared_experts:
        sff = cfg.shared_expert_d_ff or cfg.num_shared_experts * ff
        p["shared"] = {
            "w1": dense_init(gen, d, sff, **kw),
            "w3": dense_init(gen, d, sff, **kw),
            "w2": dense_init(gen, sff, d, **kw),
            "gate": dense_init(gen, d, 1, **kw),
        }
    return p


def _expert_ffn(p, x, act: str):
    """x: (n, C, d) -> (n, C, d), row block i through expert i: batched
    products over the experts' own weights (never broadcast, so never
    copied)."""
    n = x.shape[0]
    h = torch.bmm(x, p["w1"][:n].to(x.dtype))
    if "w3" in p:
        h = activation("silu" if act == "geglu" else act, h) * torch.bmm(
            x, p["w3"][:n].to(x.dtype))
    else:
        h = activation(act, h)
    return torch.bmm(h, p["w2"][:n].to(x.dtype))


def top_experts(probs, k: int):
    """(..., E) -> (..., k) ids of the k largest probabilities, ordered by
    (probability desc, id asc): a stable sort, as ``jax.lax.top_k`` breaks
    ties (``torch.topk`` promises no order among equal values)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def route(p, cfg: ModelConfig, x):
    """x (B, S, d) -> (logits, probs) (B, S, E) fp32, and the renormalised
    gates and expert ids (B, S, K) of each token's top K."""
    logits = dense_apply(p["router"], x.float())
    probs = torch.softmax(logits, dim=-1)
    ids = top_experts(probs, cfg.num_experts_per_tok)
    gates = probs.gather(-1, ids)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return logits, probs, gates, ids


def assignment_ranks(ids):
    """ids (..., A) int -> rank[..., a] = #{a' < a : ids[a'] == ids[a]}: a
    stable sort by expert, each assignment's place in its expert's segment,
    scattered back to assignment order."""
    a = ids.shape[-1]
    sorted_e, order = torch.sort(ids, dim=-1, stable=True)
    idx = torch.arange(a, device=ids.device).expand_as(ids)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    return torch.empty_like(idx).scatter_(-1, order, idx - seg_start)


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert in a row of ``s`` tokens when capacity-bounded."""
    c = int(max(1, cfg.capacity_factor * cfg.num_experts_per_tok * s
                / cfg.num_experts))
    return min(c, s)


def local_experts(p, cfg: ModelConfig) -> Tuple[int, int]:
    """(the global id of this rank's first expert, its real experts): (0,
    ``num_experts``) when the experts are whole.  Pad experts, the last of
    ``padded_num_experts``, are never chosen and never computed."""
    if comm.cut(p, "w1") is None:
        return 0, cfg.num_experts
    n = p["w1"].shape[0]
    lo = p.mesh.coords["model"] * n
    return lo, max(0, min(n, cfg.num_experts - lo))


def _bounded(p, cfg: ModelConfig, x, gates, ids, cap: int, experts, dtype):
    """The capacity-bounded dispatch: per row, the kept assignments of the
    ``experts`` (first id, count) into their (n, cap) buffer, the experts,
    the gated sum in ``dtype``.  Returns (y, keep): ``keep`` over every
    assignment, from the row's whole ranks."""
    b, s, d = x.shape
    k = cfg.num_experts_per_tok
    lo, n = experts
    flat = ids.reshape(b, s * k)
    rank = assignment_ranks(flat)
    keep = rank < cap
    local = flat - lo
    mine = keep & (local >= 0) & (local < n)
    slot = torch.where(mine, local * cap + rank, n * cap)
    src = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    idx = slot[..., None].expand(b, s * k, d)
    xin = torch.zeros((b, n * cap + 1, d), dtype=x.dtype, device=x.device)
    xin = xin.scatter(1, idx, src)          # the dump row collects the rest
    per_expert = xin[:, :n * cap].reshape(b, n, cap, d).transpose(0, 1)
    xout = _expert_ffn(p, per_expert.reshape(n, b * cap, d), cfg.activation)
    xout = xout.reshape(n, b, cap, d).transpose(0, 1).reshape(b, n * cap, d)
    xout = torch.cat([xout, torch.zeros((b, 1, d), dtype=x.dtype,
                                        device=x.device)], 1)
    g = xout.gather(1, idx).reshape(b, s, k, d).to(dtype)
    w = (gates * mine.reshape(b, s, k)).to(dtype)
    return torch.einsum("bskd,bsk->bsd", g, w), keep


def _full(p, cfg: ModelConfig, x, gates, ids, experts, dtype):
    """Full capacity: every token through each of the ``experts`` (first
    id, count), summed in ``dtype`` with its gate where the expert was
    chosen (zero elsewhere)."""
    b, s, d = x.shape
    lo, n = experts
    weight = torch.zeros((b, s, cfg.num_experts), dtype=gates.dtype,
                         device=x.device)
    weight = weight.scatter(-1, ids, gates).to(dtype)[..., lo:lo + n]
    xout = _expert_ffn(p, x.reshape(1, b * s, d).expand(n, b * s, d),
                       cfg.activation)
    return torch.einsum("etd,te->td", xout.to(dtype), weight.reshape(b * s, n)
                        ).reshape(b, s, d)


def moe_metrics(cfg: ModelConfig, logits, probs, ids, kept
                ) -> Dict[str, torch.Tensor]:
    """The Switch-Transformer load-balance loss, the router z-loss and the
    dropped share of assignments, fp32 scalars."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = ids.shape[0] * ids.shape[1]
    density = torch.bincount(ids.reshape(-1), minlength=e).float() / (t * k)
    proxy = probs.reshape(t, e).mean(dim=0)
    return {
        "moe_aux_loss": e * (density * proxy).sum(),
        "moe_z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
        "moe_dropped_frac": 1.0 - torch.as_tensor(
            kept, dtype=torch.float32, device=logits.device) / (t * k),
    }


def moe_apply(p, cfg: ModelConfig, x, *, full_capacity: bool = False,
              metrics: bool = True, trace: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (y, metrics).  ``full_capacity`` drops nothing (the
    decode path: a dropped token would break BPD's greedy equivalence);
    otherwise each row's experts take ``capacity(cfg, S)``
    assignments.  ``metrics`` False skips the three metrics (the decode
    path reads none); ``trace`` is called with the router's logits.  With
    the experts over ``model`` the ranks' fp32 partials are summed once
    (see the module)."""
    b, s, _ = x.shape
    logits, probs, gates, ids = route(p, cfg, x)
    if trace is not None:
        trace(logits.detach())
    experts = local_experts(p, cfg)
    sharded = comm.cut(p, "w1") is not None
    dtype = torch.float32 if sharded else x.dtype
    if full_capacity:
        y = _full(p, cfg, x, gates, ids, experts, dtype)
        kept = b * s * cfg.num_experts_per_tok
    else:
        y, keep = _bounded(p, cfg, x, gates, ids, capacity(cfg, s), experts,
                           dtype)
        kept = keep.sum()
    shared = None
    if "shared" in p:
        sp = p["shared"]
        g = torch.sigmoid(dense_apply(sp["gate"], x).float()).to(x.dtype)
        if sharded and comm.cut(sp["w2"], "w") is not None:
            h = F.silu(dense_apply(sp["w1"], x)) * dense_apply(sp["w3"], x)
            y = y + g.float() * comm.partial(
                h.reshape(b * s, -1), sp["w2"]["w"]).reshape(y.shape)
        else:
            shared = g * mlp_apply(sp, x, act="silu")
    if sharded:
        y = comm.partial_sum(p.mesh, y, x.dtype)
    if shared is not None:
        y = y + shared
    return y, (moe_metrics(cfg, logits, probs, ids, kept) if metrics else {})
