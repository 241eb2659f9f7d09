"""Sharding policy, as ``repro.sharding.policy``: which dimension of each
parameter, cache and decode-state tensor lies over which mesh axis.

Scheme (Megatron-style tensor parallelism):
  * ``model`` axis: attention heads / kv heads, FFN width, experts, vocab,
    SSM inner channels, BPD head hidden width.
  * ``data`` (+ ``pod``) axes: the batch dimension of activations, caches
    and inputs.
  * Norm scales, routers, token-shift anchors, small LoRA factors: replicated.

A spec is a tuple with one entry per dimension: an axis name, a tuple of
axis names, or None (replicated); a one-name tuple is the name itself, as a
``jax.sharding.PartitionSpec`` normalises it, so a spec here equals
``tuple(PartitionSpec(...))`` of the reference.  The functions read only a
mesh's ``shape`` ({axis: size}) and ``axis_names``.

The reference's GSPMD places the blocks; here ``shard_params`` cuts this
rank's block of every leaf (the counterpart of ``jax.device_put(params,
param_shardings(params, mesh))``), and ``model.init(mesh=)`` does so leaf
by leaf as it draws.  One departure: where the KV heads do not divide the
``model`` axis, the reference shards the cache's length over ``model`` and
replicates the paged pool; the port keeps, unsharded, the KV head its rank's
query heads read (``local_kv_heads``), the same function in another layout.
Mamba's ``in_proj`` (u and z side by side) is cut in each half
(``SPLIT_LEAVES``): a rank keeps the same channels of both, which is what
the reference's global layout means once GSPMD has moved the halves.

The port's path reads ``PARAM_RULES`` (through ``shard_params`` /
``shard_leaves``, and ``shard_bundles`` for a session's auxiliary models),
``batch_axes``, ``prefill_axes``, ``batch_shard`` and ``local_kv_heads``
(and ``local_channels`` for the recurrent caches); the serving engine reads
``slot_owner`` and ``packet_pod``, plain functions every rank computes
alike.  The spec tables ``param_specs``, ``bundle_param_specs``,
``data_spec``, ``batch_specs``, ``cache_specs``, ``state_specs``,
``slot_specs``, ``packet_specs`` and ``data_axis_size`` are kept to be held
against the reference's, leaf by leaf, and are read by nothing else:
``cache_specs`` describes the reference's cache layout (the length sharded
where the KV heads do not divide ``model``), which the port's caches do not
have.  Its one addition is the encoder-decoder's cross K/V (``.../cross/k``
and ``/v``, computed once a source), which the reference leaves to GSPMD's
propagation and the port holds at a rank's KV heads, as a self-attention
cache.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.utils.tree import flatten_with_names


def spec(*entries) -> Tuple:
    """A spec tuple, each one-name tuple entry replaced by the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


# ('a/b/c' param path regex, spec) — first match wins
PARAM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # --- embeddings / unembedding -------------------------------------------
    (r"(^|/)embed/table$", ("model", None)),
    (r"(^|/)src_embed/table$", ("model", None)),
    (r"(^|/)lm_head/w$", (None, "model")),
    (r"(^|/)pos_embed$", ()),
    (r"(^|/)enc_pos$", ()),
    (r"(^|/)meta_tokens$", ()),
    (r"(^|/)mask_embed$", ()),
    # --- attention ------------------------------------------------------------
    (r"(attn|cross)/wq$", (None, "model", None)),
    (r"(attn|cross)/wk$", (None, "model", None)),
    (r"(attn|cross)/wv$", (None, "model", None)),
    (r"(attn|cross)/wo$", ("model", None, None)),
    # --- MoE -------------------------------------------------------------------
    (r"moe/router/", ()),
    (r"moe/w1$", ("model", None, None)),
    (r"moe/w2$", ("model", None, None)),
    (r"moe/w3$", ("model", None, None)),
    (r"moe/shared/w1/w$", (None, "model")),
    (r"moe/shared/w3/w$", (None, "model")),
    (r"moe/shared/w2/w$", ("model", None)),
    (r"moe/shared/gate/", ()),
    # --- dense MLP --------------------------------------------------------------
    (r"mlp/w1/w$", (None, "model")),
    (r"mlp/w3/w$", (None, "model")),
    (r"mlp/w2/w$", ("model", None)),
    # --- RWKV6 -------------------------------------------------------------------
    (r"tm/w[rkvg]$", (None, "model")),
    (r"tm/wo$", ("model", None)),
    (r"tm/u$", ("model", None)),
    (r"tm/(mu|mu_x|mix_A|mix_B|w0|decay_A|decay_B)$", ()),
    (r"tm/ln_x/", ()),
    (r"cm/wk$", (None, "model")),
    (r"cm/wv$", ("model", None)),
    (r"cm/wr$", (None, "model")),
    (r"cm/mu_[kr]$", ()),
    # --- Mamba (hymba SSM heads) ---------------------------------------------------
    (r"mamba/in_proj/w$", (None, "model")),
    (r"mamba/conv_w$", (None, "model")),
    (r"mamba/conv_b$", ("model",)),
    (r"mamba/x_proj/w$", ("model", None)),
    (r"mamba/dt_proj/w$", (None, "model")),
    (r"mamba/dt_proj/b$", ("model",)),
    (r"mamba/A_log$", ("model", None)),
    (r"mamba/D$", ("model",)),
    (r"mamba/out_proj/w$", ("model", None)),
    # --- BPD heads (the paper's multi-output layer) ---------------------------------
    (r"bpd_heads/w1$", (None, None, "model")),
    (r"bpd_heads/b1$", (None, "model")),
    (r"bpd_heads/w2$", (None, "model", None)),
    (r"bpd_heads/b2$", ()),
)

DEFAULT_SPEC: Tuple = ()  # norms, biases, scalars


def _spec_for(name: str) -> Tuple:
    for pattern, s in PARAM_RULES:
        if re.search(pattern, name):
            return s
    return DEFAULT_SPEC


def _axis_size(mesh, ax) -> int:
    return math.prod(mesh.shape[a] for a in (ax if isinstance(ax, tuple)
                                             else (ax,)))


def _divisible(s: Tuple, shape, mesh) -> Tuple:
    """Drop sharding on dims the array does not divide evenly (replicated
    there), as the reference's pjit argument shardings require."""
    out = []
    for dim, ax in zip(shape, tuple(s) + (None,) * (len(shape) - len(s))):
        out.append(None if ax is None or dim % _axis_size(mesh, ax) else ax)
    return spec(*out)


def param_specs(params, mesh) -> Dict[str, Tuple]:
    """{'/'-path name: spec} of every leaf of ``params`` at its full shape."""
    return {name: _divisible(_spec_for(name), tuple(x.shape), mesh)
            for name, x in flatten_with_names(params)}


def bundle_param_specs(bundles: Dict, mesh) -> Dict[str, Dict[str, Tuple]]:
    """{bundle name: ``param_specs``} of a ``{name: core.bundle.ModelBundle}``
    mapping: every bundle's parameters go through the same path-rule table
    as the primary's (the reference's ``bundle_param_shardings``)."""
    return {name: param_specs(b.params, mesh) for name, b in bundles.items()}


# ---------------------------------------------------------------------------
# Batch / activation / cache specs
# ---------------------------------------------------------------------------


def batch_axes(mesh, batch_size: int):
    """Mesh axes to shard the batch dim over (None = replicate)."""
    names = mesh.axis_names
    cand = tuple(a for a in ("pod", "data") if a in names)
    if cand:
        n = math.prod(mesh.shape[a] for a in cand)
        if n and batch_size % n == 0:
            return cand
    if "data" in names and batch_size % mesh.shape["data"] == 0:
        return ("data",)
    return None


def prefill_axes(mesh, batch_size: int):
    """Mesh axes a prefill-worker batch shards over: the ``pod`` axis alone
    (None = replicated: on pod-less meshes, and where the width does not
    divide the pod axis, as the batch-1 admission's prefill)."""
    if ("pod" in mesh.axis_names and mesh.shape["pod"] > 1
            and batch_size % mesh.shape["pod"] == 0):
        return ("pod",)
    return None


def batch_shard(mesh, batch_size: int, axes: Any = "auto") -> Tuple[int, int]:
    """(number of shards, this rank's shard) of a ``batch_size`` batch split
    over ``axes`` (default ``batch_axes``), row-major over the axes as
    GSPMD lays out ``P(("pod", "data"))``; (1, 0) where it is replicated."""
    if axes == "auto":
        axes = batch_axes(mesh, batch_size)
    n, i = 1, 0
    for a in axes or ():
        n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.coords[a]
    return n, i


def slot_owner(mesh, num_slots: int, slot: int) -> int:
    """The shard (``batch_shard``'s index) that keeps slot ``slot`` of a
    group of ``num_slots``: every rank of that shard holds the slot's rows
    (its ``model`` ranks, and its pod replicas where the group shards over
    ``data`` alone); 0 where the group is replicated."""
    n, _ = batch_shard(mesh, num_slots)
    return slot // (num_slots // n)


def packet_pod(mesh, width: int, row: int) -> Optional[int]:
    """The pod that prefills row ``row`` of a ``width``-wide prefill batch,
    or None where every rank prefills every row (``prefill_axes``)."""
    if prefill_axes(mesh, width) is None:
        return None
    return row // (width // mesh.shape["pod"])


def data_spec(mesh, batch_size: int, ndim: int) -> Tuple:
    """(batch_axes, None, ...) for a batch-leading array."""
    return spec(*([batch_axes(mesh, batch_size)] + [None] * (ndim - 1)))


def batch_specs(mesh, batch: Dict) -> Dict[str, Tuple]:
    """Every batch leaf sharded on its leading dim."""
    return {k: data_spec(mesh, x.shape[0], x.dim()) for k, x in batch.items()}


def cache_specs(cfg: ModelConfig, caches, mesh, batch_size: int, *,
                ax: Any = "auto") -> Dict[str, Tuple]:
    """Decode caches: batch over data axes; kv heads over model where the
    head count divides the axis, else (the reference's layout) the buffer
    length over model; the paged pool never over the data axes.  ``ax``
    overrides the batch-dim axes.  Returns {'/'-path name: spec}."""
    if ax == "auto":
        ax = batch_axes(mesh, batch_size)
    msz = mesh.shape.get("model", 1)
    kv_divides = cfg.num_kv_heads and cfg.num_kv_heads % msz == 0

    def one(name: str, x) -> Tuple:
        shape = tuple(x.shape)
        if "/cross/" in name and name[-2:] in ("/k", "/v"):
            # the encoder's K/V (B, Se, KV, hd): a rank's KV heads
            return _divisible((ax, None, "model", None), shape, mesh)
        if "/attn/" in name and name.endswith(("/kp", "/vp")):
            if kv_divides:
                return _divisible((None, None, "model", None), shape, mesh)
            return ()
        if name.endswith("/tbl"):
            return spec(ax, None)
        if name.endswith("/pos"):
            if not kv_divides and len(shape) == 2 and shape[1] % msz == 0:
                return spec(ax, "model")
            return spec(ax, None)
        if "/attn/" in name and name[-2:] in ("/k", "/v"):
            if kv_divides:
                return _divisible((ax, None, "model", None), shape, mesh)
            return _divisible((ax, "model", None, None), shape, mesh)
        if "/tm/" in name:  # rwkv: state (B,H,D,D), shifts (B,d)
            if "state" in name:
                return _divisible((ax, "model", None, None), shape, mesh)
            return spec(ax, None)
        if "/mamba/" in name:
            if name.endswith("/h") or "h_steps" in name:
                return _divisible((ax, "model", None), shape, mesh)
            return _divisible((ax, None, "model"), shape, mesh)
        return spec(*([ax] + [None] * (len(shape) - 1)))

    return {name: one(name, x) for name, x in flatten_with_names(caches)}


# ---------------------------------------------------------------------------
# Loop-carried decode state specs (BPDState / GreedyState / SlotBatch)
# ---------------------------------------------------------------------------


def state_specs(cfg: ModelConfig, state, mesh, *,
                batch_size: Optional[int] = None,
                draft_cfg: Optional[ModelConfig] = None, policy: Any = None,
                ax: Any = "auto") -> Dict[str, Tuple]:
    """{'/'-path name: spec} for a batch-leading decode loop state (a
    NamedTuple: ``BPDState``, ``GreedyState``, ``SlotBatch``).  Its
    ``caches`` get ``cache_specs``; every other (B, ...) leaf, the policy
    state's included, shards its leading dim over the data axes; scalars
    and non-tensors are replicated.  A drafter state holding ``"caches"``
    (the ``draft_model`` policy's draft KV cache) gets ``cache_specs``
    under ``draft_cfg``, the draft's own config, read off ``policy``'s
    drafter when only the (bound) policy is given.  ``ax`` overrides the
    batch-dim axes (a prefill packet's)."""
    if draft_cfg is None and policy is not None:
        draft_cfg = getattr(policy.drafter, "cfg", None)
    b = batch_size if batch_size is not None else state.tokens.shape[0]
    if ax == "auto":
        ax = batch_axes(mesh, b)

    def leaf(x) -> Tuple:
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == b:
            return spec(*([ax] + [None] * (x.dim() - 1)))
        return ()

    def leaves(prefix: str, tree) -> Dict[str, Tuple]:
        if isinstance(tree, torch.Tensor) or not isinstance(
                tree, (dict, list, tuple)):
            return {prefix: leaf(tree)}
        return {f"{prefix}/{n}": leaf(x)
                for n, x in flatten_with_names(tree)}

    out: Dict[str, Tuple] = {}
    for name, val in state._asdict().items():
        if name == "caches" and val is not None:
            out.update({f"caches/{n}": s for n, s in cache_specs(
                cfg, val, mesh, b, ax=ax).items()})
        elif name == "policy_state" and hasattr(val, "drafter"):
            dstate = val.drafter
            if (draft_cfg is not None and isinstance(dstate, dict)
                    and "caches" in dstate):
                for k, v in dstate.items():
                    at = f"policy_state/drafter/{k}"
                    out.update({f"{at}/{n}": s for n, s in cache_specs(
                        draft_cfg, v, mesh, b, ax=ax).items()}
                        if k == "caches" else leaves(at, v))
            else:
                out.update(leaves("policy_state/drafter", dstate))
            out.update(leaves("policy_state/schedule", val.schedule))
        else:
            out.update(leaves(name, val))
    return out


def slot_specs(cfg: ModelConfig, slots, mesh, *,
               draft_cfg: Optional[ModelConfig] = None,
               policy: Any = None) -> Dict[str, Tuple]:
    """Specs of a serving group's ``SlotBatch``: the slot dim is the decode
    batch dim (``state_specs``), so a group's slots shard over pod×data
    (falling back to data alone) and admission's writes stay on the
    owning shard.  ``policy`` (the group's bound policy) specs a draft
    model's cache under the draft's config."""
    return state_specs(cfg, slots, mesh, batch_size=slots.tokens.shape[0],
                       draft_cfg=draft_cfg, policy=policy)


def packet_specs(cfg: ModelConfig, packet, mesh, *,
                 draft_cfg: Optional[ModelConfig] = None,
                 policy: Any = None) -> Dict[str, Tuple]:
    """Specs of a prefill worker's handoff packet: as ``state_specs`` with
    the width dim over ``prefill_axes`` (the pod axis alone); attaching a
    row into the pod×data slot slab is the prefill→decode handoff."""
    b = packet.tokens.shape[0]
    return state_specs(cfg, packet, mesh, batch_size=b, draft_cfg=draft_cfg,
                       policy=policy, ax=prefill_axes(mesh, b))


def data_axis_size(mesh) -> int:
    """Number of shards the batch/slot dim splits into on this mesh."""
    return math.prod(mesh.shape[a] for a in ("pod", "data")
                     if a in mesh.axis_names)


# ---------------------------------------------------------------------------
# This rank's blocks
# ---------------------------------------------------------------------------


def local_kv_heads(cfg: ModelConfig, model: int) -> int:
    """The KV heads one rank of a ``model``-wide axis keeps: all of them
    when the query heads do not divide the axis (attention replicated), the
    rank's block when the KV heads divide it, else the one KV head the
    rank's query heads share (the port's departure from the reference's
    length-sharded cache).  A split of query heads across KV heads raises:
    it needs that length-sharded cache, ROADMAP.md §1 item 8c(iii)."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if model == 1 or not kv or h % model:
        return kv
    if kv % model == 0:
        return kv // model
    if cfg.num_kv_groups % (h // model) == 0:
        return 1
    raise NotImplementedError(
        f"{cfg.name}: {h // model} query heads a rank straddle KV heads of "
        f"{cfg.num_kv_groups} queries at model={model}: the length-sharded "
        f"cache this needs is not ported yet (ROADMAP.md §1 item 8c(iii))")


# leaves whose cut dim holds several blocks side by side, each cut alike:
# Mamba's in_proj is [u | z] over its columns, and a rank keeps its
# channels of both (the reference's one contiguous block would give rank
# 0 of model 2 all of u and rank 1 all of z, which GSPMD then reshuffles)
SPLIT_LEAVES: Tuple[Tuple[str, int], ...] = ((r"mamba/in_proj/w$", 2),)


def _parts(name: str) -> int:
    """How many side-by-side blocks the cut dim of leaf ``name`` holds."""
    for pattern, n in SPLIT_LEAVES:
        if re.search(pattern, name):
            return n
    return 1


def local_channels(cfg: ModelConfig, model: int) -> Tuple[int, int]:
    """(the RWKV-6 wkv heads, the Mamba channels) one rank of a
    ``model``-wide axis keeps: the rank's block of each (``tm/w[rkvg]``,
    ``tm/u`` and ``mamba/*`` cut over ``model``), 0 for a family without
    them.  Raises where they do not divide the axis."""
    heads = (cfg.d_model // cfg.rwkv_head_dim
             if cfg.block_type == "rwkv6" else 0)
    channels = cfg.ssm_expand * cfg.d_model if cfg.block_type == "hymba" else 0
    for what, n in (("wkv heads", heads), ("Mamba channels", channels)):
        if n % model:
            raise ValueError(f"{cfg.name}: {n} {what} do not divide the "
                             f"model axis of {model}")
    return heads // model, channels // model


def _block(x: torch.Tensor, s: Tuple, mesh, parts: int = 1
           ) -> Tuple[torch.Tensor, Optional[int]]:
    """(this rank's block of ``x`` under spec ``s``, the dim cut or None).
    Only the ``model`` axis cuts parameters.  A dim of ``parts`` blocks
    side by side (``SPLIT_LEAVES``) keeps the rank's slice of each."""
    m = mesh.shape["model"]
    for dim, ax in enumerate(s):
        if ax == "model" and m > 1:
            xs = x.unflatten(dim, (parts, x.shape[dim] // parts))
            n = xs.shape[dim + 1] // m
            i = mesh.coords["model"]
            block = xs.narrow(dim + 1, i * n, n).flatten(dim, dim + 1)
            return block.contiguous().clone(), dim
    return x, None


def shard_leaves(tree, mesh, *, prefix: str = ""):
    """(nested dict of this rank's blocks, {'/'-name: dim cut}) of a
    nested dict / list tree (or ``ParamTree``) at full shapes; ``prefix``
    is the tree's path in the whole parameter set."""
    dims: Dict[str, int] = {}

    def visit(path: str, node):
        if isinstance(node, torch.Tensor):
            full = f"{prefix}/{path}" if prefix else path
            rule, parts = _spec_for(full), _parts(full)
            shape = list(node.shape)     # each part must divide the axis
            if parts > 1:
                shape[rule.index("model")] //= parts
            block, dim = _block(node.data, _divisible(rule, tuple(shape), mesh),
                                mesh, parts)
            if dim is not None:
                dims[full] = dim
            return block
        if isinstance(node, (list, tuple, nn.ModuleList)):
            return [visit(f"{path}/{i}" if path else str(i), v)
                    for i, v in enumerate(node)]
        keys = (list(node.keys()) if isinstance(node, dict)
                else list(node._parameters) + list(node._modules))
        return {k: visit(f"{path}/{k}" if path else k, node[k]) for k in keys}

    return visit("", tree), dims


def shard_bundles(bundles: Dict, mesh, primary, sharded) -> Dict:
    """A session's ``{name: core.bundle.ModelBundle}`` with each bundle's
    parameters cut to this rank's blocks by the same rules as the
    primary's (``shard_params``; a tree sharded for ``mesh`` already is
    kept).  A bundle whose parameters are the primary's own tree
    (``primary``, a self-draft) takes the primary's sharded tree
    ``sharded``, not a second copy."""
    out = {}
    for name, b in bundles.items():
        held = getattr(b.params, "mesh", None)
        if b.params is primary or b.params is sharded:
            params = sharded
        elif held is None:
            params = shard_params(b.params, mesh)
        elif held is mesh:
            params = b.params
        else:
            raise ValueError(f"bundle {name!r}'s parameters are sharded for "
                             f"{held}, not for the session's {mesh}")
        out[name] = dataclasses.replace(b, params=params)
    return out


def shard_params(params, mesh):
    """This rank's block of every leaf of ``params`` (a ``ParamTree`` at
    full shapes), as a ``ParamTree`` that carries ``mesh`` and the dims it
    cut: the counterpart of ``jax.device_put(params, param_shardings(params,
    mesh))``."""
    from repro_torch.models.model import ParamTree   # model <- sharding

    tree, dims = shard_leaves(params, mesh)
    return ParamTree(tree, mesh=mesh, sharded=dims)
