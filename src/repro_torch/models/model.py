"""Model assembly, as ``repro.models.model``: the decoder-only ``CausalLM``
(the text families, llava-next-34b's backbone behind its patch prefix, the
RWKV-6 and Hymba families) and the encoder-only stack (hubert-xlarge).  The
encoder-decoder lives in ``seq2seq``; ``init`` sends its configs there.

Parameters live in a ``ParamTree``: the reference's nested dict / list
pytree as an ``nn.Module``, so ``state_dict()`` keys are the reference's key
paths (``blocks.3.attn.wq`` is ``params["blocks"][3]["attn"]["wq"]``) and
``p["wq"]`` reads as it does there.  The reference keeps weights in
``param_dtype`` and casts at every use, to the compute dtype for most
leaves but to fp32 for the norms' scale/bias, RWKV-6's decay weights and
bonus, the MoE router and Mamba's A_log and D.  Here the caller casts once before decoding (``cast_for_compute``):
the leaves read in the compute dtype are cast, the fp32-read ones stay in
fp32, so every use sees the value the reference's cast gives, and fp32
weights are not re-read on every forward.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.core.heads import head_apply_single, heads_apply, heads_init
from repro_torch.kernels import ops
from repro_torch.models import cache as cache_lib
from repro_torch.models.attention import tree_commit_attn
from repro_torch.models.blocks import (
    block_cache_init,
    block_cached,
    block_full,
    block_init,
    check_supported,
    commit_cache,
)
from repro_torch.models.layers import (
    dense_apply,
    dense_init,
    embed_apply,
    embed_init,
    norm_apply,
    norm_init,
    normal,
    unembed_apply,
)
from repro_torch.sharding import comm
from repro_torch.sharding.policy import (local_channels, local_kv_heads,
                                         shard_leaves)
from repro_torch.utils.tree import flatten_with_names


class ParamTree(nn.Module):
    """A nested dict (lists for ``blocks``) of tensors as an ``nn.Module``.

    A sharded tree (``sharding.shard_params``, ``init(mesh=)``) holds this
    rank's block of each leaf, as a JAX array carries its sharding: every
    node keeps the ``mesh`` and, in ``shard_dims``, the dim of each of its
    own leaves cut over the ``model`` axis.  The layers read them to issue
    their collectives (``sharding.comm``)."""

    def __init__(self, tree: Dict, *, mesh=None,
                 sharded: Optional[Dict[str, int]] = None, prefix: str = ""):
        super().__init__()
        self.mesh = mesh
        self.shard_dims: Dict[str, int] = {}
        sharded = sharded or {}
        for key, val in tree.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(val, torch.Tensor):
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))
                if path in sharded:
                    self.shard_dims[key] = sharded[path]
            elif isinstance(val, dict):
                self.add_module(key, ParamTree(val, mesh=mesh, sharded=sharded,
                                               prefix=path))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(
                    ParamTree(v, mesh=mesh, sharded=sharded,
                              prefix=f"{path}/{i}") for i, v in enumerate(val)))
            else:
                raise TypeError(f"param {key!r}: unsupported leaf {type(val)}")

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init(cfg: ModelConfig, *, seed: int = 0, device=None,
         mesh=None) -> ParamTree:
    """Random parameters in ``cfg.param_dtype`` from a seeded
    ``torch.Generator`` on ``device`` (default ``mesh``'s device, else the
    card; ``"meta"`` gives shapes only).  Same distributions as the
    reference's ``init``; the numbers differ, as the two frameworks'
    generators do.  An encoder-decoder config goes to ``seq2seq.init``.

    With ``mesh`` (a ``launch.mesh.Mesh``) every leaf is drawn whole, in
    the single-device order and from the same generator, and only this
    rank's block is kept (``sharding.shard_leaves``), one layer's leaves at
    a time: the blocks equal the single-device draw's, and no rank holds a
    second full copy."""
    if mesh is not None:
        check_mesh_supported(cfg, mesh)
    if cfg.is_encoder_decoder:
        from repro_torch.models import seq2seq   # seq2seq imports this module

        return seq2seq.init(cfg, seed=seed, device=device, mesh=mesh)
    check_supported(cfg)
    dev = resolve_device(mesh.device if device is None and mesh is not None
                         else device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    kw = dict(dtype=cfg.params_dtype, device=dev)
    sharded: Dict[str, int] = {}

    def keep(name: str, tree):
        if mesh is None:
            return tree
        blocks, dims = shard_leaves(tree, mesh, prefix=name)
        sharded.update(dims)
        return blocks

    p: Dict = {
        "embed": keep("embed", embed_init(gen, cfg.padded_vocab_size,
                                          cfg.d_model, **kw)),
        "blocks": [keep(f"blocks/{i}", block_init(gen, cfg, i, **kw))
                   for i in range(cfg.num_layers)],
        "final_norm": norm_init(cfg.d_model, kind=cfg.norm_type, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = keep("lm_head", dense_init(
            gen, cfg.d_model, cfg.padded_vocab_size, **kw))
    if cfg.bpd_enabled:
        p["bpd_heads"] = keep("bpd_heads", heads_init(gen, cfg, **kw))
    if cfg.num_meta_tokens:
        p["meta_tokens"] = normal(gen, (cfg.num_meta_tokens, cfg.d_model),
                                  std=0.02, **kw)
    if cfg.is_encoder_only:
        p["pos_embed"] = normal(gen, (cfg.max_seq_len, cfg.d_model), std=0.02,
                                **kw)
        p["mask_embed"] = normal(gen, (cfg.d_model,), std=0.02, **kw)
    return ParamTree(p, mesh=mesh, sharded=sharded)


def check_mesh_supported(cfg: ModelConfig, mesh) -> None:
    """The sharded decode path runs every config the single-device port
    decodes: the dense trunk and the MoE blocks (attention whose query
    heads split into whole KV heads or whole groups of a KV head,
    ``sharding.local_kv_heads``; experts over ``model``), RWKV-6 (wkv heads
    over ``model``), Hymba (Mamba channels over ``model``, attention
    replicated where its heads do not divide the axis), llava's backbone
    behind its patch prefix and the encoder-decoder (both stacks' heads
    over ``model``).  The encoder-only stack, whose one path is training,
    raises before any work: sharded training is ROADMAP.md §1 item 8d."""
    check_supported(cfg)
    if cfg.is_encoder_only:
        raise NotImplementedError(
            f"{cfg.name} is encoder-only: its path is training, and sharded "
            f"training is not ported yet (ROADMAP.md §1 item 8d)")
    m = mesh.shape["model"]
    local_kv_heads(cfg, m)
    local_channels(cfg, m)
    if cfg.mlp_type == "moe" and cfg.padded_num_experts % m:
        raise ValueError(f"{cfg.name}: {cfg.padded_num_experts} experts do "
                         f"not divide the model axis of {m}")


def cache_config(params, cfg: ModelConfig) -> ModelConfig:
    """``cfg`` as this rank's caches see it when ``params`` are sharded: a
    ``cache.RankConfig`` at the KV heads, wkv heads and Mamba channels the
    rank keeps (``sharding.local_kv_heads`` / ``local_channels``)."""
    mesh = getattr(params, "mesh", None)
    if mesh is None:
        return cfg
    m = mesh.shape["model"]
    heads, channels = local_channels(cfg, m)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields.update(num_kv_heads=local_kv_heads(cfg, m), wkv_heads=heads,
                  ssm_channels=channels)
    return cache_lib.RankConfig(**fields)


# Leaves the reference reads in fp32 whatever the compute dtype: every
# norm's scale / bias (models/layers.py:46,49,61 there: ln1, ln2,
# final_norm, tm.ln_x, Hymba's fuse_ln_attn / fuse_ln_ssm, and the
# encoder-decoder's ln_cross and enc_norm), RWKV-6's decay weights and bonus
# (models/rwkv6.py:105,166-168 there), the MoE router's weight
# (models/moe.py:97 there: the router runs on x.astype(f32), so its fp32
# parameter is read uncast) and Mamba's A_log and D (models/mamba.py:105,135
# there).
FP32_READ_LEAVES = ("scale", "bias")
FP32_READ_TM = ("w0", "decay_A", "decay_B", "u")
FP32_READ_MAMBA = ("A_log", "D")


def reads_fp32(key: str) -> bool:
    """True for a ``state_dict`` key the reference reads in fp32."""
    *path, leaf = key.split(".")
    parent = path[-1] if path else ""
    return (leaf in FP32_READ_LEAVES or (parent == "tm" and leaf in FP32_READ_TM)
            or (parent == "router" and leaf == "w")
            or (parent == "mamba" and leaf in FP32_READ_MAMBA))


def cast_for_compute(params: ParamTree, cfg: ModelConfig) -> ParamTree:
    """Cast ``params`` in place to ``cfg.compute_dtype``, except the leaves
    the reference reads in fp32 (``reads_fp32``), which stay in (or go to)
    fp32.  Returns ``params``."""
    with torch.no_grad():
        for key, p in params.named_parameters():
            dtype = torch.float32 if reads_fp32(key) else cfg.compute_dtype
            if p.dtype != dtype:
                p.data = p.data.to(dtype)
    return params


def set_trainable(params: ParamTree, mask) -> ParamTree:
    """Turn ``requires_grad`` on for the leaves ``mask`` trains ({'/'-path
    name: value}, nonzero trains; None trains all) and off for the rest,
    so autograd records no graph for a frozen leaf.  Every leaf starts
    off (``ParamTree``), and the decode functions run under
    ``torch.no_grad()`` whatever this says.  Returns ``params``."""
    for name, p in flatten_with_names(params):
        p.requires_grad_(mask is None or float(mask.get(name, 0.0)) > 0)
    return params


# ---------------------------------------------------------------------------
# Input embedding (text / vision_text / audio)
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """The (B, S, d) input embeddings in the compute dtype.  batch keys by
    modality:
       text        : tokens (B, T) int32
       vision_text : patch_embeds (B, P, d) float + tokens (B, T); without
                     patch_embeds the batch is text only
       audio       : frame_embeds (B, S, d) float [+ mask (B, S) bool]
    The M = ``num_meta_tokens`` learnt meta tokens (Hymba) come first, then
    the patches, then the tokens.  An audio frame where ``mask`` is set is
    replaced by ``mask_embed`` (masked-prediction training), and every
    frame gets ``pos_embed`` of its position."""
    dtype = cfg.compute_dtype
    if cfg.modality == "audio":
        h = batch["frame_embeds"].to(dtype)
        if "mask" in batch:
            h = torch.where(batch["mask"][..., None].to(torch.bool),
                            params["mask_embed"].to(dtype), h)
        return h + params["pos_embed"][:h.shape[1]].to(dtype)
    h = embed_apply(params["embed"], batch["tokens"]).to(dtype)
    parts = []
    if cfg.num_meta_tokens:
        parts.append(params["meta_tokens"].to(dtype).expand(h.shape[0], -1, -1))
    if cfg.modality == "vision_text" and "patch_embeds" in batch:
        parts.append(batch["patch_embeds"].to(dtype))
    return torch.cat(parts + [h], dim=1) if parts else h


def prefix_len(cfg: ModelConfig, batch: Dict) -> int:
    """Number of non-text positions preceding the text tokens: the meta
    tokens, then a vision_text batch's patches."""
    n = cfg.num_meta_tokens
    if cfg.modality == "vision_text" and "patch_embeds" in batch:
        n += batch["patch_embeds"].shape[1]
    return n


# ---------------------------------------------------------------------------
# Backbone forwards
# ---------------------------------------------------------------------------


def forward_hidden(params, cfg: ModelConfig, h, *, positions=None,
                   bidirectional: bool = False, caches=None,
                   kv_chunk: int = 0, moe_full_capacity: bool = False,
                   metrics: Optional[Dict] = None):
    """Whole-sequence forward.  h: (B,S,d) embeddings.
    Returns (hidden, caches) — caches filled if given (prefill).
    ``bidirectional``: every position sees every other, with no RoPE (the
    encoder-only stack).  ``kv_chunk`` > 0 bounds each layer's score
    matrix to (S, kv_chunk) (``attention.attn_full``).  MoE layers drop
    nothing under ``moe_full_capacity`` (every decode path's prefill;
    training leaves it off, as the reference does); ``metrics``, a dict,
    receives their metrics averaged over layers (the reference returns
    them as a middle element)."""
    new_caches = list(caches) if caches is not None else None
    for i, bp in enumerate(params["blocks"]):
        c = caches[i] if caches is not None else None
        m = {} if metrics is not None else None
        h, c_out = block_full(bp, cfg, i, h, positions=positions,
                              bidirectional=bidirectional, cache=c,
                              kv_chunk=kv_chunk,
                              moe_full_capacity=moe_full_capacity, metrics=m)
        for k, v in (m or {}).items():
            metrics[k] = metrics.get(k, 0.0) + v / cfg.num_layers
        if caches is not None:
            new_caches[i] = c_out
    h = norm_apply(params["final_norm"], h, kind=cfg.norm_type)
    return h, (tuple(new_caches) if new_caches is not None else None)


def decode_block_step(params, cfg: ModelConfig, h, caches, length, *,
                      tree=None):
    """BPD verify-substep backbone: k fresh embeddings vs the caches.
    Returns (hidden_block, staged_caches); ``commit_caches`` resolves them.
    ``tree`` switches the block to tree verification."""
    new_caches = []
    for i, bp in enumerate(params["blocks"]):
        h, c_out = block_cached(bp, cfg, i, h, caches[i], length, tree=tree)
        new_caches.append(c_out)
    h = norm_apply(params["final_norm"], h, kind=cfg.norm_type)
    return h, tuple(new_caches)


def commit_caches(cfg: ModelConfig, caches, khat):
    return tuple(commit_cache(cfg, c, khat) for c in caches)


def commit_tree_path(cfg: ModelConfig, caches, path_nodes, khat, length,
                     block_k: int):
    """Compact the accepted root-to-leaf path into chain slots in every
    layer after a tree verify forward (see ``attention.tree_commit_attn``)."""
    for i, c in enumerate(caches):
        if "attn" in c:
            tree_commit_attn(c["attn"], cfg, i, path_nodes, khat, length,
                             block_k)
    return caches


def init_caches(cfg: ModelConfig, batch: int, context_len: int, block_k: int,
                dtype=None, *, device=None,
                backend: Optional[cache_lib.KVCacheBackend] = None):
    dtype = dtype or cfg.compute_dtype
    return tuple(block_cache_init(cfg, i, batch, context_len, block_k, dtype,
                                  device, backend=backend)
                 for i in range(cfg.num_layers))


def reset_cache_rows(caches, mask):
    """Invalidate rows ``mask`` ((B,) bool) of every layer's cache, in
    place: slot eviction for the continuous-batching engine."""
    return tuple(cache_lib.reset_rows(c, mask) for c in caches)


def scatter_cache_row(caches, row_caches, slot, *, row=0, tbl_row=None,
                      write_mask=None, pages: bool = True):
    """Install prefilled rows into slots of batched caches, in place:
    prefill-into-freed-slot for the continuous-batching engine (see
    ``cache.scatter_row``; ``slot`` / ``row`` ints or (n,) index tensors).
    Paged layers take the host allocator's page mapping ``tbl_row`` /
    ``write_mask``, one mapping for every layer (``cache.scatter_row_paged``;
    ``pages`` False leaves the pool to ``write_cache_pages``)."""
    for c, rc in zip(caches, row_caches):
        if cache_lib.is_paged(c):
            cache_lib.scatter_row_paged(c, rc, slot, tbl_row, write_mask,
                                        row=row, pages=pages)
        else:
            cache_lib.scatter_row(c, rc, slot, row=row)
    return caches


def write_cache_pages(caches, row_caches, rows, tbl_rows, write_masks):
    """The pool half of a paged admission in every paged layer, in place
    (``cache.write_pages``): packet ``rows`` into their mapped pages."""
    for c, rc in zip(caches, row_caches):
        if cache_lib.is_paged(c):
            cache_lib.write_pages(c, rc, tbl_rows, write_masks, row=rows)
    return caches


# ---------------------------------------------------------------------------
# Output projections
# ---------------------------------------------------------------------------


def vocab_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    """The (d, Vp) vocab projection, or this rank's (d, Vp / M) lanes of it
    when sharded: the tied table's transpose view (no copy) or the untied
    ``lm_head``."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].t()
    return params["lm_head"]["w"]


def vocab_lanes(params, cfg: ModelConfig):
    """(mesh, first lane): the first global vocab lane of this rank's block
    of the vocab projection, and the mesh that holds the others (None when
    the projection is whole)."""
    node, leaf = ((params["embed"], "table") if cfg.tie_embeddings
                  else (params["lm_head"], "w"))
    dim = comm.cut(node, leaf)
    if dim is None:
        return None, 0
    return node.mesh, node.mesh.coords["model"] * node[leaf].shape[dim]


def project_vocab(params, cfg: ModelConfig, h) -> torch.Tensor:
    """(..., d) -> (..., padded_vocab) logits, or this rank's lanes of them
    when the projection is sharded (``vocab_lanes``); pad lanes set to -1e9
    (on the rank that holds them) so argmax / softmax never select them."""
    if cfg.tie_embeddings:
        logits = unembed_apply(params["embed"], h)
    else:
        logits = dense_apply(params["lm_head"], h)
    _, lo = vocab_lanes(params, cfg)
    real = cfg.vocab_size - lo
    if real < logits.shape[-1]:
        logits[..., max(real, 0):] = -1e9
    return logits


def _whole_vocab(params, cfg: ModelConfig, logits) -> torch.Tensor:
    """Logits over the whole padded vocab: a sharded projection's lanes
    gathered over the ``model`` axis."""
    mesh, _ = vocab_lanes(params, cfg)
    return logits if mesh is None else comm.model_gather(mesh, logits)


def all_head_logits(params, cfg: ModelConfig, hidden) -> torch.Tensor:
    """hidden: (..., d) -> (..., k, V) logits of p_1..p_k (paper Fig. 3);
    a headless model gives p_1 alone, (..., 1, V)."""
    if not cfg.bpd_enabled or "bpd_heads" not in params:
        return _whole_vocab(params, cfg,
                            project_vocab(params, cfg, hidden)[..., None, :])
    outs = heads_apply(params["bpd_heads"], cfg, hidden,
                       identity_p1=cfg.bpd_identity_p1)
    return _whole_vocab(params, cfg, project_vocab(params, cfg, outs))


def base_logits(params, cfg: ModelConfig, hidden) -> torch.Tensor:
    """p_1 logits only, over the whole padded vocab on every rank."""
    if cfg.bpd_enabled and not cfg.bpd_identity_p1:
        hidden = head_apply_single(params["bpd_heads"], cfg, hidden, 0,
                                   identity_p1=False)
    return _whole_vocab(params, cfg, project_vocab(params, cfg, hidden))


def greedy_token(logits) -> torch.Tensor:
    """Greedy next token: the first maximum (lowest id among ties), int32.
    Greedy decoding and BPD's verified slot 0 both take this routine."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def head_topk(params, cfg: ModelConfig, hidden, n: int,
              top_t: int = 1) -> torch.Tensor:
    """Top-``top_t`` ids of heads p_2..p_{n+1} at hidden (B, d) ->
    (B, n, top_t) int32, ordered by (logit desc, id asc), from one
    fused-heads launch over the B·n rows (``vocab_top_t``): the heads'
    logits are never written."""
    b, d = hidden.shape
    if n >= cfg.bpd_k:
        raise ValueError(f"{n + 1} proposal slots need {n + 1} heads; "
                         f"{cfg.name} has bpd_k={cfg.bpd_k}")
    outs = heads_apply(params["bpd_heads"], cfg, hidden,
                       identity_p1=cfg.bpd_identity_p1)[:, 1:1 + n]
    return vocab_top_t(params, cfg, outs.reshape(b * n, d),
                       top_t).reshape(b, n, top_t)


def vocab_top_t(params, cfg: ModelConfig, o, top_t: int) -> torch.Tensor:
    """The (N, top_t) int32 ids of the top-``top_t`` vocab logits of
    ``o`` (N, d), ordered by (logit desc, id asc), by the fused-heads
    kernel.  A sharded projection launches on this rank's lanes and merges
    the ranks' top-T by that same rule (``comm.merge_top_t``), so the ids
    are those of one launch over the whole vocab."""
    w = vocab_matrix(params, cfg)
    mesh, lo = vocab_lanes(params, cfg)
    if mesh is None:
        return ops.fused_heads_topk(o, w, vocab=cfg.vocab_size,
                                    top_t=top_t)[1]
    real = min(max(cfg.vocab_size - lo, 0), w.shape[1])
    n = o.shape[0]
    vals = torch.full((n, top_t), float("-inf"), device=o.device)
    ids = torch.full((n, top_t), torch.iinfo(torch.int32).max,
                     dtype=torch.int32, device=o.device)
    t = min(top_t, real)      # a rank of pad lanes alone launches nothing
    if t:
        vals[:, :t], ids[:, :t] = ops.fused_heads_topk(o, w, vocab=real,
                                                       top_t=t)
        ids[:, :t] += lo
    return comm.merge_top_t(mesh, vals, ids, top_t)[1]
