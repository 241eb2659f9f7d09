"""Encoder-decoder transformer — the paper's machine-translation setting, as
in ``repro.models.seq2seq``.

Encoder: bidirectional attention blocks over learned positional embeddings.
Decoder: causal blocks with cross attention; the BPD heads sit on the
decoder output as in the decoder-only model.  ``encode`` computes each
decoder layer's cross K/V once per source; they travel with the source's
``kv_pos`` as ``attention.CrossKV``.  Whole sequences (the encoder, the BOS
prefill, teacher forcing) run on the plain path; a cached block's self and
cross attention run on ``verify_attention`` (or ``tree_verify_attention``
for a tree's self attention).

On a ``model``-sharded ``ParamTree`` (``init(mesh=)``, ``sharding.
shard_params``) both stacks run as the decoder-only trunk does: each rank
computes its own heads of self and cross attention and its block of the
MLP, the row-parallel partials summed over ``model``; ``encode`` gives each
rank the cross K/V of its own KV heads, and the source embedding is
vocab-parallel like the target's.  ``enc_pos`` and the norms are whole on
every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.core.heads import heads_init
from repro_torch.models import model as model_lib
from repro_torch.models.attention import CrossKV, cross_kv, source_positions
from repro_torch.models.blocks import (
    block_cache_init,
    block_cached,
    block_full,
    block_init,
    check_supported,
)
from repro_torch.models.layers import (
    dense_init,
    embed_apply,
    embed_init,
    norm_apply,
    norm_init,
    normal,
)
from repro_torch.sharding.policy import shard_leaves


def init(cfg: ModelConfig, *, seed: int = 0, device=None,
         mesh=None) -> "model_lib.ParamTree":
    """Random parameters under the reference's key paths (``src_embed``,
    ``embed``, ``enc_pos``, ``enc_blocks.N``, ``enc_norm``, ``blocks.N`` with
    ``ln_cross`` / ``cross``, ``final_norm``, ``lm_head``, ``bpd_heads``),
    drawn as ``model.init`` draws them, and with ``mesh`` cut as it cuts
    them: each leaf drawn whole, in the single-device order, and only this
    rank's block kept (``sharding.shard_leaves``), one layer at a time."""
    check_supported(cfg)
    dev = resolve_device(mesh.device if device is None and mesh is not None
                         else device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    kw = dict(dtype=cfg.params_dtype, device=dev)
    vp, d = cfg.padded_vocab_size, cfg.d_model
    sharded: Dict[str, int] = {}

    def keep(name: str, tree):
        if mesh is None:
            return tree
        blocks, dims = shard_leaves(tree, mesh, prefix=name)
        sharded.update(dims)
        return blocks

    p: Dict = {
        "src_embed": keep("src_embed", embed_init(gen, vp, d, **kw)),
        "embed": keep("embed", embed_init(gen, vp, d, **kw)),
        "enc_pos": normal(gen, (cfg.max_seq_len, d), std=0.02, **kw),
        "enc_blocks": [keep(f"enc_blocks/{i}", block_init(gen, cfg, i, **kw))
                       for i in range(cfg.num_encoder_layers)],
        "enc_norm": norm_init(d, kind=cfg.norm_type, **kw),
        "blocks": [keep(f"blocks/{i}", block_init(gen, cfg, i,
                                                  cross_attention=True, **kw))
                   for i in range(cfg.num_layers)],
        "final_norm": norm_init(d, kind=cfg.norm_type, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = keep("lm_head", dense_init(gen, d, vp, **kw))
    if cfg.bpd_enabled:
        p["bpd_heads"] = keep("bpd_heads", heads_init(gen, cfg, **kw))
    return model_lib.ParamTree(p, mesh=mesh, sharded=sharded)


def encode(params, cfg: ModelConfig, src_tokens,
           src_mask: Optional[torch.Tensor] = None) -> Tuple[CrossKV, ...]:
    """src_tokens: (B, Se) -> each decoder layer's ``CrossKV``; ``src_mask``
    (B, Se) bool marks the visible source tokens (None: all), and becomes
    the ``kv_pos`` every layer shares."""
    dtype = cfg.compute_dtype
    b, se = src_tokens.shape
    h = embed_apply(params["src_embed"], src_tokens).to(dtype)
    h = h + params["enc_pos"][:se].to(dtype)
    for i, bp in enumerate(params["enc_blocks"]):
        h, _ = block_full(bp, cfg, i, h, bidirectional=True)
    h = norm_apply(params["enc_norm"], h, kind=cfg.norm_type)
    kv_pos = source_positions(src_mask, b, se, h.device)
    return tuple(cross_kv(bp["cross"], cfg, h, kv_pos) for bp in params["blocks"])


def forward_hidden(params, cfg: ModelConfig, tgt_tokens, enc_kvs, *,
                   caches=None):
    """Teacher-forced decoder forward (training / the BOS prefill), plain
    path.  Returns (hidden, caches) — caches filled if given."""
    h = embed_apply(params["embed"], tgt_tokens).to(cfg.compute_dtype)
    new_caches = list(caches) if caches is not None else None
    for i, bp in enumerate(params["blocks"]):
        c = caches[i] if caches is not None else None
        h, c_out = block_full(bp, cfg, i, h, enc_kv=enc_kvs[i], cache=c)
        if caches is not None:
            new_caches[i] = c_out
    h = norm_apply(params["final_norm"], h, kind=cfg.norm_type)
    return h, (tuple(new_caches) if new_caches is not None else None)


def decode_block_step(params, cfg: ModelConfig, h, caches, length, enc_kvs,
                      q_pos, *, tree=None):
    """BPD verify-substep decoder: k fresh embeddings vs the caches and the
    source.  ``q_pos`` is the (B, k) int32 zero tensor of the cross
    attention's queries.  Returns (hidden_block, caches); attention caches
    need no commit."""
    new_caches = []
    for i, bp in enumerate(params["blocks"]):
        h, c_out = block_cached(bp, cfg, i, h, caches[i], length,
                                enc_kv=enc_kvs[i], q_pos=q_pos, tree=tree)
        new_caches.append(c_out)
    h = norm_apply(params["final_norm"], h, kind=cfg.norm_type)
    return h, tuple(new_caches)


def init_caches(cfg: ModelConfig, batch: int, context_len: int, block_k: int,
                dtype=None, *, device=None):
    """The decoder's dense self-attention caches (the reference's seq2seq
    path has no paged layout); at a rank's KV heads for a ``cfg`` of
    ``model.cache_config``."""
    dtype = dtype or cfg.compute_dtype
    return tuple(block_cache_init(cfg, i, batch, context_len, block_k, dtype,
                                  device)
                 for i in range(cfg.num_layers))


# Output projections are the decoder-only model's.


def base_logits(params, cfg: ModelConfig, hidden) -> torch.Tensor:
    return model_lib.base_logits(params, cfg, hidden)


def head_topk(params, cfg: ModelConfig, hidden, n: int,
              top_t: int = 1) -> torch.Tensor:
    return model_lib.head_topk(params, cfg, hidden, n, top_t)
