"""Per-layer block: attention + dense MLP (the ``attn`` × ``dense`` path of
``repro.models.blocks``).

Two execution modes:
  * full   — whole-sequence parallel forward (prefill); optionally fills the
             decode cache.
  * cached — a block of ``k`` fresh tokens against the cache (the BPD verify
             substep).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import cache as cache_lib
from repro_torch.models.attention import attn_cached, attn_full, attn_init, cache_write
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init


def check_supported(cfg: ModelConfig) -> None:
    """This slice ports the decoder-only text model with attention + dense
    MLP blocks; other families raise here, before any work."""
    if (cfg.block_type, cfg.mlp_type, cfg.modality) != ("attn", "dense", "text") \
            or cfg.is_encoder_only or cfg.is_encoder_decoder or cfg.num_meta_tokens:
        raise NotImplementedError(
            f"{cfg.name}: block_type={cfg.block_type!r}, mlp_type="
            f"{cfg.mlp_type!r}, modality={cfg.modality!r} is not ported yet "
            f"(see ROADMAP.md, 'Modules to port'); the port runs decoder-only "
            f"text models with attention + dense MLP blocks")


def block_init(gen, cfg: ModelConfig, layer_idx: int, *, dtype=torch.float32,
               device=None) -> Dict:
    check_supported(cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "ln1": norm_init(cfg.d_model, kind=cfg.norm_type, **kw),
        "attn": attn_init(gen, cfg, **kw),
        "ln2": norm_init(cfg.d_model, kind=cfg.norm_type, **kw),
        "mlp": mlp_init(gen, cfg, **kw),
    }


def block_cache_init(cfg: ModelConfig, layer_idx: int, batch: int,
                     context_len: int, block_k: int, dtype, device=None,
                     backend: Optional[cache_lib.DenseBackend] = None) -> Dict:
    """Static cache buffers for one layer (decode path), in the layout of
    ``backend`` (dense when None)."""
    be = backend if backend is not None else cache_lib.DenseBackend()
    return {"attn": be.layer_attn_init(cfg, layer_idx, batch, context_len,
                                       block_k, dtype, device)}


def block_full(p, cfg: ModelConfig, layer_idx: int, x, *, positions=None,
               cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (y, cache_out); cache_out is filled when a cache is passed in
    (prefill)."""
    h = norm_apply(p["ln1"], x, kind=cfg.norm_type)
    cache_out = None
    if cache is not None:
        y, (kk, vv) = attn_full(p["attn"], cfg, h, layer_idx=layer_idx,
                                positions=positions, return_kv=True)
        if positions is None:
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)
        cache_out = dict(cache)
        cache_out["attn"] = cache_write(cache["attn"], cfg, layer_idx, kk, vv,
                                        positions)
    else:
        y = attn_full(p["attn"], cfg, h, layer_idx=layer_idx,
                      positions=positions)
    x = x + y
    h = norm_apply(p["ln2"], x, kind=cfg.norm_type)
    return x + mlp_apply(p["mlp"], h, act=cfg.activation), cache_out


def block_cached(p, cfg: ModelConfig, layer_idx: int, x, cache: Dict,
                 length, *, tree=None) -> Tuple[torch.Tensor, Dict]:
    """x: (B, k, d) fresh tokens at positions length..length+k-1 (or the
    nodes of draft tree ``tree``, see ``attention.attn_cached``).
    Returns (y, cache); the attention cache is written in place."""
    new_cache = dict(cache)
    h = norm_apply(p["ln1"], x, kind=cfg.norm_type)
    y, new_cache["attn"] = attn_cached(p["attn"], cfg, h, cache["attn"],
                                       length, layer_idx=layer_idx, tree=tree)
    x = x + y
    h = norm_apply(p["ln2"], x, kind=cfg.norm_type)
    return x + mlp_apply(p["mlp"], h, act=cfg.activation), new_cache


def commit_cache(cfg: ModelConfig, cache: Dict, khat) -> Dict:
    """Resolve a staged cache to the accepted prefix.  Attention caches
    need no rollback (positions mask rejected entries), so this passes the
    cache through; recurrent families will select their accepted step."""
    return cache
