"""Decode-time caches: the dense layout of ``repro.models.cache``.

Dense KV layout (per attention layer):
    k, v : (batch, buf_len, kv_heads, head_dim)   post-RoPE keys / values
    pos  : (batch, buf_len) int32                 absolute position held by
                                                  slot (-1 = never written)

Masking is computed from absolute positions, so BPD rollback is "decrease
the length": stale slots have ``pos >= length`` and are masked out until
overwritten.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig


def attn_cache_init(batch: int, buf_len: int, kv_heads: int, head_dim: int,
                    dtype, device=None) -> Dict:
    return {
        "k": torch.zeros((batch, buf_len, kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, buf_len, kv_heads, head_dim), dtype=dtype,
                         device=device),
        # per-row absolute positions: rows advance at different rates under
        # blockwise parallel decoding
        "pos": torch.full((batch, buf_len), -1, dtype=torch.int32,
                          device=device),
    }


def attn_buf_len(cfg: ModelConfig, layer_idx: int, context_len: int,
                 block_k: int) -> int:
    """Static KV buffer size for one attention layer, rounded up to a
    multiple of 256 (extra slots hold pos = -1 and are masked out)."""
    window = cfg.sliding_window
    if window and layer_idx not in cfg.global_attn_layers:
        n = min(context_len + block_k, window + cfg.num_meta_tokens + block_k)
    else:
        n = context_len + block_k
    return ((n + 255) // 256) * 256


class DenseBackend:
    """One padded ``buf_len`` KV row per batch slot."""

    name = "dense"

    def layer_attn_init(self, cfg: ModelConfig, layer_idx: int, batch: int,
                        context_len: int, block_k: int, dtype,
                        device=None) -> Dict:
        buf = attn_buf_len(cfg, layer_idx, context_len, block_k)
        return attn_cache_init(batch, buf, cfg.num_kv_heads,
                               cfg.resolved_head_dim, dtype, device)


def get_backend(dec=None) -> DenseBackend:
    """Reads ``DecodeConfig.cache_backend``; only the dense layout is ported."""
    name = getattr(dec, "cache_backend", "dense") if dec is not None else "dense"
    if name in ("", "dense"):
        return DenseBackend()
    raise NotImplementedError(
        f"cache_backend {name!r} is not ported yet (see ROADMAP.md, "
        f"'Modules to port', item 7); use 'dense'")
