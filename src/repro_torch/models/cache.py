"""Decode-time caches: the dense and paged layouts of ``repro.models.cache``.

Dense KV layout (per attention layer, ``cache_backend="dense"``):
    k, v : (batch, buf_len, kv_heads, head_dim)   post-RoPE keys / values
    pos  : (batch, buf_len) int32                 absolute position held by
                                                  slot (-1 = never written)

Paged KV layout (per full-attention layer, ``cache_backend="paged"``):
    kp, vp : (num_pages, page_size, kv_heads, head_dim)  shared page pool
    tbl    : (batch, P) int32       logical page i of row b lives in
                                    physical page tbl[b, i]; page 0 is the
                                    trash page unmapped entries point at
    pos    : (batch, P * page_size) int32   absolute positions, as dense

RWKV-6 layers keep a recurrent cache instead (``rwkv_cache_init``): the
time-mix and channel-mix token shifts (batch, d_model) and the wkv state
(batch, H, D, D) fp32, the same under either backend.

Masking is computed from absolute positions, so BPD rollback is "decrease
the length": stale slots have ``pos >= length`` and are masked out until
overwritten, under either layout.  Windowed layers keep the dense ring
buffer under the paged backend (their buffers are window-bounded already).
The run-to-completion decode paths lay the block tables out as the
identity ``1 + b·P + i`` over a pool of ``1 + B·P`` pages, so they need no
allocator; the serving engine's allocator, managed tables and ``row_init``
are not ported (ROADMAP.md).
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


def paged_attn_cache_init(batch: int, pages_per_row: int, page_size: int,
                          num_pages: int, kv_heads: int, head_dim: int,
                          dtype, device=None) -> Dict:
    """Paged pool + block table for one full-attention layer, laid out as
    the identity: row b's logical page i is physical page ``1 + b * P + i``
    (the reference's ``identity_tbl=True``; the engine's all-trash tables
    wait for its allocator)."""
    tbl = (1 + torch.arange(batch * pages_per_row, dtype=torch.int32,
                            device=device)).reshape(batch, pages_per_row)
    shape = (num_pages, page_size, kv_heads, head_dim)
    return {
        "kp": torch.zeros(shape, dtype=dtype, device=device),
        "vp": torch.zeros(shape, dtype=dtype, device=device),
        "tbl": tbl,
        "pos": torch.full((batch, pages_per_row * page_size), -1,
                          dtype=torch.int32, device=device),
    }


def rwkv_cache_init(batch: int, d_model: int, num_heads: int, head_dim: int,
                    dtype, device=None) -> Dict:
    """One RWKV-6 layer's recurrent cache: the two token shifts in the
    compute dtype and the wkv state in fp32.  Recurrent caches do not
    depend on the KV layout: the paged backend leaves them as they are."""
    return {
        "shift_tm": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "shift_cm": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "state": torch.zeros((batch, num_heads, head_dim, head_dim),
                             dtype=torch.float32, device=device),
    }


def is_paged(layer_cache: Dict) -> bool:
    """True when a per-layer cache dict carries a paged attention part."""
    return "attn" in layer_cache and "kp" in layer_cache["attn"]


def _is_window_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    return bool(cfg.sliding_window) and layer_idx not in cfg.global_attn_layers


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


def pages_per_row(context_len: int, block_k: int, page_size: int) -> int:
    """Block-table width P: pages to address ``context_len + block_k``
    positions (the span a dense buffer covers, minus the 256-padding)."""
    return -(-(context_len + block_k) // page_size)


class DenseBackend:
    """One padded ``buf_len`` KV row per batch slot."""

    name = "dense"

    def layer_attn_init(self, cfg: ModelConfig, layer_idx: int, batch: int,
                        context_len: int, block_k: int, dtype,
                        device=None) -> Dict:
        buf = attn_buf_len(cfg, layer_idx, context_len, block_k)
        return attn_cache_init(batch, buf, cfg.num_kv_heads,
                               cfg.resolved_head_dim, dtype, device)


class PagedBackend(DenseBackend):
    """Paged pool layout for full-attention layers (windowed layers stay
    dense).  ``num_pages = 0`` sizes the pool to the identity layout's
    ``1 + batch * P`` pages."""

    name = "paged"

    def __init__(self, page_size: int = 16, num_pages: int = 0):
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)

    def layer_attn_init(self, cfg: ModelConfig, layer_idx: int, batch: int,
                        context_len: int, block_k: int, dtype,
                        device=None) -> Dict:
        if _is_window_layer(cfg, layer_idx):
            return super().layer_attn_init(cfg, layer_idx, batch, context_len,
                                           block_k, dtype, device)
        P = pages_per_row(context_len, block_k, self.page_size)
        pool = self.num_pages or (1 + batch * P)
        return paged_attn_cache_init(batch, P, self.page_size, pool,
                                     cfg.num_kv_heads, cfg.resolved_head_dim,
                                     dtype, device)


def get_backend(dec=None) -> DenseBackend:
    """Reads ``DecodeConfig.cache_backend`` (and ``page_size``)."""
    name = getattr(dec, "cache_backend", "dense") if dec is not None else "dense"
    if name in ("", "dense"):
        return DenseBackend()
    if name == "paged":
        return PagedBackend(getattr(dec, "page_size", 16))
    raise ValueError(
        f"unknown cache_backend {name!r}: expected 'dense' or 'paged'")
