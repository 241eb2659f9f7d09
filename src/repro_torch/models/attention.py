"""GQA attention with RoPE, sliding windows and a BPD-aware dense KV cache.

Two entry points, as in ``repro.models.attention`` (dense chain path):
  * ``attn_full``   — parallel forward over a whole sequence (prefill); a
                      plain tensor path, as in the reference.
  * ``attn_cached`` — scores a block of ``k`` fresh tokens against the cache
                      and each other (the paper's verify substep) through
                      ``kernels.ops.verify_attention``: the CUDA kernel for
                      tensors on the card, its plain version on the CPU.

Masking is computed from absolute positions, so the BPD rollback ("length
decreases by up to k-1") moves no data.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, norm_apply, norm_init

NEG_INF = -1e30


def attn_init(gen, cfg: ModelConfig, *, dtype=torch.float32,
              device=None) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(gen, d, h * hd, **kw)["w"].reshape(d, h, hd),
        "wk": dense_init(gen, d, kv * hd, **kw)["w"].reshape(d, kv, hd),
        "wv": dense_init(gen, d, kv * hd, **kw)["w"].reshape(d, kv, hd),
        "wo": dense_init(gen, h * hd, d, **kw)["w"].reshape(h, hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, kind="rmsnorm", **kw)
        p["k_norm"] = norm_init(hd, kind="rmsnorm", **kw)
    return p


def _project_qkv(p, cfg: ModelConfig, x, positions):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd); RoPE applied."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "q_norm" in p:
        q = norm_apply(p["q_norm"], q)
        k = norm_apply(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, ctx):
    """ctx: (B, S, H, hd) -> (B, S, d)."""
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"].to(ctx.dtype))


def _gqa_attend(q, k, v, mask, *, head_dim: int):
    """q: (B,Sq,H,hd)  k/v: (B,Sk,KV,hd)  mask: broadcastable to (B,Sq,Sk).
    Head h = kv·G + g.  Returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg, k).float()
    scores = scores / math.sqrt(head_dim)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhgqs,bshk->bqhgk", probs, v)
    return ctx.reshape(b, sq, h, hd)


def make_causal_mask(q_pos, kv_pos, *, window: int = 0, num_meta: int = 0):
    """q_pos: (..., Sq), kv_pos: (..., Sk) absolute positions ->
    (..., Sq, Sk) bool.  Leading dims broadcast."""
    q = q_pos[..., :, None]
    s = kv_pos[..., None, :]
    m = (s >= 0) & (s <= q)
    if window:
        m = m & ((q - s < window) | (s < num_meta))
    return m


def _window(cfg: ModelConfig, layer_idx: int) -> int:
    return 0 if layer_idx in cfg.global_attn_layers else cfg.sliding_window


def attn_full(p, cfg: ModelConfig, x, *, layer_idx: int = 0, positions=None,
              return_kv: bool = False):
    """Parallel causal attention over the full sequence (prefill)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    mask = make_causal_mask(positions, positions, window=_window(cfg, layer_idx),
                            num_meta=cfg.num_meta_tokens)[None]
    ctx = _gqa_attend(q, k, v, mask, head_dim=cfg.resolved_head_dim)
    y = _out_proj(p, ctx)
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# Cache plumbing
# ---------------------------------------------------------------------------


def _slot_for(pos, buf_len: int, num_reserved: int):
    """Ring-buffer slot assignment with reserved leading (meta-token) slots."""
    ring = buf_len - num_reserved
    wrapped = num_reserved + torch.remainder(pos - num_reserved, ring)
    return torch.where(pos < num_reserved, pos, wrapped).to(torch.int32)


def _reserved_slots(cfg: ModelConfig, layer_idx: int, buf_len: int) -> int:
    return cfg.num_meta_tokens if _window(cfg, layer_idx) else 0


def cache_write(cache: Dict, cfg: ModelConfig, layer_idx: int, k, v,
                positions) -> Dict:
    """Scatter post-RoPE K/V for ``positions`` into the dense ring buffer,
    in place, and return the same cache dict.

    positions: (S,) shared across rows (prefill) or (B, S) per row (decode).
    """
    buf_len = cache["k"].shape[1]
    b = cache["k"].shape[0]
    nres = _reserved_slots(cfg, layer_idx, buf_len)

    if positions.dim() == 1:
        if positions.shape[0] > buf_len:
            # prefill longer than the window: keep the reserved (meta) head
            # plus the last (buf_len - nres) positions, so scatter slots stay
            # unique
            keep = buf_len - nres
            if nres:
                cache_write(cache, cfg, layer_idx, k[:, :nres], v[:, :nres],
                            positions[:nres])
            k, v, positions = k[:, -keep:], v[:, -keep:], positions[-keep:]
        slots = _slot_for(positions, buf_len, nres).long()
        cache["k"][:, slots] = k.to(cache["k"].dtype)
        cache["v"][:, slots] = v.to(cache["v"].dtype)
        cache["pos"][:, slots] = positions.to(torch.int32)[None].expand(b, -1)
        return cache

    slots = _slot_for(positions, buf_len, nres).long()              # (B, S)
    rows = torch.arange(b, device=slots.device)[:, None]
    cache["k"][rows, slots] = k.to(cache["k"].dtype)
    cache["v"][rows, slots] = v.to(cache["v"].dtype)
    cache["pos"][rows, slots] = positions.to(torch.int32)
    return cache


def attn_cached(p, cfg: ModelConfig, x_block, cache: Dict, length, *,
                layer_idx: int = 0) -> Tuple[torch.Tensor, Dict]:
    """Verify-substep attention: ``k`` fresh tokens vs the cache and each other.

    x_block : (B, k, d) tokens at absolute positions length .. length+k-1
    length  : (B,) or () int32 — number of *accepted* tokens per row.  Cache
              entries with pos >= length+k are stale speculative writes and
              are masked out; entries in [length, length+k) are overwritten
              by this call's own write.

    The block's K/V are written into ``cache`` in place (the reference
    returns a new cache).  That is sound because attention caches need no
    rollback: rejected entries are masked by position and overwritten by
    the next block (``blocks.commit_cache`` passes them through).
    """
    b, kblk, _ = x_block.shape
    length = torch.as_tensor(length, dtype=torch.int32,
                             device=x_block.device).expand(b)
    positions = length[:, None] + torch.arange(kblk, dtype=torch.int32,
                                               device=x_block.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x_block, positions)
    cache = cache_write(cache, cfg, layer_idx, k, v, positions)
    kv_pos = cache["pos"]                                            # (B, L)
    kv_pos = torch.where(kv_pos < (length + kblk)[:, None], kv_pos, -1)
    ctx = ops.verify_attention(q, cache["k"], cache["v"], positions, kv_pos,
                               window=_window(cfg, layer_idx),
                               num_meta=cfg.num_meta_tokens)
    return _out_proj(p, ctx), cache
