"""GQA attention with RoPE, sliding windows and a BPD-aware KV cache, dense
or paged.

Entry points, as in ``repro.models.attention``:
  * ``attn_full``   — parallel forward over a whole sequence (prefill, or
                      the encoder with ``bidirectional``); a plain tensor
                      path, as in the reference, and with ``kv_chunk`` > 0
                      the reference's memory-bounded chunked softmax
                      (``_chunked_attend``: no (S, S) score matrix).
  * ``attn_cached`` — scores a block of ``k`` fresh tokens against the cache
                      and each other (the paper's verify substep), as a
                      chain or as a candidate tree, through the kernels of
                      ``kernels.ops`` (the CUDA kernel for tensors on the
                      card, its plain version on the CPU):

                        chain, dense cache  -> verify_attention
                        chain, paged cache  -> paged_verify_attention
                        tree,  dense cache  -> tree_verify_attention
                        tree,  paged cache  -> cache_kv_view's page gather,
                                               then tree_verify_attention
  * ``tree_commit_attn`` — after a tree forward, moves the accepted
                      root-to-leaf path's K/V into chain slots.
  * ``cross_kv`` / ``cross_attn_full`` / ``cross_attn_apply`` — the
                      encoder-decoder's cross attention (the paper's MT
                      setting): the encoder's K/V once per source, then
                      the plain path for whole sequences and
                      ``verify_attention`` for a cached block; on a
                      sharded tree at a rank's heads, as self attention.

Masking is computed from absolute positions, so the BPD rollback ("length
decreases by up to k-1") moves no data.  Caches are written in place (the
reference returns new ones).

On a sharded ``ParamTree`` a rank computes its own query heads (``wq`` cut
over the ``model`` axis, head numbering h = kv·G + g kept) against the KV
heads they read (``wk`` / ``wv`` cut the same way, or, where the KV heads
do not divide the axis, the one KV head the rank's heads share:
``sharding.local_kv_heads``), and ``wo``'s partial products are summed over
``model``.  Its caches hold those KV heads only.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, norm_apply, norm_init
from repro_torch.sharding import comm

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


def _kv_weights(p, cfg: ModelConfig):
    """``wk`` / ``wv`` as this rank reads them: its block when they are cut
    over ``model``, whole where attention is replicated, and where only the
    query heads are cut, the one KV head the rank's query heads share
    (``sharding.local_kv_heads``)."""
    wk, wv = p["wk"], p["wv"]
    if comm.cut(p, "wq") is not None and comm.cut(p, "wk") is None:
        kv0 = p.mesh.coords["model"] * p["wq"].shape[1] // cfg.num_kv_groups
        wk, wv = wk[:, kv0:kv0 + 1], wv[:, kv0:kv0 + 1]
    return wk, wv


def _project_qkv(p, cfg: ModelConfig, x, positions, *, rope: bool = True):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd); RoPE applied unless
    ``rope`` is False (the encoder)."""
    wk, wv = _kv_weights(p, cfg)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, wk.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, wv.to(x.dtype))
    if "q_norm" in p:
        q = norm_apply(p["q_norm"], q)
        k = norm_apply(p["k_norm"], k)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, ctx):
    """ctx: (B, S, H, hd) -> (B, S, d), summed over the ``model`` axis
    when ``wo``'s heads are cut over it."""
    wo = p["wo"]
    if comm.cut(p, "wo") is None:
        return torch.einsum("bshk,hkd->bsd", ctx, wo.to(ctx.dtype))
    b, s, h, k = ctx.shape
    return comm.row_sum(p.mesh, ctx.reshape(b * s, h * k),
                        wo.reshape(h * k, -1)).reshape(b, s, -1)


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


def make_causal_mask(q_pos, kv_pos, *, window: int = 0, num_meta: int = 0,
                     bidirectional: bool = False):
    """q_pos: (..., Sq), kv_pos: (..., Sk) absolute positions ->
    (..., Sq, Sk) bool.  Leading dims broadcast.  ``bidirectional`` keeps
    only ``kv_pos >= 0``."""
    q = q_pos[..., :, None]
    s = kv_pos[..., None, :]
    if bidirectional:
        return (s >= 0).expand(torch.broadcast_shapes(q.shape, s.shape))
    m = (s >= 0) & (s <= q)
    if window:
        m = m & ((q - s < window) | (s < num_meta))
    return m


def _window(cfg: ModelConfig, layer_idx: int) -> int:
    return 0 if layer_idx in cfg.global_attn_layers else cfg.sliding_window


def attn_full(p, cfg: ModelConfig, x, *, layer_idx: int = 0, positions=None,
              bidirectional: bool = False, return_kv: bool = False,
              kv_chunk: int = 0):
    """Parallel attention over the full sequence: causal (prefill), or
    ``bidirectional`` with no RoPE and no window (the encoder).
    ``kv_chunk`` > 0 scans the keys in chunks of that many with an online
    softmax (``_chunked_attend``), so no (S, S) score matrix is made: the
    reference's long-prefill path."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions, rope=not bidirectional)
    window = 0 if bidirectional else _window(cfg, layer_idx)
    if kv_chunk:
        ctx = _chunked_attend(q, k, v, positions, positions, window=window,
                              num_meta=cfg.num_meta_tokens,
                              bidirectional=bidirectional,
                              head_dim=cfg.resolved_head_dim, chunk=kv_chunk)
    else:
        mask = make_causal_mask(positions, positions, window=window,
                                num_meta=cfg.num_meta_tokens,
                                bidirectional=bidirectional)[None]
        ctx = _gqa_attend(q, k, v, mask, head_dim=cfg.resolved_head_dim)
    y = _out_proj(p, ctx)
    if return_kv:
        return y, (k, v)
    return y


def _chunked_attend(q, k, v, q_pos, kv_pos, *, window, num_meta,
                    bidirectional, head_dim, chunk):
    """Online-softmax attention over the keys in chunks of ``chunk``, in
    fp32, as the reference's: per chunk the scores of every query against
    ``chunk`` keys, the running max ``m``, sum ``l`` and unnormalised
    output ``acc`` rescaled by exp(m_old - m_new).  The largest
    intermediate is (B, KV, G, Sq, chunk) instead of (.., Sq, Sk).
    q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd), q_pos (Sq,) or (B, Sq),
    kv_pos (Sk,) or (B, Sk).  Returns (B, Sq, H, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    q_pos = torch.as_tensor(q_pos).expand(b, sq)
    kv_pos = torch.as_tensor(kv_pos).expand(b, sk)
    qg = q.reshape(b, sq, kvh, g, hd).float() / math.sqrt(head_dim)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        scores = torch.einsum("bqhgk,bshk->bhgqs", qg, kb)
        mask = make_causal_mask(q_pos, kv_pos[:, c0:c0 + chunk], window=window,
                                num_meta=num_meta,
                                bidirectional=bidirectional)   # (B, Sq, c)
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(scores - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqs,bshk->bhgqk",
                                                    pexp, vb)
        m = m_new
    ctx = acc / torch.clamp(l, min=1e-30)[..., None]
    return ctx.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


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


def _paged_cache_write(cache: Dict, k, v, positions) -> Dict:
    """Scatter K/V through the block table into the page pool, in place.

    Paged layers are full-attention, so position p lives at offset
    ``p % page_size`` of logical page ``p // page_size``, i.e. at physical
    slot ``tbl[b, p // ps] * ps + p % ps``; ``pos`` is indexed by position.
    positions: (S,) shared across rows (prefill) or (B, S) per row.
    """
    kp, vp, tbl = cache["kp"], cache["vp"], cache["tbl"]
    num_pages, ps, kvh, hd = kp.shape
    b = tbl.shape[0]
    positions = positions.to(torch.int32)
    if positions.dim() == 1:
        positions = positions[None].expand(b, -1)
    s = positions.shape[1]
    rows = torch.arange(b, device=tbl.device)[:, None]
    pl = positions.long()
    phys = (tbl[rows, pl // ps].long() * ps + pl % ps).reshape(-1)
    kp.view(num_pages * ps, kvh, hd)[phys] = k.reshape(b * s, kvh, hd).to(kp.dtype)
    vp.view(num_pages * ps, kvh, hd)[phys] = v.reshape(b * s, kvh, hd).to(vp.dtype)
    cache["pos"][rows, pl] = positions
    return cache


def cache_kv_view(cache: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (B, L, KV, hd) K/V that attention scores against: the arrays
    themselves for a dense layer, a page gather for a paged one (column j
    of the view is position j)."""
    if "kp" in cache:
        kp, vp, tbl = cache["kp"], cache["vp"], cache["tbl"]
        _, ps, kvh, hd = kp.shape
        b, n_pages = tbl.shape
        idx = tbl.long()
        return (kp[idx].reshape(b, n_pages * ps, kvh, hd),
                vp[idx].reshape(b, n_pages * ps, kvh, hd))
    return cache["k"], cache["v"]


def cache_write(cache: Dict, cfg: ModelConfig, layer_idx: int, k, v,
                positions) -> Dict:
    """Scatter post-RoPE K/V for ``positions`` into the dense ring buffer
    or through the block table (paged), in place, and return the same cache
    dict.

    positions: (S,) shared across rows (prefill) or (B, S) per row (decode).
    """
    if "kp" in cache:
        return _paged_cache_write(cache, k, v, positions)
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


@functools.lru_cache(maxsize=64)
def tree_tables(tree, device) -> Dict[str, torch.Tensor]:
    """A topology's tables as tensors on ``device``, made once per topology
    and device: every layer of every tree iteration reads them, and a copy
    from pageable host memory would wait for the stream each time.  The
    tensors are shared; callers never write to them.

      depths (N,) int32, anc_bits (N,) int32, nodes (N,) int32 = 0..N-1,
      paths (N, N) int32 = ``path_matrix`` padded with -1,
      verify_perm (N,) int64 = parents[1:] + (0,), ranks (N,) int64.
    """
    n = tree.num_nodes
    paths = np.full((n, n), -1, np.int32)
    paths[:, :tree.max_depth + 1] = tree.path_matrix
    tables = {"depths": (tree.depths, torch.int32),
              "anc_bits": (tree.anc_bits, torch.int32),
              "nodes": (np.arange(n), torch.int32),
              "paths": (paths, torch.int32),
              "verify_perm": (tree.parents[1:] + (0,), torch.int64),
              "ranks": (tree.ranks, torch.int64)}
    return {name: torch.as_tensor(np.asarray(t), dtype=dt, device=device)
            for name, (t, dt) in tables.items()}


def attn_cached(p, cfg: ModelConfig, x_block, cache: Dict, length, *,
                layer_idx: int = 0, tree=None) -> Tuple[torch.Tensor, Dict]:
    """Verify-substep attention: ``k`` fresh tokens vs the cache and each other.

    x_block : (B, k, d) tokens at absolute positions length .. length+k-1
    length  : (B,) or () int32 — number of *accepted* tokens per row.  Cache
              entries with pos >= length+k are stale speculative writes and
              are masked out; entries in [length, length+k) are overwritten
              by this call's own write.
    tree    : optional ``kernels.tree_mask.TreeTopology`` — the block is a
              draft tree of ``k`` nodes.  Node n still writes its K/V at
              storage position ``length + n``, but RoPE runs at its logical
              position ``length + depth[n]``, and the kernel sees the
              block's columns at those logical positions with node ids, so
              each node attends to its root-to-node chain plus the
              committed cache.  ``tree_commit_attn`` then compacts the
              accepted path into chain slots.

    The reference's ``kv_chunk`` has no counterpart here: a block's scores
    are (k, L), which bounds no memory that matters, and the verify kernels
    stream the cache in split-KV ranges of their own.

    The block's K/V are written into ``cache`` in place (the reference
    returns a new cache).  That is sound because attention caches need no
    rollback: rejected entries are masked by position and overwritten by
    the next block (``blocks.commit_cache`` passes them through).
    """
    b, kblk, _ = x_block.shape
    dev = x_block.device
    length = torch.as_tensor(length, dtype=torch.int32, device=dev).expand(b)
    slot_ids = torch.arange(kblk, dtype=torch.int32, device=dev)
    positions = length[:, None] + slot_ids[None, :]
    if tree is None:
        rope_pos = positions
    else:
        if tree.num_nodes != kblk:
            raise ValueError(
                f"tree topology has {tree.num_nodes} nodes but the block "
                f"has {kblk} slots")
        tables = tree_tables(tree, dev)
        rope_pos = length[:, None] + tables["depths"][None, :]
    q, k, v = _project_qkv(p, cfg, x_block, rope_pos)
    cache = cache_write(cache, cfg, layer_idx, k, v, positions)
    window = _window(cfg, layer_idx)
    kv_pos = cache["pos"]                                            # (B, L)
    kv_pos = torch.where(kv_pos < (length + kblk)[:, None], kv_pos, -1)
    if tree is None:
        if "kp" in cache:
            ctx = ops.paged_verify_attention(
                q, cache["kp"], cache["vp"], cache["tbl"], positions, kv_pos,
                window=window, num_meta=cfg.num_meta_tokens)
        else:
            ctx = ops.verify_attention(q, cache["k"], cache["v"], positions,
                                       kv_pos, window=window,
                                       num_meta=cfg.num_meta_tokens)
        return _out_proj(p, ctx), cache
    # The block's columns of the K/V view (the ring slot of a dense layer,
    # the position itself for a paged one) carry the nodes' logical
    # positions and node ids; the kernel adds the ancestor-bit test there.
    if "kp" in cache:
        cols = positions
    else:
        buf_len = cache["k"].shape[1]
        cols = _slot_for(positions, buf_len,
                         _reserved_slots(cfg, layer_idx, buf_len))
    rows = torch.arange(b, device=dev)[:, None]
    kv_pos[rows, cols.long()] = rope_pos      # kv_pos is torch.where's copy
    kv_node = torch.full_like(kv_pos, -1)
    kv_node[rows, cols.long()] = tables["nodes"][None, :].expand(b, -1)
    ck, cv = cache_kv_view(cache)
    ctx = ops.tree_verify_attention(
        q, ck, cv, rope_pos, kv_pos, kv_node,
        tables["anc_bits"][None, :].expand(b, -1).contiguous(), window=window,
        num_meta=cfg.num_meta_tokens)
    return _out_proj(p, ctx), cache


def tree_commit_attn(cache: Dict, cfg: ModelConfig, layer_idx: int,
                     path_nodes, khat, length, block_k: int) -> Dict:
    """Compact an accepted root-to-leaf tree path into chain slots, in place.

    After a tree verify forward, the K/V of the token committed at position
    ``length + j`` lives at storage position ``length + path_nodes[:, j]``
    (its RoPE position is already right, since depth[path_nodes[:, j]] ==
    j).  This copies those entries into the leading ``khat`` chain slots;
    slots at j >= k̂ keep their speculative entries, which the next block
    overwrites as in chain decode.  All sources are gathered into a fresh
    tensor before any slot is written: a source of one depth can be the
    destination of a deeper one.

    path_nodes : (B, k) int32 — node id at depth j (< 0 beyond the path)
    khat       : (B,) int32 accepted tokens; 0 = frozen row (unchanged)
    length     : (B,) or () int32 pre-accept lengths (the block's base)
    """
    b = path_nodes.shape[0]
    dev = path_nodes.device
    length = torch.as_tensor(length, dtype=torch.int32, device=dev).expand(b)
    j = torch.arange(block_k, dtype=torch.int32, device=dev)[None, :]
    node = path_nodes.clamp(0, block_k - 1)
    src_pos = (length[:, None] + node).long()
    dst_pos = (length[:, None] + j).long()
    keep = (j < khat[:, None]) & (node != j)
    rows = torch.arange(b, device=dev)[:, None]
    # every chain slot is rewritten, a slot that keeps its entry from
    # itself: a boolean selection would wait for the device to count it
    if "kp" in cache:
        kp, tbl = cache["kp"], cache["tbl"]
        num_pages, ps, kvh, hd = kp.shape
        src = tbl[rows, src_pos // ps].long() * ps + src_pos % ps
        dst = tbl[rows, dst_pos // ps].long() * ps + dst_pos % ps
        src = torch.where(keep, src, dst)
        for name in ("kp", "vp"):
            flat = cache[name].view(num_pages * ps, kvh, hd)
            flat[dst] = flat[src]          # the gather copies before the write
        return cache
    buf_len = cache["k"].shape[1]
    nres = _reserved_slots(cfg, layer_idx, buf_len)
    dst = _slot_for(dst_pos, buf_len, nres).long()
    src = torch.where(keep, _slot_for(src_pos, buf_len, nres).long(), dst)
    for name in ("k", "v"):
        buf = cache[name]
        buf[rows, dst] = buf[rows, src]    # the gather copies before the write
    return cache


# ---------------------------------------------------------------------------
# Cross attention (the paper's encoder-decoder MT setting)
# ---------------------------------------------------------------------------


class CrossKV(NamedTuple):
    """One decoder layer's view of the encoded source: K/V (B, Se, KV, hd)
    and ``kv_pos`` (B, Se) int32, 0 for a visible source key and -1 for a
    masked one (one tensor shared by every layer)."""

    k: torch.Tensor
    v: torch.Tensor
    kv_pos: torch.Tensor


def source_positions(src_mask, b: int, se: int, device) -> torch.Tensor:
    """The (B, Se) int32 ``kv_pos`` of a source: 0 where ``src_mask``
    (B, Se) bool is True, -1 where it is False; all 0 for None."""
    if src_mask is None:
        return torch.zeros((b, se), dtype=torch.int32, device=device)
    return torch.where(src_mask.to(device=device, dtype=torch.bool), 0,
                       -1).to(torch.int32)


def cross_attn_init(gen, cfg: ModelConfig, *, dtype=torch.float32,
                    device=None) -> Dict:
    return attn_init(gen, cfg, dtype=dtype, device=device)


def cross_kv(p, cfg: ModelConfig, enc_out, kv_pos) -> CrossKV:
    """The encoder's K/V for one decoder layer, once per source (no RoPE
    across modalities; ``k_norm`` where the config has it).  On a sharded
    ``ParamTree``, the KV heads this rank's query heads read
    (``_kv_weights``)."""
    wk, wv = _kv_weights(p, cfg)
    k = torch.einsum("bsd,dhk->bshk", enc_out, wk.to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out, wv.to(enc_out.dtype))
    if "k_norm" in p:
        k = norm_apply(p["k_norm"], k)
    return CrossKV(k.contiguous(), v.contiguous(), kv_pos)


def _cross_q(p, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if "q_norm" in p:
        q = norm_apply(p["q_norm"], q)
    return q


def cross_attn_full(p, cfg: ModelConfig, x, enc_kv: CrossKV):
    """x: (B, Sq, d) against the source, on the plain path (whole
    sequences: the BOS prefill, teacher forcing)."""
    mask = (enc_kv.kv_pos >= 0)[:, None, :]                      # (B, 1, Se)
    ctx = _gqa_attend(_cross_q(p, x), enc_kv.k, enc_kv.v, mask,
                      head_dim=cfg.resolved_head_dim)
    return _out_proj(p, ctx)


def cross_attn_apply(p, cfg: ModelConfig, x, enc_kv: CrossKV, q_pos):
    """x: (B, kq, d) fresh tokens against the source, through
    ``ops.verify_attention``: with every query at position 0 its mask
    (``kv_pos >= 0 and kv_pos <= q_pos``) is the source mask.  ``q_pos``
    is that (B, kq) int32 zero tensor, made once per decode by the
    caller."""
    ctx = ops.verify_attention(_cross_q(p, x).contiguous(), enc_kv.k,
                               enc_kv.v, q_pos, enc_kv.kv_pos)
    return _out_proj(p, ctx)
