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
(batch, H, D, D) fp32, the same under either backend.  A Hymba layer keeps
both: its attention cache and a Mamba cache (``mamba_cache_init``: the
conv's trailing inputs and the SSM state (batch, d_inner, N) fp32).  On a
``model``-sharded mesh a rank's state holds its H / M wkv heads and its
d_inner / M channels (``RankConfig``).
Windowed layers reserve ``num_meta_tokens`` leading slots of their ring for
the meta tokens, which every query sees.

Masking is computed from absolute positions, so BPD rollback is "decrease
the length": stale slots have ``pos >= length`` and are masked out until
overwritten, under either layout.  Windowed layers keep the dense ring
buffer under the paged backend (their buffers are window-bounded already).
The run-to-completion decode paths lay the block tables out as the
identity ``1 + b·P + i`` over a pool of ``1 + B·P`` pages, so they need no
allocator.  The serving engine builds ``PagedBackend(managed=True)``: its
tables start at the trash page 0 and ``serving.pages.PageAllocator`` maps
pages at admission, with copy-on-write prefix sharing.

Backend selection: ``get_backend(dec)`` reads ``DecodeConfig.cache_backend``
and ``page_size``; a ``KVCacheBackend`` also owns the serving engine's slot
lifecycle (``row_init``, ``reset_rows``, ``scatter_or_alloc``).  Unlike the
reference, which returns new caches, every lifecycle operation here writes
the slot slab in place, as the decode paths' cache writes do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class RankConfig(ModelConfig):
    """A config as one rank of a ``model``-sharded mesh holds its caches
    (``models.model.cache_config``): ``num_kv_heads`` the rank's KV heads,
    ``wkv_heads`` the RWKV-6 heads of its wkv state and ``ssm_channels`` the
    Mamba channels of its conv window and SSM state.  The token shifts and
    hymba's attention, replicated, keep their whole width."""

    wkv_heads: int = 0
    ssm_channels: int = 0


def wkv_heads(cfg: ModelConfig) -> int:
    """The wkv heads of an RWKV-6 layer's state: a rank's under a mesh."""
    return getattr(cfg, "wkv_heads", 0) or cfg.d_model // cfg.rwkv_head_dim


def ssm_channels(cfg: ModelConfig) -> int:
    """The channels of a Mamba cache: a rank's under a mesh."""
    return getattr(cfg, "ssm_channels", 0) or cfg.ssm_expand * cfg.d_model


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
                          dtype, device=None, *,
                          identity_tbl: bool = True) -> Dict:
    """Paged pool + block table for one full-attention layer.

    ``identity_tbl`` maps row b's logical page i to physical page
    ``1 + b * P + i``, the allocator-free layout of the run-to-completion
    decode paths.  Serving starts all-trash (``tbl = 0``) and maps pages at
    admission through ``serving.pages.PageAllocator``.
    """
    if identity_tbl:
        tbl = (1 + torch.arange(batch * pages_per_row, dtype=torch.int32,
                                device=device)).reshape(batch, pages_per_row)
    else:
        tbl = torch.zeros((batch, pages_per_row), dtype=torch.int32,
                          device=device)
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


def mamba_cache_init(batch: int, d_inner: int, state_dim: int,
                     conv_width: int, dtype, device=None) -> Dict:
    """One Hymba layer's Mamba cache: the conv's trailing inputs in the
    compute dtype and the SSM state in fp32.  It sits beside the layer's
    attention cache, and no KV layout changes it."""
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_inner, state_dim), dtype=torch.float32,
                         device=device),
    }


def _rows(idx):
    """An index that keeps the leading lane axis: ``i:i+1`` for an int,
    the index tensor itself for a (n,) tensor of rows."""
    return slice(idx, idx + 1) if isinstance(idx, int) else idx


def _masked_zero_(t: torch.Tensor, mask: torch.Tensor, value) -> None:
    t.masked_fill_(mask.reshape((-1,) + (1,) * (t.dim() - 1)), value)


def reset_rows(cache: Dict, mask: torch.Tensor) -> Dict:
    """Invalidate, in place, the cache rows selected by ``mask`` ((B,) bool
    on the cache's device): the slot-recycling primitive of the serving
    engine.  An evicted row's KV slots get ``pos = -1`` (masked out of
    every attention) and its recurrent state returns to zero; K/V values
    stay, unreachable, until the next admission overwrites the row.  Paged
    rows also drop their block table to the trash page (``tbl = 0``), so a
    later speculative write from the retired row cannot touch pages the
    host allocator has handed to another slot."""
    if "attn" in cache:
        a = cache["attn"]
        _masked_zero_(a["pos"], mask, -1)
        if "tbl" in a:
            _masked_zero_(a["tbl"], mask, 0)
    for key in ("tm", "mamba"):
        for v in cache.get(key, {}).values():
            _masked_zero_(v, mask, 0)
    return cache


def _scatter_tree(full, row, slot, src_row) -> None:
    if isinstance(full, dict):
        for key, val in full.items():
            _scatter_tree(val, row[key], slot, src_row)
        return
    full[_rows(slot)] = row[_rows(src_row)].to(full.dtype)


def scatter_row(cache: Dict, row_cache: Dict, slot, *, row=0) -> Dict:
    """Write row ``row`` of ``row_cache`` into row ``slot`` of ``cache``, in
    place: how the engine installs an admitted request's prefilled caches
    into a freed slot while the other slots keep their state.  ``slot`` and
    ``row`` are ints, or (n,) index tensors on the cache's device that
    install n rows in one indexed write.  Leaf structures must match."""
    _scatter_tree(cache, row_cache, slot, row)
    return cache


def write_pages(cache: Dict, row_cache: Dict, tbl_row, write_mask, *,
                row=0) -> Dict:
    """The pool half of a paged admission, in place: logical page i of
    packet row ``row`` (keys ``[i*ps, (i+1)*ps)`` of ``row_cache``'s
    attention buffers, exactly ``P * page_size`` long) into physical page
    ``tbl_row[i]`` wherever ``write_mask[i]``; masked pages (copy-on-write
    prefix hits, unmapped tail pages) go to the trash page 0, so a shared
    page is never written by an admission.  ``tbl_row`` / ``write_mask``
    are (P,) or (n, P) with ``row`` an int or (n,) index tensor."""
    a, r = cache["attn"], row_cache["attn"]
    num_pages, ps, kvh, hd = a["kp"].shape
    n_pages = a["tbl"].shape[1]
    dst = torch.where(write_mask.reshape(-1, n_pages),
                      tbl_row.reshape(-1, n_pages).to(torch.int32),
                      0).reshape(-1).long()
    for name, src in (("kp", "k"), ("vp", "v")):
        pages = r[src][_rows(row)].reshape(-1, ps, kvh, hd)
        a[name][dst] = pages.to(a[name].dtype)
    return cache


def scatter_row_paged(cache: Dict, row_cache: Dict, slot, tbl_row,
                      write_mask, *, row=0, pages: bool = True) -> Dict:
    """Paged admission: install prefilled dense rows into the page pool, in
    place.

    ``row_cache``'s attention buffers are exactly ``P * page_size`` long
    (``PagedBackend.row_init``), so logical page i of a row is its keys
    ``[i*ps, (i+1)*ps)``.  ``tbl_row`` ((P,) or (n, P) int32) is the host
    allocator's physical mapping of each slot and ``write_mask`` (same
    shape, bool) the pages to write (``write_pages``); ``pages`` False
    leaves the pool to a ``write_pages`` call of its own (a sharded engine
    writes an admission's pages on every rank of a replicated pool, its
    slot rows only where the slot lives).  ``slot`` / ``row`` as in
    ``scatter_row``.  Non-attention parts scatter densely.
    """
    if pages:
        write_pages(cache, row_cache, tbl_row, write_mask, row=row)
    a, r = cache["attn"], row_cache["attn"]
    a["tbl"][_rows(slot)] = tbl_row.reshape(-1, a["tbl"].shape[1]).to(
        torch.int32)
    a["pos"][_rows(slot)] = r["pos"][_rows(row)]
    for key in cache:
        if key != "attn":
            _scatter_tree(cache[key], row_cache[key], slot, row)
    return cache


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


class KVCacheBackend:
    """The construction and slot-lifecycle surface of the decode caches.

      init(cfg, batch, context_len, block_k, dtype=None)  -> caches
      row_init(cfg, context_len, block_k, dtype=None)     -> dense rows
                  (sized so a row scatters into ``init``'s buffers: the
                  admission prefill's workspace)
      reset_rows(caches, mask)                            -> caches
      scatter_or_alloc(caches, row_caches, slot, ...)     -> caches

    plus the per-layer hook ``layer_attn_init`` that
    ``blocks.block_cache_init`` dispatches through.  The lifecycle
    operations write in place and return the same caches.
    """

    name = "abstract"

    def layer_attn_init(self, cfg: ModelConfig, layer_idx: int, batch: int,
                        context_len: int, block_k: int, dtype,
                        device=None) -> Dict:
        raise NotImplementedError

    def init(self, cfg: ModelConfig, batch: int, context_len: int,
             block_k: int, dtype=None, *, device=None):
        from repro_torch.models import model as model_lib  # cache <- model

        return model_lib.init_caches(cfg, batch, context_len, block_k, dtype,
                                     device=device, backend=self)

    def row_init(self, cfg: ModelConfig, context_len: int, block_k: int,
                 dtype=None, *, batch: int = 1, device=None):
        """Admission-prefill workspace: ``batch`` rows in the dense layout
        (batch > 1 is a prefill worker's whole packet)."""
        from repro_torch.models import model as model_lib

        return model_lib.init_caches(cfg, batch, context_len, block_k, dtype,
                                     device=device, backend=DenseBackend())

    def reset_rows(self, caches, mask):
        from repro_torch.models import model as model_lib

        return model_lib.reset_cache_rows(caches, mask)

    def scatter_or_alloc(self, caches, row_caches, slot, *, row=0,
                         tbl_row=None, write_mask=None):
        """Install prefilled rows: dense layers scatter, paged layers also
        bind the allocator's page mapping (``tbl_row`` / ``write_mask``,
        one mapping for every layer)."""
        from repro_torch.models import model as model_lib

        return model_lib.scatter_cache_row(caches, row_caches, slot, row=row,
                                           tbl_row=tbl_row,
                                           write_mask=write_mask)


class DenseBackend(KVCacheBackend):
    """One padded ``buf_len`` KV row per batch slot."""

    name = "dense"

    def layer_attn_init(self, cfg: ModelConfig, layer_idx: int, batch: int,
                        context_len: int, block_k: int, dtype,
                        device=None) -> Dict:
        buf = attn_buf_len(cfg, layer_idx, context_len, block_k)
        return attn_cache_init(batch, buf, cfg.num_kv_heads,
                               cfg.resolved_head_dim, dtype, device)


class _PagedRowBackend(DenseBackend):
    """Dense rows whose full-attention buffers are exactly ``P * page_size``
    long, so an admission prefill's output reshapes page-aligned into the
    pool (``scatter_row_paged``)."""

    name = "paged_row"

    def __init__(self, page_size: int):
        self.page_size = int(page_size)

    def layer_attn_init(self, cfg: ModelConfig, layer_idx: int, batch: int,
                        context_len: int, block_k: int, dtype,
                        device=None) -> Dict:
        if _is_window_layer(cfg, layer_idx):
            return super().layer_attn_init(cfg, layer_idx, batch, context_len,
                                           block_k, dtype, device)
        P = pages_per_row(context_len, block_k, self.page_size)
        return attn_cache_init(batch, P * self.page_size, cfg.num_kv_heads,
                               cfg.resolved_head_dim, dtype, device)


class PagedBackend(DenseBackend):
    """Paged pool layout for full-attention layers (windowed layers stay
    dense).  ``num_pages = 0`` sizes the pool to the identity layout's
    ``1 + batch * P`` pages.  ``managed=True`` (the serving engine, with
    an explicit pool size) starts every table at the trash page 0 for
    ``serving.pages.PageAllocator`` to map."""

    name = "paged"

    def __init__(self, page_size: int = 16, num_pages: int = 0,
                 managed: bool = False):
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.managed = bool(managed)

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
                                     dtype, device,
                                     identity_tbl=not self.managed)

    def row_init(self, cfg: ModelConfig, context_len: int, block_k: int,
                 dtype=None, *, batch: int = 1, device=None):
        from repro_torch.models import model as model_lib

        return model_lib.init_caches(
            cfg, batch, context_len, block_k, dtype, device=device,
            backend=_PagedRowBackend(self.page_size))


def get_backend(dec=None, *, num_pages: int = 0,
                managed: bool = False) -> KVCacheBackend:
    """Reads ``DecodeConfig.cache_backend`` (and ``page_size``); serving
    passes its pool size and ``managed=True``."""
    name = getattr(dec, "cache_backend", "dense") if dec is not None else "dense"
    if name in ("", "dense"):
        return DenseBackend()
    if name == "paged":
        return PagedBackend(getattr(dec, "page_size", 16),
                            num_pages=num_pages, managed=managed)
    raise ValueError(
        f"unknown cache_backend {name!r}: expected 'dense' or 'paged'")
