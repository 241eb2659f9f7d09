"""Per-layer block: attention + dense MLP, attention + MoE MLP, the RWKV-6
time mix + channel mix, or Hymba's attention and Mamba heads side by side +
dense MLP (the ``attn`` × ``dense``, ``attn`` × ``moe``, ``rwkv6`` ×
``rwkv_channel_mix`` and ``hymba`` × ``dense`` paths of
``repro.models.blocks``).  An encoder-decoder's decoder blocks add cross
attention between self attention and the MLP; an encoder's blocks
(hubert's, the encoder-decoder's) attend ``bidirectional``.

Two execution modes:
  * full   — whole-sequence parallel forward (prefill); optionally fills the
             decode cache.
  * cached — a block of ``k`` fresh tokens against the cache (the BPD
             verify substep).  Recurrent components return per-step states
             stacked along axis 1; ``commit_cache`` selects the accepted
             step.

On a ``model``-sharded ``ParamTree`` each sublayer sums its own
row-parallel products (``sharding.comm``), so a block's residual stream is
whole on every rank: attention's ``wo``, the dense MLP's ``w2``, the MoE
MLP's routed and shared experts in one sum (``models.moe``), RWKV-6's
``tm/wo`` and ``cm/wv`` (``models.rwkv6``), and the Mamba heads' ``x_proj``
and ``out_proj`` (``models.mamba``).  A Hymba layer's attention, whose
25 query heads over 5 KV heads divide no ``model`` axis of 2 or 4, stays
replicated (``sharding.local_kv_heads`` keeps every KV head; no leaf of it
is cut), so its output is not summed; the Mamba branch's ``out_proj`` sum
finishes inside ``mamba_apply``, before ``_hymba_fuse`` normalises each
branch over the full ``d``.  The per-step recurrent states stay at the
rank's wkv heads and Mamba channels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import cache as cache_lib
from repro_torch.models.attention import (
    CrossKV,
    attn_cached,
    attn_full,
    attn_init,
    cache_write,
    cross_attn_apply,
    cross_attn_full,
    cross_attn_init,
    tree_tables,
)
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init
from repro_torch.models.mamba import mamba_apply, mamba_init
from repro_torch.models.rwkv6 import (
    rwkv_cm_apply,
    rwkv_cm_init,
    rwkv_tm_apply,
    rwkv_tm_init,
)

SUPPORTED_BLOCKS = (("attn", "dense"), ("attn", "moe"),
                    ("rwkv6", "rwkv_channel_mix"), ("hymba", "dense"))
PORTED_ARCHS = ("granite-3-8b", "stablelm-12b", "starcoder2-7b",
                "nemotron-4-15b", "olmoe-1b-7b", "qwen2-moe-a2.7b",
                "rwkv6-1.6b", "hymba-1.5b", "llava-next-34b",
                "hubert-xlarge", "paper-mt-base")


def check_supported(cfg: ModelConfig) -> None:
    """The combinations the reference's registered archs use, and no other:
    decoder-only text models with attention + dense or MoE MLP blocks,
    RWKV-6 blocks or Hymba blocks (which alone may prepend meta tokens);
    a vision_text decoder with attention + dense MLP blocks behind its
    patch prefix (llava-next-34b); an audio encoder with attention + dense
    MLP blocks (hubert-xlarge); and encoder-decoders with attention +
    dense MLP blocks.  Anything else raises here, before any work."""
    pair = (cfg.block_type, cfg.mlp_type)
    plain = pair == SUPPORTED_BLOCKS[0]
    if cfg.is_encoder_decoder:
        ok = plain and cfg.modality == "text" and not cfg.is_encoder_only
    elif cfg.is_encoder_only:
        ok = plain and cfg.modality == "audio"
    elif cfg.modality == "vision_text":
        ok = plain
    else:
        ok = pair in SUPPORTED_BLOCKS and cfg.modality == "text"
    if not ok or (cfg.num_meta_tokens and cfg.block_type != "hymba"):
        raise NotImplementedError(
            f"{cfg.name}: block_type={cfg.block_type!r}, mlp_type="
            f"{cfg.mlp_type!r}, modality={cfg.modality!r}, "
            f"is_encoder_decoder={cfg.is_encoder_decoder}, is_encoder_only="
            f"{cfg.is_encoder_only} is not ported (see ROADMAP.md, 'Modules "
            f"to port'); the port runs text decoders with (block_type, "
            f"mlp_type) in {SUPPORTED_BLOCKS}, and vision_text decoders, "
            f"audio encoders and encoder-decoders with {SUPPORTED_BLOCKS[0]}: "
            f"the registered archs {PORTED_ARCHS}")


def check_tree_supported(cfg: ModelConfig) -> None:
    """Tree verification needs pure attention blocks: recurrent states are
    conditioned on the whole previous chain step by step, so a branching
    block has no single per-step state to roll back to."""
    if cfg.block_type != "attn":
        raise NotImplementedError(
            f"tree verification requires pure attention blocks "
            f"(block_type='attn'); {cfg.block_type!r} carries chain-"
            f"conditioned per-step recurrent state")


def block_init(gen, cfg: ModelConfig, layer_idx: int, *, dtype=torch.float32,
               device=None, cross_attention: bool = False) -> Dict:
    check_supported(cfg)
    kw = dict(dtype=dtype, device=device)
    p: Dict = {"ln1": norm_init(cfg.d_model, kind=cfg.norm_type, **kw)}
    if cfg.block_type == "rwkv6":
        p["tm"] = rwkv_tm_init(gen, cfg, **kw)
    else:
        p["attn"] = attn_init(gen, cfg, **kw)
    if cfg.block_type == "hymba":
        p["mamba"] = mamba_init(gen, cfg, **kw)
        p["fuse_ln_attn"] = norm_init(cfg.d_model, kind="rmsnorm", **kw)
        p["fuse_ln_ssm"] = norm_init(cfg.d_model, kind="rmsnorm", **kw)
        p["beta_attn"] = torch.ones((cfg.d_model,), **kw)
        p["beta_ssm"] = torch.ones((cfg.d_model,), **kw)
    if cross_attention:
        p["ln_cross"] = norm_init(cfg.d_model, kind=cfg.norm_type, **kw)
        p["cross"] = cross_attn_init(gen, cfg, **kw)
    p["ln2"] = norm_init(cfg.d_model, kind=cfg.norm_type, **kw)
    if cfg.mlp_type == "dense":
        p["mlp"] = mlp_init(gen, cfg, **kw)
    elif cfg.mlp_type == "moe":
        p["moe"] = moe_lib.moe_init(gen, cfg, **kw)
    else:
        p["cm"] = rwkv_cm_init(gen, cfg, **kw)
    return p


def block_cache_init(cfg: ModelConfig, layer_idx: int, batch: int,
                     context_len: int, block_k: int, dtype, device=None,
                     backend: Optional[cache_lib.KVCacheBackend] = None) -> Dict:
    """Static cache buffers for one layer (decode path): the attention cache
    in the layout of ``backend`` (dense when None), the RWKV-6 recurrent
    cache, or a Hymba layer's both: its attention cache and its Mamba
    cache, which every backend leaves as it is."""
    if cfg.block_type == "rwkv6":
        return {"tm": cache_lib.rwkv_cache_init(batch, cfg.d_model,
                                                cache_lib.wkv_heads(cfg),
                                                cfg.rwkv_head_dim, dtype,
                                                device)}
    be = backend if backend is not None else cache_lib.DenseBackend()
    c = {"attn": be.layer_attn_init(cfg, layer_idx, batch, context_len,
                                    block_k, dtype, device)}
    if cfg.block_type == "hymba":
        c["mamba"] = cache_lib.mamba_cache_init(
            batch, cache_lib.ssm_channels(cfg), cfg.ssm_state_dim,
            cfg.ssm_conv_width, dtype, device)
    return c


def block_full(p, cfg: ModelConfig, layer_idx: int, x, *, positions=None,
               bidirectional: bool = False, enc_kv: Optional[CrossKV] = None,
               cache: Optional[Dict] = None, kv_chunk: int = 0,
               moe_full_capacity: bool = False,
               metrics: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (y, cache_out); cache_out is filled when a cache is passed in
    (prefill).  ``bidirectional``: an encoder block; ``enc_kv``: a decoder
    block's source, attended on the plain path; ``kv_chunk``: the chunked
    softmax of ``attention.attn_full``.  An MoE block drops nothing under
    ``moe_full_capacity`` (the decode paths' prefills) and writes its
    metrics into ``metrics`` when given one."""
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    h = norm_apply(p["ln1"], x, kind=cfg.norm_type)
    cache_out = dict(cache) if cache is not None else None
    if cfg.block_type == "rwkv6":
        y, aux = rwkv_tm_apply(p["tm"], cfg, h)
        if cache is not None:
            cache_out["tm"] = {
                "shift_tm": aux["x_last"],
                "shift_cm": cache["tm"]["shift_cm"],  # filled below
                "state": aux["state"],
            }
    elif cfg.block_type == "hymba":
        y = _hymba_mix(p, cfg, layer_idx, h, positions, cache_out, kv_chunk)
    elif cache is not None:
        y, (kk, vv) = attn_full(p["attn"], cfg, h, layer_idx=layer_idx,
                                positions=positions, return_kv=True,
                                kv_chunk=kv_chunk)
        cache_out["attn"] = cache_write(cache["attn"], cfg, layer_idx, kk, vv,
                                        positions)
    else:
        y = attn_full(p["attn"], cfg, h, layer_idx=layer_idx,
                      positions=positions, bidirectional=bidirectional,
                      kv_chunk=kv_chunk)
    x = x + y
    if enc_kv is not None:
        h = norm_apply(p["ln_cross"], x, kind=cfg.norm_type)
        x = x + cross_attn_full(p["cross"], cfg, h, enc_kv)
    h = norm_apply(p["ln2"], x, kind=cfg.norm_type)
    if cfg.mlp_type == "dense":
        return x + mlp_apply(p["mlp"], h, act=cfg.activation), cache_out
    if cfg.mlp_type == "moe":
        y, m = _moe(p, cfg, layer_idx, h, lambda: positions.expand(
            x.shape[:2]), full_capacity=moe_full_capacity,
            metrics=metrics is not None)
        if metrics is not None:
            metrics.update(m)
        return x + y, cache_out
    y, cm_aux = rwkv_cm_apply(p["cm"], cfg, h)
    if cache_out is not None:
        cache_out["tm"] = dict(cache_out["tm"], shift_cm=cm_aux["x_last"])
    return x + y, cache_out


def block_cached(p, cfg: ModelConfig, layer_idx: int, x, cache: Dict,
                 length, *, enc_kv: Optional[CrossKV] = None, q_pos=None,
                 tree=None) -> Tuple[torch.Tensor, Dict]:
    """x: (B, k, d) fresh tokens at positions length..length+k-1 (or the
    nodes of draft tree ``tree``, see ``attention.attn_cached``; attention
    blocks only).  Returns (y, cache): the attention cache is written in
    place; an RWKV-6 cache comes back staged, its per-step shifts (the
    normed block inputs) and states stacked along axis 1 beside the old
    entries, for ``commit_cache``, and so does a Hymba layer's Mamba cache
    (its per-step conv windows and SSM states).  ``enc_kv``: a decoder
    block's source, attended through ``cross_attn_apply`` with the (B, k)
    zero ``q_pos``, which it then needs (every tree node attends to the
    whole source)."""
    if enc_kv is not None and q_pos is None:
        raise ValueError("block_cached: enc_kv needs the (B, k) zero q_pos")
    if tree is not None:
        check_tree_supported(cfg)
    new_cache = dict(cache)
    h = norm_apply(p["ln1"], x, kind=cfg.norm_type)
    if cfg.block_type == "hymba":
        ya, new_cache["attn"] = attn_cached(p["attn"], cfg, h, cache["attn"],
                                            length, layer_idx=layer_idx)
        mb = cache["mamba"]
        ym, maux = mamba_apply(p["mamba"], cfg, h, conv_state=mb["conv"],
                               h0=mb["h"], return_states=True)
        y = _hymba_fuse(p, ya, ym)
        new_cache["mamba"] = {
            "conv_steps": maux["conv"],                # (B,k,W-1,di)
            "h_steps": maux["ssm"],                    # (B,k,di,N)
            "conv": mb["conv"],
            "h": mb["h"],
        }
    elif cfg.block_type == "rwkv6":
        tm = cache["tm"]
        y, aux = rwkv_tm_apply(p["tm"], cfg, h, x_prev=tm["shift_tm"],
                               state0=tm["state"], return_states=True)
        new_cache["tm"] = {
            "shift_tm_steps": h,                       # (B,k,d)
            "state_steps": aux["state"],               # (B,k,H,D,D)
            "shift_tm": tm["shift_tm"],
            "shift_cm": tm["shift_cm"],
            "state": tm["state"],
        }
    else:
        y, new_cache["attn"] = attn_cached(p["attn"], cfg, h, cache["attn"],
                                           length, layer_idx=layer_idx,
                                           tree=tree)
    x = x + y
    if enc_kv is not None:
        h = norm_apply(p["ln_cross"], x, kind=cfg.norm_type)
        x = x + cross_attn_apply(p["cross"], cfg, h, enc_kv, q_pos)
    h = norm_apply(p["ln2"], x, kind=cfg.norm_type)
    if cfg.mlp_type == "dense":
        return x + mlp_apply(p["mlp"], h, act=cfg.activation), new_cache
    if cfg.mlp_type == "moe":
        y, _ = _moe(p, cfg, layer_idx, h,
                    lambda: _block_positions(x, length, tree),
                    full_capacity=True, metrics=False)
        return x + y, new_cache
    y, _ = rwkv_cm_apply(p["cm"], cfg, h, x_prev=cache["tm"]["shift_cm"])
    new_cache["tm"]["shift_cm_steps"] = h              # (B,k,d)
    return x + y, new_cache


def _hymba_fuse(p, ya, ym):
    """Hymba's head fusion: each path RMS-normed and scaled by its beta,
    then averaged."""
    dt = ya.dtype
    ya = norm_apply(p["fuse_ln_attn"], ya) * p["beta_attn"].to(dt)
    ym = norm_apply(p["fuse_ln_ssm"], ym) * p["beta_ssm"].to(dt)
    return 0.5 * (ya + ym)


def _hymba_mix(p, cfg: ModelConfig, layer_idx: int, h, positions, cache_out,
               kv_chunk: int):
    """A Hymba block's token mixer over a whole sequence: attention and the
    Mamba heads on the same normed input, fused; with ``cache_out`` (a
    prefill) it receives the K/V and the final Mamba states."""
    ya, (kk, vv) = attn_full(p["attn"], cfg, h, layer_idx=layer_idx,
                             positions=positions, return_kv=True,
                             kv_chunk=kv_chunk)
    ym, maux = mamba_apply(p["mamba"], cfg, h)
    if cache_out is not None:
        cache_out["attn"] = cache_write(cache_out["attn"], cfg, layer_idx,
                                        kk, vv, positions)
        cache_out["mamba"] = {"conv": maux["conv"], "h": maux["ssm"]}
    return _hymba_fuse(p, ya, ym)


def _block_positions(x, length, tree):
    """(B, k) logical positions of a cached block's tokens: length + slot
    along a chain, length + depth at a tree's nodes."""
    b, kblk = x.shape[:2]
    length = torch.as_tensor(length, dtype=torch.int32,
                             device=x.device).expand(b)
    offs = (torch.arange(kblk, dtype=torch.int32, device=x.device)
            if tree is None else tree_tables(tree, x.device)["depths"])
    return length[:, None] + offs[None, :]


def _moe(p, cfg: ModelConfig, layer_idx: int, h, positions, *,
         full_capacity: bool, metrics: bool):
    """The block's MoE MLP; ``positions`` (a thunk, run only when
    ``moe.ROUTER_TRACE`` is set) gives the (B, S) positions it reports."""
    trace = moe_lib.ROUTER_TRACE
    hook = None if trace is None else (
        lambda logits: trace(layer_idx, positions(), logits))
    return moe_lib.moe_apply(p["moe"], cfg, h, full_capacity=full_capacity,
                             metrics=metrics, trace=hook)


def _pick(steps, old, khat):
    """steps (B, k, ...), old (B, ...): step k̂-1 of each row, the old entry
    where k̂ == 0, in the old entry's dtype."""
    b = steps.shape[0]
    kh = torch.broadcast_to(torch.as_tensor(khat, device=steps.device), (b,))
    rows = torch.arange(b, device=steps.device)
    picked = steps[rows, (kh - 1).clamp(min=0).long()]
    keep_old = (kh == 0).reshape((b,) + (1,) * (old.dim() - 1))
    return torch.where(keep_old, old, picked.to(old.dtype))


def commit_cache(cfg: ModelConfig, cache: Dict, khat) -> Dict:
    """Resolve a staged cache to the accepted prefix.

    khat: (B,) or () int32 in [0, k] — tokens accepted per row this
    iteration (0 = the row is frozen: keep its pre-iteration state).
    Attention caches pass through (positions mask rejected entries);
    recurrent entries (RWKV-6's, a Hymba layer's Mamba cache) select step
    k̂-1.
    """
    tm, mb = cache.get("tm"), cache.get("mamba")
    if "state_steps" not in (tm or {}) and "h_steps" not in (mb or {}):
        return cache
    out = dict(cache)
    if tm is not None and "state_steps" in tm:
        out["tm"] = {
            "shift_tm": _pick(tm["shift_tm_steps"], tm["shift_tm"], khat),
            "shift_cm": _pick(tm["shift_cm_steps"], tm["shift_cm"], khat),
            "state": _pick(tm["state_steps"], tm["state"], khat),
        }
    if mb is not None and "h_steps" in mb:
        out["mamba"] = {"conv": _pick(mb["conv_steps"], mb["conv"], khat),
                        "h": _pick(mb["h_steps"], mb["h"], khat)}
    return out
