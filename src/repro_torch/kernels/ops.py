"""Public kernel entry points, dispatched by device.

A CUDA tensor goes to the hand-written kernel (which raises on anything it
does not take); a CPU tensor goes to the kernel's plain PyTorch version.
There is no other fallback.  Launch counts are in ``_build.LAUNCHES``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.block_attention import (tree_verify_attention_cuda,
                                                 verify_attention_cuda)
from repro_torch.kernels.fused_heads import fused_heads_topk_cuda
from repro_torch.kernels.fused_verify import fused_verify_cuda
from repro_torch.kernels.paged_attention import paged_verify_attention_cuda
from repro_torch.kernels.rwkv6_scan import RWKV6Scan, rwkv6_scan_cuda


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def verify_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                     num_meta: int = 0):
    """BPD verify-substep attention (see kernels.block_attention)."""
    fn = verify_attention_cuda if _on_card(q) else ref.verify_attention
    return fn(q, k, v, q_pos, kv_pos, window=window, num_meta=num_meta)


def tree_verify_attention(q, k, v, q_pos, kv_pos, kv_node, anc_bits, *,
                          window: int = 0, num_meta: int = 0):
    """Tree-verification attention: a whole candidate tree scored in one
    forward (see kernels.block_attention and kernels.tree_mask)."""
    fn = tree_verify_attention_cuda if _on_card(q) else ref.tree_verify_attention
    return fn(q, k, v, q_pos, kv_pos, kv_node, anc_bits, window=window,
              num_meta=num_meta)


def paged_verify_attention(q, kp, vp, tbl, q_pos, kv_pos, *, window: int = 0,
                           num_meta: int = 0):
    """BPD verify attention over a paged KV pool (see
    kernels.paged_attention)."""
    fn = paged_verify_attention_cuda if _on_card(q) else ref.paged_verify_attention
    return fn(q, kp, vp, tbl, q_pos, kv_pos, window=window, num_meta=num_meta)


def fused_verify(p1_logits, proposals, *, criterion: str, top_k: int = 1,
                 epsilon: float = 0.0):
    """One-pass block verification: top-T + criterion compare + prefix
    scan (see kernels.fused_verify).  Returns (accepts (B, k) bool, k̂ (B,)
    int32, accepted_tokens (B, k), next_greedy (B,)).  A 1-slot block takes
    the same route: the kernel scans nothing and returns slot 0's argmax."""
    fn = fused_verify_cuda if _on_card(p1_logits) else ref.fused_verify
    return fn(p1_logits, proposals, criterion=criterion, top_k=top_k,
              epsilon=epsilon)


def fused_heads_topk(o, w_vocab, *, vocab: int, top_t: int = 4):
    """Streaming head-logits top-T (see kernels.fused_heads)."""
    fn = fused_heads_topk_cuda if _on_card(o) else ref.heads_topk
    return fn(o, w_vocab, vocab=vocab, top_t=top_t)


def rwkv6_scan(r, k, v, logw, u, *, chunk: int = 16):
    """RWKV-6 wkv scan from a zero state (see kernels.rwkv6_scan).  Returns
    (y (B, S, H, D) f32, final state (B, H, D, D) f32).

    With grad enabled and any of r, k, v, logw or u requiring grad, the
    scan runs as ``RWKV6Scan`` (either device): the forward also writes the
    state at the start of every ``chunk`` steps, and the backward is the
    reverse scan from those checkpoints (``rwkv6_scan_bwd``).  ``chunk`` is
    thus the reference's checkpoint interval (its ``_wkv_scan(chunk=)``);
    on the card it is a multiple of 16.  Otherwise (decode, serve, anything
    under ``torch.no_grad``) the plain forward: no checkpoints, no saved
    inputs.  The result does not depend on ``chunk`` (the kernel runs the
    closed form on 8-step sub-chunks, the plain version step by step)."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    on_card = _on_card(r)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, logw, u)):
        return RWKV6Scan.apply(r, k, v, logw, u, chunk)
    fn = rwkv6_scan_cuda if on_card else ref.rwkv6_scan
    return fn(r, k, v, logw, u)
