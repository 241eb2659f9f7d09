"""BPD verify attention over a paged KV cache, on Hopper.

The CUDA kernel (``csrc/paged_verify_attention.cu``) replaces the
reference's ``repro/kernels/paged_attention.py::paged_verify_attention_pallas``:
the context lives in a shared pool of fixed-size pages kp/vp (num_pages, ps,
KV, hd), and row b reaches its logical page i through the block table
``tbl[b, i]``.  It is the ``PagedRows`` instantiation of the split-KV body
(``csrc/split_attention.cuh``) that the dense kernels share: the KV axis is
cut into ``split_plan(P·ps)`` ranges over a thread-block cluster, and each
block stages its range's table entries in shared memory once, so no dense
copy of the pool is made.  The plan depends on L = P·ps alone, so the
result equals ``verify_attention_cuda`` on the gathered view ``kp[tbl]``
bit for bit.  Physical page 0 is the trash page: unmapped entries point at
it and carry pos -1.  ``paged_verify_attention_plain`` (``kernels/ref.py``:
gather, then the dense plain version) is its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_attention import (_check_aligned,
                                                 check_attention_inputs,
                                                 launch_attention, split_plan)
from repro_torch.kernels.ref import paged_verify_attention as paged_verify_attention_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 13 + [_P]
MAX_STAGED_PAGES = 512      # csrc/split_attention.cuh: PagedRows::kStaged

__all__ = ["paged_verify_attention_cuda", "paged_verify_attention_plain"]


def paged_verify_attention_cuda(q, kp, vp, tbl, q_pos, kv_pos, *,
                                window: int = 0,
                                num_meta: int = 0) -> torch.Tensor:
    """q: (B, kq, H, hd); kp/vp: (num_pages, ps, KV, hd) with ps % 8 == 0;
    tbl: (B, P) int32 physical page ids; q_pos: (B, kq) int32; kv_pos:
    (B, P·ps) int32 logical positions (-1 = masked).  Returns (B, kq, H,
    hd) in q's dtype.  All tensors contiguous on one CUDA device."""
    kernel = "paged_verify_attention"
    _build.require(kernel, tbl.dim() == 2 and kp.dim() == 4,
                   "tbl must be (B, P) and kp/vp (num_pages, ps, KV, hd)")
    b, n_pages_row = tbl.shape
    num_pages, ps = kp.shape[0], kp.shape[1]
    l = n_pages_row * ps
    _build.require(kernel, ps >= 8 and ps % 8 == 0,
                   f"page_size {ps} must be a multiple of 8")
    check_attention_inputs(kernel, q, kp, vp, q_pos, kv_pos, kv_len=l,
                           tbl=tbl)
    _build.require(kernel, q.shape[0] == b, "tbl batch != q batch")
    _check_aligned(kernel, q, kp, vp)
    splits, keys = split_plan(l)
    _build.require(kernel, keys // ps + 2 <= MAX_STAGED_PAGES,
                   f"a range of {keys} keys spans more than "
                   f"{MAX_STAGED_PAGES} pages of {ps}")
    _, kq, h, hd = q.shape
    return launch_attention(kernel, _ARGTYPES, q,
                            (kp, vp, tbl, q_pos, kv_pos),
                            (b, kq, h, kp.shape[2], hd, num_pages, ps,
                             n_pages_row, int(window), int(num_meta), splits))
