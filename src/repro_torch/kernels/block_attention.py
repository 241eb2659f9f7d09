"""BPD verify attention on Hopper: k fresh queries against a dense KV cache.

The CUDA kernel (``csrc/verify_attention.cu``) replaces the reference's
``repro/kernels/block_attention.py::verify_attention_pallas``: one thread
block per (batch row, KV head) holds the kq·G query rows of that head group
and streams the cache through shared memory with an fp32 online softmax.
``verify_attention_plain`` (``kernels/ref.py``) is its plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import verify_attention as verify_attention_plain

HEAD_DIMS = (32, 64, 128)
MAX_ROWS = 64                       # kq · G query rows per thread block
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 9 + [_P]

_require = functools.partial(_build.require, "verify_attention")

__all__ = ["verify_attention_cuda", "verify_attention_plain"]


def verify_attention_cuda(q, k, v, q_pos, kv_pos, *, window: int = 0,
                          num_meta: int = 0) -> torch.Tensor:
    """q: (B, kq, H, hd); k/v: (B, L, KV, hd); q_pos: (B, kq) int32;
    kv_pos: (B, L) int32 (-1 = empty or stale).  Returns (B, kq, H, hd) in
    q's dtype.  All tensors contiguous on one CUDA device."""
    _require(q.dim() == 4 and k.dim() == 4, "q and k/v must be 4-d")
    b, kq, h, hd = q.shape
    l, kvh = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        _require(t.device == q.device and t.is_cuda,
                 f"{name} must be on q's CUDA device")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(q.dtype in _build.DTYPE_CODES, f"dtype {q.dtype} not supported")
    _require(k.dtype == q.dtype and v.dtype == q.dtype,
             "q, k and v must share one dtype")
    _require(tuple(k.shape) == (b, l, kvh, hd) and v.shape == k.shape,
             f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _require(l >= 1 and kvh >= 1 and h % kvh == 0,
             f"{h} heads over {kvh} KV heads, L={l}")
    _require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    _require(kq * (h // kvh) <= MAX_ROWS,
             f"kq·G = {kq * (h // kvh)} query rows exceed {MAX_ROWS}")
    _require(q_pos.dtype == torch.int32 and tuple(q_pos.shape) == (b, kq),
             "q_pos must be (B, kq) int32")
    _require(kv_pos.dtype == torch.int32 and tuple(kv_pos.shape) == (b, l),
             "kv_pos must be (B, L) int32")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("verify_attention", "verify_attention", _ARGTYPES,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      q_pos.data_ptr(), kv_pos.data_ptr(), out.data_ptr(),
                      _build.DTYPE_CODES[q.dtype], b, kq, h, kvh, hd, l,
                      int(window), int(num_meta), stream)
    return out
