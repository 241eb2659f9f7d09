"""BPD heads' vocab projection with a running top-T, on Hopper.

The CUDA kernel (``csrc/fused_heads.cu``) replaces the reference's
``repro/kernels/fused_heads.py::fused_heads_topk_pallas``: the (N, d) ×
(d, Vp) logits are computed in fp32 tile by tile and never written out.
Thread blocks cannot carry a reduction across the grid, so it runs in two
passes: blocks over (vocab chunk, row tile) keep a per-row top-T of their
chunk in scratch, and a merge kernel reduces the chunks.  ``w_vocab`` is read
by its strides, so the tied embedding's ``table.t()`` view needs no copy.
``heads_topk_plain`` (``kernels/ref.py``) is its plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import heads_topk as heads_topk_plain

VOCAB_CHUNK = 64                    # vocab columns per pass-1 thread block
MAX_TOP_T = 8
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 6 + [_L, _L] + [_I] * 7 + [_P]

_require = functools.partial(_build.require, "fused_heads")

__all__ = ["fused_heads_topk_cuda", "heads_topk_plain"]


def fused_heads_topk_cuda(o, w_vocab, *, vocab: int, top_t: int = 4):
    """o: (N, d) contiguous; w_vocab: (d, Vp), any strides (the tied
    table's transpose view included).  Returns (vals (N, T) f32, ids (N, T)
    int32) over the logical vocab: lanes >= ``vocab`` never win."""
    _require(o.dim() == 2 and w_vocab.dim() == 2, "o and w_vocab must be 2-d")
    n, d = o.shape
    vp = w_vocab.shape[1]
    _require(o.is_cuda and w_vocab.device == o.device,
             "o and w_vocab must be on one CUDA device")
    _require(o.dtype in _build.DTYPE_CODES and w_vocab.dtype == o.dtype,
             f"dtypes {o.dtype}/{w_vocab.dtype}: need one of f32/bf16")
    _require(o.is_contiguous(), "o must be contiguous")
    _require(w_vocab.shape[0] == d, f"w_vocab {tuple(w_vocab.shape)} vs d={d}")
    _require(min(w_vocab.stride()) >= 1, "w_vocab strides must be positive")
    _require(n >= 1 and 1 <= top_t <= MAX_TOP_T and top_t <= vocab <= vp,
             f"N={n}, top_t={top_t}, vocab={vocab}, Vp={vp}")
    chunks = -(-vp // VOCAB_CHUNK)
    dev = o.device
    part_v = torch.empty((n, chunks, top_t), dtype=torch.float32, device=dev)
    part_i = torch.empty((n, chunks, top_t), dtype=torch.int32, device=dev)
    vals = torch.empty((n, top_t), dtype=torch.float32, device=dev)
    ids = torch.empty((n, top_t), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("fused_heads", "fused_heads_topk", _ARGTYPES,
                      o.data_ptr(), w_vocab.data_ptr(), part_v.data_ptr(),
                      part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                      w_vocab.stride(0), w_vocab.stride(1),
                      _build.DTYPE_CODES[o.dtype], n, d, vp, int(vocab), top_t,
                      chunks, stream)
    return vals, ids
