"""BPD heads' vocab projection with a running top-T, on Hopper.

The CUDA kernel (``csrc/fused_heads.cu``) replaces the reference's
``repro/kernels/fused_heads.py::fused_heads_topk_pallas``: the (N, d) ×
(d, Vp) logits are computed in fp32 tile by tile and never written out.
The products run on the tensor cores (``wgmma``, the vocab as the M side)
fed by a ring of TMA loads; persistent blocks walk contiguous ranges of
128-lane vocab tiles (``vocab_plan``), each carrying a per-row top-T
across its tiles, and a small merge kernel reduces the blocks' partials.
bf16 takes both operands from shared memory; fp32 splits each operand
into two TF32 parts and sums three TF32 products (lo·hi + hi·lo + hi·hi,
"3xTF32"), which keeps fp32 accuracy: w's fragments are split in
registers, o's parts by a small kernel in the same call, into a (2, N, d)
scratch the wrapper allocates.  ``w_vocab`` is read by its strides, so the
tied embedding's ``table.t()`` view needs no copy; one of its strides
must be 1 and the other a multiple of 16 bytes (a TMA tensor map's rule),
which both the tied view and a row-major ``lm_head`` meet.
``heads_topk_plain`` (``kernels/ref.py``) is its plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import heads_topk as heads_topk_plain

VOCAB_TILE = 128      # vocab lanes per tile (two m64 products)
MAX_TOP_T = 8
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_L, _L] + [_I] * 7 + [_P]

_require = functools.partial(_build.require, "fused_heads")

__all__ = ["fused_heads_topk_cuda", "heads_topk_plain", "vocab_plan",
           "block_tiles"]


def vocab_plan(vp: int, sms: int) -> tuple:
    """How the kernel cuts Vp lanes over the card: (blocks, tiles).
    ``tiles`` tiles of VOCAB_TILE lanes (the last ragged), one persistent
    block per SM at most and never more blocks than tiles; block i walks
    ``block_tiles(blocks, tiles, i)``.  ``csrc/fused_heads.cu`` computes
    the same tiles and refuses a block count outside [1, tiles]."""
    if vp < 1 or sms < 1:
        raise ValueError(f"vocab_plan needs Vp >= 1 and SMs >= 1, got {vp}, {sms}")
    tiles = -(-vp // VOCAB_TILE)
    return min(tiles, sms), tiles


def block_tiles(blocks: int, tiles: int, i: int) -> range:
    """The contiguous tiles block ``i`` of ``blocks`` walks."""
    return range(i * tiles // blocks, (i + 1) * tiles // blocks)


def fused_heads_topk_cuda(o, w_vocab, *, vocab: int, top_t: int = 4):
    """o: (N, d) contiguous; w_vocab: (d, Vp) with one stride 1 and the
    other a multiple of 16 bytes (8 bf16 or 4 fp32 elements; the tied
    table's transpose view and a row-major lm_head both qualify), d a
    multiple of 16 bytes, both tensors on 16-byte boundaries.  Returns
    (vals (N, T) f32, ids (N, T) int32) over the logical vocab: lanes >=
    ``vocab`` never win."""
    _require(o.dim() == 2 and w_vocab.dim() == 2, "o and w_vocab must be 2-d")
    n, d = o.shape
    vp = w_vocab.shape[1]
    _require(n >= 1 and 1 <= top_t <= MAX_TOP_T and top_t <= vocab <= vp,
             f"N={n}, top_t={top_t}, vocab={vocab}, Vp={vp}")
    _require(o.dtype in _build.DTYPE_CODES and w_vocab.dtype == o.dtype,
             f"dtypes {o.dtype}/{w_vocab.dtype}: need one of f32/bf16")
    _require(o.is_contiguous(), "o must be contiguous")
    _require(w_vocab.shape[0] == d, f"w_vocab {tuple(w_vocab.shape)} vs d={d}")
    ws0, ws1 = w_vocab.stride()
    _require(min(ws0, ws1) >= 1, "w_vocab strides must be positive")
    name = "bf16" if o.dtype == torch.bfloat16 else "fp32"
    align = 16 // o.element_size()             # elements in 16 bytes
    pitch = ws1 if ws0 == 1 else ws0
    _require(1 in (ws0, ws1) and pitch % align == 0,
             f"{name} w_vocab strides {(ws0, ws1)}: one must be 1 and the "
             f"other a multiple of 16 bytes ({align} elements)")
    _require(d % align == 0,
             f"{name} d={d}: o's rows must be a multiple of 16 bytes")
    _require(o.data_ptr() % 16 == 0 and w_vocab.data_ptr() % 16 == 0,
             f"{name} o and w_vocab must start on 16-byte boundaries")
    _require(o.is_cuda and w_vocab.device == o.device,
             "o and w_vocab must be on one CUDA device")
    dev = o.device
    parts, _ = vocab_plan(vp, _build.sm_count(dev))
    part_v = torch.empty((n, parts, top_t), dtype=torch.float32, device=dev)
    part_i = torch.empty((n, parts, top_t), dtype=torch.int32, device=dev)
    vals = torch.empty((n, top_t), dtype=torch.float32, device=dev)
    ids = torch.empty((n, top_t), dtype=torch.int32, device=dev)
    # fp32: o's TF32 high and low parts, written by the call's first kernel
    split = (torch.empty((2, n, d), dtype=torch.float32, device=dev)
             if o.dtype == torch.float32 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("fused_heads", "fused_heads_topk", _ARGTYPES,
                      o.data_ptr(), w_vocab.data_ptr(),
                      None if split is None else split.data_ptr(),
                      part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
                      ids.data_ptr(), ws0, ws1, _build.DTYPE_CODES[o.dtype],
                      n, d, vp, int(vocab), top_t, parts, stream)
    return vals, ids
