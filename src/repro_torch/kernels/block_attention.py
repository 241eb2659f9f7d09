"""BPD verify attention on Hopper: k fresh queries against a dense KV cache,
as a chain (``verify_attention_cuda``) or as a candidate tree
(``tree_verify_attention_cuda``).

The CUDA kernels (``csrc/verify_attention.cu``, ``csrc/tree_verify_attention.cu``,
sharing the split-KV body in ``csrc/split_attention.cuh``) replace the
reference's ``repro/kernels/block_attention.py::verify_attention_pallas``
and ``tree_verify_attention_pallas``.  The KV axis is cut into
``split_plan(L)`` ranges, one thread block per (batch row, KV head, range),
the ranges of one (row, head) forming a thread-block cluster that combines
its partial softmaxes through distributed shared memory in the same launch.
bf16 products run on the tensor cores (``mma.sync``), fp32 on CUDA-core
FMAs.  The plan depends on L alone, so a query's result does not depend on
kq or B.  A block holds at most 64 query rows: kq·G rows of a (batch row,
KV head) past that are cut into ``row_plan(kq·G)`` tiles, one more grid
axis, still one launch (starcoder2-7b's G 9 gives 72 rows at block_k 8,
288 under a 32-node tree); the plan depends on kq·G alone and a row's
arithmetic not on its tile.  head_dim 24 is computed at the width 32 with
the padded lanes zero in shared memory, as the reference pads head_dim to
its lane width; the tensors keep their 24 lanes and the softmax scale
stays 1/√24.  head_dim 160 (stablelm-12b) is computed at its own width.
``verify_attention_plain`` and ``tree_verify_attention_plain``
(``kernels/ref.py``) are their plain versions.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import tree_verify_attention as tree_verify_attention_plain
from repro_torch.kernels.ref import verify_attention as verify_attention_plain

HEAD_DIMS = (16, 24, 32, 64, 128, 160)   # 24 computed at width 32
MAX_ROWS = 64                       # query rows per thread block (a row tile)
ROW_ALIGN = 16                      # rows per tile: a multiple of one mma
MAX_TREE_NODES = 32                 # anc_bits is one int32 per node
MAX_SPLITS = 8                      # the portable thread-block cluster size
MIN_SPLIT_KEYS = 64
SPLIT_ALIGN = 16                    # keys per range: a multiple of one k16 step
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 11 + [_P]
_TREE_ARGTYPES = [_P] * 8 + [_I] * 11 + [_P]

__all__ = ["verify_attention_cuda", "verify_attention_plain",
           "tree_verify_attention_cuda", "tree_verify_attention_plain",
           "check_attention_inputs", "launch_attention", "split_plan", "row_plan"]


def split_plan(kv_len: int) -> tuple:
    """How the split-KV kernels cut a cache of ``kv_len`` keys: (splits,
    keys per split).  Range i holds keys [i·keys, min(L, (i+1)·keys)); there
    is one range per 64 keys of L, rounded up, at most 8, ``keys`` is a
    multiple of 16, and no range is empty.  It depends on L alone, so a
    query's arithmetic does not depend on kq or B.  ``csrc/split_attention.cuh``
    has the same function and refuses a launch whose splits differ."""
    if kv_len < 1:
        raise ValueError(f"split_plan needs L >= 1, got {kv_len}")
    s = min(MAX_SPLITS, -(-kv_len // MIN_SPLIT_KEYS))
    keys = -(-(-(-kv_len // s)) // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-kv_len // keys), keys


def row_plan(rows: int) -> tuple:
    """How the split-KV kernels cut the ``rows`` = kq·G query rows of one
    (batch row, KV head): (tiles, rows per tile).  Tile i holds rows
    [i·per, min(rows, (i+1)·per)); there are ceil(rows / 64) tiles, ``per``
    is a multiple of 16 and at most 64, and no tile is empty (72 rows are
    48 + 24, 288 are four of 64 and one of 32).  It depends on the row count
    alone.  ``csrc/split_attention.cuh`` has the same function and refuses
    a launch whose tiles differ."""
    if rows < 1:
        raise ValueError(f"row_plan needs at least one row, got {rows}")
    n = -(-rows // MAX_ROWS)
    per = -(-(-(-rows // n)) // ROW_ALIGN) * ROW_ALIGN
    return -(-rows // per), per


def check_attention_inputs(kernel: str, q, k, v, q_pos, kv_pos, *,
                           kv_len: int, **extra) -> None:
    """The checks every verify-attention wrapper makes before a launch: q
    (B, kq, H, hd), k/v of q's dtype with KV heads in dim 2 and head_dim
    last, q_pos (B, kq) and kv_pos (B, kv_len) int32, ``extra`` int32
    tensors, all contiguous on q's CUDA device."""
    require = functools.partial(_build.require, kernel)
    require(q.dim() == 4 and k.dim() == 4, "q and k/v must be 4-d")
    b, kq, h, hd = q.shape
    kvh = k.shape[2]
    require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    require(kvh >= 1 and h % kvh == 0, f"{h} heads over {kvh} KV heads")
    tensors = {"q": q, "k": k, "v": v, "q_pos": q_pos, "kv_pos": kv_pos,
               **extra}
    for name, t in tensors.items():
        require(t.device == q.device and t.is_cuda,
                f"{name} must be on q's CUDA device")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(q.dtype in _build.DTYPE_CODES, f"dtype {q.dtype} not supported")
    require(k.dtype == q.dtype and v.dtype == q.dtype,
            "q, k and v must share one dtype")
    require(v.shape == k.shape and k.shape[3] == hd,
            f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    require(kv_len >= 1, f"L={kv_len} keys")
    require(q_pos.dtype == torch.int32 and tuple(q_pos.shape) == (b, kq),
            "q_pos must be (B, kq) int32")
    require(kv_pos.dtype == torch.int32
            and tuple(kv_pos.shape) == (b, kv_len),
            f"kv_pos must be (B, {kv_len}) int32")
    for name, t in extra.items():
        require(t.dtype == torch.int32, f"{name} must be int32")


def _check_aligned(kernel: str, q, k, v) -> None:
    """The split-KV kernels copy K/V rows in 16-byte pieces and read q in
    4-byte pairs: each tensor must start on a 16-byte boundary."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(kernel, t.data_ptr() % 16 == 0,
                       f"{name} must start on a 16-byte boundary")


def launch_attention(kernel: str, argtypes, q, pointers, ints) -> torch.Tensor:
    """Launch ``kernel``'s C entry (q, *pointers, out, dtype, *ints,
    row_tiles, stream) on q's device and current stream, ``row_tiles`` from
    q's kq·G rows; returns the new output."""
    _, kq, h, _ = q.shape
    row_tiles = row_plan(kq * (h // pointers[0].shape[2]))[0]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(kernel, kernel, argtypes, q.data_ptr(),
                      *(t.data_ptr() for t in pointers), out.data_ptr(),
                      _build.DTYPE_CODES[q.dtype], *ints, row_tiles, stream)
    return out


def verify_attention_cuda(q, k, v, q_pos, kv_pos, *, window: int = 0,
                          num_meta: int = 0) -> torch.Tensor:
    """q: (B, kq, H, hd); k/v: (B, L, KV, hd); q_pos: (B, kq) int32;
    kv_pos: (B, L) int32 (-1 = empty or stale).  Returns (B, kq, H, hd) in
    q's dtype.  All tensors contiguous on one CUDA device."""
    check_attention_inputs("verify_attention", q, k, v, q_pos, kv_pos,
                           kv_len=k.shape[1] if k.dim() == 4 else 0)
    b, kq, h, hd = q.shape
    _build.require("verify_attention", k.shape[0] == b, "k/v batch != q batch")
    _check_aligned("verify_attention", q, k, v)
    l = k.shape[1]
    return launch_attention("verify_attention", _ARGTYPES, q,
                            (k, v, q_pos, kv_pos),
                            (b, kq, h, k.shape[2], hd, l, int(window),
                             int(num_meta), split_plan(l)[0]))


def tree_verify_attention_cuda(q, k, v, q_pos, kv_pos, kv_node, anc_bits, *,
                               window: int = 0,
                               num_meta: int = 0) -> torch.Tensor:
    """``verify_attention_cuda`` for a candidate tree of kq <= 32 nodes.
    kv_node: (B, L) int32 node index of the block's slots, -1 for the
    committed prefix; anc_bits: (B, kq) int32 packed ancestor-or-self bits
    per query node (``TreeTopology.anc_bits``).  q_pos and kv_pos are
    logical (RoPE) positions."""
    check_attention_inputs("tree_verify_attention", q, k, v, q_pos, kv_pos,
                           kv_len=k.shape[1] if k.dim() == 4 else 0,
                           kv_node=kv_node, anc_bits=anc_bits)
    b, kq, h, hd = q.shape
    l = k.shape[1]
    _build.require("tree_verify_attention", k.shape[0] == b,
                   "k/v batch != q batch")
    _build.require("tree_verify_attention", kq <= MAX_TREE_NODES,
                   f"{kq} tree nodes exceed {MAX_TREE_NODES}")
    _build.require("tree_verify_attention",
                   tuple(kv_node.shape) == (b, l)
                   and tuple(anc_bits.shape) == (b, kq),
                   "kv_node must be (B, L) and anc_bits (B, kq)")
    _check_aligned("tree_verify_attention", q, k, v)
    return launch_attention("tree_verify_attention", _TREE_ARGTYPES, q,
                            (k, v, q_pos, kv_pos, kv_node, anc_bits),
                            (b, kq, h, k.shape[2], hd, l, int(window),
                             int(num_meta), split_plan(l)[0]))
