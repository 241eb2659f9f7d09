"""One-pass block verification on Hopper (paper §3, §5.1–5.2).

The CUDA kernel (``csrc/fused_verify.cu``) replaces the reference's
``repro/kernels/fused_verify.py::fused_verify_pallas``: one thread-block
cluster per batch row reads that row's (k, V) p_1 logits once, each slot
cut into ``verify_plan``'s contiguous vocab ranges and the (slot, range)
items shared by the cluster's blocks; each block reduces an item to a
top-T partial in shared memory, and rank 0 merges the partials through
distributed shared memory by (value desc, id asc) and runs the criterion
compare and the longest-accepted-prefix scan, all in one launch.
``fused_verify_plain`` (``kernels/ref.py``) is its plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import CRITERIA
from repro_torch.kernels.ref import fused_verify as fused_verify_plain

MAX_K = 32
MAX_TOP_T = 8
MAX_CLUSTER = 8       # the portable cluster size: blocks a batch row
MAX_RANGES = 8
MIN_RANGE = 2048      # no slot is cut into ranges shorter than this
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]

_require = functools.partial(_build.require, "fused_verify")

__all__ = ["fused_verify_cuda", "fused_verify_plain", "verify_plan",
           "range_bounds"]


def verify_plan(vocab: int, b: int, k: int, sms: int) -> tuple:
    """How the kernel cuts (B, k, V) logits over the card: (cluster,
    ranges).  Each slot's V ids are cut into ``ranges`` contiguous ranges
    (``range_bounds``); a batch row's k * ranges (slot, range) items go to
    the ``cluster`` blocks of its cluster, item i to block i % cluster.
    The cluster is as wide as the portable limit allows while B clusters
    stay within two blocks an SM; ranges make the items a multiple of the
    cluster (every block reads as much), none shorter than MIN_RANGE ids
    unless the slot is.  ``csrc/fused_verify.cu`` refuses a plan outside
    1 <= ranges <= min(MAX_RANGES, V), 1 <= cluster <= min(MAX_CLUSTER,
    k * ranges)."""
    if vocab < 1 or b < 1 or not 1 <= k <= MAX_K or sms < 1:
        raise ValueError(f"verify_plan needs V, B, SMs >= 1 and 1 <= k <= "
                         f"{MAX_K}, got {vocab}, {b}, {k}, {sms}")
    cluster = max(1, min(MAX_CLUSTER, 2 * sms // b))
    ranges = min(cluster // math.gcd(k, cluster), max(1, vocab // MIN_RANGE))
    return min(cluster, k * ranges), ranges


def range_bounds(vocab: int, ranges: int, i: int) -> range:
    """The ids range ``i`` of ``ranges`` covers in each slot."""
    return range(vocab * i // ranges, vocab * (i + 1) // ranges)


def fused_verify_cuda(p1_logits, proposals, *, criterion: str,
                      top_k: int = 1, epsilon: float = 0.0):
    """p1_logits: (B, k, V) f32/bf16; proposals: (B, k) int32.

    Returns (accepts (B, k) bool, k̂ (B,) int32, accepted_tokens (B, k)
    int32, next_greedy (B,) int32), as ``fused_verify_plain``.
    """
    _require(criterion in CRITERIA,
             f"unknown criterion {criterion!r}; one of {CRITERIA}")
    _require(p1_logits.dim() == 3, "p1_logits must be (B, k, V)")
    b, k, vocab = p1_logits.shape
    top_t = max(1, int(top_k)) if criterion == "topk" else 1
    _require(p1_logits.dtype in _build.DTYPE_CODES,
             f"dtype {p1_logits.dtype} not supported")
    _require(p1_logits.is_contiguous() and proposals.is_contiguous(),
             "inputs must be contiguous")
    _require(proposals.dtype == torch.int32
             and tuple(proposals.shape) == (b, k),
             "proposals must be (B, k) int32")
    _require(b >= 1 and vocab >= 1, f"empty logits {tuple(p1_logits.shape)}")
    _require(1 <= k <= MAX_K, f"block size {k} outside [1, {MAX_K}]")
    _require(top_t <= MAX_TOP_T and top_t <= vocab,
             f"top_k={top_t} exceeds {MAX_TOP_T} or the vocab")
    _require(p1_logits.is_cuda and proposals.device == p1_logits.device,
             "p1_logits and proposals must be on one CUDA device")
    dev = p1_logits.device
    cluster, ranges = verify_plan(vocab, b, k, _build.sm_count(dev))
    acc = torch.empty((b, k), dtype=torch.bool, device=dev)
    khat = torch.empty((b,), dtype=torch.int32, device=dev)
    toks = torch.empty((b, k), dtype=torch.int32, device=dev)
    nxt = torch.empty((b,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("fused_verify", "fused_verify", _ARGTYPES,
                      p1_logits.data_ptr(), proposals.data_ptr(),
                      acc.data_ptr(), khat.data_ptr(), toks.data_ptr(),
                      nxt.data_ptr(), _build.DTYPE_CODES[p1_logits.dtype], b, k,
                      vocab, top_t, CRITERIA.index(criterion),
                      float(epsilon), cluster, ranges, stream)
    return acc, khat, toks, nxt
