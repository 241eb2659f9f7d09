"""The RWKV-6 wkv scan on Hopper: the prefill's recurrence from a zero state.

The CUDA kernel (``csrc/rwkv6_scan.cu``) replaces the reference's
``repro/kernels/rwkv6_scan.py::rwkv6_scan_pallas`` with its closed chunk
form on the tensor cores: tiles of ``STAGE_STEPS`` steps, each two
sub-chunks of ``SUB_CHUNK`` with their own midpoint renormalisation, a
step's log-decay floored at ``LOGW_FLOOR`` (so every factor fits in fp32
however strong the decay), products on ``mma.sync`` TF32 split three ways
for fp32 accuracy.  One warp-specialised block per (batch row, head):
consumer warps own 16 columns of the (D, D) state each, in mma
accumulators; producer warps copy r/k/v/logw ahead with ``cp.async`` and
form each tile's decays, exponentials and score partials while the
consumers multiply the last.  ``rwkv6_scan_plain`` (``kernels/ref.py``:
the sequential fp32 recurrence) is its plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_scan as rwkv6_scan_plain

HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instantiations
# twins of csrc/rwkv6_scan.cu's kSub, kTile and kLogwFloor
SUB_CHUNK = 8
STAGE_STEPS = 16
LOGW_FLOOR = -16.0
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 5 + [_P]

_require = functools.partial(_build.require, "rwkv6_scan")

__all__ = ["rwkv6_scan_cuda", "rwkv6_scan_plain"]


def rwkv6_scan_cuda(r, k, v, logw, u):
    """r/k/v: (B, S, H, D) f32 or bf16; logw: (B, S, H, D) f32 (<= 0);
    u: (H, D) f32.  All contiguous on one CUDA device, D one of
    ``HEAD_DIMS``.  Returns (y (B, S, H, D) f32, final state (B, H, D, D)
    f32), as ``rwkv6_scan_plain``."""
    _require(r.dim() == 4, "r/k/v/logw must be (B, S, H, D)")
    b, s, h, d = r.shape
    ins = (r, k, v, logw, u)
    _require(all(t.is_cuda and t.device == r.device for t in ins),
             "inputs must be on one CUDA device")
    _require(all(t.shape == r.shape for t in (k, v, logw))
             and tuple(u.shape) == (h, d),
             "k/v/logw must have r's shape (B, S, H, D) and u must be (H, D)")
    _require(r.dtype in _build.DTYPE_CODES and k.dtype == r.dtype
             and v.dtype == r.dtype, f"r/k/v dtype {r.dtype} not supported "
                                     f"(one of f32, bf16 for all three)")
    _require(logw.dtype == torch.float32 and u.dtype == torch.float32,
             "logw and u must be float32")
    _require(all(t.is_contiguous() for t in ins), "inputs must be contiguous")
    _require(d in HEAD_DIMS, f"head dim {d} not one of {HEAD_DIMS}")
    _require(s >= 1, "the sequence is empty")
    _require(all(t.data_ptr() % 16 == 0 for t in (r, k, v, logw)),
             "r/k/v/logw must start on 16-byte boundaries")
    dev = r.device
    y = torch.empty((b, s, h, d), dtype=torch.float32, device=dev)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("rwkv6_scan", "rwkv6_scan", _ARGTYPES, r.data_ptr(),
                      k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                      u.data_ptr(), y.data_ptr(), state.data_ptr(),
                      _build.DTYPE_CODES[r.dtype], b, s, h, d, stream)
    return y, state
