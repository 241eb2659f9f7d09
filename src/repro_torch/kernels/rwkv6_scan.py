"""The RWKV-6 wkv scan on Hopper: the prefill's recurrence from a zero state,
and its gradient.

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
consumers multiply the last.  Nothing in the launch depends on H beyond
the grid: a rank of a ``model``-sharded mesh scans its own H / M heads
(16 of rwkv6-1.6b's 32 at ``model`` 2) with the same kernel.  ``rwkv6_scan_plain`` (``kernels/ref.py``:
the sequential fp32 recurrence) is its plain version.  Given a ``chunk``
(a multiple of ``STAGE_STEPS``) it also writes the state at the start of
every chunk: the training forward's checkpoints.

The backward kernel (``csrc/rwkv6_scan_bwd.cu``) replaces no TPU kernel:
the reference trains through its jnp scan and XLA differentiates it
(``repro/models/rwkv6.py:90 _wkv_scan``).  It runs the reverse scan in the
same closed chunk form on the same tensor-core products, tiles of 16 steps
last first, each from its start state (the checkpoint, or replayed from it
past a chunk's first tile) and the carried dL/dS; dlogw comes from per-tile
sums of exact terms, with no per-step state and no scratch.  At D 128 the
key channels of a (batch row, head) are cut into ``bwd_splits(D)`` blocks,
which add their dv partials into a zeroed dv.  ``rwkv6_scan_bwd_plain``
(``kernels/ref.py``: the sequential reverse scan) is its plain version.
``RWKV6Scan`` joins the two under autograd: the CUDA kernels for CUDA
tensors, the plain versions for CPU tensors.

Checkpoint memory: ⌈S / chunk⌉ (D, D) fp32 states a (batch row, head), so
at rwkv6-1.6b's training shape (B 4, S 512, H 32, D 64) and the default
``TRAIN_CHUNK`` of 16, 32 × 4 × 32 × 16 KiB = 64 MiB a layer.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_scan as rwkv6_scan_plain
from repro_torch.kernels.ref import rwkv6_scan_bwd as rwkv6_scan_bwd_plain

HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instantiations
# twins of csrc/rwkv6_scan.cu's kSub, kTile and kLogwFloor
SUB_CHUNK = 8
STAGE_STEPS = 16
LOGW_FLOOR = -16.0
TRAIN_CHUNK = 16                  # steps between the training forward's checkpoints
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]
_BWD_ARGTYPES = [_P] * 13 + [_I] * 6 + [_P]

_require = functools.partial(_build.require, "rwkv6_scan")
_require_bwd = functools.partial(_build.require, "rwkv6_scan_bwd")

__all__ = ["RWKV6Scan", "bwd_splits", "rwkv6_scan_bwd_cuda",
           "rwkv6_scan_bwd_plain",
           "rwkv6_scan_cuda", "rwkv6_scan_plain"]


def bwd_splits(d: int) -> int:
    """The backward kernel's blocks per (batch row, head), each over D /
    splits of the key channels (twin of csrc/rwkv6_scan_bwd.cu's kSplit)."""
    return 2 if d >= 128 else 1


def _check_inputs(require, r, k, v, logw, u):
    """The forward's inputs, as both kernels take them."""
    require(r.dim() == 4, "r/k/v/logw must be (B, S, H, D)")
    b, s, h, d = r.shape
    ins = (r, k, v, logw, u)
    require(all(t.is_cuda and t.device == r.device for t in ins),
            "inputs must be on one CUDA device")
    require(all(t.shape == r.shape for t in (k, v, logw))
            and tuple(u.shape) == (h, d),
            "k/v/logw must have r's shape (B, S, H, D) and u must be (H, D)")
    require(r.dtype in _build.DTYPE_CODES and k.dtype == r.dtype
            and v.dtype == r.dtype, f"r/k/v dtype {r.dtype} not supported "
                                    f"(one of f32, bf16 for all three)")
    require(logw.dtype == torch.float32 and u.dtype == torch.float32,
            "logw and u must be float32")
    require(all(t.is_contiguous() for t in ins), "inputs must be contiguous")
    require(d in HEAD_DIMS, f"head dim {d} not one of {HEAD_DIMS}")
    require(s >= 1, "the sequence is empty")


def rwkv6_scan_cuda(r, k, v, logw, u, *, chunk: int = 0):
    """r/k/v: (B, S, H, D) f32 or bf16; logw: (B, S, H, D) f32 (<= 0);
    u: (H, D) f32.  All contiguous on one CUDA device, D one of
    ``HEAD_DIMS``.  Returns (y (B, S, H, D) f32, final state (B, H, D, D)
    f32), as ``rwkv6_scan_plain``; with ``chunk`` > 0 (a multiple of
    ``STAGE_STEPS``) also the checkpoints (B, H, ⌈S / chunk⌉, D, D) f32."""
    _check_inputs(_require, r, k, v, logw, u)
    b, s, h, d = r.shape
    _require(chunk == 0 or (chunk > 0 and chunk % STAGE_STEPS == 0),
             f"chunk {chunk} is not a positive multiple of {STAGE_STEPS}")
    _require(all(t.data_ptr() % 16 == 0 for t in (r, k, v, logw)),
             "r/k/v/logw must start on 16-byte boundaries")
    dev = r.device
    y = torch.empty((b, s, h, d), dtype=torch.float32, device=dev)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    ckpt = (torch.empty((b, h, -(-s // chunk), d, d), dtype=torch.float32,
                        device=dev) if chunk else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("rwkv6_scan", "rwkv6_scan", _ARGTYPES, r.data_ptr(),
                      k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                      u.data_ptr(), y.data_ptr(), state.data_ptr(),
                      None if ckpt is None else ckpt.data_ptr(), chunk,
                      _build.DTYPE_CODES[r.dtype], b, s, h, d, stream)
    if ckpt is None:
        return y, state
    _build.CHECKPOINTED_SCANS += 1
    return y, state, ckpt


def rwkv6_scan_bwd_cuda(r, k, v, logw, u, checkpoints, dy, dstate, *,
                        chunk: int):
    """The gradient of ``rwkv6_scan_cuda`` from its checkpoints of every
    ``chunk`` steps (a positive multiple of ``STAGE_STEPS``): r/k/v/logw/u
    as the forward takes them; checkpoints (B, H, ⌈S / chunk⌉, D, D) f32;
    dy (B, S, H, D) f32; dstate (B, H, D, D) f32 or None (zeros); all
    contiguous on r's device, r/k/v/logw/dy/checkpoints on 16-byte
    boundaries.  Returns (dr, dk, dv, dlogw (B, S, H, D) f32, du (H, D)
    f32), as ``rwkv6_scan_bwd_plain``; at D 128 the call launches dv's
    zeroing before the reverse scan."""
    _check_inputs(_require_bwd, r, k, v, logw, u)
    b, s, h, d = r.shape
    _require_bwd(chunk > 0 and chunk % STAGE_STEPS == 0,
                 f"chunk {chunk} is not a positive multiple of {STAGE_STEPS}")
    n = -(-s // chunk)
    grads = (checkpoints, dy) + (() if dstate is None else (dstate,))
    _require_bwd(all(t.is_cuda and t.device == r.device for t in grads),
                 "checkpoints, dy and dstate must be on r's device")
    _require_bwd(all(t.dtype == torch.float32 and t.is_contiguous()
                     for t in grads),
                 "checkpoints, dy and dstate must be contiguous float32")
    _require_bwd(tuple(checkpoints.shape) == (b, h, n, d, d),
                 f"checkpoints must be (B, H, ⌈S / chunk⌉, D, D) = "
                 f"{(b, h, n, d, d)}, got {tuple(checkpoints.shape)}")
    _require_bwd(dy.shape == r.shape, "dy must have r's shape (B, S, H, D)")
    _require_bwd(dstate is None or tuple(dstate.shape) == (b, h, d, d),
                 "dstate must be (B, H, D, D)")
    _require_bwd(all(t.data_ptr() % 16 == 0
                     for t in (r, k, v, logw, dy, checkpoints)),
                 "r/k/v/logw/dy/checkpoints must start on 16-byte boundaries")
    dev = r.device
    dr, dk, dv, dlogw = (torch.empty((b, s, h, d), dtype=torch.float32,
                                     device=dev) for _ in range(4))
    du_part = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("rwkv6_scan_bwd", "rwkv6_scan_bwd", _BWD_ARGTYPES,
                      r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      logw.data_ptr(), u.data_ptr(), checkpoints.data_ptr(),
                      dy.data_ptr(),
                      None if dstate is None else dstate.data_ptr(),
                      dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      dlogw.data_ptr(), du_part.data_ptr(),
                      _build.DTYPE_CODES[r.dtype], b, s, h, d, chunk, stream)
    return dr, dk, dv, dlogw, du_part.sum(0)


class RWKV6Scan(torch.autograd.Function):
    """``rwkv6_scan`` under autograd: the forward saves r, k, v, logw, u and
    its checkpoints of every ``chunk`` steps; the backward runs the reverse
    scan from them.  The CUDA kernels for CUDA tensors, the plain versions
    for CPU tensors.  The gradients of r, k and v come back in their dtype;
    an output whose gradient is not asked for is taken as zeros.

    ``RWKV6Scan.apply(r, k, v, logw, u, chunk) -> (y, final state)``."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk):
        fwd = rwkv6_scan_cuda if r.is_cuda else rwkv6_scan_plain
        y, state, checkpoints = fwd(r, k, v, logw, u, chunk=chunk)
        ctx.save_for_backward(r, k, v, logw, u, checkpoints)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, logw, u, checkpoints = ctx.saved_tensors
        dy = (torch.zeros(r.shape, dtype=torch.float32, device=r.device)
              if dy is None else dy.float().contiguous())
        if dstate is not None:
            dstate = dstate.float().contiguous()
        bwd = rwkv6_scan_bwd_cuda if r.is_cuda else rwkv6_scan_bwd_plain
        dr, dk, dv, dlogw, du = bwd(r, k, v, logw, u, checkpoints, dy, dstate,
                                    chunk=ctx.chunk)
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
                dlogw.to(logw.dtype), du.to(u.dtype), None)
