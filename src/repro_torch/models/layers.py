"""Shared building blocks: initializers, norms, activations, RoPE, MLPs.

Functions take parameters as nested dicts of tensors (``p["w"]``), as the
reference's pure functions take pytrees; ``p["w"].to(x.dtype)`` is a no-op
once the parameter set has been cast to the compute dtype.  On a sharded
``ParamTree`` the MLP is column-parallel in ``w1`` / ``w3`` and
row-parallel in ``w2`` (summed over the ``model`` axis, the bias added
once after the sum), and the embedding is vocab-parallel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.sharding import comm

# ---------------------------------------------------------------------------
# Initializers: draws from one explicit torch.Generator (None on the meta
# device, where nothing is drawn).  Same distributions as the reference.
# ---------------------------------------------------------------------------


def normal(gen: Optional[torch.Generator], shape, *, std: float = 1.0,
           dtype=torch.float32, device=None) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(std) if std != 1.0 else x


def dense_init(gen, in_dim: int, out_dim: int, *, dtype=torch.float32,
               device=None, scale: float = 1.0, bias: bool = False):
    p = {"w": normal(gen, (in_dim, out_dim), std=scale / math.sqrt(in_dim),
                     dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def dense_apply(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def norm_init(dim: int, *, kind: str = "rmsnorm", dtype=torch.float32,
              device=None):
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def norm_apply(p, x, *, kind: str = "rmsnorm", eps: float = 1e-6):
    """RMSNorm / LayerNorm computed in fp32, returned in x's dtype."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def group_norm_apply(p, x, num_groups: int, *, eps: float = 1e-5):
    """GroupNorm over the channel dim (RWKV-6's per-head ``ln_x``): fp32,
    the population variance, eps 1e-5; returned in x's dtype."""
    *lead, c = x.shape
    xf = x.float().reshape(*lead, num_groups, c // num_groups)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, c)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def activation(name: str, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":  # nemotron-4 squared ReLU
        r = F.relu(x)
        return r * r
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {name}")


GATED_ACTIVATIONS = ("silu", "geglu")  # use the w1/w3 gated form


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split layout, not interleaved)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)
    angles = positions[..., :, None].float() * freqs       # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, cfg: ModelConfig, *, d_ff: Optional[int] = None,
             dtype=torch.float32, device=None):
    d_ff = d_ff or cfg.d_ff
    p = {"w1": dense_init(gen, cfg.d_model, d_ff, dtype=dtype, device=device)}
    if cfg.activation in GATED_ACTIVATIONS:
        p["w3"] = dense_init(gen, cfg.d_model, d_ff, dtype=dtype,
                             device=device)
    p["w2"] = dense_init(gen, d_ff, cfg.d_model, dtype=dtype, device=device)
    return p


def row_parallel_apply(p, x):
    """``dense_apply`` of a weight whose input dim may be cut over the
    ``model`` axis: the partial products summed there, then the bias."""
    if comm.cut(p, "w") is None:
        return dense_apply(p, x)
    w = p["w"]
    y = comm.row_sum(p.mesh, x.reshape(-1, w.shape[0]), w).reshape(
        *x.shape[:-1], w.shape[1])
    return y + p["b"].to(x.dtype) if "b" in p else y


def mlp_apply(p, x, *, act: str):
    h = dense_apply(p["w1"], x)
    if "w3" in p:
        # the reference gates "geglu" with silu too (layers.py:125)
        h = activation("silu" if act == "geglu" else act, h) * dense_apply(p["w3"], x)
    else:
        h = activation(act, h)
    return row_parallel_apply(p["w2"], h)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_init(gen, vocab: int, dim: int, *, dtype=torch.float32,
               device=None):
    return {"table": normal(gen, (vocab, dim), std=0.02, dtype=dtype,
                            device=device)}


def embed_apply(p, ids):
    """Rows ``ids`` of the table.  A table cut over the ``model`` axis
    (vocab-parallel) gives zeros for the ids outside this rank's rows and
    sums the ranks' rows: one non-zero term each."""
    table = p["table"]
    if comm.cut(p, "table") is None:
        return table.index_select(0, ids.reshape(-1)).reshape(
            *ids.shape, table.shape[1])
    n = table.shape[0]
    local = ids - p.mesh.coords["model"] * n
    mine = (local >= 0) & (local < n)
    rows = table.index_select(0, torch.where(mine, local, 0).reshape(-1))
    rows = torch.where(mine.reshape(-1, 1), rows, 0)
    return comm.model_sum(p.mesh, rows).reshape(*ids.shape, table.shape[1])


def unembed_apply(p, x):
    """Tied unembedding: x @ table^T (the transpose is a view)."""
    return x @ p["table"].t().to(x.dtype)
