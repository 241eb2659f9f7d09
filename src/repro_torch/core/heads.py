"""Combined scoring-and-proposal heads (paper §4, §6, Fig. 3), as in
``repro.core.heads``.

One feedforward layer with hidden size k·d_hidden and output size k·d_model
after the decoder output, a residual from the decoder output into each of
the k outputs, and the vocabulary projection applied to each output.  With
``identity_p1`` (the default) p_1 is the base model itself, so exact
blockwise decoding reproduces greedy decoding of p_1.

On a sharded ``ParamTree`` the hidden width is cut over the ``model`` axis
(``w1`` / ``b1`` column-parallel, ``w2`` row-parallel): ``w2``'s partial
products are summed there, and ``b2`` and the residual are added once,
after the sum.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import normal
from repro_torch.sharding import comm


def heads_init(gen, cfg: ModelConfig, *, dtype=torch.float32,
               device=None) -> Dict:
    d, k, dh = cfg.d_model, cfg.bpd_k, cfg.resolved_bpd_hidden
    kw = dict(dtype=dtype, device=device)
    return {
        "w1": normal(gen, (d, k, dh), std=d ** -0.5, **kw),
        "b1": torch.zeros((k, dh), **kw),
        "w2": normal(gen, (k, dh, d), std=(dh ** -0.5) * 0.1, **kw),
        "b2": torch.zeros((k, d), **kw),
    }


def heads_apply(p, cfg: ModelConfig, hidden, *,
                identity_p1: bool = True) -> torch.Tensor:
    """hidden: (..., d) -> (..., k, d) per-head decoder outputs."""
    dt = hidden.dtype
    h = torch.einsum("...d,dkh->...kh", hidden, p["w1"].to(dt))
    h = F.relu(h + p["b1"].to(dt))
    out = _w2_product(p, h)
    out = out + p["b2"].to(dt) + hidden[..., None, :]
    if identity_p1:
        out[..., 0, :] = hidden
    return out


def head_apply_single(p, cfg: ModelConfig, hidden, head_idx: int, *,
                      identity_p1: bool = True) -> torch.Tensor:
    """Only head ``head_idx``."""
    if identity_p1 and head_idx == 0:
        return hidden
    dt = hidden.dtype
    w1 = p["w1"][:, head_idx].to(dt)
    b1 = p["b1"][head_idx].to(dt)
    w2 = p["w2"][head_idx].to(dt)
    b2 = p["b2"][head_idx].to(dt)
    h = F.relu(hidden @ w1 + b1)
    if comm.cut(p, "w2") is None:
        return h @ w2 + b2 + hidden
    y = comm.row_sum(p.mesh, h.reshape(-1, w2.shape[0]), w2)
    return y.reshape(*h.shape[:-1], -1) + b2 + hidden


def _w2_product(p, h):
    """h: (..., k, dh) -> (..., k, d), every head's ``w2`` product, summed
    over the ``model`` axis when the hidden width is cut over it."""
    w2 = p["w2"]
    if comm.cut(p, "w2") is None:
        return torch.einsum("...kh,khd->...kd", h, w2.to(h.dtype))
    k, dh = h.shape[-2:]
    y = comm.row_sum(p.mesh, h.reshape(-1, k, dh).transpose(0, 1), w2)
    return y.transpose(0, 1).reshape(*h.shape[:-1], -1)


def head_apply_dynamic(p, cfg: ModelConfig, hidden, head_idx: int, *,
                       identity_p1: bool = True,
                       detach_residual: bool = False) -> torch.Tensor:
    """Head ``head_idx`` for training (§6's one random sub-loss per
    minibatch).  The index is a host int drawn per step; with
    ``identity_p1`` head 0 is ``hidden`` itself (the reference selects it
    with a ``where``, whose other branch gets a zero gradient: the same
    value and gradients).  ``detach_residual`` detaches only the
    ``+ hidden`` residual of the head, so a future-token loss reaches the
    trunk only through the head's FFN (``repro.core.heads``)."""
    if identity_p1 and head_idx == 0:
        return hidden
    dt = hidden.dtype
    h = F.relu(hidden @ p["w1"][:, head_idx].to(dt) + p["b1"][head_idx].to(dt))
    res = hidden.detach() if detach_residual else hidden
    return h @ p["w2"][head_idx].to(dt) + p["b2"][head_idx].to(dt) + res
