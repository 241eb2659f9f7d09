"""Mamba-1 selective SSM: the SSM heads of the Hymba hybrid block, as
``repro.models.mamba``.

  h_t = exp(Δ_t A) ⊙ h_{t-1} + (Δ_t B_t) x_t ;  y_t = C_t h_t + D x_t

with data-dependent Δ, B, C and a causal depthwise conv front-end.

The scan runs in fp32 whatever the compute dtype (u, Δ, B, C and A are read
in fp32, as the reference casts them), and ``y + u·D`` stays fp32 until the
cast back.  The reference computes the recurrence with ``lax.scan`` in jnp:
it has no Pallas kernel, so here it is a plain loop over the steps, one
``addcmul`` a step, with the output products done once over the stacked
states.  The decode block asks for per-step conv and SSM states
(``return_states``), which blockwise parallel decoding rolls back to
(``blocks.commit_cache``).  Training differentiates the same loop through
autograd; the reference checkpoints its scan in chunks to bound the
backward's memory, which changes no value.

One departure: past 128 steps the reference's prefill scans in chunks of
128 and pads the last chunk with zeros after the exponential, so its final
SSM state is zero whenever S % 128 != 0 (ROADMAP.md §3).  The final state
here is the recurrence's, the last of the reference's own per-step states.

On a ``model``-sharded ``ParamTree`` the d_inner channels lie over
``model``: a rank keeps its channels of both halves of ``in_proj``
(``sharding.policy.SPLIT_LEAVES``), and of ``conv_w``, ``conv_b``,
``dt_proj``, ``A_log`` and ``D``, so its conv, scan and states run at d_inner
/ M.  ``x_proj`` is a row block over d_inner, so Δ_low, B and C are summed
over ``model`` before the split (B and C feed every channel); ``out_proj``
is a row sum.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import dense_init, normal, row_parallel_apply

DT_RANK_DIV = 16  # dt_rank = ceil(d_model / 16), the mamba default


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, (cfg.d_model + DT_RANK_DIV - 1) // DT_RANK_DIV)


def mamba_init(gen, cfg: ModelConfig, *, dtype=torch.float32,
               device=None) -> Dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    dtr = _dt_rank(cfg)
    kw = dict(dtype=dtype, device=device)
    # softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1], in fp32
    lo, hi = math.log(1e-3), math.log(1e-1)
    log_dt = torch.rand((di,), generator=gen, dtype=torch.float32,
                        device=device) * (hi - lo) + lo
    return {
        "in_proj": dense_init(gen, d, 2 * di, **kw),        # x and gate z
        "conv_w": normal(gen, (cfg.ssm_conv_width, di), std=0.2, **kw),
        "conv_b": torch.zeros((di,), **kw),
        "x_proj": dense_init(gen, di, dtr + 2 * n, **kw),   # Δ_low, B, C
        "dt_proj": {
            "w": normal(gen, (dtr, di), std=dtr ** -0.5, **kw),
            "b": torch.log(torch.expm1(torch.exp(log_dt))).to(dtype),
        },
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=device)).expand(di, n)
        .to(dtype).contiguous(),
        "D": torch.ones((di,), **kw),
        "out_proj": dense_init(gen, di, d, **kw),
    }


def _causal_conv(p, u, conv_state):
    """u: (B, S, di); conv_state: (B, W-1, di), the trailing inputs of the
    prefix.  Returns (silu(conv), the new state, the padded input xx)."""
    w = p["conv_w"].to(u.dtype)                      # (W, di)
    width = w.shape[0]
    s = u.shape[1]
    xx = torch.cat([conv_state.to(u.dtype), u], dim=1)   # (B, W-1+S, di)
    out = xx[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xx[:, i:i + s] * w[i]
    out = out + p["conv_b"].to(u.dtype)
    return F.silu(out), xx[:, s:], xx


def _ssm_scan(u, dt, Bm, Cm, A, D, h0, *, return_states: bool):
    """u, dt: (B, S, di); Bm, Cm: (B, S, N); A: (di, N) fp32; h0: (B, di, N)
    fp32.  Returns (y (B, S, di) fp32, the per-step states (B, S, di, N)
    when ``return_states``, else the final state (B, di, N))."""
    uf, dtf, Bf, Cf = (t.float() for t in (u, dt, Bm, Cm))
    # step-major, so each step reads one contiguous (B, di, N) slab
    dt_s = dtf.transpose(0, 1)[..., None]            # (S, B, di, 1)
    dA = torch.exp(dt_s * A)                         # (S, B, di, N)
    dBu = dt_s * Bf.transpose(0, 1)[:, :, None, :] * uf.transpose(0, 1)[..., None]
    h = h0
    hs = []
    # unbind once: autograd then stacks the steps' gradients in one copy,
    # where indexing dA[t] would add each into a zeroed (S, B, di, N) tensor
    for dA_t, dBu_t in zip(dA.unbind(0), dBu.unbind(0)):
        h = torch.addcmul(dBu_t, dA_t, h)            # dA_t ⊙ h + dBu_t
        hs.append(h)
    states = torch.stack(hs, dim=1)                  # (B, S, di, N)
    y = torch.einsum("bsdn,bsn->bsd", states, Cf) + uf * D.float()
    return y, states if return_states else h


def mamba_apply(p, cfg: ModelConfig, x, *, conv_state=None, h0=None,
                return_states: bool = False):
    """x: (B, S, d) -> (y, aux) with aux = {"conv", "ssm"}: the final conv
    input window (B, W-1, di) and SSM state (B, di, N), or with
    ``return_states`` (the decode block) each step's, (B, S, W-1, di) and
    (B, S, di, N); di is this rank's channels when they are sharded."""
    b, s, d = x.shape
    di = p["D"].shape[0]
    n = cfg.ssm_state_dim
    width = cfg.ssm_conv_width
    dtr = _dt_rank(cfg)
    if conv_state is None:
        conv_state = torch.zeros((b, width - 1, di), dtype=x.dtype,
                                 device=x.device)
    if h0 is None:
        h0 = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)

    xz = x @ p["in_proj"]["w"].to(x.dtype)
    u_in, z = xz.split(di, dim=-1)
    u, new_conv, xx = _causal_conv(p, u_in, conv_state)

    proj = row_parallel_apply(p["x_proj"], u)        # (B, S, dtr + 2N)
    dt_low, Bm, Cm = proj.split((dtr, n, n), dim=-1)
    # torch's softplus returns x itself above 20, where jax's adds
    # log1p(exp(-x)) < 2.1e-9: below 1e-10 of the value, far under a ulp
    dt = F.softplus(dt_low @ p["dt_proj"]["w"].to(x.dtype)
                    + p["dt_proj"]["b"].to(x.dtype))
    A = -torch.exp(p["A_log"].float())

    y, states = _ssm_scan(u, dt, Bm, Cm, A, p["D"], h0,
                          return_states=return_states)
    y = y.to(x.dtype) * F.silu(z)
    y = row_parallel_apply(p["out_proj"], y)

    if return_states:
        # the trailing W-1 inputs after each step: windows 1..S of xx
        conv_states = xx.unfold(1, width - 1, 1)[:, 1:].transpose(2, 3)
        return y, {"conv": conv_states, "ssm": states}
    return y, {"conv": new_conv, "ssm": states}
