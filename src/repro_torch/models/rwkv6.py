"""RWKV-6 ("Finch", arXiv:2404.05892): the attention-free block of
``repro.models.rwkv6``, with data-dependent per-channel decay.

  time-mix:    token-shift ddlerp -> r, k, v, g projections, decay
               w_t = exp(-exp(w0 + lora_w(x_w))); per-head state
               S_t = diag(w_t) S_{t-1} + k_tᵀ v_t;
               y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t);  GroupNorm, gate g.
  channel-mix: token-shift lerp; k = relu(x_k W_k)²; y = sigmoid(x_r W_r) ⊙ (k W_v)

The decay chain is fp32 from the fp32 decay weights, as the reference
reads them (``models.model.cast_for_compute`` keeps those leaves fp32).
The prefill's wkv recurrence (zero initial state, final state only) runs
``ops.rwkv6_scan``: the CUDA kernel on the card, its plain version on the
CPU.  It is also the training forward: under autograd it runs as
``kernels.rwkv6_scan.RWKV6Scan``, which saves the state every 16 steps and
whose backward is the reverse scan from them (a second CUDA kernel on the
card), where the reference differentiates its jnp scan of 128-step chunks
under ``jax.checkpoint``.  The decode block keeps the per-step states that
blockwise parallel decoding rolls back to (``blocks.commit_cache``), in the
reference's per-step loop.

On a ``model``-sharded ``ParamTree`` the wkv heads lie over ``model``:
``tm/wr|wk|wv|wg`` are column blocks of whole heads and ``tm/u`` the same
heads' rows, so a rank scans its H / M heads (``ops.rwkv6_scan`` at the
local H) and keeps their (B, H / M, D, D) state.  The token-shift mixes
and the decay LoRA stay whole: a rank forms ``logw`` for its own columns
only (``w0`` and ``decay_B``'s columns), and ``ln_x``, a group norm per
head, reads its heads' slice of the whole scale and bias.  ``tm/wo`` is a
row sum over ``model``.  In channel mix ``cm/wk`` is a column block and
``cm/wv`` a row sum; the receptance ``sigmoid(x_r W_r)`` is computed on
``cm/wr``'s column block and gathered over ``model`` to the full width
before it gates the summed product (one ``all_gather``; the reference's
GSPMD moves the same bytes), so the rank's ``cm/wr`` stays the block
``PARAM_RULES`` gives it.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, group_norm_apply, normal
from repro_torch.sharding import comm

LORA_MIX_RANK = 32
LORA_DECAY_RANK = 64
MIX_NAMES = ("w", "k", "v", "r", "g")


def rwkv_tm_init(gen, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None) -> Dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    kw = dict(dtype=dtype, device=device)
    return {
        # token-shift interpolation anchors
        "mu_x": torch.zeros((d,), **kw),
        "mu": torch.zeros((5, d), **kw),
        # data-dependent mix lora: tanh(xxx @ A) (5 heads) @ B
        "mix_A": normal(gen, (d, 5 * LORA_MIX_RANK), std=1e-2, **kw),
        "mix_B": normal(gen, (5, LORA_MIX_RANK, d), std=1e-2, **kw),
        # projections
        "wr": dense_init(gen, d, d, **kw)["w"],
        "wk": dense_init(gen, d, d, **kw)["w"],
        "wv": dense_init(gen, d, d, **kw)["w"],
        "wg": dense_init(gen, d, d, **kw)["w"],
        "wo": dense_init(gen, d, d, **kw)["w"],
        # decay: w0 + tanh(x_w @ dA) @ dB
        "w0": torch.full((d,), -4.0, **kw),
        "decay_A": normal(gen, (d, LORA_DECAY_RANK), std=1e-2, **kw),
        "decay_B": normal(gen, (LORA_DECAY_RANK, d), std=1e-2, **kw),
        # per-head bonus u ("time_faaaa")
        "u": normal(gen, (h, hd), std=0.1, **kw),
        "ln_x": {"scale": torch.ones((d,), **kw),
                 "bias": torch.zeros((d,), **kw)},
    }


def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift mixing -> (xw, xk, xv, xr, xg)."""
    sx = x_prev - x
    xxx = x + sx * p["mu_x"].to(x.dtype)
    b, s, d = x.shape
    low = torch.tanh(xxx @ p["mix_A"].to(x.dtype))            # (B,S,5r)
    low = low.reshape(b, s, 5, LORA_MIX_RANK)
    delta = torch.einsum("bsnr,nrd->bsnd", low, p["mix_B"].to(x.dtype))
    return tuple(x + sx * (p["mu"][i].to(x.dtype) + delta[:, :, i])
                 for i in range(5))


def _log_decay(p, xw, cols: slice = slice(None)):
    """log w = -exp(w0 + tanh(x_w dA) dB) at channels ``cols``, in fp32
    from a compute-dtype x_w and the fp32 decay weights (exp of it is the
    reference's decay)."""
    ww = p["w0"][cols].float() + (
        torch.tanh(xw.float() @ p["decay_A"].float())
        @ p["decay_B"][:, cols].float())
    return -torch.exp(ww)


def _columns(p, leaf: str) -> slice:
    """The channels of ``p[leaf]``'s columns: this rank's block when they
    are cut over ``model``, else all of them."""
    n = p[leaf].shape[1]
    lo = 0 if comm.cut(p, leaf) is None else p.mesh.coords["model"] * n
    return slice(lo, lo + n)


def _row_product(p, leaf: str, x):
    """``x @ p[leaf]``, summed over ``model`` when its rows are cut."""
    w = p[leaf]
    if comm.cut(p, leaf) is None:
        return x @ w.to(x.dtype)
    return comm.row_sum(p.mesh, x.reshape(-1, w.shape[0]), w).reshape(
        *x.shape[:-1], w.shape[1])


def _wkv_step(uf):
    def step(S, rt, kt, vt, wt):                   # (B,H,D) each
        kv = kt[..., :, None] * vt[..., None, :]
        yt = torch.einsum("bhi,bhij->bhj", rt, S + uf[None, :, :, None] * kv)
        return wt[..., None] * S + kv, yt

    return step


def _wkv_scan(r, k, v, logw, u, state0=None, *, return_states: bool = False):
    """The wkv recurrence.  r, k, v, logw: (B,S,H,D); u: (H,D).

    return_states=False (prefill and training): from a zero state through
    ``ops.rwkv6_scan`` (differentiable); returns (y (B,S,H,D) f32, final
    state (B,H,D,D) f32).  A carried-in ``state0`` raises: the reference never scans a
    prefill from one, and the kernel starts from zero.

    return_states=True (decode, S == block_k): the per-step loop from
    ``state0`` (zeros when None); returns (y, per-step states (B,S,H,D,D)
    f32) so BPD can roll back to the accepted prefix.
    """
    if not return_states:
        if state0 is not None:
            raise ValueError("the prefill scan starts from a zero state; "
                             "pass state0 only with return_states=True")
        return ops.rwkv6_scan(r, k, v, logw, u)
    rf, kf, vf = (t.float() for t in (r, k, v))
    wf = torch.exp(logw)
    b, s, h, d = rf.shape
    S = state0 if state0 is not None else torch.zeros(
        (b, h, d, d), dtype=torch.float32, device=r.device)
    step = _wkv_step(u.float())
    ys, states = [], []
    for t in range(s):
        S, yt = step(S, rf[:, t], kf[:, t], vf[:, t], wf[:, t])
        ys.append(yt)
        states.append(S)
    return torch.stack(ys, dim=1), torch.stack(states, dim=1)


def rwkv_tm_apply(p, cfg: ModelConfig, x, *, x_prev=None, state0=None,
                  return_states: bool = False):
    """Time-mix forward.

    x       : (B, S, d)
    x_prev  : (B, d) last token of the preceding context (token shift), zeros
              at sequence start.
    state0  : (B, H, D, D) initial wkv state (decode only; the prefill
              starts from zeros).
    Returns (y, aux) where aux = {"x_last": (B,d), "state": the final state,
    or the per-step states if return_states}.  Sharded, H and the state
    are this rank's heads (see the module).
    """
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    cols = _columns(p, "wr")                       # this rank's channels
    dl = cols.stop - cols.start
    h = dl // hd
    if x_prev is None:
        x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(p, x, shifted)

    r = (xr @ p["wr"].to(x.dtype)).reshape(b, s, h, hd)
    k = (xk @ p["wk"].to(x.dtype)).reshape(b, s, h, hd)
    v = (xv @ p["wv"].to(x.dtype)).reshape(b, s, h, hd)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    logw = _log_decay(p, xw, cols).reshape(b, s, h, hd)

    y, states = _wkv_scan(r, k, v, logw, p["u"].float(), state0,
                          return_states=return_states)
    y = y.reshape(b, s, dl).to(x.dtype)
    ln = p["ln_x"]
    y = group_norm_apply({"scale": ln["scale"][cols],
                          "bias": ln["bias"][cols]}, y, h)
    y = _row_product(p, "wo", y * g)
    return y, {"x_last": x[:, -1, :], "state": states}


# ---------------------------------------------------------------------------
# Channel mix
# ---------------------------------------------------------------------------


def rwkv_cm_init(gen, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    return {
        "mu_k": torch.zeros((d,), **kw),
        "mu_r": torch.zeros((d,), **kw),
        "wk": dense_init(gen, d, ff, **kw)["w"],
        "wv": dense_init(gen, ff, d, **kw)["w"],
        "wr": dense_init(gen, d, d, **kw)["w"],
    }


def rwkv_cm_apply(p, cfg: ModelConfig, x, *, x_prev=None):
    b, s, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    sx = shifted - x
    xk = x + sx * p["mu_k"].to(x.dtype)
    xr = x + sx * p["mu_r"].to(x.dtype)
    kk = F.relu(xk @ p["wk"].to(x.dtype))
    kk = kk * kk
    vv = _row_product(p, "wv", kk)
    rr = torch.sigmoid(xr @ p["wr"].to(x.dtype))
    if comm.cut(p, "wr") is not None:    # the receptance at the full width
        rr = comm.model_gather(p.mesh, rr)
    return rr * vv, {"x_last": x[:, -1, :]}
