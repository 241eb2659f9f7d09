"""AdamW and Adafactor with global-norm clipping, per-leaf masks (paper
§6.1 frozen-base training, discriminative fine-tuning) and the schedules of
``repro.optim.adamw``, with the reference's formulas: ``eps`` inside
``sqrt(nu / bc2) + eps``, decoupled weight decay added to the update, the
Adafactor factored second moment, its RMS clip and its decay rule
(``torch.optim``'s AdamW and Adafactor differ from them).

Parameters are updated in place under ``torch.no_grad()``.  ``grads`` and
``mask`` are dicts keyed by leaf name (``utils.tree``); a leaf with no
gradient in ``grads`` (None or absent) updates with a zero gradient, as a
leaf the reference's loss does not reach does.  A mask is a per-leaf lr
multiplier: 0 frozen, 1 full lr, a fraction for discriminative
fine-tuning.  A frozen leaf keeps its parameter, and, unlike the
reference, holds no optimizer state: the reference's masked update leaves
a frozen leaf's AdamW moments at zero forever, and its Adafactor moments
never reach the leaf, so the parameters come out the same while a frozen
8 B trunk costs no moments.  The step count and the schedule live on the
host (``state["step"]`` is an int), in float32 as the reference computes
them; the clip scale stays on the device.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.utils.tree import flatten_with_names, global_norm, tree_map_with_name

F32 = np.float32


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def make_schedule(tc: TrainConfig) -> Callable[[int], float]:
    warm = F32(max(tc.warmup_steps, 1))
    lr = F32(tc.lr)

    def inv_sqrt(step):
        s = F32(max(step, 1))
        return float(lr * min(s / warm, np.sqrt(warm / s)))

    def cosine(step):
        s = F32(step)
        warm_frac = min(s / warm, F32(1.0))
        prog = np.clip((s - warm) / F32(max(tc.steps - warm, 1)), F32(0), F32(1))
        return float(lr * warm_frac * F32(0.5) * (F32(1) + np.cos(F32(math.pi) * prog)))

    def constant(step):
        return float(lr * min(F32(step) / warm, F32(1.0)))

    return {"inv_sqrt": inv_sqrt, "cosine": cosine, "constant": constant}[tc.schedule]


def _updated(params, mask) -> Dict[str, torch.Tensor]:
    """The leaves an update moves: all, or those with a nonzero mask."""
    return {name: p for name, p in flatten_with_names(params)
            if mask is None or float(mask.get(name, 0.0)) > 0}


def _clipped(grads, updated, tc: TrainConfig):
    """(gradient getter, global norm): the norm of every gradient given (a
    leaf with no gradient adds zero); the getter returns a leaf's fp32
    gradient scaled by the clip (never to be written), zeros for none."""
    gnorm = global_norm(g for g in grads.values() if g is not None)
    scale = None
    if tc.grad_clip > 0:
        scale = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    def grad(name):
        g = grads.get(name)
        if g is None:
            return torch.zeros_like(updated[name], dtype=torch.float32)
        return g.float() * scale if scale is not None else g.float()

    return grad, gnorm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params, mask=None) -> Dict:
    leaves = _updated(params, mask)
    return {"mu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in leaves.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in leaves.items()},
            "step": 0}


@torch.no_grad()
def adamw_update(grads, state: Dict, params, tc: TrainConfig, *,
                 schedule: Callable, mask=None):
    """Returns (params, state, metrics); params and state updated in place."""
    step = state["step"] + 1
    lr = schedule(step)
    updated = _updated(params, mask)
    grad, gnorm = _clipped(grads, updated, tc)
    b1, b2, eps, wd = tc.b1, tc.b2, tc.eps, tc.weight_decay
    bc1 = float(F32(1) - F32(b1) ** F32(step))
    bc2 = float(F32(1) - F32(b2) ** F32(step))
    for name, p in updated.items():
        g = grad(name)
        mu, nu = state["mu"][name], state["nu"][name]
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).add_(g.square(), alpha=1 - b2)
        upd = (mu / bc1).div_((nu / bc2).sqrt_().add_(eps))
        upd.add_(p.float(), alpha=wd)
        m = F32(1.0 if mask is None else mask[name])
        # p.float() is p itself for an fp32 leaf (copy_ onto itself is a no-op)
        p.copy_(p.float().sub_(upd, alpha=float(F32(lr) * m)))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------


def adafactor_init(params, mask=None) -> Dict:
    def factored(p):
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=p.device)}
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    return {"v": {n: factored(p) for n, p in _updated(params, mask).items()},
            "step": 0}


@torch.no_grad()
def adafactor_update(grads, state: Dict, params, tc: TrainConfig, *,
                     schedule: Callable, mask=None):
    """As the reference: a nonzero mask trains the leaf at full lr (the
    mask is not a multiplier here), a zero mask freezes it."""
    step = state["step"] + 1
    lr = schedule(step)
    decay = float(F32(1) - (F32(step) + F32(1)) ** F32(-0.8))
    eps = 1e-30
    updated = _updated(params, mask)
    grad, gnorm = _clipped(grads, updated, tc)
    for name, p in updated.items():
        g = grad(name)
        v = state["v"][name]
        g2 = g.square().add_(eps)
        if "vr" in v:
            v["vr"].mul_(decay).add_(g2.mean(dim=-1), alpha=1 - decay)
            v["vc"].mul_(decay).add_(g2.mean(dim=-2), alpha=1 - decay)
            vr, vc = v["vr"], v["vc"]
            row = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            denom = row[..., None] * vc[..., None, :]
        else:
            v["v"].mul_(decay).add_(g2, alpha=1 - decay)
            denom = v["v"]
        del g2
        u = g * torch.rsqrt(torch.clamp(denom, min=eps))
        rms = torch.sqrt(u.square().mean() + eps)
        u.div_(torch.clamp(rms, min=1.0))
        u.add_(p.float(), alpha=tc.weight_decay)
        p.copy_(p.float().sub_(u, alpha=lr))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


def optimizer_init(params, tc: TrainConfig, mask=None) -> Dict:
    """State for the leaves ``mask`` trains (all when None)."""
    init = adamw_init if tc.optimizer == "adamw" else adafactor_init
    return init(params, mask)


def optimizer_update(grads, state, params, tc: TrainConfig, mask=None):
    schedule = make_schedule(tc)
    update = adamw_update if tc.optimizer == "adamw" else adafactor_update
    return update(grads, state, params, tc, schedule=schedule, mask=mask)


def freeze_mask(params, *, train_only_heads: bool) -> Optional[Dict[str, float]]:
    """§6.1: a mask that trains only the BPD heads (1.0 = trainable)."""
    if not train_only_heads:
        return None
    return tree_map_with_name(
        lambda name, p: 1.0 if name.startswith("bpd_heads") else 0.0, params)


def lr_scale_mask(params, *, trunk_scale: float) -> Dict[str, float]:
    """Discriminative fine-tuning: heads at full lr, every other leaf at
    ``trunk_scale`` × lr (``repro.optim.lr_scale_mask``)."""
    return tree_map_with_name(
        lambda name, p: 1.0 if name.startswith("bpd_heads") else float(trunk_scale),
        params)
