"""Step factories, as ``repro.launch.steps``: ``make_train_step`` (forward,
the BPD multi-head loss, backward, optimizer update) and ``text_len_for``.
The reference's input specs and prefill / serve step factories serve its
multi-pod dry run, which is not ported (ROADMAP.md §1 item 8)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.train import loss_fn_for
from repro_torch.models.model import set_trainable
from repro_torch.optim import optimizer_update
from repro_torch.utils.tree import flatten_with_names, tree_map_with_name


def text_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Text positions = seq_len minus the modality / meta prefix."""
    n = cfg.num_meta_tokens
    if cfg.modality == "vision_text":
        n += cfg.num_patch_tokens
    return max(seq_len - n, 8)


def differentiated(cfg: ModelConfig, tc: TrainConfig, params) -> Dict[str, float]:
    """The leaves the reference's gradient reaches ({name: 1.0 or 0.0}):
    every leaf of a fine-tuned model, of an MoE model, whose router terms
    reach the trunk past the frozen hidden states, or of an encoder-only
    model, whose masked-prediction loss stops no gradient; with a frozen
    base otherwise only the heads and the vocab projection, whose gradient
    counts in the clip's global norm even where a mask freezes it."""
    proj = "embed/table" if cfg.tie_embeddings else "lm_head/"
    every = not tc.freeze_base or cfg.mlp_type == "moe" or cfg.is_encoder_only
    return tree_map_with_name(
        lambda name, p: float(every or name.startswith("bpd_heads")
                              or name.startswith(proj)), params)


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    mask: Optional[Dict[str, float]] = None) -> Callable:
    """``train_step(params, opt_state, batch, gen, *, head_idx=None,
    swap=None) -> (params, opt_state, metrics)``: params and state are
    updated in place, each leaf's gradient stays in its ``.grad`` until the
    next step, and the metrics are tensors on the device (no host read) or
    host numbers (``head_idx``, ``lr``).  ``gen`` is the host generator of
    the step's draws; ``head_idx`` / ``swap`` override them
    (``core.train``).  Raises for a family whose loss is not ported."""
    loss_fn = loss_fn_for(cfg)

    def train_step(params, opt_state, batch, gen, *, head_idx=None, swap=None):
        set_trainable(params, differentiated(cfg, tc, params))
        leaves = flatten_with_names(params)
        for _, p in leaves:
            p.grad = None
        loss, metrics = loss_fn(params, cfg, tc, batch, gen,
                                head_idx=head_idx, swap=swap)
        loss.backward()
        grads = {name: p.grad for name, p in leaves if p.grad is not None}
        params, opt_state, opt_m = optimizer_update(grads, opt_state, params,
                                                    tc, mask=mask)
        metrics.update(opt_m)
        return params, opt_state, metrics

    return train_step
